"""Observability: metrics registry + trace spans.

One import surface for instrumented subsystems::

    from deeplearning4j_tpu_torch import obs

    _REQS = obs.counter("serve.requests_total", "Requests accepted")
    with obs.span("serve.dispatch", rows=8):
        ...
    _REQS.inc()

``obs.metrics`` aggregates Counters/Gauges/Histograms process-wide and
exports them as one JSON-able snapshot. ``obs.tracing`` records
Chrome-trace-event spans with thread ids (``DL4J_TORCH_TRACE_DIR``).
Neither imports torch, and both record host scalars only.
"""

from deeplearning4j_tpu_torch.obs import metrics, tracing
from deeplearning4j_tpu_torch.obs.metrics import (counter, gauge, histogram,
                                                  metrics_snapshot,
                                                  metrics_summary,
                                                  prometheus_text,
                                                  reset_metrics, timer)
from deeplearning4j_tpu_torch.obs.tracing import add_span, span

__all__ = ["metrics", "tracing", "add_span", "counter", "gauge", "histogram",
           "metrics_snapshot", "metrics_summary", "prometheus_text",
           "reset_metrics", "span", "timer"]
