"""Observability: metrics registry + trace spans.

One import surface for instrumented subsystems::

    from deeplearning4j_tpu_torch import obs

    _REQS = obs.counter("serve.requests_total", "Requests accepted")
    with obs.span("serve.dispatch", rows=8):
        ...
    _REQS.inc()

``obs.metrics`` aggregates Counters/Gauges/Histograms process-wide and
exports them as one JSON-able snapshot. ``obs.tracing`` records spans:
Chrome-trace-event spans with thread ids while ``DL4J_TORCH_TRACE_DIR``
is set, and, while a ``torch.profiler`` profile records, host ranges in
that profile too. A span can also time its body on the device's stream
(``span(name, device=dev)``, a CUDA event pair resolved without a
synchronize into ``<name>.device_seconds``). Span files and profiles
share one clock, the profiler's (Unix epoch). Neither module imports
torch.
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
