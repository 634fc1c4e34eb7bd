"""Mean device ms of one prefill window: the port's
``serve.prefill_window`` span, timed between CUDA events into
``serve.prefill_window.device_seconds``. Spans record only while a
profile runs, so the histogram holds the windows of the traced seconds.
None where the program has no such span."""


def read(m):
    from deeplearning4j_tpu_torch.obs import metrics, tracing
    # device spans still pending land in their histograms first
    getattr(tracing, "resolve_device_spans", lambda: None)()
    h = metrics.metrics_snapshot()["histograms"].get(
        "serve.prefill_window.device_seconds")
    return h["sum"] / h["count"] * 1e3 if h and h["count"] else None
