"""Device ms a step of the step's input copies (the LM's tokens and
targets, the ViT's images and labels): the port's ``fit.input_copy`` span,
timed between CUDA events on the training stream into
``fit.input_copy.device_seconds``. The start event completes when the
previous step's work has drained, so the host's wait for it is not
counted. Spans record only while a profile runs, so the histogram holds
the traced steps, one observation a step. None where the program has no
such span."""


def read(m):
    from deeplearning4j_tpu_torch.obs import metrics, tracing
    # device spans still pending land in their histograms first
    getattr(tracing, "resolve_device_spans", lambda: None)()
    h = metrics.metrics_snapshot()["histograms"].get(
        "fit.input_copy.device_seconds")
    return h["sum"] / h["count"] * 1e3 if h and h["count"] else None
