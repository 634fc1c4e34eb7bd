"""Device ms a step of the update (the LM's clip, AdamW and EMA; the ViT's
AdamW): the port's ``fit.update`` span, timed between CUDA events on the
training stream into ``fit.update.device_seconds``. Spans record only
while a profile runs, so the histogram holds the traced steps, one
observation a step. None where the program has no such span."""


def read(m):
    from deeplearning4j_tpu_torch.obs import metrics, tracing
    # device spans still pending land in their histograms first
    getattr(tracing, "resolve_device_spans", lambda: None)()
    h = metrics.metrics_snapshot()["histograms"].get(
        "fit.update.device_seconds")
    return h["sum"] / h["count"] * 1e3 if h and h["count"] else None
