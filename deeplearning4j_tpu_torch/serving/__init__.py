"""Serving front ends: the request batcher over ``model.output()``
(``batcher.py``) and continuous-batching generation over a
TransformerLM's persistent KV slot pool (``decode.py``), sharing one
queue and lifecycle core (``_base.py``)."""

from deeplearning4j_tpu_torch.serving.batcher import (InferenceServer,
                                                      serve_buckets)
from deeplearning4j_tpu_torch.serving.decode import (ContinuousLM, kv_ladder,
                                                     prefill_ladder,
                                                     slots_ladder)

__all__ = ["ContinuousLM", "InferenceServer", "kv_ladder", "prefill_ladder",
           "serve_buckets", "slots_ladder"]
