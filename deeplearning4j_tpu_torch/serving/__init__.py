"""Serving front ends: the request batcher over ``model.output()``
(``batcher.py``) and continuous-batching generation over a
TransformerLM's persistent KV slot pool (``decode.py``), sharing one
queue and lifecycle core (``_base.py``); a health-checked router over
several of them (``router.py``) and the HTTP ingress in front of either
(``ingress.py``)."""

from deeplearning4j_tpu_torch.serving.batcher import (InferenceServer,
                                                      serve_buckets)
from deeplearning4j_tpu_torch.serving.decode import (ContinuousLM, kv_ladder,
                                                     prefill_ladder,
                                                     slots_ladder)
from deeplearning4j_tpu_torch.serving.ingress import ServingIngress
from deeplearning4j_tpu_torch.serving.router import ReplicaRouter

__all__ = ["ContinuousLM", "InferenceServer", "ReplicaRouter",
           "ServingIngress", "kv_ladder", "prefill_ladder", "serve_buckets",
           "slots_ladder"]
