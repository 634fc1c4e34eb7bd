"""PyTorch port of deeplearning4j_tpu for an NVIDIA H100.

Module paths and names follow the JAX package (``deeplearning4j_tpu``),
which stays in the repository as the reference; nothing here imports it
or JAX. Entry points run on the card unless the caller passes
``device="cpu"``. Hand-written CUDA kernels live in ``csrc/`` and are
built at first use into ``_build/``, as is the native host library of
``nativelib.py`` (from the repository's ``native/src``).
"""

from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM, moe_ffn_dense)
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM,
                                                         params_from_numpy)
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
from deeplearning4j_tpu_torch.serving.batcher import InferenceServer

__all__ = ["MoETransformerConfig", "MoETransformerLM", "TransformerConfig",
           "TransformerLM", "ViT", "ViTConfig", "moe_ffn_dense",
           "params_from_numpy", "InferenceServer"]
