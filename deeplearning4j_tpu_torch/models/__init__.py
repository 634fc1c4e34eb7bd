"""Models of the port."""

from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM, moe_ffn_dense)
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM,
                                                         params_from_numpy)
from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig

__all__ = ["MoETransformerConfig", "MoETransformerLM", "TransformerConfig",
           "TransformerLM", "ViT", "ViTConfig", "moe_ffn_dense",
           "params_from_numpy"]
