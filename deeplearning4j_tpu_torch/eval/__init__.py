"""Evaluation of the port."""

from deeplearning4j_tpu_torch.eval.evaluation import (ConfusionMatrix,
                                                      Evaluation)

__all__ = ["ConfusionMatrix", "Evaluation"]
