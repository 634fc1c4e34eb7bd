"""Evaluation of the port: classification, regression and ROC."""

from deeplearning4j_tpu_torch.eval.evaluation import (ConfusionMatrix,
                                                      Evaluation,
                                                      RegressionEvaluation)
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "ROC", "ROCMultiClass",
           "RegressionEvaluation"]
