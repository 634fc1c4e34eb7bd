"""Network configuration: the builder, ``MultiLayerConfiguration``, input
types and preprocessors."""

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    ListBuilder, MultiLayerConfiguration, NeuralNetConfiguration)

__all__ = ["InputType", "ListBuilder", "MultiLayerConfiguration",
           "NeuralNetConfiguration"]
