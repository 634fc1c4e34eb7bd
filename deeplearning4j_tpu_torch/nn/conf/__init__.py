"""Network configuration: the builder, ``MultiLayerConfiguration``,
``ComputationGraphConfiguration`` and its vertices, input types and
preprocessors."""

from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration, GraphBuilder, LayerVertex)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    ListBuilder, MultiLayerConfiguration, NeuralNetConfiguration)

__all__ = ["ComputationGraphConfiguration", "GraphBuilder", "InputType",
           "LayerVertex", "ListBuilder", "MultiLayerConfiguration",
           "NeuralNetConfiguration"]
