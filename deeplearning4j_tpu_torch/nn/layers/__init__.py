"""Layers of the port: core feed-forward layers and the recurrent family."""

from deeplearning4j_tpu_torch.nn.layers.base import (BaseLayer,
                                                     FeedForwardLayer,
                                                     layer_from_dict,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.layers.core import (ActivationLayer,
                                                     BaseOutputLayer,
                                                     DenseLayer, DropoutLayer,
                                                     LossLayer, OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer)

__all__ = ["ActivationLayer", "BaseLayer", "BaseOutputLayer", "DenseLayer",
           "DropoutLayer", "FeedForwardLayer", "GravesBidirectionalLSTM",
           "GravesLSTM", "LSTM", "LastTimeStepLayer", "LossLayer",
           "OutputLayer", "RnnOutputLayer", "layer_from_dict",
           "register_layer"]
