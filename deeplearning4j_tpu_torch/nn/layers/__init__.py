"""Layers of the port: core feed-forward layers, the recurrent family,
convolution, pooling and normalization."""

from deeplearning4j_tpu_torch.nn.layers.base import (BaseLayer,
                                                     FeedForwardLayer,
                                                     layer_from_dict,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.layers.conv import (ConvolutionLayer,
                                                     SubsamplingLayer,
                                                     ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.layers.core import (ActivationLayer,
                                                     BaseOutputLayer,
                                                     DenseLayer, DropoutLayer,
                                                     LossLayer, OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.norm import (
    BatchNormalization, LocalResponseNormalization)
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer)

__all__ = ["ActivationLayer", "BaseLayer", "BaseOutputLayer",
           "BatchNormalization", "ConvolutionLayer", "DenseLayer",
           "DropoutLayer", "FeedForwardLayer", "GlobalPoolingLayer",
           "GravesBidirectionalLSTM", "GravesLSTM", "LSTM",
           "LastTimeStepLayer", "LocalResponseNormalization", "LossLayer",
           "OutputLayer", "RnnOutputLayer", "SubsamplingLayer",
           "ZeroPaddingLayer", "layer_from_dict", "register_layer"]
