"""Layers of the port: core feed-forward layers, the recurrent family,
self-attention, convolution, pooling, normalization and the unsupervised
pretrain layers."""

from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.base import (BaseLayer,
                                                     FeedForwardLayer,
                                                     layer_from_dict,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.layers.conv import (ConvolutionLayer,
                                                     SubsamplingLayer,
                                                     ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer, BaseOutputLayer, CenterLossOutputLayer, DenseLayer,
    DropoutLayer, EmbeddingLayer, LossLayer, OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.norm import (
    BatchNormalization, LocalResponseNormalization)
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.layers.pretrain import (
    RBM, AutoEncoder, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer)

__all__ = ["ActivationLayer", "AutoEncoder", "BaseLayer", "BaseOutputLayer",
           "BatchNormalization", "CenterLossOutputLayer", "ConvolutionLayer",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer",
           "FeedForwardLayer", "GlobalPoolingLayer",
           "GravesBidirectionalLSTM", "GravesLSTM", "LSTM",
           "LastTimeStepLayer", "LocalResponseNormalization", "LossLayer",
           "OutputLayer", "RBM", "RnnOutputLayer", "SelfAttentionLayer",
           "SubsamplingLayer", "VariationalAutoencoder",
           "ZeroPaddingLayer", "layer_from_dict", "register_layer"]
