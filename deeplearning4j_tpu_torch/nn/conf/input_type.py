"""InputType: shape metadata flowing through layer configs.

The port's copy of ``deeplearning4j_tpu/nn/conf/input_type.py``
(``nn/conf/inputs/InputType.java``): FF / RNN / CNN / CNNFlat kinds drive
per-layer shape inference and automatic preprocessor insertion. The
layouts are the JAX package's, so one configuration JSON describes both:
RNN activations are [batch, time, features] and CNN activations NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass


class InputType:
    kind = "abstract"

    def to_dict(self):
        d = {"kind": self.kind}
        d.update(self.__dict__)
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        kind = d.pop("kind")
        cls = {"ff": FeedForward, "rnn": Recurrent, "cnn": Convolutional,
               "cnnflat": ConvolutionalFlat}[kind]
        return cls(**d)

    # factory helpers mirroring InputType.feedForward()/recurrent()/convolutional()
    @staticmethod
    def feed_forward(size):
        return FeedForward(size)

    @staticmethod
    def recurrent(size, timeseries_length=None):
        return Recurrent(size, timeseries_length)

    @staticmethod
    def convolutional(height, width, channels):
        return Convolutional(height, width, channels)

    @staticmethod
    def convolutional_flat(height, width, channels):
        return ConvolutionalFlat(height, width, channels)


@dataclass
class FeedForward(InputType):
    size: int
    kind = "ff"

    def array_shape(self, batch):
        return (batch, self.size)


@dataclass
class Recurrent(InputType):
    size: int
    timeseries_length: int | None = None
    kind = "rnn"

    def array_shape(self, batch):
        return (batch, self.timeseries_length or 1, self.size)


@dataclass
class Convolutional(InputType):
    height: int
    width: int
    channels: int
    kind = "cnn"

    def array_shape(self, batch):  # NHWC
        return (batch, self.height, self.width, self.channels)


@dataclass
class ConvolutionalFlat(InputType):
    height: int
    width: int
    channels: int
    kind = "cnnflat"

    @property
    def flattened_size(self):
        return self.height * self.width * self.channels

    def array_shape(self, batch):
        return (batch, self.flattened_size)
