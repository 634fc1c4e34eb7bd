"""Input preprocessors: the port of
``deeplearning4j_tpu/nn/conf/preprocessors.py`` (``nn/conf/preprocessor/*``).

Shape adapters between layer families, each a reshape plus its InputType
propagation; autograd carries the gradient back through the reshape.
Layouts are the reference's: CNN activations NHWC, RNN activations
[batch, time, size]. So the CNN-to-feed-forward flatten keeps the H, W, C
order that a dense layer's weight rows were trained against.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.input_type import (Convolutional,
                                                         FeedForward,
                                                         Recurrent)

__all__ = ["CnnToFeedForwardPreProcessor", "CnnToRnnPreProcessor",
           "ComposableInputPreProcessor", "FeedForwardToCnnPreProcessor",
           "FeedForwardToRnnPreProcessor", "InputPreProcessor",
           "RnnToCnnPreProcessor", "RnnToFeedForwardPreProcessor",
           "preprocessor_from_dict"]

_REGISTRY = {}


def register_preprocessor(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d):
    d = dict(d)
    name = d.pop("type")
    return _REGISTRY[name](**d)


class InputPreProcessor:
    """``pre_process`` adapts input on the way in."""

    def pre_process(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, input_type):
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        return mask

    def to_dict(self):
        d = {"type": type(self).__name__}
        d.update(self.__dict__)
        return d


@register_preprocessor
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """NHWC [batch, h, w, c] -> [batch, h*w*c], flattened in H, W, C
    order."""

    def __init__(self, input_height=None, input_width=None,
                 num_channels=None):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        if isinstance(input_type, Convolutional):
            return FeedForward(input_type.height * input_type.width
                               * input_type.channels)
        return input_type


@register_preprocessor
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[batch, h*w*c] -> NHWC [batch, h, w, c]."""

    def __init__(self, input_height, input_width, num_channels):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], self.input_height, self.input_width,
                         self.num_channels)

    def output_type(self, input_type):
        return Convolutional(self.input_height, self.input_width,
                             self.num_channels)


@register_preprocessor
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[batch, time, size] -> [batch*time, size] (time folded into
    examples)."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type):
        if isinstance(input_type, Recurrent):
            return FeedForward(input_type.size)
        return input_type

    def feed_forward_mask(self, mask):
        if mask is not None and mask.ndim == 2:
            return mask.reshape(-1, 1)
        return mask


@register_preprocessor
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[batch*time, size] -> [batch, time, size]; needs the time length at
    call."""

    def __init__(self, timeseries_length=None):
        self.timeseries_length = timeseries_length

    def pre_process(self, x, mask=None):
        t = self.timeseries_length
        if t is None:
            raise ValueError("FeedForwardToRnnPreProcessor needs "
                             "timeseries_length")
        return x.reshape(-1, t, x.shape[-1])

    def output_type(self, input_type):
        if isinstance(input_type, FeedForward):
            return Recurrent(input_type.size, self.timeseries_length)
        return input_type


@register_preprocessor
class CnnToRnnPreProcessor(InputPreProcessor):
    """[batch*time, h, w, c] -> [batch, time, h*w*c]."""

    def __init__(self, input_height, input_width, num_channels,
                 timeseries_length=None):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels
        self.timeseries_length = timeseries_length

    def pre_process(self, x, mask=None):
        t = self.timeseries_length
        if t is None:
            raise ValueError("CnnToRnnPreProcessor needs timeseries_length")
        return x.reshape(-1, t, self.input_height * self.input_width
                         * self.num_channels)

    def output_type(self, input_type):
        return Recurrent(self.input_height * self.input_width
                         * self.num_channels, self.timeseries_length)


@register_preprocessor
class RnnToCnnPreProcessor(InputPreProcessor):
    """[batch, time, h*w*c] -> [batch*time, h, w, c]."""

    def __init__(self, input_height, input_width, num_channels):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.input_height, self.input_width,
                         self.num_channels)

    def output_type(self, input_type):
        return Convolutional(self.input_height, self.input_width,
                             self.num_channels)


@register_preprocessor
class ComposableInputPreProcessor(InputPreProcessor):
    """Its preprocessors applied in order."""

    def __init__(self, preprocessors):
        self.preprocessors = [
            p if isinstance(p, InputPreProcessor)
            else preprocessor_from_dict(p) for p in preprocessors]

    def pre_process(self, x, mask=None):
        for p in self.preprocessors:
            x = p.pre_process(x, mask)
        return x

    def output_type(self, input_type):
        for p in self.preprocessors:
            input_type = p.output_type(input_type)
        return input_type

    def to_dict(self):
        return {"type": "ComposableInputPreProcessor",
                "preprocessors": [p.to_dict() for p in self.preprocessors]}
