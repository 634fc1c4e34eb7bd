"""Input preprocessors: the port of
``deeplearning4j_tpu/nn/conf/preprocessors.py`` (``nn/conf/preprocessor/*``).

Shape adapters between layer families, each a reshape plus its InputType
propagation; autograd carries the gradient back through the reshape. This
slice ports the recurrent pair (RnnToFeedForward, FeedForwardToRnn); the
CNN preprocessors come with the convolution layers and raise until then.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.input_type import (FeedForward,
                                                         Recurrent)

__all__ = ["FeedForwardToRnnPreProcessor", "InputPreProcessor",
           "RnnToFeedForwardPreProcessor", "not_ported",
           "preprocessor_from_dict"]

_REGISTRY = {}
# the reference's preprocessors this package does not have yet
_NOT_PORTED = ("CnnToFeedForwardPreProcessor", "FeedForwardToCnnPreProcessor",
               "CnnToRnnPreProcessor", "RnnToCnnPreProcessor",
               "ComposableInputPreProcessor")


def not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        "(ROADMAP.md, queue 1)")


def register_preprocessor(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d):
    d = dict(d)
    name = d.pop("type")
    if name in _NOT_PORTED:
        raise not_ported(name)
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
