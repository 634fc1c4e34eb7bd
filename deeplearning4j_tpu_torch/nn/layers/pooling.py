"""GlobalPoolingLayer: the port of ``deeplearning4j_tpu/nn/layers/pooling.py``
(GlobalPoolingLayer.java).

MAX / AVG / SUM / PNORM over time ([batch, time, size], masked steps left
out of the statistic) or over H and W (NHWC).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import (Convolutional,
                                                         FeedForward,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, register_layer

__all__ = ["GlobalPoolingLayer"]


@register_layer
@dataclass
class GlobalPoolingLayer(BaseLayer):
    pooling_type: str = "max"
    pnorm: int = 2

    def set_input_type(self, input_type):
        return self.output_type(input_type)

    def output_type(self, input_type):
        if isinstance(input_type, Recurrent):
            return FeedForward(input_type.size)
        if isinstance(input_type, Convolutional):
            return FeedForward(input_type.channels)
        return input_type

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        if x.ndim == 3:      # RNN [batch, time, size]: pool over time
            dims = (1,)
        elif x.ndim == 4:    # CNN NHWC: pool over H, W
            dims = (1, 2)
        else:
            return x, state
        kind = self.pooling_type.lower()
        if kind not in ("max", "avg", "average", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type {self.pooling_type!r}")
        p = float(self.pnorm)
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if kind == "max":
                return torch.where(m > 0, x, float("-inf")).amax(dim=1), state
            if kind in ("avg", "average"):
                return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1),
                                                        min=1.0), state
            if kind == "sum":
                return (x * m).sum(dim=1), state
            return ((x.abs() ** p) * m).sum(dim=1) ** (1.0 / p), state
        if kind == "max":
            return x.amax(dim=dims), state
        if kind in ("avg", "average"):
            return x.mean(dim=dims), state
        if kind == "sum":
            return x.sum(dim=dims), state
        return (x.abs() ** p).sum(dim=dims) ** (1.0 / p), state

    def feed_forward_mask(self, mask):
        return None  # the time dimension is consumed
