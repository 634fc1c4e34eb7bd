"""Normalization layers: the port of ``deeplearning4j_tpu/nn/layers/norm.py``
(BatchNormalization.java, LocalResponseNormalization.java).

BatchNormalization keeps the reference's arithmetic rather than calling
``F.batch_norm``: the batch moments in one pass, shifted by the batch's
first row per channel (raw E[x²] - E[x]² cancels when the mean is large
against the spread), statistics in at least float32, and the running
variance updated with the biased batch variance (``F.batch_norm`` uses
the unbiased one). The running mean and variance are the layer state
``{"mean", "var"}``, the keys a model archive's ``state.npz`` uses. In a
train step under a sharding plan of N ranks the moments are those of the
global batch, as in the reference's global-batch step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import (Convolutional,
                                                         FeedForward,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, register_layer
from deeplearning4j_tpu_torch.parallel.sharding_core import current_batch_plan

__all__ = ["BatchNormalization", "LocalResponseNormalization"]


@register_layer
@dataclass
class BatchNormalization(BaseLayer):
    """Batch norm over the feature/channel axis (the last: NHWC, [B, F],
    [B, T, F]). ``lock_gamma_beta`` fixes gamma and beta at their
    initial values, with no parameters."""

    n_out: Optional[int] = None
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0

    def set_input_type(self, input_type):
        if self.n_out is None:
            if isinstance(input_type, Convolutional):
                self.n_out = input_type.channels
            elif isinstance(input_type, (FeedForward, Recurrent)):
                self.n_out = input_type.size
            else:
                raise ValueError(f"BatchNormalization got {input_type}")
        return input_type

    def output_type(self, input_type):
        return input_type

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    @property
    def param_order(self):
        return [] if self.lock_gamma_beta else ["gamma", "beta"]

    def init_params(self, generator, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        dev = generator.device
        return {"gamma": torch.full((self.n_out,), self.gamma_init,
                                    dtype=dtype, device=dev),
                "beta": torch.full((self.n_out,), self.beta_init,
                                   dtype=dtype, device=dev)}

    def init_state(self):
        return {"mean": torch.zeros(self.n_out, dtype=torch.float32),
                "var": torch.ones(self.n_out, dtype=torch.float32)}

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        dims = tuple(range(x.ndim - 1))   # all but the channel axis
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        plan = current_batch_plan() if train else None
        if plan is not None:
            dmean, shift, var = self._global_moments(plan, xf, dims)
            mean = shift + dmean
        elif train:
            shift = xf.reshape(-1, xf.shape[-1])[0].detach()
            d = xf - shift
            dmean = d.mean(dim=dims)
            mean = shift + dmean
            var = torch.clamp((d * d).mean(dim=dims) - dmean * dmean,
                              min=0.0)
        if not train:
            mean, var = state["mean"], state["var"]
            new_state = state
        else:
            new_state = {
                "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                "var": self.decay * state["var"] + (1 - self.decay) * var}
        xhat = ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        if self.lock_gamma_beta:
            out = self.gamma_init * xhat + self.beta_init
        else:
            out = params["gamma"] * xhat + params["beta"]
        return out, new_state

    @staticmethod
    def _global_moments(plan, xf, dims):
        """(shifted mean, shift, biased variance) of the global batch
        across ``plan``'s ranks: the shift is the global batch's first
        row (rank 0's, broadcast); the shifted sums, sums of squares and
        row counts are summed over the ranks (differentiably: every
        rank's loss depends on every row)."""
        shift = xf.reshape(-1, xf.shape[-1])[0].detach().clone()
        plan.broadcast(shift, 0)
        d = xf - shift
        rows = torch.full((1,), d.numel() // d.shape[-1], dtype=d.dtype,
                          device=d.device)
        sums = plan.all_reduce_sum(torch.cat(
            [d.sum(dim=dims), (d * d).sum(dim=dims), rows]))
        c = d.shape[-1]
        count = sums[2 * c].detach()
        dmean = sums[:c] / count
        var = torch.clamp(sums[c:2 * c] / count - dmean * dmean, min=0.0)
        return dmean, shift, var


@register_layer
@dataclass
class LocalResponseNormalization(BaseLayer):
    """Cross-channel LRN on the last axis:
    out = x / (k + alpha * sum over n adjacent channels of x²)^beta."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, input_type):
        return input_type

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        half = self.n // 2
        c = x.shape[-1]
        sq = x * x
        pad = torch.nn.functional.pad(sq, (half, half))
        # the window sum as a sum of shifted slices, in the reference's order
        acc = torch.zeros_like(sq)
        for i in range(self.n):
            acc = acc + pad[..., i:i + c]
        return x / (self.k + self.alpha * acc) ** self.beta, state
