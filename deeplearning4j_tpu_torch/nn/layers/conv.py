"""Convolutional layers: the port of ``deeplearning4j_tpu/nn/layers/conv.py``
(ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer).

Layouts are the reference's at every boundary: activations NHWC, conv
weights HWIO. So a JAX net's parameters copy across unchanged, the
CNN-to-dense flatten keeps its H, W, C order, and a model archive's
coefficient vector is the same in both packages. Inside the layer the
tensors are permuted, not copied: an NHWC tensor viewed as [B, C, H, W]
is a channels_last NCHW tensor, which ``F.conv2d`` (cuDNN on the card)
takes as it is, and the HWIO weight viewed as [O, I, H, W] is its OIHW
form.

A conv asks the helper seam (``nn/helpers.py``) first, as the
reference's does: the registered ``Im2ColConvolutionHelper`` takes a conv
with at most 25 kernel elements and at most 4 input channels (LeNet's
first) as a patch gather and one GEMM; it declines the others, and
``DL4J_TPU_DISABLE_HELPERS=1`` turns it off. The other convs call
``F.conv2d``.

Padding follows ``lax``: ``same`` pads ``(out - 1) * stride + kernel -
size`` in all, the smaller half before. Pooling pads explicitly (-inf for
max, 0 for the sums) and pools with no padding of its own, because
``F.max_pool2d`` takes neither asymmetric padding nor padding above half
the kernel, and the average divides by kh*kw, padding included, as
``lax.reduce_window``'s does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.input_type import Convolutional
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, register_layer

__all__ = ["ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
           "conv_out_size", "same_pads", "spatial_pads"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def conv_out_size(size, kernel, stride, pad, mode="truncate"):
    if mode == "same":
        return -(-size // stride)
    return (size + 2 * pad - kernel) // stride + 1


def same_pads(size, kernel, stride):
    """(before, after) padding of one spatial dim under ``same``, as
    ``lax`` computes it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def spatial_pads(layer, x):
    """(top, bottom, left, right) padding of an NHWC input."""
    kh, kw = _pair(layer.kernel_size)
    sh, sw = _pair(layer.stride)
    if layer.convolution_mode == "same":
        return same_pads(x.shape[1], kh, sh) + same_pads(x.shape[2], kw, sw)
    ph, pw = _pair(layer.padding)
    return ph, ph, pw, pw


def _checked_output(what, input_type, kernel, stride, padding, mode,
                    channels):
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    oh = conv_out_size(input_type.height, kh, sh, ph, mode)
    ow = conv_out_size(input_type.width, kw, sw, pw, mode)
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"Invalid {what} configuration: input {input_type.height}x"
            f"{input_type.width}, kernel {kh}x{kw}, stride {sh}x{sw}, "
            f"padding {ph}x{pw} gives output {oh}x{ow}")
    return Convolutional(oh, ow, channels)


@register_layer
@dataclass
class ConvolutionLayer(BaseLayer):
    """2-D convolution. kernel/stride/padding are (h, w) pairs or ints."""

    n_in: Optional[int] = None    # input channels
    n_out: Optional[int] = None   # output channels
    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"  # "truncate" (explicit pad) or "same"
    cudnn_algo_mode: Optional[str] = None  # kept for the JSON; cuDNN picks
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, Convolutional):
            raise ValueError(f"ConvolutionLayer expects CNN input, got "
                             f"{input_type}")
        if self.n_in is None:
            self.n_in = input_type.channels
        return self.output_type(input_type)

    def output_type(self, input_type):
        return _checked_output("conv", input_type, self.kernel_size,
                               self.stride, self.padding,
                               self.convolution_mode, self.n_out)

    def param_shapes(self):
        kh, kw = _pair(self.kernel_size)
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}   # HWIO
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    @property
    def param_order(self):
        return ["W", "b"] if self.has_bias else ["W"]

    def init_params(self, generator, dtype=torch.float32):
        kh, kw = _pair(self.kernel_size)
        params = {"W": self._init_weight(
            generator, (kh, kw, self.n_in, self.n_out), dtype=dtype)}
        if self.has_bias:
            params["b"] = self._init_bias(generator, (self.n_out,),
                                          dtype=dtype)
        return params

    def uses_im2col(self):
        """Whether the im2col helper's gate admits this conv (the route
        it takes unless ``DL4J_TPU_DISABLE_HELPERS`` is set)."""
        return helpers.Im2ColConvolutionHelper().supports(self)

    def pre_output(self, params, x):
        helper = helpers.get_helper(self)
        if helper is not None:
            if helper.supports(self):
                return helper.pre_output(self, params, x)
            helpers.count_decline(self)
        pt, pb, pl, pr = spatial_pads(self, x)
        xc = x.permute(0, 3, 1, 2)                  # NHWC as channels_last
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            padding = (0, 0)
        z = F.conv2d(xc, params["W"].permute(3, 2, 0, 1),
                     params.get("b"), stride=_pair(self.stride),
                     padding=padding)
        return z.permute(0, 2, 3, 1)                # back to NHWC

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        return self.activation_fn()(self.pre_output(params, x)), state


@register_layer
@dataclass
class SubsamplingLayer(BaseLayer):
    """Pooling: MAX / AVG / SUM / PNORM (SubsamplingLayer.java)."""

    pooling_type: str = "max"
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    pnorm: int = 2
    convolution_mode: str = "truncate"

    def set_input_type(self, input_type):
        if not isinstance(input_type, Convolutional):
            raise ValueError(f"SubsamplingLayer expects CNN input, got "
                             f"{input_type}")
        return self.output_type(input_type)

    def output_type(self, input_type):
        return _checked_output("pooling", input_type, self.kernel_size,
                               self.stride, self.padding,
                               self.convolution_mode, input_type.channels)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pt, pb, pl, pr = spatial_pads(self, x)
        kind = self.pooling_type.lower()
        if kind not in ("max", "avg", "average", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type {self.pooling_type!r}")
        xc = x.permute(0, 3, 1, 2)
        if kind == "pnorm":
            p = float(self.pnorm)
            xc = xc.abs() ** p
        if pt or pb or pl or pr:
            xc = F.pad(xc, (pl, pr, pt, pb),
                       value=float("-inf") if kind == "max" else 0.0)
        if kind == "max":
            out = F.max_pool2d(xc, kernel, stride)
        else:
            out = F.avg_pool2d(xc, kernel, stride, divisor_override=1)
            if kind in ("avg", "average"):
                out = out / (kernel[0] * kernel[1])
            elif kind == "pnorm":
                out = out ** (1.0 / p)
        return out.permute(0, 2, 3, 1), state


@register_layer
@dataclass
class ZeroPaddingLayer(BaseLayer):
    """Zero padding in H and W (ZeroPaddingLayer.java)."""

    padding: tuple = (1, 1)  # (h, w) or ((top, bottom), (left, right))

    def _pads(self):
        p = self.padding
        if isinstance(p, (list, tuple)) and len(p) == 2 and \
                isinstance(p[0], (list, tuple)):
            (pt, pb), (pl, pr) = p
        else:
            ph, pw = _pair(p)
            pt = pb = ph
            pl = pr = pw
        return pt, pb, pl, pr

    def set_input_type(self, input_type):
        return self.output_type(input_type)

    def output_type(self, input_type):
        pt, pb, pl, pr = self._pads()
        return Convolutional(input_type.height + pt + pb,
                             input_type.width + pl + pr, input_type.channels)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        pt, pb, pl, pr = self._pads()
        return F.pad(x, (0, 0, pl, pr, pt, pb)), state
