"""Accelerated-layer helper seam: the port of
``deeplearning4j_tpu/nn/helpers.py`` (the reference's cuDNN helper
plug-in, ``ConvolutionLayer.java:69-76``).

The registry maps a layer class name to a helper object. A layer asks
:func:`get_helper` for its helper on each call, and the helper's
``supports(layer, **ctx)`` gates that call. ``DL4J_TPU_DISABLE_HELPERS=1``
turns every helper off (the reference's "remove cuDNN from the
classpath"); the knob keeps the reference's name.

One difference from the reference: nothing falls back on an error. The
reference wraps each helper call in ``except Exception: pass`` and takes
the built-in path on any failure; here a helper that raises propagates
its error, since on the card that error is a kernel failure. Only a
``supports()`` decline takes the built-in path, and each decline is
counted (``helpers.declines_total.<layer class>``, :func:`declines`).

Tenants:

- :class:`FlashAttentionHelper` — SelfAttentionLayer through
  ``ops.flash_attention`` (the three flash kernels on the card). It
  declines under a key mask, as the reference's does, and for a tensor
  not on CUDA (the counterpart of ``pallas_supported()`` being False off
  the TPU).
- :class:`Im2ColConvolutionHelper` — a conv with at most 25 kernel
  elements and at most 4 input channels (LeNet's first) as a patch
  gather and one GEMM. At LeNet's first conv cuDNN's own pick is worse
  on the card: at batch 128 a weight gradient whose bits change from call
  to call, at batch 16 a Winograd one 6.1e-4 off in f32 against float64,
  where this route is bit-stable, within 5.7e-7, and as fast
  (``conv_variants.py``, H100 80GB HBM3).
- :class:`AcceleratedLSTMHelper` — registered for the LSTM family so
  that :func:`get_helper` answers as the reference's does. Its ``scan``
  is the layer's built-in recurrence; the LSTM kernel route
  (``ops.lstm_sequence``) keeps its priority over it, as the reference's
  ``DL4J_TPU_LSTM_KERNEL`` branch does.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_flag

__all__ = ["AcceleratedLSTMHelper", "FlashAttentionHelper",
           "Im2ColConvolutionHelper", "LayerHelper", "count_decline",
           "declines", "get_helper", "register_helper", "unregister_helper"]

_REGISTRY: dict[str, object] = {}


def register_helper(layer_cls_name: str, helper):
    _REGISTRY[layer_cls_name] = helper
    return helper


def unregister_helper(layer_cls_name: str):
    _REGISTRY.pop(layer_cls_name, None)


def get_helper(layer):
    """The registered helper for this layer instance, or None."""
    if env_flag("DL4J_TPU_DISABLE_HELPERS"):
        return None
    return _REGISTRY.get(type(layer).__name__)


def _decline_counter(layer):
    name = type(layer).__name__
    return obs.counter(f"helpers.declines_total.{name}",
                       f"Calls of a {name} whose registered helper "
                       "declined them (supports() False): each took the "
                       "layer's built-in path")


def count_decline(layer):
    """Record one ``supports()`` decline of ``layer``'s helper."""
    _decline_counter(layer).inc()


def declines(layer_cls_name):
    """Declines counted so far for a layer class."""
    try:
        return obs.metrics.value(f"helpers.declines_total.{layer_cls_name}")
    except KeyError:
        return 0


class LayerHelper:
    """Helper contract (``ConvolutionHelper.java`` role)."""

    def supports(self, layer, **ctx) -> bool:
        return False


class AcceleratedLSTMHelper(LayerHelper):
    """The reference's unrolled-scan LSTM. Here the unrolling has nothing
    to amortise (there is no compiled loop), so ``scan`` is the layer's
    built-in recurrence; ``supports`` keeps the reference's gate."""

    def __init__(self, unroll: int = 8):
        self.unroll = unroll

    def supports(self, layer, *, mask=None, seq_len=None, **ctx):
        return seq_len is None or seq_len >= self.unroll

    def scan(self, layer, params, x, h0, c0, mask, reverse=False):
        return layer._scan_builtin(params, x, h0, c0, mask, reverse)


class Im2ColConvolutionHelper(LayerHelper):
    """Conv forward as a patch gather and one
    (B·OH·OW, C·KH·KW) x (C·KH·KW, F) GEMM, for small kernels over few
    channels; the gate is the reference's."""

    def __init__(self, max_kernel_elems: int = 25, max_in_channels: int = 4):
        self.max_kernel_elems = max_kernel_elems
        self.max_in_channels = max_in_channels

    def supports(self, layer, **ctx):
        # imported here: nn/layers/conv.py imports this module
        from deeplearning4j_tpu_torch.nn.layers.conv import _pair
        kh, kw = _pair(layer.kernel_size)
        n_in = layer.n_in or 0
        return kh * kw <= self.max_kernel_elems and \
            0 < n_in <= self.max_in_channels

    def pre_output(self, layer, params, x):
        """NHWC -> NHWC: the patches as rows of (C, KH, KW) (two strided
        window views of the input, copied once by the reshape), times the
        HWIO weight laid out the same way."""
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.nn.layers.conv import (_pair,
                                                             spatial_pads)
        kh, kw = _pair(layer.kernel_size)
        sh, sw = _pair(layer.stride)
        pt, pb, pl, pr = spatial_pads(layer, x)
        if pt or pb or pl or pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
        # [B, OH, OW, C, KH, KW]
        patches = x.unfold(1, kh, sh).unfold(2, kw, sw)
        b, oh, ow, c = patches.shape[:4]
        cols = patches.reshape(b * oh * ow, c * kh * kw)
        wmat = params["W"].permute(2, 0, 1, 3).reshape(c * kh * kw,
                                                       layer.n_out)
        z = (cols @ wmat).reshape(b, oh, ow, layer.n_out)
        return z + params["b"] if layer.has_bias else z


class FlashAttentionHelper(LayerHelper):
    """SelfAttentionLayer through ``ops.flash_attention``: the forward
    kernel, and under autograd the dQ and dK/dV kernels."""

    def supports(self, layer, *, mask=None, q=None, **ctx):
        # a key-validity mask is not fused into the kernels: decline and
        # let the built-in path handle it, as the reference does; off the
        # card there is no kernel to take
        return mask is None and q is not None and q.is_cuda

    def attention(self, q, k, v, *, causal, block_size=None):
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_attention
        bs = block_size or 512
        return flash_attention(q, k, v, causal=causal, block_q=bs,
                               block_k=bs)


register_helper("SelfAttentionLayer", FlashAttentionHelper())
_lstm_helper = AcceleratedLSTMHelper()
register_helper("LSTM", _lstm_helper)
register_helper("GravesLSTM", _lstm_helper)
register_helper("GravesBidirectionalLSTM", _lstm_helper)
register_helper("ConvolutionLayer", Im2ColConvolutionHelper())
