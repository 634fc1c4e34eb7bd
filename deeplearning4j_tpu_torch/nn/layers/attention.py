"""Self-attention layer: the port of
``deeplearning4j_tpu/nn/layers/attention.py``.

Multi-head self-attention over ``[batch, time, size]`` activations with
a ``[batch, time]`` mask, the contracts of the LSTM layers, so it
composes with masking and RnnOutputLayer unchanged. Parameters and their
flat order are the reference's (``Wq, Wk, Wv, Wo, b``).

Routes (``_attend``), as the reference's:

- the helper seam first (``nn/helpers.py``): ``FlashAttentionHelper``
  takes an unmasked CUDA call to ``ops.flash_attention``, the hand-written
  flash kernels (forward; under autograd dQ and dK/dV too); it declines a
  masked call or a CPU tensor, and each decline is counted;
- otherwise the built-in plain routes of ``parallel/sequence_parallel.py``:
  ``blockwise_attention`` when ``block_size`` is set, ``dense_attention``
  when not, both with the key mask.

With ``sequence_axis`` set the layer is sequence-parallel, as the
reference's under ``shard_map``: its input and mask are this rank's
shard of the sequence, and the attention is
``sequence_parallel.ring_attention`` over the grid axis of that name
(call inside ``with mesh:``), the mask rotating with K and V.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.input_type import Recurrent
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, register_layer
from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp

__all__ = ["SelfAttentionLayer"]


@register_layer
@dataclass
class SelfAttentionLayer(BaseLayer):
    """Projections, softmax(QKᵀ/√d)V per head and an output projection;
    residual optional. ``block_size`` selects the blockwise built-in
    route (and is the flash wrapper's tile argument)."""

    # attention output wants no squashing by default, over the global
    # cascade (which would impose sigmoid)
    activation: Optional[str] = "identity"

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 1
    causal: bool = False
    residual: bool = False
    block_size: Optional[int] = None
    sequence_axis: Optional[str] = None

    def set_input_type(self, input_type):
        if self.n_in is None and isinstance(input_type, Recurrent):
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.residual and self.n_in != self.n_out:
            raise ValueError(f"residual=True needs n_in == n_out, got "
                             f"{self.n_in} != {self.n_out}")
        return self.output_type(input_type)

    def output_type(self, input_type):
        t = input_type.timeseries_length \
            if isinstance(input_type, Recurrent) else None
        return Recurrent(self.n_out, t)

    def param_shapes(self):
        return {"Wq": (self.n_in, self.n_out), "Wk": (self.n_in, self.n_out),
                "Wv": (self.n_in, self.n_out), "Wo": (self.n_out, self.n_out),
                "b": (self.n_out,)}

    @property
    def param_order(self):
        return ["Wq", "Wk", "Wv", "Wo", "b"]

    def init_params(self, generator, dtype=torch.float32):
        def mk(shape):
            return self._init_weight(generator, shape, dtype=dtype)
        return {"Wq": mk((self.n_in, self.n_out)),
                "Wk": mk((self.n_in, self.n_out)),
                "Wv": mk((self.n_in, self.n_out)),
                "Wo": mk((self.n_out, self.n_out)),
                "b": self._init_bias(generator, (self.n_out,), dtype=dtype)}

    def _split_heads(self, x):
        b, t, _ = x.shape
        h = self.n_heads
        return x.reshape(b, t, h, self.n_out // h).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def _attend(self, q, k, v, mask):
        """The helper when it supports the call, else the built-in route.
        A helper that raises propagates its error."""
        helper = helpers.get_helper(self)
        if helper is not None:
            if helper.supports(self, mask=mask, q=q):
                return helper.attention(q, k, v, causal=self.causal,
                                        block_size=self.block_size)
            helpers.count_decline(self)
        if self.block_size is not None:
            return sp.blockwise_attention(q, k, v, causal=self.causal,
                                          block_size=self.block_size,
                                          mask=mask)
        return sp.dense_attention(q, k, v, causal=self.causal, mask=mask)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        if self.n_out % self.n_heads != 0:
            raise ValueError(f"n_out={self.n_out} not divisible by "
                             f"n_heads={self.n_heads}")
        x = self.apply_dropout(x, train=train, rng=rng)
        q = self._split_heads(x @ params["Wq"])
        k = self._split_heads(x @ params["Wk"])
        v = self._split_heads(x @ params["Wv"])
        if self.sequence_axis is not None:
            # x and the mask are this rank's sequence shard; the mask
            # rotates around the ring together with K/V
            out = sp.ring_attention(q, k, v, axis_name=self.sequence_axis,
                                    causal=self.causal, mask=mask)
        else:
            out = self._attend(q, k, v, mask)
        out = self._merge_heads(out) @ params["Wo"] + params["b"]
        out = self.activation_fn()(out)
        if self.residual:
            out = out + x
        if mask is not None:
            out = out * torch.as_tensor(mask, device=out.device)[..., None] \
                .to(out.dtype)
        return out, state
