"""Recurrent layers: the port of ``deeplearning4j_tpu/nn/layers/recurrent.py``
(LSTM, GravesLSTM with peepholes, GravesBidirectionalLSTM, LastTimeStepLayer).

Layout and math are the reference's: activations ``[batch, time,
features]``; gates packed ``[i, f, g, o]`` in ``W [n_in, 4H]`` and
``RW [H, 4H]``; peepholes ``P [3, H]``; mask ``[batch, time]``, where a
masked step emits 0 and holds (h, c).

The input projection of every time step is one matmul, laid out once as a
contiguous ``[T, B, 4H]``. Routing (``LSTM._scan``):

- a layer with sigmoid gates and a tanh cell (``lstm_cell_supported``)
  calls ``ops.lstm_sequence`` once per window and direction, an autograd
  Function: on a CUDA tensor it launches the hand-written sequence kernel
  (every step of the window in one launch) and, in the backward, the cell
  backward kernel once a step; on a CPU tensor it runs their plain twins;
- any other activations ask the helper seam (``nn/helpers.py``): the
  registered ``AcceleratedLSTMHelper`` runs ``_scan_builtin``, a Python
  loop over the steps of the plain recurrence under autograd, on either
  device, when it supports the call, and a decline (counted) takes
  ``_scan_builtin`` directly (routing by configuration, as the
  reference's ``lstm_cell_supported`` routes; the kernel route keeps its
  priority over the helper, as the reference's ``DL4J_TPU_LSTM_KERNEL``
  branch does);
- ``DL4J_TORCH_LSTM_KERNEL=builtin`` takes ``_scan_builtin`` for CPU
  tensors and raises for any other device.

Nothing falls back: a CUDA call launches the kernel or raises, and a
helper that raises propagates its error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.input_type import (FeedForward,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, register_layer
from deeplearning4j_tpu_torch.ops import activations as activations_mod
from deeplearning4j_tpu_torch.ops.lstm_cell import (lstm_cell_supported,
                                                    lstm_sequence)

__all__ = ["GravesBidirectionalLSTM", "GravesLSTM", "LSTM",
           "LastTimeStepLayer"]


def _lstm_gates(z, c_prev, peep, cell_act, gate_act, n_out):
    """Split packed preactivations z [batch, 4H] and apply the cell."""
    i, f, g, o = (z[:, :n_out], z[:, n_out:2 * n_out],
                  z[:, 2 * n_out:3 * n_out], z[:, 3 * n_out:])
    if peep is not None:
        i = i + c_prev * peep[0]
        f = f + c_prev * peep[1]
    i = gate_act(i)
    f = gate_act(f)
    g = cell_act(g)
    c = f * c_prev + i * g
    if peep is not None:
        o = o + c * peep[2]
    o = gate_act(o)
    return o * cell_act(c), c


def _time_major_projection(params, x, n_out):
    """``x @ W + b`` for every time step at once, as a contiguous
    [T, B, 4H]: each step's slice is then a contiguous [B, 4H]."""
    b, t, _ = x.shape
    zx = (x.reshape(b * t, -1) @ params["W"] + params["b"]).reshape(
        b, t, 4 * n_out)
    return zx.transpose(0, 1).contiguous()


def _step_mask(mask):
    """[T] list of [B, 1] bool keep-masks, or None."""
    if mask is None:
        return None
    return list((torch.as_tensor(mask) > 0).transpose(0, 1)[..., None]
                .unbind(0))


@register_layer
@dataclass
class LSTM(BaseLayer):
    """LSTM without peepholes; ``activation`` is the cell activation
    (default tanh)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    peephole = False

    def set_input_type(self, input_type):
        if self.n_in is None:
            if isinstance(input_type, (Recurrent, FeedForward)):
                self.n_in = input_type.size
            else:
                raise ValueError(f"{type(self).__name__} got {input_type}")
        return self.output_type(input_type)

    def output_type(self, input_type):
        t = input_type.timeseries_length \
            if isinstance(input_type, Recurrent) else None
        return Recurrent(self.n_out, t)

    def param_shapes(self):
        shapes = {"W": (self.n_in, 4 * self.n_out),
                  "RW": (self.n_out, 4 * self.n_out),
                  "b": (4 * self.n_out,)}
        if self.peephole:
            shapes["P"] = (3, self.n_out)
        return shapes

    @property
    def param_order(self):
        return ["W", "RW", "b"] + (["P"] if self.peephole else [])

    def init_params(self, generator, dtype=torch.float32):
        h = self.n_out
        b = torch.zeros((4 * h,), dtype=dtype, device=generator.device)
        b[h:2 * h] = self.forget_gate_bias_init   # forget-gate bias
        params = {
            "W": self._init_weight(generator, (self.n_in, 4 * h),
                                   fan_override=(self.n_in, h), dtype=dtype),
            "RW": self._init_weight(generator, (h, 4 * h),
                                    fan_override=(h, h), dtype=dtype),
            "b": b,
        }
        if self.peephole:
            # the reference draws 0 * normal: zeros
            params["P"] = torch.zeros((3, h), dtype=dtype,
                                      device=generator.device)
        return params

    def _activations(self):
        cell_act = self.activation_fn() if self.activation \
            else activations_mod.get("tanh")
        return cell_act, activations_mod.get(self.gate_activation)

    def _scan(self, params, x, h0, c0, mask, reverse=False):
        """(outputs [B, T, H], (h_T, c_T)) over the whole sequence; the
        route is chosen as the module docstring says."""
        if env_str("DL4J_TORCH_LSTM_KERNEL") == "builtin":
            if x.device.type != "cpu":
                raise ValueError(
                    f"DL4J_TORCH_LSTM_KERNEL=builtin runs on the CPU only; "
                    f"{x.device} tensors take the LSTM cell kernels")
            return self._scan_builtin(params, x, h0, c0, mask, reverse)
        if lstm_cell_supported(self.gate_activation, self.activation):
            return self._scan_kernel(params, x, h0, c0, mask, reverse)
        helper = helpers.get_helper(self)
        if helper is not None:
            if helper.supports(self, mask=mask, seq_len=x.shape[1]):
                return helper.scan(self, params, x, h0, c0, mask, reverse)
            helpers.count_decline(self)
        return self._scan_builtin(params, x, h0, c0, mask, reverse)

    def _walk(self, zx_t, h0, c0, mask, reverse, cell):
        """The plain route's time loop: ``cell(z_t, h, c)`` gives the new
        (h, c); masked steps hold (h, c) and emit 0."""
        keeps = _step_mask(mask)
        steps = range(zx_t.shape[0])
        outs = [None] * zx_t.shape[0]
        h, c = h0, c0
        z_steps = zx_t.unbind(0)
        for s in (reversed(steps) if reverse else steps):
            hn, cn = cell(z_steps[s], h, c)
            if keeps is not None:
                keep = keeps[s]
                hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
                outs[s] = hn * keep
            else:
                outs[s] = hn
            h, c = hn, cn
        return torch.stack(outs, dim=1), (h, c)

    def _scan_kernel(self, params, x, h0, c0, mask, reverse=False):
        """The reference's ``_scan_pallas``: one ``ops.lstm_sequence``
        call over the window (one forward launch; a backward launch a
        step)."""
        zx_t = _time_major_projection(params, x, self.n_out)
        keep = None if mask is None else \
            (torch.as_tensor(mask, device=x.device) > 0).transpose(0, 1) \
            .contiguous()
        out, carry = lstm_sequence(zx_t, h0.contiguous(), c0.contiguous(),
                                   params["RW"], params.get("P"), keep,
                                   reverse)
        return out.transpose(0, 1), carry

    def _scan_builtin(self, params, x, h0, c0, mask, reverse=False):
        """The reference's ``_scan_builtin``: the plain gate math per step,
        differentiated by autograd."""
        cell_act, gate_act = self._activations()
        zx_t = _time_major_projection(params, x, self.n_out)
        rw, peep, n = params["RW"], params.get("P"), self.n_out
        return self._walk(
            zx_t, h0, c0, mask, reverse,
            lambda z, h, c: _lstm_gates(z + h @ rw, c, peep, cell_act,
                                        gate_act, n))

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        h0, c0 = self.initial_carry(x.shape[0], x.dtype, x.device)
        out, _ = self._scan(params, x, h0, c0, mask)
        return out, state

    def step(self, params, x_t, carry):
        """Single-timestep stateful inference (rnnTimeStep), with the plain
        gate math as in the reference."""
        cell_act, gate_act = self._activations()
        h_prev, c_prev = carry
        z = x_t @ params["W"] + params["b"] + h_prev @ params["RW"]
        h, c = _lstm_gates(z, c_prev, params.get("P"), cell_act, gate_act,
                           self.n_out)
        return h, (h, c)

    def initial_carry(self, batch, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),
                torch.zeros((batch, self.n_out), dtype=dtype, device=device))


@register_layer
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013; GravesLSTM.java)."""

    peephole = True


@register_layer
@dataclass
class GravesBidirectionalLSTM(LSTM):
    """Bidirectional peephole LSTM: two parameter sets (prefixes F/B), the
    backward one walking time in reverse; outputs combined by ``mode``
    ("add", the reference's behaviour, or "concat")."""

    mode: str = "add"
    peephole = True

    def output_type(self, input_type):
        t = input_type.timeseries_length \
            if isinstance(input_type, Recurrent) else None
        n = self.n_out * (2 if self.mode == "concat" else 1)
        return Recurrent(n, t)

    def param_shapes(self):
        one = super().param_shapes()
        return {f"{d}_{k}": v for d in ("F", "B") for k, v in one.items()}

    @property
    def param_order(self):
        one = super().param_order
        return [f"F_{k}" for k in one] + [f"B_{k}" for k in one]

    def init_params(self, generator, dtype=torch.float32):
        f = super().init_params(generator, dtype)
        bwd = super().init_params(generator, dtype)
        out = {f"F_{k}": v for k, v in f.items()}
        out.update({f"B_{k}": v for k, v in bwd.items()})
        return out

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        h0, c0 = self.initial_carry(x.shape[0], x.dtype, x.device)
        pf = {k[2:]: v for k, v in params.items() if k.startswith("F_")}
        pb = {k[2:]: v for k, v in params.items() if k.startswith("B_")}
        out_f, _ = self._scan(pf, x, h0, c0, mask)
        out_b, _ = self._scan(pb, x, h0, c0, mask, reverse=True)
        if self.mode == "concat":
            return torch.cat([out_f, out_b], dim=-1), state
        return out_f + out_b, state


@register_layer
@dataclass
class LastTimeStepLayer(BaseLayer):
    """[batch, time, size] → [batch, size]: the last unmasked step
    (LastTimeStepVertex.java)."""

    def set_input_type(self, input_type):
        return self.output_type(input_type)

    def output_type(self, input_type):
        return FeedForward(input_type.size)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        if mask is None:
            return x[:, -1, :], state
        # the last NONZERO mask index (handles pre-padded masks)
        t = x.shape[1]
        rev = torch.flip(torch.as_tensor(mask, device=x.device) > 0, dims=(1,))
        idx = t - 1 - torch.argmax(rev.to(torch.int32), dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx, :], state

    def feed_forward_mask(self, mask):
        return None
