"""The fused LSTM: the CUDA kernels' wrappers, their plain twins, and the
autograd Functions that join them.

Ports ``deeplearning4j_tpu/ops/pallas_kernels.py:487-689``
(``lstm_cell_supported``, ``lstm_cell`` and its two ``custom_vjp``s) and
the time loop the reference runs the cell in
(``deeplearning4j_tpu/nn/layers/recurrent.py:_scan_pallas``). One cell
step of a (Graves) LSTM:

- ``z = zx + h_prev @ RW``, accumulated in f32; gates packed ``[i, f, g, o]``;
- with peepholes ``P [3, H]``: ``i += c_prev·P0``, ``f += c_prev·P1`` and,
  after the cell update, ``o += c·P2`` on the **new** c;
- ``c = σ(f)·c_prev + σ(i)·tanh(g)``, ``h = σ(o)·tanh(c)``; h and c are
  rounded once to h_prev/c_prev's dtype.

The backward recomputes the gates and returns ``dzx`` (which is ``dz``),
``dh_prev = dz·RWᵀ``, ``dc_prev`` (with the peephole paths),
``dRW = h_prevᵀ·dz`` and ``dP`` (batch column sums; None without
peepholes), each rounded once to its input's dtype (dP to RW's).

:func:`lstm_sequence` runs a layer's whole window (``[T, B, 4H]`` input
projections, an optional ``[T, B]`` keep mask, either direction);
:func:`lstm_cell` one step. A CUDA tensor goes to the hand-written
kernels: ``csrc/lstm_cell_fwd.cu`` runs every step of a window in one
launch (a step of ``lstm_cell`` is a window of one), and
``csrc/lstm_cell_bwd.cu`` the backward of one step, which the sequence
Function's backward launches once a step, adding each step's dRW and dP
into one pair of buffers. A CPU tensor goes to the plain twins
:func:`lstm_sequence_plain`, :func:`lstm_cell_plain` and
:func:`lstm_cell_bwd_plain` through the same Functions. There is no
fallback between the two: a CUDA call launches the kernel or raises.
``lstm_sequence.launches`` counts forward launches and
``lstm_cell.bwd_launches`` backward launches; each is one CUDA kernel.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from deeplearning4j_tpu_torch.ops import _build

__all__ = ["lstm_cell", "lstm_cell_bwd_plain", "lstm_cell_plain",
           "lstm_cell_supported", "lstm_sequence", "lstm_sequence_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the launch counts are bumped under it: threads launch concurrently
_COUNT_LOCK = threading.Lock()

# An f32 window's out, h and c against the twin's: F32_WINDOW_TOL abs up to
# H 200 (a single step: 1e-6). Each step's rounding feeds the next: over
# the char-RNN's window (B 32, H 200, T 50) the f32 twin departs from the
# exact (float64) recurrence by up to 0.39 of this bar (12 seeds; held
# within 0.5 of it by tests/test_torch_lstm_cell.py), and a kernel that
# rounds as finely, in another order, departs as far.
F32_WINDOW_TOL = 2e-6

# A bf16 window against the twin's bf16 window: |got - want| <=
# BF16_WINDOW_BAR * max|want|, output by output. Each step rounds h and c to
# bf16 and feeds them on, so where two sums of a step round to neighbouring
# bf16 values the two windows part by a step of the storage type and carry
# that on; the one-step bar element by element holds for one step only.
# Two twins that differ only in the f32 rounding of z part by up to 0.34 of
# this bar over the char-RNN's window (B 32, H 200, T 50; held on the CPU
# by tests/test_torch_lstm_cell.py).
BF16_WINDOW_BAR = 2.0 ** -6


def lstm_cell_supported(gate_activation, cell_activation):
    """The kernels compute the standard cell only: sigmoid gates and a tanh
    cell/output activation. Other activations take the plain recurrence
    (``LSTM._scan_builtin``) on any device."""
    return gate_activation == "sigmoid" and \
        (cell_activation or "tanh") == "tanh"


def _acc_dtype(zx):
    """The twins' arithmetic type: f32, as both reference kernels compute,
    and float64 for float64 inputs (the kernels refuse those; on the CPU
    the gradient checker runs the twins in float64)."""
    return torch.float64 if zx.dtype == torch.float64 else torch.float32


def _gates(zx, h_prev, c_prev, rw, peep):
    """(i, f, g, o, c, tanh(c)) in :func:`_acc_dtype`."""
    acc = _acc_dtype(zx)
    hp, cp = h_prev.to(acc), c_prev.to(acc)
    z = zx.to(acc) + torch.matmul(hp, rw.to(acc))
    i, f, g, o = torch.chunk(z, 4, dim=1)
    if peep is not None:
        p = peep.to(acc)
        i = i + cp * p[0:1]
        f = f + cp * p[1:2]
    i, f, g = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g)
    c = f * cp + i * g
    if peep is not None:
        o = o + c * p[2:3]
    o = torch.sigmoid(o)
    return i, f, g, o, c, torch.tanh(c)


def lstm_cell_plain(zx, h_prev, c_prev, rw, peep=None):
    """The forward kernel's plain twin (``_lstm_cell_fwd_kernel``):
    returns (h, c) in h_prev/c_prev's dtypes."""
    _, _, _, o, c, tc = _gates(zx, h_prev, c_prev, rw, peep)
    return (o * tc).to(h_prev.dtype), c.to(c_prev.dtype)


def lstm_cell_bwd_plain(zx, h_prev, c_prev, rw, peep, dh, dc):
    """The backward kernel's plain twin (``_lstm_cell_bwd_kernel``),
    formula by formula. Returns (dzx, dh_prev, dc_prev, dRW, dP or None)."""
    i, f, g, o, c, tc = _gates(zx, h_prev, c_prev, rw, peep)
    acc = _acc_dtype(zx)
    cp = c_prev.to(acc)
    dh, dc = dh.to(acc), dc.to(acc)
    d_opre = dh * tc * o * (1.0 - o)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    if peep is not None:
        p = peep.to(acc)
        dc_tot = dc_tot + d_opre * p[2:3]
    d_ipre = dc_tot * g * i * (1.0 - i)
    d_fpre = dc_tot * cp * f * (1.0 - f)
    d_gpre = dc_tot * i * (1.0 - g * g)
    dc_prev = dc_tot * f
    if peep is not None:
        dc_prev = dc_prev + d_ipre * p[0:1] + d_fpre * p[1:2]
    dz = torch.cat([d_ipre, d_fpre, d_gpre, d_opre], dim=1)
    dh_prev = torch.matmul(dz, rw.to(acc).t())
    drw = torch.matmul(h_prev.to(acc).t(), dz)
    dp = None
    if peep is not None:
        dp = torch.stack([(d_ipre * cp).sum(0), (d_fpre * cp).sum(0),
                          (d_opre * c).sum(0)]).to(rw.dtype)
    return (dz.to(zx.dtype), dh_prev.to(h_prev.dtype),
            dc_prev.to(c_prev.dtype), drw.to(rw.dtype), dp)


def _check_kernel_inputs(what, zx, h_prev, c_prev, rw, peep, *like_h):
    """Refuse what the kernels cannot take, before any pointer is passed:
    dtype, device, shape and contiguity. ``like_h`` are further tensors
    shaped and typed like h_prev (the backward's dh, dc)."""
    ts = [zx, h_prev, c_prev, rw, *like_h] + ([] if peep is None else [peep])
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {zx.dtype}")
    if any(t.dtype != zx.dtype for t in ts):
        raise TypeError(f"{what}: input dtypes differ from zx's {zx.dtype}")
    if any(t.device != zx.device for t in ts):
        raise ValueError(f"{what}: inputs on different devices")
    if h_prev.ndim != 2 or h_prev.shape[0] < 1 or h_prev.shape[1] < 1:
        raise ValueError(f"{what}: h_prev must be [B, H], got "
                         f"{tuple(h_prev.shape)}")
    b, h = h_prev.shape
    want = {"zx": (zx, (b, 4 * h)), "c_prev": (c_prev, (b, h)),
            "RW": (rw, (h, 4 * h))}
    if peep is not None:
        want["P"] = (peep, (3, h))
    for i, t in enumerate(like_h):
        want[f"grad {i}"] = (t, (b, h))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {list(shape)} for "
                             f"h_prev [{b}, {h}], got {list(t.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous inputs")


def lstm_sequence_plain(zx_t, h0, c0, rw, peep=None, keep=None,
                        reverse=False, with_states=False):
    """The sequence kernel's plain twin: :func:`lstm_cell_plain` step by
    step over the window, t = 0 .. T-1 (``reverse``: T-1 .. 0); where
    ``keep[t, b]`` is False the row holds (h, c) and emits 0. Returns
    (out [T, B, H], (h_T, c_T)); ``with_states`` returns (out, h_all,
    c_all) instead, the states [T+1, B, H] in walk order (slot 0 h0, c0)."""
    n = zx_t.shape[0]
    hs, cs, outs = [h0], [c0], [None] * n
    for k in range(n):
        t = n - 1 - k if reverse else k
        h, c = lstm_cell_plain(zx_t[t], hs[-1], cs[-1], rw, peep)
        if keep is not None:
            kp = keep[t].unsqueeze(1)
            h, c = torch.where(kp, h, hs[-1]), torch.where(kp, c, cs[-1])
            outs[t] = torch.where(kp, h, 0.0)
        else:
            outs[t] = h
        hs.append(h)
        cs.append(c)
    out = torch.stack(outs)
    if with_states:
        return out, torch.stack(hs), torch.stack(cs)
    return out, (hs[-1], cs[-1])


def _check_sequence_inputs(what, zx_t, h0, c0, rw, peep, keep):
    """:func:`_check_kernel_inputs` for a window: zx_t [T, B, 4H] with T at
    least 1, contiguous; keep None or a contiguous bool [T, B] beside it."""
    if zx_t.ndim != 3 or zx_t.shape[0] < 1:
        raise ValueError(f"{what}: zx_t must be [T, B, 4H] with T >= 1, got "
                         f"{tuple(zx_t.shape)}")
    _check_kernel_inputs(what, zx_t[0], h0, c0, rw, peep)
    if not zx_t.is_contiguous():
        raise ValueError(f"{what} needs contiguous inputs")
    if keep is None:
        return
    if keep.dtype != torch.bool:
        raise TypeError(f"{what}: keep must be bool, got {keep.dtype}")
    if tuple(keep.shape) != tuple(zx_t.shape[:2]):
        raise ValueError(f"{what}: keep must be {list(zx_t.shape[:2])} "
                         f"[T, B], got {list(keep.shape)}")
    if keep.device != zx_t.device:
        raise ValueError(f"{what}: inputs on different devices")
    if not keep.is_contiguous():
        raise ValueError(f"{what} needs contiguous inputs")


def _require_cuda(what, t):
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_sequence(zx_t, h0, c0, rw, peep, keep, reverse):
    """Launch the sequence kernel on contiguous CUDA tensors: (out [T, B,
    H], h_all, c_all [T+1, B, H]), views of one fresh buffer."""
    _check_sequence_inputs("lstm_sequence", zx_t, h0, c0, rw, peep, keep)
    _require_cuda("lstm_sequence", zx_t)
    n, (b, h) = zx_t.shape[0], h0.shape
    lib = _build.load("lstm_cell_fwd")
    buf = torch.empty((3 * n + 2, b, h), dtype=zx_t.dtype, device=zx_t.device)
    h_all, c_all, out = buf[:n + 1], buf[n + 1:2 * n + 2], buf[2 * n + 2:]
    ints = lib.lstm_cell_fwd_scratch_ints(b, h) if n > 1 else 0
    counters = torch.empty(ints, dtype=torch.int32, device=zx_t.device) \
        if ints else None
    with torch.cuda.device(zx_t.device):
        rc = lib.lstm_cell_fwd(
            zx_t.data_ptr(), h0.data_ptr(), c0.data_ptr(), rw.data_ptr(),
            _ptr(peep), _ptr(keep), h_all.data_ptr(), c_all.data_ptr(),
            out.data_ptr(), _ptr(counters), n, b, h, int(reverse),
            _DTYPE_CODES[zx_t.dtype], _stream(zx_t.device))
    if rc != 0:
        raise RuntimeError(f"lstm_cell_fwd launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        lstm_sequence.launches += 1
    return out, h_all, c_all


def _kernel_forward(zx, h_prev, c_prev, rw, peep):
    """One step on contiguous CUDA tensors, the sequence kernel over a
    window of one; (h, c)."""
    _check_kernel_inputs("lstm_cell_fwd", zx, h_prev, c_prev, rw, peep)
    _, h_all, c_all = _kernel_sequence(zx[None], h_prev, c_prev, rw, peep,
                                       None, False)
    return h_all[1], c_all[1]


def _launch_backward(lib, zx, h_prev, c_prev, rw, peep, dh, dc, dzx, dz32,
                     scratch, drw, dp, accumulate, stream):
    """One backward launch into the given outputs; (dh_prev, dc_prev)."""
    b, h = h_prev.shape
    dhp, dcp = torch.empty_like(h_prev), torch.empty_like(c_prev)
    rc = lib.lstm_cell_bwd(
        zx.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(), rw.data_ptr(),
        _ptr(peep), dh.data_ptr(), dc.data_ptr(), dzx.data_ptr(),
        dz32.data_ptr(), scratch.data_ptr(), dhp.data_ptr(), dcp.data_ptr(),
        drw.data_ptr(), _ptr(dp), b, h, int(accumulate),
        _DTYPE_CODES[zx.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell_bwd launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        lstm_cell.bwd_launches += 1
    return dhp, dcp


def _bwd_scratch(lib, zx):
    """(dz32 or None for f32, the dP partials) for steps shaped like zx."""
    b, h = zx.shape[0], zx.shape[1] // 4
    dz32 = None if zx.dtype == torch.float32 else \
        torch.empty(zx.shape, dtype=torch.float32, device=zx.device)
    return dz32, torch.empty(lib.lstm_cell_bwd_scratch_floats(b, h),
                             dtype=torch.float32, device=zx.device)


def _kernel_backward(zx, h_prev, c_prev, rw, peep, dh, dc):
    """Launch the backward kernel on contiguous CUDA tensors; returns
    (dzx, dh_prev, dc_prev, dRW, dP or None). For bf16 the kernel also
    keeps the unrounded f32 dz in scratch: the products take dz before its
    rounding, as the reference's kernel does. The f32 scratch of the dP
    partials is sized by the library itself."""
    _check_kernel_inputs("lstm_cell_bwd", zx, h_prev, c_prev, rw, peep,
                         dh, dc)
    _require_cuda("lstm_cell_bwd", zx)
    lib = _build.load("lstm_cell_bwd")
    dz32, scratch = _bwd_scratch(lib, zx)
    dzx, drw = torch.empty_like(zx), torch.empty_like(rw)
    dp = None if peep is None else torch.empty_like(peep)
    with torch.cuda.device(zx.device):
        dhp, dcp = _launch_backward(
            lib, zx, h_prev, c_prev, rw, peep, dh, dc, dzx,
            dzx if dz32 is None else dz32, scratch, drw, dp, False,
            _stream(zx.device))
    return dzx, dhp, dcp, drw, dp


def _cell_forward(zx, h_prev, c_prev, rw, peep):
    if zx.device.type == "cpu":
        return lstm_cell_plain(zx, h_prev, c_prev, rw, peep)
    return _kernel_forward(zx, h_prev, c_prev, rw, peep)


def _cell_backward(zx, h_prev, c_prev, rw, peep, dh, dc):
    if zx.device.type == "cpu":
        return lstm_cell_bwd_plain(zx, h_prev, c_prev, rw, peep, dh, dc)
    return _kernel_backward(zx, h_prev, c_prev, rw, peep, dh, dc)


def _step_backward(zx_t, rw, peep):
    """The backward of one step of a window, ``step(zx, h_prev, c_prev,
    dh, dc, dzx, drw, dp) -> (dh_prev, dc_prev, dRW, dP)``: dz goes into
    ``dzx``, and the step's dRW and dP are added to ``drw`` and ``dp``
    (fresh ones when ``drw`` is None). On the card one kernel launch,
    its library, stream and scratch taken once for the window (whose
    inputs the forward checked) and dRW and dP added in place; on the CPU
    the twin, the sums new tensors (as adding two tensors of the storage
    type rounds them, which is what the kernel does)."""
    if zx_t.device.type == "cpu":
        def plain(zx, hp, cp, dh, dc, dzx, drw, dp):
            g_zx, dhp, dcp, g_rw, g_p = lstm_cell_bwd_plain(zx, hp, cp, rw,
                                                           peep, dh, dc)
            dzx.copy_(g_zx)
            if drw is None:
                return dhp, dcp, g_rw, g_p
            return dhp, dcp, drw + g_rw, None if g_p is None else dp + g_p
        return plain
    _require_cuda("lstm_sequence", zx_t)
    lib = _build.load("lstm_cell_bwd")
    dz32, scratch = _bwd_scratch(lib, zx_t[0])
    stream = _stream(zx_t.device)

    def kernel(zx, hp, cp, dh, dc, dzx, drw, dp):
        fresh = drw is None
        if fresh:
            drw = torch.empty_like(rw)
            dp = None if peep is None else torch.empty_like(peep)
        dhp, dcp = _launch_backward(lib, zx, hp, cp, rw, peep, dh, dc, dzx,
                                    dzx if dz32 is None else dz32, scratch,
                                    drw, dp, not fresh, stream)
        return dhp, dcp, drw, dp
    return kernel


def _sequence_forward(zx_t, h0, c0, rw, peep, keep, reverse):
    """(out, h_all, c_all) of a window: the kernel for a device tensor, the
    twin for a CPU tensor."""
    if zx_t.device.type == "cpu":
        return lstm_sequence_plain(zx_t, h0, c0, rw, peep, keep, reverse,
                                   with_states=True)
    return _kernel_sequence(zx_t, h0, c0, rw, peep, keep, reverse)


def _sequence_backward(zx_t, h_all, c_all, rw, peep, keep, reverse, d_out,
                       dh, dc):
    """The window's backward from the saved states: the steps in the
    opposite order to the forward, each one :func:`_step_backward` into
    its slice of dzx_t, with dRW and dP summed over the steps in that
    order. A row a step dropped gets no gradient through the cell there
    and passes (dh, dc) on unchanged. Returns (dzx_t, dh0, dc0, dRW, dP)."""
    n = zx_t.shape[0]
    dzx_t = torch.empty_like(zx_t)
    d_out = None if d_out is None else d_out.contiguous()
    zero = torch.zeros_like(h_all[0]) if dh is None or dc is None else None
    dh = zero if dh is None else dh.contiguous()
    dc = zero if dc is None else dc.contiguous()
    drw = dp = None
    with torch.cuda.device(zx_t.device) if zx_t.is_cuda else \
            contextlib.nullcontext():
        step = _step_backward(zx_t, rw, peep)
        for k in reversed(range(n)):
            t = n - 1 - k if reverse else k
            dh_in = dh if d_out is None else dh + d_out[t]
            dc_in = dc
            if keep is not None:
                kp = keep[t].unsqueeze(1)
                dh_in, dc_in = torch.where(kp, dh_in, 0.0), \
                    torch.where(kp, dc, 0.0)
            dhp, dcp, drw, dp = step(zx_t[t], h_all[k], c_all[k], dh_in,
                                     dc_in, dzx_t[t], drw, dp)
            if keep is not None:
                dhp, dcp = torch.where(kp, dhp, dh), torch.where(kp, dcp, dc)
            dh, dc = dhp, dcp
    return dzx_t, dh, dc, drw, dp


class _LstmSequence(torch.autograd.Function):
    """A window's forward in one call and its backward step by step; the
    forward keeps (zx_t, RW, P, keep) and every step's (h, c)."""

    @staticmethod
    def forward(ctx, zx_t, h0, c0, rw, peep, keep, reverse):
        out, h_all, c_all = _sequence_forward(zx_t, h0, c0, rw, peep, keep,
                                              reverse)
        ctx.reverse = reverse
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(zx_t, rw, peep, keep, h_all, c_all)
        return out, h_all[-1], c_all[-1]

    @staticmethod
    def backward(ctx, d_out, dh, dc):
        zx_t, rw, peep, keep, h_all, c_all = ctx.saved_tensors
        return (*_sequence_backward(zx_t, h_all, c_all, rw, peep, keep,
                                    ctx.reverse, d_out, dh, dc), None, None)


def lstm_sequence(zx_t, h0, c0, rw, peep=None, keep=None, reverse=False):
    """A layer's window: ``(out [T, B, H], (h_T, c_T))`` from the packed
    input projections ``zx_t`` [T, B, 4H] (time-major, contiguous), the
    initial state [B, H], the recurrent weights ``rw`` [H, 4H], optional
    peepholes ``peep`` [3, H] and an optional bool ``keep`` [T, B] (a
    dropped step holds (h, c) and emits 0), walked t = 0 .. T-1 or, with
    ``reverse``, T-1 .. 0. Differentiable in zx_t, h0, c0, rw and peep:
    one forward launch a window, one backward launch a step on the card,
    the twins on the CPU."""
    args = (zx_t, h0, c0, rw, peep)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        out, h, c = _LstmSequence.apply(*args, keep, reverse)
        return out, (h, c)
    out, h_all, c_all = _sequence_forward(*args, keep, reverse)
    return out, (h_all[-1], c_all[-1])


class _LstmCell(torch.autograd.Function):
    """The counterpart of the reference's two ``custom_vjp``s: the forward
    keeps (zx, h_prev, c_prev, RW, P) and the backward recomputes the
    gates from them."""

    @staticmethod
    def forward(ctx, zx, h_prev, c_prev, rw, peep):
        h, c = _cell_forward(zx, h_prev, c_prev, rw, peep)
        ctx.save_for_backward(zx, h_prev, c_prev, rw, peep)
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        zx, h_prev, c_prev, rw, peep = ctx.saved_tensors
        return _cell_backward(zx, h_prev, c_prev, rw, peep, dh.contiguous(),
                              dc.contiguous())


def lstm_cell(zx, h_prev, c_prev, rw, peep=None):
    """One fused cell step: ``(h, c)`` from the packed input projection
    ``zx`` [B, 4H], the previous state [B, H], the recurrent weights ``rw``
    [H, 4H] and optional peepholes ``peep`` [3, H] (rows i/f/o).
    Differentiable: its backward is the backward kernel (the plain twin on
    the CPU); on the card its forward is the sequence kernel over one
    step."""
    args = (zx, h_prev, c_prev, rw, peep)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _LstmCell.apply(*args)
    return _cell_forward(*args)


lstm_sequence.launches = 0
lstm_cell.bwd_launches = 0
