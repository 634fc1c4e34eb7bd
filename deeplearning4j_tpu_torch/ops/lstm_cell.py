"""The fused LSTM cell: the CUDA kernels' wrappers, their plain twins, and
the autograd Function that joins them.

Ports ``deeplearning4j_tpu/ops/pallas_kernels.py:487-689``
(``lstm_cell_supported``, ``lstm_cell`` and its two ``custom_vjp``s). One
call is one time step of a (Graves) LSTM:

- ``z = zx + h_prev @ RW``, accumulated in f32; gates packed ``[i, f, g, o]``;
- with peepholes ``P [3, H]``: ``i += c_prev·P0``, ``f += c_prev·P1`` and,
  after the cell update, ``o += c·P2`` on the **new** c;
- ``c = σ(f)·c_prev + σ(i)·tanh(g)``, ``h = σ(o)·tanh(c)``; h and c are
  rounded once to h_prev/c_prev's dtype.

The backward recomputes the gates and returns ``dzx`` (which is ``dz``),
``dh_prev = dz·RWᵀ``, ``dc_prev`` (with the peephole paths),
``dRW = h_prevᵀ·dz`` and ``dP`` (batch column sums; None without
peepholes), each rounded once to its input's dtype (dP to RW's).

A CUDA tensor goes to the hand-written kernels, ``csrc/lstm_cell_fwd.cu``
and ``csrc/lstm_cell_bwd.cu``; a CPU tensor goes to the plain twins
:func:`lstm_cell_plain` and :func:`lstm_cell_bwd_plain`. There is no
fallback between the two: a CUDA call launches the kernel or raises.
``lstm_cell.launches`` and ``lstm_cell.bwd_launches`` count the kernel
calls; each call is one CUDA launch (the backward a cooperative launch
with one grid-wide barrier inside, see ``csrc/lstm_cell_bwd.cu``).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import _build

__all__ = ["lstm_cell", "lstm_cell_bwd_plain", "lstm_cell_plain",
           "lstm_cell_supported"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_cell_supported(gate_activation, cell_activation):
    """The kernels compute the standard cell only: sigmoid gates and a tanh
    cell/output activation. Other activations take the plain recurrence
    (``LSTM._scan_builtin``) on any device."""
    return gate_activation == "sigmoid" and \
        (cell_activation or "tanh") == "tanh"


def _gates(zx, h_prev, c_prev, rw, peep):
    """(i, f, g, o, c, tanh(c)) in f32, as both reference kernels compute
    them."""
    hp, cp = h_prev.float(), c_prev.float()
    z = zx.float() + torch.matmul(hp, rw.float())
    i, f, g, o = torch.chunk(z, 4, dim=1)
    if peep is not None:
        p = peep.float()
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
    cp = c_prev.float()
    dh, dc = dh.float(), dc.float()
    d_opre = dh * tc * o * (1.0 - o)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    if peep is not None:
        p = peep.float()
        dc_tot = dc_tot + d_opre * p[2:3]
    d_ipre = dc_tot * g * i * (1.0 - i)
    d_fpre = dc_tot * cp * f * (1.0 - f)
    d_gpre = dc_tot * i * (1.0 - g * g)
    dc_prev = dc_tot * f
    if peep is not None:
        dc_prev = dc_prev + d_ipre * p[0:1] + d_fpre * p[1:2]
    dz = torch.cat([d_ipre, d_fpre, d_gpre, d_opre], dim=1)
    dh_prev = torch.matmul(dz, rw.float().t())
    drw = torch.matmul(h_prev.float().t(), dz)
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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_forward(zx, h_prev, c_prev, rw, peep):
    """Launch the forward kernel on contiguous CUDA tensors; (h, c)."""
    _check_kernel_inputs("lstm_cell_fwd", zx, h_prev, c_prev, rw, peep)
    b, h = h_prev.shape
    h_out, c_out = torch.empty_like(h_prev), torch.empty_like(c_prev)
    lib = _build.load("lstm_cell_fwd")
    with torch.cuda.device(zx.device):
        rc = lib.lstm_cell_fwd(
            zx.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
            rw.data_ptr(), _ptr(peep), h_out.data_ptr(), c_out.data_ptr(),
            b, h, _DTYPE_CODES[zx.dtype], _stream(zx.device))
    if rc != 0:
        raise RuntimeError(f"lstm_cell_fwd launch failed: CUDA error {rc}")
    lstm_cell.launches += 1
    return h_out, c_out


def _kernel_backward(zx, h_prev, c_prev, rw, peep, dh, dc):
    """Launch the backward kernel on contiguous CUDA tensors; returns
    (dzx, dh_prev, dc_prev, dRW, dP or None). For bf16 the kernel also
    keeps the unrounded f32 dz in scratch: the products take dz before its
    rounding, as the reference's kernel does. The f32 scratch of the dP
    partials is sized by the library itself."""
    _check_kernel_inputs("lstm_cell_bwd", zx, h_prev, c_prev, rw, peep,
                         dh, dc)
    b, h = h_prev.shape
    lib = _build.load("lstm_cell_bwd")
    dzx = torch.empty_like(zx)
    dz32 = dzx if zx.dtype == torch.float32 else \
        torch.empty(zx.shape, dtype=torch.float32, device=zx.device)
    scratch = torch.empty(lib.lstm_cell_bwd_scratch_floats(b, h),
                          dtype=torch.float32, device=zx.device)
    dhp, dcp = torch.empty_like(h_prev), torch.empty_like(c_prev)
    drw = torch.empty_like(rw)
    dp = None if peep is None else torch.empty_like(peep)
    with torch.cuda.device(zx.device):
        rc = lib.lstm_cell_bwd(
            zx.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
            rw.data_ptr(), _ptr(peep), dh.data_ptr(), dc.data_ptr(),
            dzx.data_ptr(), dz32.data_ptr(), scratch.data_ptr(),
            dhp.data_ptr(), dcp.data_ptr(), drw.data_ptr(), _ptr(dp), b, h,
            _DTYPE_CODES[zx.dtype], _stream(zx.device))
    if rc != 0:
        raise RuntimeError(f"lstm_cell_bwd launch failed: CUDA error {rc}")
    lstm_cell.bwd_launches += 1
    return dzx, dhp, dcp, drw, dp


def _cell_forward(zx, h_prev, c_prev, rw, peep):
    if zx.device.type == "cpu":
        return lstm_cell_plain(zx, h_prev, c_prev, rw, peep)
    if zx.device.type == "cuda":
        return _kernel_forward(zx, h_prev, c_prev, rw, peep)
    raise ValueError(f"lstm_cell runs on cuda or cpu, not {zx.device}")


def _cell_backward(zx, h_prev, c_prev, rw, peep, dh, dc):
    if zx.device.type == "cpu":
        return lstm_cell_bwd_plain(zx, h_prev, c_prev, rw, peep, dh, dc)
    if zx.device.type == "cuda":
        return _kernel_backward(zx, h_prev, c_prev, rw, peep, dh, dc)
    raise ValueError(f"lstm_cell runs on cuda or cpu, not {zx.device}")


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
    the CPU)."""
    args = (zx, h_prev, c_prev, rw, peep)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _LstmCell.apply(*args)
    return _cell_forward(*args)


lstm_cell.launches = 0
lstm_cell.bwd_launches = 0
