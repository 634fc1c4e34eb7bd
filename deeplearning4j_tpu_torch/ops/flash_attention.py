"""Flash attention: the CUDA kernels' wrappers, their plain twins, and the
autograd Function that joins them.

``flash_attention`` keeps the reference's signature and checks
(``deeplearning4j_tpu/ops/pallas_kernels.py:flash_attention``) and is
differentiable, as the reference's ``custom_vjp`` is. A CUDA tensor goes
to the hand-written kernels: the forward in ``csrc/flash_attn_fwd.cu``,
the backward in ``csrc/flash_attn_dq.cu`` and ``csrc/flash_attn_dkv.cu``.
A CPU tensor goes to the plain twins: :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain`, the same functions in plain PyTorch.
There is no fallback between the two: a CUDA call either launches the
kernels or raises. ``DL4J_TORCH_FLASH_BWD=scan`` differentiates the plain
forward recurrence instead, on CPU tensors only.

Semantics both sides hold, as the reference kernels do:

- forward: q is multiplied by ``1/sqrt(d)`` in q's dtype before ``QKᵀ``;
  scores, softmax statistics and the output accumulate in f32; O is
  returned in q's dtype and the logsumexp ``lse`` in f32;
- backward: ``S = f32(QKᵀ)`` times the unrounded f32 ``1/sqrt(d)`` (not
  the forward's order), ``P = exp(S - lse)``, ``dS = P∘(dO·Vᵀ - delta)``
  times the scale with ``delta = rowsum(dO∘O)``; dQ, dK and dV accumulate
  in f32 and are returned in q/k/v's dtypes;
- masked scores are ``NEG_INF = -1e30``; a row with no unmasked key gets
  O = 0 and ``lse = +1e30``, so its P is an exact 0;
- GQA maps flattened q-head ``b`` to kv-head ``b // kv_group``; dK/dV of
  a kv head sum its group's q-heads in f32 and are rounded once.

On the card the kernels split by dtype. f32 runs on the CUDA cores and
holds the twins within 1e-5 (summation order only). bf16 runs all three
kernels on the tensor cores, which take bf16 operands: the forward rounds
P to bf16 before ``P·V``, dK/dV rounds ``Pᵀ`` and ``dSᵀ`` to bf16 before
``Pᵀ·dO`` and ``dSᵀ·Q``, and dQ rounds ``dS`` to bf16 before ``dS·K``,
where the reference (and the twins) multiply those in f32. Scores, the
softmax statistics (so lse) and every accumulation stay f32.
:data:`BF16_O_BAR`, :data:`BF16_DKV_BAR` and :data:`BF16_DQ_BAR` bound
what that rounding may move.

``block_q``/``block_k`` are the reference's tile sizes, kept in the
signature so callers port unchanged; results do not depend on them. The
reference clamps them to T and pads T up to a block (falling back to
``blockwise_attention`` for non-causal padded input); here the kernels
tile 64 x 64 themselves and mask their own ragged edge, and the twins
attend densely, so there is nothing to pad and no fallback to take.

``flash_attention.launches``, ``.dq_launches`` and ``.dkv_launches``
count the launches of the three kernels.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    NEG_INF, blockwise_attention, dense_attention)

__all__ = ["flash_attention", "flash_attention_bwd_plain",
           "flash_attention_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The largest head dim the kernels are built for (csrc/flash_common.cuh:
# MAX_HEAD_DIM). The reference takes any; the twins do too, but a CUDA
# tensor with a larger head dim is refused, never sent to a twin.
MAX_HEAD_DIM = 256

# Bars of the bf16 tensor-core kernels against the plain twin's unrounded
# f32 result on the same bf16 inputs.
# Forward O: rounding p_j to bf16 moves each term p_j v_j of the convex
# combination O = sum_j p_j v_j / l by at most 2^-9 p_j |v_j|, so O moves by
# at most 2^-9 max|V| (l is summed from the unrounded P); O's own rounding
# to bf16 adds at most 2^-9 |O|. The bar is twice that sum, element-wise:
# |O - O_f32| <= BF16_O_BAR (max|V| of the kv head + |O_f32|).
BF16_O_BAR = 2.0 ** -8
# dK, dV: rounding Pᵀ and dSᵀ moves each term of the sums over queries by
# at most 2^-9 of its size; the moves are unbiased and independent, so they
# add like a random walk, far below 2^-9 of the sum of the terms' sizes;
# the result's own rounding adds half a step. The bar is one bf16 step at
# the gradient's scale: max|g - g_f32| <= BF16_DKV_BAR max|g_f32|.
BF16_DKV_BAR = 2.0 ** -7
# dQ: rounding dS moves each term dS_ij K_j of the sum over keys by at most
# 2^-9 of its size, unbiased and independent, so the same random walk;
# the result's own rounding adds half a step. The sum over a row's keys
# cancels more than dK's sum over queries does (sum_j dS_ij = 0 in exact
# arithmetic, since delta_i = sum_j P_ij dP_ij), so dQ is smaller against
# its terms; on the adversarial inputs of tests/test_torch_flash_rounding.py
# the emulated kernel still uses at most half of one step at the gradient's
# scale. The bar: max|dq - dq_f32| <= BF16_DQ_BAR max|dq_f32|.
BF16_DQ_BAR = 2.0 ** -7
# A gradient that cancels: where each query sees one key (T 1, window 1) O
# is that key's V, so dP = delta and dS = P∘(dP - delta) is 0 in exact
# arithmetic; dQ and dK are then f32 rounding of the cancelled terms,
# summed in another order by each side, and no bar relative to their own
# size can hold. A gradient whose twin's max abs is at most GRAD_CANCEL of
# the size of its terms (:func:`bwd_term_sizes`) is held instead to
# |g - g_f32| <= GRAD_CANCEL x that size, 2^8 above f32's step; every
# other gradient keeps its bar.
GRAD_CANCEL = 2.0 ** -16


def bf16_o_limit(v, o_f32, kv_group):
    """Element-wise limit of |O - O_f32| for the bf16 forward kernel
    (:data:`BF16_O_BAR`): v [n // kv_group, T, d], o_f32 [n, T, d]."""
    vmax = v.float().abs().amax(dim=(1, 2)).repeat_interleave(kv_group)
    return BF16_O_BAR * (vmax[:, None, None] + o_f32.float().abs())


def _scale(q):
    # 1/sqrt(d) as the reference's forward multiplies by it: a Python
    # scalar is weakly typed in JAX, so it is rounded to q's dtype first
    return float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))


def _bwd_scale(d):
    # the reference's backward multiplies f32 scores by 1/sqrt(d) unrounded
    return 1.0 / math.sqrt(d)


def _keep(t, causal, window, device):
    """[T, T] bool: whether query row i sees key column j."""
    pos = torch.arange(t, device=device)
    keep = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        keep = pos[:, None] >= pos[None, :]
        if window is not None:
            keep &= pos[:, None] - pos[None, :] < window
    return keep


def _plain_forward(q, k, v, *, causal, window, kv_group):
    """Dense masked softmax attention on 3-D [n, T, d] inputs; returns
    (out in f32, lse in f32)."""
    scale = torch.tensor(_scale(q), dtype=q.dtype, device=q.device)
    qs = (q * scale).float()
    kf, vf = k.float(), v.float()
    if kv_group > 1:
        kf = kf.repeat_interleave(kv_group, dim=0)
        vf = vf.repeat_interleave(kv_group, dim=0)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    keep = _keep(q.shape[1], causal, window, q.device)
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full((), -NEG_INF, device=q.device))
    return out, lse


def flash_attention_plain(q, k, v, *, causal=False, window=None,
                          kv_group=1):
    """The forward kernel's plain twin on 3-D inputs: q [n, T, d], k/v
    [n // kv_group, T, d]. Returns (O in q's dtype, lse [n, T] f32)."""
    out, lse = _plain_forward(q, k, v, causal=causal, window=window,
                              kv_group=kv_group)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=False,
                              window=None, kv_group=1):
    """The backward kernels' plain twin, formula by formula the
    reference's ``_flash_bwd``: q/o/do [n, T, d], k/v [n // kv_group, T,
    d], lse [n, T] f32 as the forward returned them. Returns (dq, dk, dv)
    in q/k/v's dtypes; under GQA dk/dv sum each group of kv_group q-heads
    in f32 into their kv head."""
    n, t, d = q.shape
    scale = _bwd_scale(d)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    if kv_group > 1:
        kf = kf.repeat_interleave(kv_group, dim=0)
        vf = vf.repeat_interleave(kv_group, dim=0)
    delta = (gf * o.float()).sum(-1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = _keep(t, causal, window, q.device)
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    if kv_group > 1:
        dk = dk.reshape(n // kv_group, kv_group, t, d).sum(1)
        dv = dv.reshape(n // kv_group, kv_group, t, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_term_sizes(q, k, v, o, lse, do, *, causal=False, window=None,
                   kv_group=1):
    """The plain backward on absolute values: the largest sum of term
    sizes each of dQ, dK and dV takes before anything cancels, with
    ``P (|dO||V|ᵀ + |delta|) scale`` for dS. Returns three floats."""
    n, t, d = q.shape
    scale = _bwd_scale(d)
    kf, vf = (x.float().repeat_interleave(kv_group, dim=0) for x in (k, v))
    ga = do.float().abs()
    delta = (do.float() * o.float()).sum(-1).abs()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    keep = _keep(t, causal, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    ds = p * (torch.matmul(ga, vf.abs().transpose(-1, -2))
              + delta[..., None]) * scale
    dq = torch.matmul(ds, kf.abs())
    dk = torch.matmul(ds.transpose(-1, -2), q.float().abs())
    dv = torch.matmul(p.transpose(-1, -2), ga)
    if kv_group > 1:
        dk = dk.reshape(n // kv_group, kv_group, t, d).sum(1)
        dv = dv.reshape(n // kv_group, kv_group, t, d).sum(1)
    return tuple(x.max().item() for x in (dq, dk, dv))


def _check_kernel_inputs(what, q, k, v, kv_group, *same_as_q):
    """Refuse what the kernels cannot take, before any pointer is passed:
    dtype, devices, contiguity, head dim, and k/v shapes against
    kv_group (a shape that disagrees would read past their ends).
    ``same_as_q`` are further tensors shaped and typed like q."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    if any(x.dtype != q.dtype for x in (k, v, *same_as_q)):
        raise TypeError(f"{what}: input dtypes differ from q's {q.dtype}")
    if any(x.device != q.device for x in (k, v, *same_as_q)):
        raise ValueError(f"{what}: inputs on different devices")
    if not all(x.is_contiguous() for x in (q, k, v, *same_as_q)):
        raise ValueError(f"{what} needs contiguous inputs")
    n, t, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes head dims up to MAX_HEAD_DIM = "
                         f"{MAX_HEAD_DIM}, "
                         f"got {d}")
    if n % kv_group or k.shape != (n // kv_group, t, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{n} // kv_group={kv_group}, {t}, "
                         f"{d}]: k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(x.shape != q.shape for x in same_as_q):
        raise ValueError(f"{what}: O and dO must be shaped like q "
                         f"{tuple(q.shape)}")


def _check_rows(what, q, *rows):
    """lse and delta: contiguous f32 [n, T] on q's device."""
    for x in rows:
        if x.dtype != torch.float32 or x.shape != q.shape[:2] \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{what}: lse/delta must be contiguous f32 "
                             f"{tuple(q.shape[:2])} on {q.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _kernel_forward(q, k, v, *, causal, window, kv_group, with_lse=True):
    """Launch the forward kernel on contiguous 3-D CUDA tensors. Without
    ``with_lse`` the kernel writes no lse and None is returned for it."""
    _check_kernel_inputs("flash_attention kernel", q, k, v, kv_group)
    n, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = getattr(_build.load("flash_attn_fwd"), "flash_attn_fwd")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), n, t, d, kv_group,
                int(causal), 0 if window is None else window, _scale(q),
                _DTYPE_CODES[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def _kernel_dq(q, k, v, do, lse, delta, *, causal, window, kv_group):
    """Launch the dQ kernel; returns dQ in q's dtype."""
    _check_kernel_inputs("flash_attn_dq", q, k, v, kv_group, do)
    _check_rows("flash_attn_dq", q, lse, delta)
    n, t, d = q.shape
    dq = torch.empty_like(q)
    fn = getattr(_build.load("flash_attn_dq"), "flash_attn_dq")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, t, d,
                kv_group, int(causal), 0 if window is None else window,
                _bwd_scale(d), _DTYPE_CODES[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attn_dq launch failed: CUDA error {rc}")
    flash_attention.dq_launches += 1
    return dq


def _kernel_dkv(q, k, v, do, lse, delta, *, causal, window, kv_group):
    """Launch the dK/dV kernel; returns (dK, dV) shaped and typed like
    k/v, each kv head's group of q-heads summed in the kernel."""
    _check_kernel_inputs("flash_attn_dkv", q, k, v, kv_group, do)
    _check_rows("flash_attn_dkv", q, lse, delta)
    n, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = getattr(_build.load("flash_attn_dkv"), "flash_attn_dkv")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), n, t, d, kv_group, int(causal),
                0 if window is None else window, _bwd_scale(d),
                _DTYPE_CODES[q.dtype], _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attn_dkv launch failed: CUDA error {rc}")
    flash_attention.dkv_launches += 1
    return dk, dv


def _kernel_backward(q, k, v, o, lse, do, *, causal, window, kv_group):
    """delta = rowsum(dO∘O) in plain torch (as the reference computes it
    outside its kernels), then the dQ and dK/dV kernels, each of which
    checks its inputs (delta's shape included) before launching."""
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(causal=causal, window=window, kv_group=kv_group)
    dq = _kernel_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = _kernel_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _flash_forward(q, k, v, *, causal, window=None, kv_group=1,
                   with_lse=True):
    """q: [n, T, d]; k/v: [n // kv_group, T, d]. Returns (O, lse). A CPU
    tensor takes the plain twin; a CUDA tensor takes the kernel, which
    writes no lse (None) when ``with_lse`` is False."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_group=kv_group)
    if q.device.type == "cuda":
        return _kernel_forward(q, k, v, causal=causal, window=window,
                               kv_group=kv_group, with_lse=with_lse)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _scan_backward(q, k, v, do, *, causal, window, kv_group, block_k):
    """``DL4J_TORCH_FLASH_BWD=scan``: autograd through the plain forward
    recurrence (dense attention under a window, which the recurrence
    lacks), as the reference's escape hatch differentiates its scan. GQA
    rides ``repeat_interleave``, whose adjoint sums each group."""
    if q.device.type != "cpu":
        raise ValueError(f"DL4J_TORCH_FLASH_BWD=scan runs on the CPU only; "
                         f"{q.device} tensors take the backward kernels")
    with torch.enable_grad():
        a, b, c = (x.detach().requires_grad_() for x in (q, k, v))
        kk, vv = b, c
        if kv_group > 1:
            kk = b.repeat_interleave(kv_group, dim=0)
            vv = c.repeat_interleave(kv_group, dim=0)
        if window is not None:
            out = dense_attention(a, kk, vv, causal=causal, window=window)
        else:
            out = blockwise_attention(a, kk, vv, causal=causal,
                                      block_size=min(block_k,
                                                     max(8, q.shape[1])))
        return torch.autograd.grad(out, (a, b, c), do)


def _flash_backward(q, k, v, o, lse, do, *, causal, window, kv_group,
                    block_k):
    """(dq, dk, dv) of 3-D contiguous inputs: the two backward kernels for
    a CUDA tensor, the plain twin for a CPU tensor, or the ``scan``
    parity route (CPU only) when ``DL4J_TORCH_FLASH_BWD=scan``."""
    kw = dict(causal=causal, window=window, kv_group=kv_group)
    if env_str("DL4J_TORCH_FLASH_BWD") == "scan":
        return _scan_backward(q, k, v, do, block_k=block_k, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type == "cuda":
        return _kernel_backward(q, k, v, o, lse, do, **kw)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp``
    (``_flash_attention_3d`` with ``_flash_fwd``/``_flash_bwd``): the
    forward keeps (q, k, v, O, lse) and the backward recomputes P from
    lse. Inputs are contiguous [n, T, d] / [n // kv_group, T, d]."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_group, block_k):
        out, lse = _flash_forward(q, k, v, causal=causal, window=window,
                                  kv_group=kv_group, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, kv_group, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, kv_group, block_k = ctx.attrs
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do.contiguous(),
                                     causal=causal, window=window,
                                     kv_group=kv_group, block_k=block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=False, block_q=512, block_k=512,
                    window=None):
    """Exact softmax attention. q: [..., T, d].

    k/v may carry fewer heads than q (grouped-query attention): with the
    head axis at -3, q [..., Hq, T, d] against k/v [..., Hkv, T, d] where
    Hq % Hkv == 0; consecutive runs of Hq/Hkv query heads share a K/V
    head. ``window`` (requires causal) limits each query to the last
    ``window`` positions. Differentiable: when a gradient is needed the
    forward also writes lse and the backward runs the dQ and dK/dV
    kernels (their plain twin on the CPU)."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    orig_shape = q.shape
    t = q.shape[-2]
    d = q.shape[-1]
    n_q = math.prod(q.shape[:-2])
    n_kv = math.prod(k.shape[:-2])
    if n_q % n_kv:
        raise ValueError(f"q heads {tuple(q.shape[:-2])} not a multiple of "
                         f"k/v heads {tuple(k.shape[:-2])}")
    kv_group = n_q // n_kv
    if kv_group > 1 and (k.ndim < 3 or q.shape[:-3] != k.shape[:-3]
                         or q.shape[-3] % k.shape[-3]):
        raise ValueError("GQA requires identical batch dims and the head "
                         f"axis at -3: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape or k.shape[-2:] != (t, d):
        raise ValueError(f"k/v must be [..., T={t}, d={d}] alike: k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    # the kernels take contiguous [n, T, d]; the model's heads arrive as
    # transposed views, which this copies (a no-op when already dense);
    # autograd carries the gradient back through the copies
    q3, k3, v3 = (x.reshape(-1, t, d).contiguous() for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (q3, k3, v3)):
        out = _FlashAttention.apply(q3, k3, v3, causal, window, kv_group,
                                    block_k)
    else:
        out, _ = _flash_forward(q3, k3, v3, causal=causal, window=window,
                                kv_group=kv_group, with_lse=False)
    return out.reshape(orig_shape)


flash_attention.launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
