"""Plain attention: the dense oracle and the blockwise flash recurrence.

The JAX module of the same name also carries ring and Ulysses sequence
parallelism; this port carries only the two single-device functions the
TransformerLM serving path and SelfAttentionLayer's built-in route
reach. Both take the reference's ``mask``, a [batch, Tk] key-validity
mask (a key whose entry is 0 gets no weight). Masked scores are set to
``NEG_INF = -1e30``, never ``-inf``, as in the reference: a fully masked
row then stays finite.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "blockwise_attention", "dense_attention"]

NEG_INF = -1e30


def _sqrt_d(q):
    # the reference divides by sqrt(d) cast to q's dtype
    return torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype,
                        device=q.device)


def _attend_block(q, k, v, bias, m_prev, l_prev, o_prev):
    """One flash-attention accumulation step. q: [..., Tq, d]; k/v:
    [..., Tk, d]; bias broadcastable to [..., Tq, Tk]; carries m (running
    max, [..., Tq]), l (running sum) and o (unnormalised output)."""
    s = torch.einsum("...qd,...kd->...qk", q, k) / _sqrt_d(q)
    s = s + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # a row that has seen nothing keeps m at NEG_INF; exp(NEG_INF - NEG_INF)
    # would be 1, so the correction is clamped to 0 until a real score lands
    correction = torch.exp(torch.where(m_prev == NEG_INF,
                                       torch.full_like(m_prev, NEG_INF),
                                       m_prev - m_new))
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * correction + p.sum(dim=-1)
    o_new = o_prev * correction[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v)
    return m_new, l_new, o_new


def _key_bias(mask, q):
    """[batch, Tk] key mask -> additive bias broadcastable to q's scores
    (0 where the key counts, NEG_INF where it does not)."""
    mask = torch.as_tensor(mask, device=q.device)
    bias = torch.where(mask > 0, torch.zeros((), dtype=q.dtype,
                                             device=q.device),
                       torch.full((), NEG_INF, dtype=q.dtype,
                                  device=q.device))
    return bias[:, None, :] if q.ndim == 3 else bias[:, None, None, :]


def blockwise_attention(q, k, v, *, causal=False, block_size=128,
                        mask=None):
    """Exact attention by the flash recurrence over K/V blocks of
    ``block_size`` (a Python loop where the reference scans).

    q/k/v: [batch, T, d] or [batch, heads, T, d]; ``mask``: [batch, Tk]
    key-validity mask. Returns softmax(QKᵀ/√d)V with O(T·block) score
    memory."""
    tq = q.shape[-2]
    tk = k.shape[-2]
    pad = (-tk) % block_size
    n_blocks = (tk + pad) // block_size
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        if pad:   # padded keys are masked, as the reference pads its mask
            mask = torch.nn.functional.pad(mask, (0, pad))
    q_pos = torch.arange(tq, device=q.device)
    batch_shape = q.shape[:-2]
    m = torch.full(batch_shape + (tq,), NEG_INF, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros(batch_shape + (tq,), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    for bi in range(n_blocks):
        lo = bi * block_size
        kblk = k[..., lo:lo + block_size, :]
        vblk = v[..., lo:lo + block_size, :]
        if kblk.shape[-2] < block_size:   # ragged last block: zero keys
            widths = [0, 0, 0, block_size - kblk.shape[-2]]
            kblk = torch.nn.functional.pad(kblk, widths)
            vblk = torch.nn.functional.pad(vblk, widths)
        k_pos = lo + torch.arange(block_size, device=q.device)
        keep = (k_pos < tk)[None, :].expand(tq, block_size)
        if causal:
            keep = keep & (q_pos[:, None] >= k_pos[None, :])
        bias = torch.where(keep, torch.zeros((), dtype=q.dtype,
                                             device=q.device),
                           torch.full((), NEG_INF, dtype=q.dtype,
                                      device=q.device))
        if mask is not None:
            bias = bias + _key_bias(mask[:, lo:lo + block_size], q)
        m, l, o = _attend_block(q, kblk, vblk, bias, m, l, o)
    return o / torch.clamp(l, min=1e-30)[..., None]


def dense_attention(q, k, v, *, causal=False, mask=None, window=None):
    """Reference O(T²) attention (test oracle). ``mask``: [batch, Tk]
    key-validity mask. ``window`` (requires causal): each query sees only
    the last ``window`` positions."""
    s = torch.einsum("...qd,...kd->...qk", q, k) / _sqrt_d(q)
    tq, tk = s.shape[-2], s.shape[-1]
    if causal:
        ones = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
        cm = torch.tril(ones)
        if window is not None:
            cm &= ~torch.tril(ones, -int(window))
        s = torch.where(cm, s, torch.full((), NEG_INF, dtype=s.dtype,
                                          device=s.device))
    elif window is not None:
        raise ValueError("window requires causal=True")
    if mask is not None:
        mm = torch.as_tensor(mask, device=q.device)
        mm = mm[:, None, :] if q.ndim == 3 else mm[:, None, None, :]
        s = torch.where(mm > 0, s, torch.full((), NEG_INF, dtype=s.dtype,
                                              device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v)
