"""Attention: the dense oracle, the blockwise flash recurrence, and ring
and Ulysses sequence parallelism. The port of
``deeplearning4j_tpu/parallel/sequence_parallel.py``.

``dense_attention`` and ``blockwise_attention`` are the single-device
functions the TransformerLM and SelfAttentionLayer's built-in route
reach. Every function takes the reference's ``mask``, a [batch, Tk]
key-validity mask (a key whose entry is 0 gets no weight). Masked scores
are set to ``NEG_INF = -1e30``, never ``-inf``, as in the reference: a
fully masked row then stays finite.

Sequence parallelism runs on a grid of ranks, one process a rank
(``parallel/tensor_parallel.py``): a caller makes the grid with
``tp_mesh(1, N, axis_names=("data", "seq"))`` (every rank of the
process group calls it) and calls inside ``with mesh:``, where
``axis_name="seq"`` names that grid's row, as the reference's name does
inside ``shard_map``:

- :func:`ring_attention` takes this rank's [..., T/N, d] shards of q, k
  and v; K, V and the mask rotate one rank a step around the ring
  (``multihost.exchange``; the rotation's backward sends the gradient
  the other way) while the flash recurrence accumulates, so the result
  is exact softmax attention over the whole sequence. The reference's
  last rotation, which brings each block home unused, is not made;
- :func:`ulysses_attention` reshards [B, T/N, H, D] sequence -> heads
  with one ``all_to_all``, attends densely over the whole sequence for
  H/N heads, and reshards back (each exchange's backward is the inverse
  exchange);
- :func:`sequence_parallel_attention` and :func:`ulysses_attention` are
  the host-level entries: the whole q/k/v on every rank in, this rank's
  sequence rows attended, the whole output on every rank out.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "blockwise_attention", "dense_attention",
           "ring_attention", "sequence_parallel_attention",
           "ulysses_attention"]

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


def _grid(axis_name):
    # imported here: the models import this module, and the grid's module
    # must not come in with them
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        active_axis
    return active_axis(axis_name)


def _shift(x, mesh, axis, shift):
    """Every rank's ``x`` to the rank ``shift`` places on along ``axis``;
    returns the one that arrives from ``shift`` places back."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    mesh.exchange(axis, sends=[(x, (me + shift) % n)],
                  recvs=[(out, (me - shift) % n)])
    return out


class _Rotate(torch.autograd.Function):
    """One step of the ring: the forward hands each rank's block to the
    next rank, the backward hands each gradient back (``ppermute``'s
    transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x.detach(), mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -1), None, None


def ring_attention(q, k, v, *, axis_name, causal=False, mask=None):
    """Exact attention over a sequence sharded on the grid axis
    ``axis_name`` (call inside ``with mesh:``). q/k/v: this rank's
    [..., T/N, d] shards (rank i holds rows i T/N ...); ``mask``: its
    [batch, T/N] key mask, which travels with K and V. Returns this
    rank's rows of softmax(QKᵀ/√d)V."""
    mesh = _grid(axis_name)
    n, my = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    t_local = q.shape[-2]
    ar = torch.arange(t_local, device=q.device)
    q_pos = my * t_local + ar
    batch_shape = q.shape[:-2]
    m = torch.full(batch_shape + (t_local,), NEG_INF, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros(batch_shape + (t_local,), dtype=q.dtype,
                    device=q.device)
    o = torch.zeros_like(q)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    neg = torch.full((), NEG_INF, dtype=q.dtype, device=q.device)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
    for i in range(n):
        src = (my - i) % n          # whose block this rank holds now
        bias = zero.expand(t_local, t_local)
        if causal:
            k_pos = src * t_local + ar
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], zero, neg)
        if mask is not None:
            bias = bias + _key_bias(mask, q)
        m, l, o = _attend_block(q, k, v, bias, m, l, o)
        if i < n - 1:
            k = _Rotate.apply(k, mesh, axis_name)
            v = _Rotate.apply(v, mesh, axis_name)
            if mask is not None:
                mask = _shift(mask, mesh, axis_name, 1)
    return o / torch.clamp(l, min=1e-30)[..., None]


def _rows(x, mesh, axis, dim):
    from deeplearning4j_tpu_torch.parallel.multihost import take_rows
    return take_rows(x, mesh.axis_index(axis), mesh.axis_size(axis),
                     axis=dim % x.ndim)


def sequence_parallel_attention(q, k, v, mesh, *, axis="seq",
                                causal=False):
    """Ring attention from the host: q/k/v [batch, T, d] whole on every
    rank of ``mesh``; this rank attends its T/N query rows by the ring
    and every rank gets the exact dense result, whole."""
    with mesh:
        o = ring_attention(*(_rows(x, mesh, axis, -2) for x in (q, k, v)),
                           axis_name=axis, causal=causal)
    return mesh.all_gather(o, axis, dim=o.ndim - 2)


def ulysses_attention(q, k, v, mesh, *, axis="seq", causal=False):
    """DeepSpeed-Ulysses context parallelism, the all-to-all counterpart
    of the ring: q/k/v [batch, T, H, D] whole on every rank of ``mesh``;
    this rank's T/N rows go sequence -> heads by one ``all_to_all``
    (each rank then holds the whole sequence for H/N heads), dense
    attention runs locally, and heads -> sequence brings the rows back;
    the whole output on every rank. H and T must divide by the axis."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import all_to_all
    n = mesh.axis_size(axis)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the '{axis}' "
            f"axis ({n}); use ring attention for head counts that don't")
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ulysses needs sequence length ({q.shape[1]}) divisible by "
            f"the '{axis}' axis ({n}); pad the sequence or use blockwise "
            f"attention")
    # local [B, T/N, H, D] -> [B, T, H/N, D]
    qh, kh, vh = (all_to_all(_rows(x, mesh, axis, 1), mesh, axis, 2, 1)
                  for x in (q, k, v))
    oh = dense_attention(qh.transpose(1, 2), kh.transpose(1, 2),
                         vh.transpose(1, 2), causal=causal).transpose(1, 2)
    o = all_to_all(oh, mesh, axis, 1, 2)     # heads -> sequence
    return mesh.all_gather(o, axis, dim=1)
