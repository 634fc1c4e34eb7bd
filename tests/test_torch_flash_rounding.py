"""The bars of the bf16 tensor-core flash kernels, derived and held on the
CPU.

On the card the bf16 forward rounds P to bf16 before ``P·V``, the dK/dV
pass rounds ``Pᵀ`` and ``dSᵀ`` to bf16 before ``Pᵀ·dO`` and ``dSᵀ·Q``, and
the dQ pass rounds ``dS`` to bf16 before ``dS·K``; the reference (and the
port's plain twins) multiply them in f32. This file repeats those
kernels' arithmetic in plain torch, tile by tile as the kernels walk it
(64-key tiles, an online softmax whose row sum is taken from the
unrounded P, padded rows and keys masked to exact zeros), and holds the
result against the twin's unrounded f32 result on adversarial inputs:
one-key rows, window 1, GQA, fully masked padded rows, rows with no
visible key, a large-|V| outlier. It shows that the bars of
``ops/flash_attention.py`` (``BF16_O_BAR``, ``BF16_DKV_BAR``,
``BF16_DQ_BAR``) hold with margin, and that the element-wise
one-bf16-step bar the CUDA-core kernels met does not. The JAX package's
Pallas forward in bf16 (interpret mode) sits within the same O bar of the
same twin, so the bar is one the reference meets too, not one tuned to
the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.ops.flash_attention import (
    BF16_DKV_BAR, BF16_DQ_BAR, GRAD_CANCEL, NEG_INF, bf16_o_limit, bwd_term_sizes,
    flash_attention_bwd_plain)

TILE = 64          # the kernels' query and key tiles
MARGIN = 0.75      # the largest share of a bar a case may use
F32_TOL = 1e-5


def _round(x):
    return x.to(torch.bfloat16).float()


def _padded_keep(t, causal, window):
    """[Tp, Tp] visibility over T padded up to a whole tile: rows and keys
    past T see nothing, as the kernels mask them."""
    tp = max(TILE, -(-t // TILE) * TILE)
    keep = port_fa._keep(tp, causal, window, "cpu")
    inside = torch.arange(tp) < t
    return keep & inside[:, None] & inside[None, :], tp


def _pad(x, tp):
    return torch.nn.functional.pad(x, (0, 0, 0, tp - x.shape[1]))


def emulate_forward(q, k, v, *, causal, window, kv_group, round_p=True):
    """The bf16 forward kernel's arithmetic: q scaled in bf16, S in f32,
    an online softmax over 64-key tiles, P rounded to bf16 (``round_p``)
    before P·V, l from the unrounded P. Returns (O in q's dtype, lse)."""
    n, t, d = q.shape
    keep, tp = _padded_keep(t, causal, window)
    scale = torch.tensor(port_fa._scale(q), dtype=q.dtype)
    qs = _pad((q * scale).float(), tp)
    kf = _pad(k.float(), tp).repeat_interleave(kv_group, dim=0)
    vf = _pad(v.float(), tp).repeat_interleave(kv_group, dim=0)
    m = torch.full((n, tp), NEG_INF)
    l = torch.zeros((n, tp))
    acc = torch.zeros((n, tp, d))
    for k0 in range(0, tp, TILE):
        kp = keep[:, k0:k0 + TILE]
        s = qs @ kf[:, k0:k0 + TILE].transpose(-1, -2)
        mx = torch.where(kp, s, torch.tensor(NEG_INF)).amax(-1)
        m_new = torch.maximum(m, mx)
        corr = torch.where(m == NEG_INF, torch.tensor(0.0),
                           torch.exp(m - m_new))
        # a masked key adds an exact 0, even where m_new is still NEG_INF
        p = torch.where(kp, torch.exp(s - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * corr + p.sum(-1)
        pv = (_round(p) if round_p else p) @ vf[:, k0:k0 + TILE]
        acc = acc * corr[..., None] + pv
        m = m_new
    den = torch.clamp(l, min=1e-30)
    o = (acc / den[..., None])[:, :t]
    lse = torch.where(l > 0, m + torch.log(den), torch.tensor(-NEG_INF))
    return o.to(q.dtype), lse[:, :t]


def emulate_dkv(q, k, v, o, lse, do, *, causal, window, kv_group,
                round_=True):
    """The bf16 dK/dV kernel's arithmetic: S in f32 times the unrounded
    scale, P = exp(S - lse) with masked entries an exact 0, dS in f32, and
    Pᵀ and dSᵀ rounded to bf16 (``round_``) before their products; each
    group of q-heads summed in f32 and rounded once."""
    n, t, d = q.shape
    keep, tp = _padded_keep(t, causal, window)
    keep = keep[:t, :t]
    scale = 1.0 / math.sqrt(d)
    qf, gf = q.float(), do.float()
    kf = k.float().repeat_interleave(kv_group, dim=0)
    vf = v.float().repeat_interleave(kv_group, dim=0)
    delta = (gf * o.float()).sum(-1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None]) * scale
    if round_:
        p, ds = _round(p), _round(ds)
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ gf
    if kv_group > 1:
        dk = dk.reshape(n // kv_group, kv_group, t, d).sum(1)
        dv = dv.reshape(n // kv_group, kv_group, t, d).sum(1)
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate_dq(q, k, v, o, lse, do, *, causal, window, kv_group,
               round_=True):
    """The bf16 dQ kernel's arithmetic: S in f32 times the unrounded
    scale, P = exp(S - lse) with masked entries an exact 0, dS in f32, and
    dS rounded to bf16 (``round_``) before dS·K; dQ accumulated in f32 and
    rounded once."""
    n, t, d = q.shape
    keep, _ = _padded_keep(t, causal, window)
    keep = keep[:t, :t]
    scale = 1.0 / math.sqrt(d)
    qf, gf = q.float(), do.float()
    kf = k.float().repeat_interleave(kv_group, dim=0)
    vf = v.float().repeat_interleave(kv_group, dim=0)
    delta = (gf * o.float()).sum(-1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None]) * scale
    if round_:
        ds = _round(ds)
    return (ds @ kf).to(q.dtype)


def _inputs(n, kv_n, t, d, seed, std=0.5, outlier=None):
    r = np.random.RandomState(seed)
    q, do = (torch.from_numpy(std * r.randn(n, t, d).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(std * r.randn(kv_n, t, d).astype(np.float32))
            for _ in range(2))
    if outlier is not None:
        v[0, t // 3, d // 2] = outlier
    return tuple(x.to(torch.bfloat16) for x in (q, k, v, do))


# name -> (n, kv_n, T, d, causal, window, std, outlier)
CASES = {
    "plain": (8, 8, 200, 64, True, None, 0.5, None),
    "train_like": (4, 4, 511, 64, True, None, 0.5, None),
    "one_key": (8, 8, 1, 64, True, None, 0.5, None),
    "window1": (8, 8, 130, 32, True, 1, 0.5, None),
    "gqa4_window24": (16, 4, 150, 32, True, 24, 1.0, None),
    "padded_t65": (8, 8, 65, 64, True, None, 1.0, None),
    "d36_noncausal": (8, 8, 100, 36, False, None, 1.0, None),
    "outlier_v": (8, 8, 200, 64, True, None, 0.5, 300.0),
}
# the ordinary cases, where rounding P moves O by more than one bf16 step
# of O itself somewhere (one key, window 1: P is 1 or 0, exact in bf16)
OLD_BAR_FAILS = ["plain", "train_like", "gqa4_window24", "padded_t65",
                 "d36_noncausal", "outlier_v"]


def _forward_case(name):
    n, kv_n, t, d, causal, window, std, outlier = CASES[name]
    q, k, v, do = _inputs(n, kv_n, t, d, seed=len(name), std=std,
                          outlier=outlier)
    kw = dict(causal=causal, window=window, kv_group=n // kv_n)
    o, lse = emulate_forward(q, k, v, **kw)
    want_f32, want_lse = port_fa._plain_forward(q, k, v, **kw)
    return q, k, v, do, o, lse, want_f32, want_lse, kw


def _o_ratios(o, v, want_f32, kv_group):
    """(share of the tensor-core bar used, share of the old element-wise
    one-step bar used against the twin's O rounded to bf16)."""
    err = (o.float() - want_f32).abs()
    new = (err / bf16_o_limit(v, want_f32, kv_group)).max().item()
    rounded = want_f32.to(torch.bfloat16).float()
    old_err = (o.float() - rounded).abs()
    old = (old_err / (1e-5 + 2.0 ** -7 * rounded.abs())).max().item()
    return new, old


@pytest.mark.parametrize("name", list(CASES))
def test_forward_rounding_stays_within_the_bar(name):
    q, k, v, do, o, lse, want_f32, want_lse, kw = _forward_case(name)
    new, _ = _o_ratios(o, v, want_f32, kw["kv_group"])
    assert new <= MARGIN, new
    # lse comes from the unrounded P: it keeps the f32 bar
    assert (lse - want_lse).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("name", OLD_BAR_FAILS)
def test_forward_rounding_breaks_the_one_step_bar(name):
    q, k, v, do, o, lse, want_f32, want_lse, kw = _forward_case(name)
    _, old = _o_ratios(o, v, want_f32, kw["kv_group"])
    assert old > 1.0, old


def _dkv_ratios(name):
    q, k, v, do, o, lse, want_f32, want_lse, kw = _forward_case(name)
    got = emulate_dkv(q, k, v, o, lse, do, **kw)
    _, dk_bf16, dv_bf16 = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    _, dk32, dv32 = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    out = {}
    for gname, g, g32, gb in (("dk", got[0], dk32, dk_bf16),
                              ("dv", got[1], dv32, dv_bf16)):
        scale = g32.abs().max().item()
        new = (g.float() - g32).abs().max().item() / (BF16_DKV_BAR * scale)
        old_limit = 1e-5 * scale + 2.0 ** -7 * gb.float().abs()
        old = ((g.float() - gb.float()).abs() / old_limit).max().item()
        out[gname] = (new, old)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_dkv_rounding_stays_within_the_bar(name):
    for gname, (new, _) in _dkv_ratios(name).items():
        assert new <= MARGIN, (gname, new)


@pytest.mark.parametrize("name", OLD_BAR_FAILS)
def test_dkv_rounding_breaks_the_one_step_bar(name):
    ratios = _dkv_ratios(name)
    assert max(old for _, old in ratios.values()) > 1.0, ratios


def _dq_ratios(name):
    """(share of BF16_DQ_BAR used against the twin's unrounded f32 dQ,
    share of the old element-wise one-step bar used against the twin's
    bf16 dQ) of the emulated tensor-core dQ."""
    q, k, v, do, o, lse, want_f32, want_lse, kw = _forward_case(name)
    got = emulate_dq(q, k, v, o, lse, do, **kw)
    dq_bf16, _, _ = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    dq32, _, _ = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    scale = dq32.abs().max().item()
    new = (got.float() - dq32).abs().max().item() / (BF16_DQ_BAR * scale)
    old_limit = 1e-5 * scale + 2.0 ** -7 * dq_bf16.float().abs()
    old = ((got.float() - dq_bf16.float()).abs() / old_limit).max().item()
    return new, old


# the cases whose dQ is a real gradient (one key, window 1: it cancels to
# f32 rounding and the cancellation rule holds it instead)
DQ_CASES = [name for name in CASES if name not in ("one_key", "window1")]


@pytest.mark.parametrize("name", DQ_CASES)
def test_dq_rounding_stays_within_the_bar(name):
    new, _ = _dq_ratios(name)
    assert new <= MARGIN, new


@pytest.mark.parametrize("name", OLD_BAR_FAILS)
def test_dq_rounding_breaks_the_one_step_bar(name):
    _, old = _dq_ratios(name)
    assert old > 1.0, old


@pytest.mark.parametrize("name", list(CASES))
def test_cancellation_rule_holds_only_where_rows_see_one_key(name):
    """Where every row sees one key (T 1, window 1) dQ and dK cancel to f32
    rounding, far below GRAD_CANCEL of their terms' size, and the emulated
    kernel stays within that; every other gradient of these cases is far
    above it, so the rule never stands in for a gradient's own bar."""
    q, k, v, do, o, lse, _, _, kw = _forward_case(name)
    sizes = bwd_term_sizes(q, k, v, o, lse, do, **kw)
    dk, dv = emulate_dkv(q, k, v, o, lse, do, **kw)
    dq = emulate_dq(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), **kw)
    one_key = name in ("one_key", "window1")
    for gname, got, g32, size in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                     want, sizes):
        scale = g32.abs().max().item()
        cancels = scale <= GRAD_CANCEL * size
        assert cancels == (one_key and gname != "dv"), (gname, scale, size)
        if not cancels:
            assert scale >= 2 ** 8 * GRAD_CANCEL * size, (gname, scale, size)
        else:
            err = (got.float() - g32).abs().max().item()
            assert err <= GRAD_CANCEL * size / 2 ** 4, (gname, err, size)


@pytest.mark.parametrize("name", ["plain", "gqa4_window24", "padded_t65"])
def test_emulation_without_rounding_is_the_twin(name):
    """Without the bf16 rounding the emulations compute the twins' f32
    results (summation order only): what the bars measure is the rounding
    and nothing else."""
    n, kv_n, t, d, causal, window, std, _ = CASES[name]
    q, k, v, do = (x.float() for x in _inputs(n, kv_n, t, d, seed=1,
                                              std=std))
    kw = dict(causal=causal, window=window, kv_group=n // kv_n)
    o, lse = emulate_forward(q, k, v, round_p=False, **kw)
    want_o, want_lse = port_fa._plain_forward(q, k, v, **kw)
    assert (o - want_o).abs().max().item() <= F32_TOL
    assert (lse - want_lse).abs().max().item() <= F32_TOL
    dk, dv = emulate_dkv(q, k, v, o, lse, do, round_=False, **kw)
    dq = emulate_dq(q, k, v, o, lse, do, round_=False, **kw)
    want_dq, want_dk, want_dv = flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do, **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert (got - want).abs().max().item() <= \
            F32_TOL * want.abs().max().item()


def test_rows_with_no_visible_key_stay_exact_zeros():
    """An empty window (called on the emulation directly: no public call
    makes one) leaves every row without a key: O = 0 and lse = +1e30
    exactly, and the backward's P = exp(s - 1e30) is an exact 0, so dQ, dK
    and dV are exact zeros, through the bf16 rounding."""
    q, k, v, do = _inputs(4, 4, 70, 16, seed=9)
    kw = dict(causal=True, window=0, kv_group=1)
    o, lse = emulate_forward(q, k, v, **kw)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.all(lse == -NEG_INF)
    dk, dv = emulate_dkv(q, k, v, o, lse, do, **kw)
    dq = emulate_dq(q, k, v, o, lse, do, **kw)
    assert torch.equal(dq, torch.zeros_like(dq))
    assert torch.equal(dk, torch.zeros_like(dk))
    assert torch.equal(dv, torch.zeros_like(dv))


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


# (n, kv_n, T, d, causal, window, block, outlier): T divisible by the
# block, as the reference's kernel requires
PALLAS_CASES = [
    (4, 4, 64, 16, True, None, 16, None),
    (4, 2, 64, 8, True, 10, 16, None),
    (2, 2, 32, 16, False, None, 16, None),
    (2, 2, 64, 16, True, None, 16, 300.0),
]


@pytest.mark.parametrize("n,kv_n,t,d,causal,window,block,outlier",
                         PALLAS_CASES)
def test_pallas_bf16_forward_meets_the_same_bar(interpret_pallas, n, kv_n, t,
                                                d, causal, window, block,
                                                outlier):
    q, k, v, _ = _inputs(n, kv_n, t, d, seed=t + d, std=1.0,
                         outlier=outlier)
    kw = dict(causal=causal, window=window, kv_group=n // kv_n)
    want_f32, want_lse = port_fa._plain_forward(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    jo, jlse = jax_pk._flash_forward(jq, jk, jv, causal=causal,
                                     block_q=block, block_k=block,
                                     window=window, kv_group=n // kv_n)
    jo = torch.from_numpy(np.asarray(jo, np.float32))
    err = (jo - want_f32).abs()
    limit = bf16_o_limit(v, want_f32, n // kv_n)
    assert (err / limit).max().item() <= MARGIN
    # and the emulated tensor-core kernel on the same inputs
    o, _ = emulate_forward(q, k, v, **kw)
    assert ((o.float() - want_f32).abs() / limit).max().item() <= MARGIN
    assert np.abs(np.asarray(jlse) - want_lse.numpy()).max() <= F32_TOL
