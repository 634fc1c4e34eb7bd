"""The port's flash-attention backward against the JAX package's.

The same numpy-seeded q, k, v and cotangent go through ``jax.vjp`` of the
reference's ``flash_attention`` (its Pallas dQ and dK/dV kernels, in
interpret mode) and through ``torch.autograd.grad`` of the port's
``flash_attention`` on the CPU, where the backward is the kernels' plain
twin ``flash_attention_bwd_plain``. The CUDA kernels themselves are held
against that twin by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
on the card.

Tolerances:
- f32: 1e-5 of each gradient's max abs (or of 1, the size of the unit
  normal inputs, where a gradient cancels to rounding noise). Both sides
  run the same formulas in f32 in another summation order; measured
  spread is under 1e-6 of it.
- bf16: one bf16 step at the gradient's scale, 2^-7 max|g|. Both sides
  compute in f32 from the same bf16 inputs and round the result once,
  but each side's forward rounds O to bf16, and O enters
  ``delta = rowsum(dO∘O)``, so a one-step difference in O moves dQ by
  a fraction of a step. Under GQA the reference also rounds each q-head's
  dK/dV to bf16 before the group sum (the port sums in f32 and rounds
  once): half a step of each head's term, 2^-8 Σ_h |dK_h| element by
  element, is added for dK and dV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_plain)

F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _inputs(q_shape, kv_shape, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(*q_shape).astype(np.float32),
            r.randn(*kv_shape).astype(np.float32),
            r.randn(*kv_shape).astype(np.float32),
            r.randn(*q_shape).astype(np.float32))


def _jax_grads(q, k, v, cot, dtype, **kw):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    @jax.jit
    def grads(a, b, c, g):
        _, vjp = jax.vjp(lambda a, b, c: jax_pk.flash_attention(a, b, c,
                                                                **kw),
                         a, b, c)
        return vjp(g)
    out = grads(*(jnp.asarray(x, jd) for x in (q, k, v, cot)))
    return [np.asarray(g, np.float32) for g in out]


def _port_grads(q, k, v, cot, dtype, **kw):
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(cot).to(td))
    assert all(g.dtype == td for g in grads)
    return [g.float().numpy() for g in grads]


def _head_terms(q, k, v, cot, causal, window):
    """Σ over each kv head's q-heads of |that head's f32 dK|, |dV|: the
    size of the terms the reference rounds to bf16 one by one."""
    def heads(x):
        return torch.from_numpy(x).to(torch.bfloat16).reshape(
            -1, *x.shape[-2:])
    tq, tk, tv, tg = heads(q), heads(k), heads(v), heads(cot)
    g = tq.shape[0] // tk.shape[0]
    kw = dict(causal=causal, window=window, kv_group=g)
    o, lse = flash_attention_plain(tq, tk, tv, **kw)
    kr, vr = (x.float().repeat_interleave(g, dim=0) for x in (tk, tv))
    _, dk, dv = flash_attention_bwd_plain(
        tq.float(), kr, vr, o.float(), lse, tg.float(), causal=causal,
        window=window)
    return [x.abs().reshape(-1, g, *x.shape[1:]).sum(1).reshape(k.shape)
            .numpy() for x in (dk, dv)]


# (q shape, k/v shape, causal, window, block_q, block_k, dtype): the
# reference tests' multi-block, rectangular-block, ragged and GQA cases
# (tests/test_pallas.py), plus T = 333, d 64 and bf16
CASES = [
    ((2, 64, 16), (2, 64, 16), False, None, 16, 16, "float32"),
    ((2, 64, 16), (2, 64, 16), True, None, 16, 16, "float32"),
    ((1, 64, 8), (1, 64, 8), True, None, 32, 16, "float32"),
    ((1, 27, 8), (1, 27, 8), True, None, 8, 8, "float32"),
    ((1, 27, 8), (1, 27, 8), False, None, 8, 8, "float32"),
    ((1, 64, 8), (1, 64, 8), True, 1, 16, 16, "float32"),
    ((1, 64, 8), (1, 64, 8), True, 5, 16, 16, "float32"),
    ((1, 4, 64, 8), (1, 2, 64, 8), True, None, 16, 16, "float32"),
    ((2, 8, 32, 16), (2, 2, 32, 16), False, None, 16, 16, "float32"),
    ((1, 4, 27, 16), (1, 1, 27, 16), True, 5, 8, 8, "float32"),
    ((2, 333, 64), (2, 333, 64), True, None, 64, 64, "float32"),
    ((1, 32, 8), (1, 32, 8), True, None, 16, 16, "bfloat16"),
    ((2, 27, 16), (2, 27, 16), True, 5, 8, 8, "bfloat16"),
    ((1, 4, 333, 64), (1, 2, 333, 64), True, None, 64, 64, "bfloat16"),
    ((1, 4, 64, 16), (1, 1, 64, 16), True, 1, 16, 16, "bfloat16"),
]


@pytest.mark.parametrize("qs,ks,causal,window,bq,bk,dtype", CASES)
def test_grads_match_jax_pallas_backward(interpret_pallas, qs, ks, causal,
                                         window, bq, bk, dtype):
    q, k, v, cot = _inputs(qs, ks)
    kw = dict(causal=causal, block_q=bq, block_k=bk, window=window)
    want = _jax_grads(q, k, v, cot, dtype, **kw)
    got = _port_grads(q, k, v, cot, dtype, **kw)
    gqa = qs[-3] != ks[-3] if len(qs) > 3 else False
    terms = _head_terms(q, k, v, cot, causal, window) \
        if dtype == "bfloat16" and gqa else [None, None]
    for name, g, w, term in zip("qkv", got, want, [None, *terms]):
        assert g.shape == w.shape and np.isfinite(g).all(), f"d{name}"
        # inputs are unit normals, so gradient terms are O(1); under
        # window 1 (P = 1, dS = 0 in real arithmetic) dQ cancels to
        # rounding noise, so the scale never drops below 1
        scale = max(np.abs(w).max(), 1.0)
        if dtype == "float32":
            limit = F32_TOL * scale
        else:
            limit = BF16_STEP * scale + (0 if term is None
                                         else 2.0 ** -8 * term)
        err = np.abs(g - w)
        assert (err <= limit).all(), \
            f"d{name}: max err {err.max()} (scale {scale})"


@pytest.mark.parametrize("causal,window,kv_group", [
    (False, None, 1), (True, None, 1), (True, 3, 1), (True, None, 2),
    (True, 4, 4)])
def test_plain_backward_equals_autograd_of_the_plain_forward(causal, window,
                                                             kv_group):
    """Two independent derivations of one gradient: the hand-written
    plain backward, and autograd through the dense plain forward."""
    n, t, d = 4, 29, 16
    q, k, v, cot = _inputs((n, t, d), (n // kv_group, t, d), seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = dict(causal=causal, window=window, kv_group=kv_group)
    out, _ = port_fa._plain_forward(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    o, lse = flash_attention_plain(*(x.detach() for x in (tq, tk, tv)), **kw)
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o,
                                    lse, torch.from_numpy(cot), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= F32_TOL * w.abs().max().item()


def test_fully_masked_row_gives_zero_not_nan():
    """A row with no visible key has lse = +1e30, so P = exp(S - lse) is
    an exact 0: its dQ is 0 and it adds nothing to dK/dV. No causal row
    is ever empty, so the plain functions get an empty window mask."""
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs((2, 6, 8),
                                                         (2, 6, 8)))
    o, lse = port_fa._plain_forward(q, k, v, causal=True, window=0,
                                    kv_group=1)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, cot, causal=True,
                                           window=0)
    for g in (dq, dk, dv):
        assert torch.equal(g, torch.zeros_like(g))


@pytest.mark.parametrize("window", [None, 5])
def test_scan_backward_matches_jax_pallas_backward(interpret_pallas,
                                                   monkeypatch, window):
    """``DL4J_TORCH_FLASH_BWD=scan`` (autograd through the plain forward
    recurrence, or dense attention under a window) gives the reference
    kernels' gradients, GQA included."""
    q, k, v, cot = _inputs((1, 4, 27, 8), (1, 2, 27, 8), seed=5)
    kw = dict(causal=True, block_q=8, block_k=8, window=window)
    want = _jax_grads(q, k, v, cot, "float32", **kw)

    def no_plain(*a, **k):
        raise AssertionError("the scan route ran the plain backward")
    monkeypatch.setattr(port_fa, "flash_attention_bwd_plain", no_plain)
    monkeypatch.setenv("DL4J_TORCH_FLASH_BWD", "scan")
    got = _port_grads(q, k, v, cot, "float32", **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_TOL * np.abs(w).max())


def test_no_gradient_needed_runs_no_backward_and_skips_lse(monkeypatch):
    """Without a gradient to compute, the wrapper bypasses the autograd
    Function and asks the forward for no lse, as serving does."""
    seen = []
    real = port_fa._flash_forward

    def spy(*a, **kw):
        seen.append(kw["with_lse"])
        return real(*a, **kw)
    monkeypatch.setattr(port_fa, "_flash_forward", spy)
    q = torch.randn(2, 16, 8, requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    out = flash_attention(q.detach(), q.detach(), q.detach(), causal=True)
    assert out.grad_fn is None
    out = flash_attention(q, q, q, causal=True)
    assert out.grad_fn is not None
    assert seen == [False, False, True]
