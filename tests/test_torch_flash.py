"""The port's flash-attention forward against the JAX package's.

The same numpy-seeded inputs go through the reference
(``deeplearning4j_tpu.ops.pallas_kernels.flash_attention`` in Pallas
interpret mode, and the plain ``sequence_parallel`` functions) and
through the port. On the CPU the port's wrapper runs its plain twin;
the CUDA kernel itself is held against that twin by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.

Tolerances: f32 1e-5 abs (the two sides sum in another order; nothing
else differs). bf16 inputs 2e-2 abs (both sides compute in f32 from the
same bf16 values, but O is rounded to bf16, whose step near 1 is 2^-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as jax_pk
from deeplearning4j_tpu.parallel import sequence_parallel as jax_sp
from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.ops.flash_attention import (
    _flash_forward, flash_attention)
from deeplearning4j_tpu_torch.parallel import sequence_parallel as port_sp

F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _inputs(q_shape, kv_shape, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(*q_shape).astype(np.float32),
            r.randn(*kv_shape).astype(np.float32),
            r.randn(*kv_shape).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0)


# (q shape, k/v shape, causal, window, block) — the reference tests'
# cases: multi-head, ragged T=27 both ways (non-causal ragged takes the
# reference's blockwise fallback), GQA both ways, windows incl. 1
FWD_CASES = [
    ((2, 3, 32, 8), (2, 3, 32, 8), False, None, 16),
    ((1, 32, 8), (1, 32, 8), True, None, 8),
    ((1, 27, 8), (1, 27, 8), True, None, 8),
    ((1, 27, 8), (1, 27, 8), False, None, 8),
    ((2, 8, 32, 16), (2, 2, 32, 16), False, None, 16),
    ((2, 8, 32, 16), (2, 2, 32, 16), True, None, 16),
    ((2, 64, 8), (2, 64, 8), True, 1, 16),
    ((2, 64, 8), (2, 64, 8), True, 7, 16),
    ((2, 64, 8), (2, 64, 8), True, 16, 16),
    ((2, 64, 8), (2, 64, 8), True, 40, 16),
    ((2, 64, 8), (2, 64, 8), True, 64, 16),
    ((2, 64, 8), (2, 64, 8), True, 1000, 16),
    ((1, 4, 64, 8), (1, 2, 64, 8), True, 10, 16),
    ((1, 4, 27, 8), (1, 2, 27, 8), True, 5, 8),
]


@pytest.mark.parametrize("qs,ks,causal,window,block", FWD_CASES)
def test_forward_matches_jax_kernel(interpret_pallas, qs, ks, causal,
                                    window, block):
    q, k, v = _inputs(qs, ks)
    want = jax_pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=block, block_k=block,
                                  window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, block_q=block,
                          block_k=block, window=window)
    assert tuple(got.shape) == qs and got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_bf16_inputs_match_jax_kernel(interpret_pallas):
    q, k, v = _inputs((2, 32, 8), (2, 32, 8), seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_pk.flash_attention(jq, jk, jv, causal=True, block_q=16,
                                  block_k=16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16_TOL)


# (n, kv_n, T, d, causal, window, block): T divisible by the block, as
# the reference's _flash_forward requires
LSE_CASES = [
    (3, 3, 32, 8, False, None, 16),
    (3, 3, 32, 8, True, None, 8),
    (4, 2, 64, 8, True, 10, 16),
    (2, 2, 64, 16, True, 1, 16),
]


@pytest.mark.parametrize("n,kv_n,t,d,causal,window,block", LSE_CASES)
def test_lse_matches_jax_flash_forward(interpret_pallas, n, kv_n, t, d,
                                       causal, window, block):
    q, k, v = _inputs((n, t, d), (kv_n, t, d), seed=1)
    want_o, want_lse = jax_pk._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, window=window, kv_group=n // kv_n)
    got_o, got_lse = _flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, kv_group=n // kv_n)
    assert got_lse.shape == (n, t) and got_lse.dtype == torch.float32
    _close(got_o, want_o, F32_TOL)
    _close(got_lse, want_lse, F32_TOL)


def test_row_with_no_key_gets_zero_and_large_lse():
    """The reference gives a row with no unmasked key lse = +1e30 (so a
    backward's exp(s - lse) is an exact 0) and O = 0; the twin holds the
    same contract. No causal row is ever empty, so the test calls the
    twin's core with an empty window mask directly."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 4, 8), (1, 4, 8)))
    out, lse = port_fa._plain_forward(q, k, v, causal=True, window=0,
                                      kv_group=1)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.all(lse == 1e30)


def test_window_one_attends_self_only():
    q, _, v = (torch.from_numpy(a) for a in _inputs((1, 32, 8), (1, 32, 8)))
    out = flash_attention(q, q, v, causal=True, block_q=8, block_k=8,
                          window=1)
    _close(out, v, F32_TOL)


# the reference's error cases (tests/test_pallas.py): the same inputs
# must raise ValueError on both sides, with the same message
ERROR_CASES = [
    ((1, 16, 4), (1, 16, 4), dict(window=4)),
    ((1, 16, 4), (1, 16, 4), dict(causal=True, window=0)),
    ((1, 3, 16, 4), (1, 2, 16, 4), dict(causal=True)),
    ((2, 4, 16, 4), (1, 4, 16, 4), dict(causal=True)),
]


@pytest.mark.parametrize("qs,ks,kw", ERROR_CASES)
def test_invalid_calls_raise_like_jax(interpret_pallas, qs, ks, kw):
    q, k, _ = _inputs(qs, ks)
    with pytest.raises(ValueError) as want:
        jax_pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(k), **kw)
    with pytest.raises(ValueError) as got:
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(k), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_wide_head_dims_match_jax_kernel(interpret_pallas, d, causal):
    """Head dims above 128 (the card's DP 256 instances): the twin against
    the reference, GQA, f32."""
    q, k, v = _inputs((1, 4, 32, d), (1, 2, 32, d), seed=d)
    want = jax_pk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=16,
                                  block_k=16)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, block_q=16,
                          block_k=16)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("d,ok", [(255, True), (256, True), (257, False),
                                  (512, False)])
def test_kernel_boundary_takes_head_dims_up_to_256(d, ok):
    """The kernels' boundary (forward and backward) takes d up to
    MAX_HEAD_DIM = 256 and refuses a larger one with a message naming the
    limit, before any pointer is passed."""
    assert port_fa.MAX_HEAD_DIM == 256
    q = torch.empty((4, 8, d), device="meta")
    k = torch.empty((2, 8, d), device="meta")
    for same_as_q in ((), (q, q)):
        if ok:
            port_fa._check_kernel_inputs("flash_attention kernel", q, k, k,
                                         2, *same_as_q)
        else:
            with pytest.raises(ValueError,
                               match="head dims up to MAX_HEAD_DIM = 256"):
                port_fa._check_kernel_inputs("flash_attention kernel", q, k,
                                             k, 2, *same_as_q)


def test_meta_tensor_never_reaches_the_twin():
    """A tensor that is not on the CPU never takes the plain twin: it
    goes to the kernel (cuda) or raises."""
    q = torch.empty((1, 16, 8), device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q, causal=True)
    assert flash_attention.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_jax(causal, dtype):
    q, k, v = _inputs((2, 2, 24, 8), (2, 2, 24, 8), seed=5)
    want = jax_sp.dense_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                  causal=causal)
    got = port_sp.dense_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=causal)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got.float(), want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("window", [1, 5, 24])
def test_dense_attention_window_matches_jax(window):
    q, k, v = _inputs((2, 24, 8), (2, 24, 8), seed=6)
    want = jax_sp.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window)
    got = port_sp.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window)
    _close(got, want, F32_TOL)


def test_dense_window_requires_causal():
    q = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="window requires causal"):
        port_sp.dense_attention(q, q, q, window=2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", [(32, 8), (27, 8), (20, 32)])
def test_blockwise_attention_matches_jax(causal, t, block):
    q, k, v = _inputs((2, 3, t, 8), (2, 3, t, 8), seed=7)
    want = jax_sp.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      block_size=block)
    got = port_sp.blockwise_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal,
                                      block_size=block)
    _close(got, want, F32_TOL)
