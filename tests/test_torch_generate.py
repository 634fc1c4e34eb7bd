"""The port's generation against the JAX package's, on carried weights.

At the reference's ``small_lm`` sizes (``tests/test_serving.py``: V 50,
d 16, L 2, H 2, max_len 64), for learned and rope positions and GQA
(``n_kv_heads`` 1), both models hold one parameter tree drawn from a
numpy seed (wider than ``init()``'s 0.02, so greedy rows do not sit on
near-ties): the one-token step (scalar and per-row positions), the
top-k/nucleus filters, greedy ``generate()`` and ``beam_search()``, the
repetition penalty, the continuous-batching decode chunk and the prefill
program from one decode state crossed over from JAX
(``decode_state_from_numpy``), and sampled decode tokens with the
reference's own Gumbel draws injected. ``generate()``'s sampler (its own
counter-based noise) is held to the softmax by a chi-square test.

Tolerance: logits, K/V caches and prefill pages 1e-5 relative to the
tensor's scale (its largest magnitude, at least 1): the two sides sum
matmuls and softmaxes in another order; tokens and filter masks
exactly. bf16 compute: 2e-2 (bf16's step near 1 is 2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deeplearning4j_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, decode_state_from_numpy, gumbel_noise,
    params_from_numpy, prefill_record)

RTOL = 1e-5
BF16_TOL = 2e-2
SMALL_LM = dict(vocab_size=50, max_len=64, d_model=16, n_heads=2,
                n_layers=2, d_ff=32)
VARIANTS = {"learned": {}, "rope": dict(pos_embed="rope"),
            "gqa": dict(n_kv_heads=1)}


def _tree(jlm, seed):
    """A parameter tree of the reference's shapes drawn from a numpy
    seed: weights N(0, 0.3), LayerNorm gains 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name.endswith("_g"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jlm.params)


def _pair(variant="learned", seed=0, **extra):
    kw = dict(SMALL_LM, **VARIANTS[variant], **extra)
    jlm = JaxLM(JaxConfig(**kw)).init()
    tree = _tree(jlm, seed)
    jlm.params = jax.tree.map(jnp.asarray, tree)
    plm = TransformerLM(TransformerConfig(**kw), device="cpu")
    plm.params = params_from_numpy(tree, "cpu")
    return jlm, plm


def _close(got, want, rtol=RTOL):
    """The largest difference within ``rtol`` of the tensor's scale (its
    largest magnitude, at least 1)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, (err, scale)


def _prompts(b, p, seed=0):
    return np.random.default_rng(seed).integers(1, 50, (b, p)).astype(
        np.int32)


@pytest.mark.parametrize("vector_pos", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_token_step_logits_and_caches_match_jax(variant, vector_pos):
    jlm, plm = _pair(variant)
    c = plm.conf
    B, T, hd = 3, 24, c.d_model // c.n_heads
    rng = np.random.default_rng(1)
    shape = (B, c.kv_heads, T, hd)
    ks = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(c.n_layers)]
    vs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(c.n_layers)]
    tok = rng.integers(0, 50, B).astype(np.int32)
    if vector_pos:
        # the last row sits past the cache's end: it writes nothing
        pos = np.array([3, 17, T + 2], np.int32)
        write = np.array([True, True, True])
        jargs = (jnp.asarray(pos),)
        jkw = dict(write=jnp.asarray(write))
        pargs = (torch.tensor(pos, dtype=torch.int64),)
        pkw = dict(write=torch.tensor(write))
    else:
        pos = 11
        jargs = pargs = (pos,)
        jkw = pkw = {}
    jstep = jlm._make_token_step(B, T, vector_pos=vector_pos)
    jl, jk, jv = jstep(jlm.params, jnp.asarray(tok), *jargs,
                       [jnp.asarray(a) for a in ks],
                       [jnp.asarray(a) for a in vs], **jkw)
    pk = [torch.tensor(a) for a in ks]
    pv = [torch.tensor(a) for a in vs]
    pstep = plm._make_token_step(B, T, vector_pos=vector_pos)
    with torch.no_grad():
        pl = pstep(plm._step_params(plm.params),
                   torch.tensor(tok, dtype=torch.int64), *pargs, pk, pv,
                   **pkw)
    assert pl.dtype == torch.float32 and pl.shape == (B, 50)
    _close(pl, jl)
    for a, b in zip(pk + pv, list(jk) + list(jv)):
        _close(a, b)


def test_bf16_step_keeps_a_bf16_cache():
    jlm, plm = _pair("rope", compute_dtype="bfloat16")
    assert plm._cache_dtype() == torch.bfloat16
    S = 2
    jstate = jlm._init_decode_state(S)
    state = plm._init_decode_state(S)
    assert all(b.dtype == torch.bfloat16 for b in state["k"] + state["v"])
    B, T = 2, 16
    tok = np.array([3, 9], np.int32)
    jk = [jnp.zeros((B, 2, T, 8), jnp.bfloat16)] * 2
    pk = [torch.zeros((B, 2, T, 8), dtype=torch.bfloat16) for _ in range(2)]
    pv = [torch.zeros((B, 2, T, 8), dtype=torch.bfloat16) for _ in range(2)]
    jl, jkc, _ = jlm._make_token_step(B, T)(jlm.params, jnp.asarray(tok), 0,
                                          jk, jk)
    with torch.no_grad():
        pl = plm._make_token_step(B, T)(plm._step_params(plm.params),
                                        torch.tensor(tok), 0, pk, pv)
    assert pl.dtype == torch.float32
    _close(pl, jl, rtol=BF16_TOL)
    _close(pk[0].float(), np.asarray(jkc[0], np.float32), rtol=BF16_TOL)
    assert jstate["k"][0].dtype == jnp.bfloat16


def _tied_logits(rng, rows, V):
    """Logits with ties: rounded to 0.5, so equal values share ranks."""
    return np.round(2 * rng.standard_normal((rows, V))).astype(
        np.float32) / 2


def test_filter_masks_match_jax_ties_included():
    rng = np.random.default_rng(2)
    logits = _tied_logits(rng, 6, 50)
    for top_k, top_p in ((None, None), (1, None), (5, None), (7, 0.8),
                         (None, 0.5), (None, 0.93), (50, 1.0), (3, 1e-9)):
        want = np.asarray(JaxLM._filter_logits(jnp.asarray(logits), top_k,
                                               top_p))
        got = TransformerLM._filter_logits(torch.tensor(logits), top_k,
                                           top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)],
                                      want[~np.isinf(want)])
    ks = np.array([1, 5, 50, 12, 3, 50], np.int32)
    ps = np.array([1.0, 0.7, 0.35, 1.0, 0.9, 1e-9], np.float32)
    want = np.asarray(JaxLM._filter_logits_rows(
        jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ps)))
    got = TransformerLM._filter_logits_rows(
        torch.tensor(logits), torch.tensor(ks, dtype=torch.int64),
        torch.tensor(ps)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    # without ties (the per-row top-k keeps k ranks, the scalar one every
    # tie of the k-th value) the per-row form is the scalar filter row for
    # row
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    got = TransformerLM._filter_logits_rows(
        torch.tensor(logits), torch.tensor(ks, dtype=torch.int64),
        torch.tensor(ps)).numpy()
    for i in range(6):
        one = TransformerLM._filter_logits(
            torch.tensor(logits[i:i + 1]), int(ks[i]) if ks[i] < 50 else None,
            float(ps[i]) if ps[i] < 1.0 else None).numpy()[0]
        np.testing.assert_array_equal(np.isinf(one), np.isinf(got[i]))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_equals_jax(variant):
    jlm, plm = _pair(variant)
    prompt = _prompts(2, 7)
    want = np.asarray(jlm.generate(prompt, 12, temperature=0.0))
    got = plm.generate(prompt, 12, temperature=0.0)
    assert got.dtype == np.int32 and got.shape == (2, 19)
    np.testing.assert_array_equal(got, want)
    # informative: the rows are not one repeated token
    assert len(set(got[:, 7:].ravel().tolist())) > 2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_beam_search_equals_jax(variant):
    jlm, plm = _pair(variant, seed=1)
    prompt = _prompts(2, 5, seed=1)
    want = np.asarray(jlm.beam_search(prompt, 8, beams=3))
    got = plm.beam_search(prompt, 8, beams=3)
    np.testing.assert_array_equal(got, want)


def test_repetition_penalty_equals_jax():
    jlm, plm = _pair("learned", seed=2)
    prompt = _prompts(2, 6, seed=2)
    plain = plm.generate(prompt, 16, temperature=0.0)
    want = np.asarray(jlm.generate(prompt, 16, temperature=0.0,
                                   repetition_penalty=1.8))
    got = plm.generate(prompt, 16, temperature=0.0, repetition_penalty=1.8)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, plain)   # the penalty took effect


def test_generate_validation():
    _, plm = _pair()
    p = _prompts(1, 4)
    for kw in (dict(top_k=0), dict(top_k=51), dict(top_p=0.0),
               dict(top_p=1.5), dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError):
            plm.generate(p, 4, **kw)
    with pytest.raises(ValueError, match="max_len"):
        plm.generate(_prompts(1, 60), 8)
    with pytest.raises(ValueError, match="beams"):
        plm.beam_search(p, 4, beams=51)


def test_gen_cache_bounded_by_knob(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_SERVE_GEN_CACHE", "2")
    _, plm = _pair()
    for p_len in (3, 4, 5):
        plm.generate(_prompts(1, p_len), 3, temperature=0.0)
    assert list(plm._jit_gen) == [("sample", 1, 4, 3, 0.0, None, None,
                                   None),
                                  ("sample", 1, 5, 3, 0.0, None, None,
                                   None)]
    plm.beam_search(_prompts(1, 3), 3, beams=2)
    assert len(plm._jit_gen) == 2
    assert plm._gen_signature("beam", 1, 3, 3, 2) in plm._jit_gen


def _jax_decode_state(jlm, S, rows, seed=5):
    """A JAX decode state with ``rows`` admitted: (slot, prompt, n_new,
    temperature, top_k, top_p, seed)."""
    c = jlm.conf
    state = jlm._init_decode_state(S, seed)
    admit = jlm._build_admit(S)
    for slot, prompt, n_new, temp, k, p, rs in rows:
        row = np.zeros(c.max_len, np.int32)
        row[:len(prompt)] = prompt
        state = admit(state, np.int32(slot), row, np.int32(len(prompt)),
                      np.int32(n_new), np.float32(temp), np.int32(k),
                      np.float32(p), np.bool_(True), np.int32(rs))
    return state


def _port_state(jstate):
    return decode_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _hold_states(state, jstate):
    js = jax.tree.map(np.asarray, jstate)
    for a, b in zip(state["k"] + state["v"], js["k"] + js["v"]):
        _close(a, b)
    for k in ("pos", "last", "out", "active", "plen", "nnew"):
        np.testing.assert_array_equal(state[k].numpy(), js[k], err_msg=k)


@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_chunk_from_crossed_state_matches_jax(variant, W):
    jlm, plm = _pair(variant, seed=3)
    S, chunk = 3, 4
    rows = [(0, [5, 9, 2], 6, 0.0, 50, 1.0, 0),
            (2, [7, 1, 4, 4, 8], 9, 0.0, 50, 1.0, 0)]
    jstate = _jax_decode_state(jlm, S, rows)
    state = _port_state(jstate)
    jstep = jlm._build_decode_step(S, chunk, W)
    step = plm._build_decode_step(S, chunk, W, "greedy")
    for _ in range(3):    # the prompt, then sampled tokens fed back
        jstate = jstep(jlm.params, jstate)
        with torch.no_grad():
            step(plm.params, state)
        _hold_states(state, jstate)
    assert state["out"][0, :6].ne(0).any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_pages_from_crossed_state_match_jax(variant):
    jlm, plm = _pair(variant, seed=4)
    c = plm.conf
    S, W = 2, 16
    prompt = _prompts(1, 30, seed=4)[0]
    jstate = _jax_decode_state(jlm, S, [(1, prompt, 4, 0.0, 50, 1.0, 0)])
    state = _port_state(jstate)
    jpf = jlm._build_prefill(S, W)
    pf = plm._build_prefill(S, W, False)
    hd = c.d_model // c.n_heads
    shape = (c.n_layers, c.kv_heads, W, hd)
    zeros = jnp.zeros(shape, jnp.float32)
    pages = [torch.zeros(shape) for _ in range(4)]
    for start, n, final in ((0, 16, False), (16, 13, True)):
        toks = np.zeros(W, np.int32)
        toks[:n] = prompt[start:start + n]
        jstate, jk, jv = jpf(jlm.params, jstate, np.int32(1), toks,
                             np.int32(start), np.int32(n), np.bool_(final),
                             np.bool_(False), zeros, zeros)
        stage = torch.tensor(prefill_record(1, prompt[start:start + n],
                                            start, n, final, W))
        with torch.no_grad():
            pf(plm.params, state, stage, *pages)
        _close(pages[2], jk)
        _close(pages[3], jv)
        _hold_states(state, jstate)
    assert bool(state["active"][1]) and int(state["pos"][1]) == 29
    # the inject variant writes given pages where the compute one
    # computed them: the same row
    fresh = _port_state(_jax_decode_state(jlm, S, [(1, prompt, 4, 0.0, 50,
                                                    1.0, 0)]))
    inj = plm._build_prefill(S, W, True)
    stage = torch.tensor(prefill_record(1, prompt[:16], 0, 16, False, W))
    with torch.no_grad():
        pf(plm.params, fresh, stage, *pages)
        kp, vp = pages[2].clone(), pages[3].clone()
        again = _port_state(_jax_decode_state(jlm, S, [(1, prompt, 4, 0.0,
                                                        50, 1.0, 0)]))
        inj(plm.params, again, stage, kp, vp, *pages[2:])
    for a, b in zip(again["k"] + again["v"], fresh["k"] + fresh["v"]):
        assert torch.equal(a, b)


def _jax_noise(base, seeds, pos, vocab):
    """The reference's draws, ``jax.random.gumbel(fold_in(fold_in(
    PRNGKey(base), seed), pos), (V,))`` a row, for injection."""
    key = jax.random.PRNGKey(int(base))
    rows = [jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(key, int(s)), int(p)), (vocab,))
        for s, p in zip(seeds.tolist(), pos.tolist())]
    return torch.tensor(np.stack([np.asarray(r) for r in rows]))


@pytest.mark.parametrize("variant", ["learned", "gqa"])
def test_sampled_decode_equals_jax_under_injected_noise(variant,
                                                        monkeypatch):
    jlm, plm = _pair(variant, seed=5)
    monkeypatch.setattr(plm, "_gumbel", _jax_noise)
    S, chunk, W = 4, 4, 64
    rows = [(0, [5, 9, 2], 10, 1.0, 50, 1.0, 11),     # sampled
            (1, [7, 1, 4], 10, 0.7, 5, 0.9, 12),      # filtered
            (2, [3, 3], 10, 0.0, 50, 1.0, 0),         # greedy
            (3, [8, 2, 6, 1], 10, 1.3, 50, 0.6, 13)]  # nucleus
    jstate = _jax_decode_state(jlm, S, rows)
    state = _port_state(jstate)
    jstep = jlm._build_decode_step(S, chunk, W)
    step = plm._build_decode_step(S, chunk, W, "filter")
    for _ in range(3):
        jstate = jstep(jlm.params, jstate)
        with torch.no_grad():
            step(plm.params, state)
    np.testing.assert_array_equal(state["out"].numpy(),
                                  np.asarray(jstate["out"]))
    assert state["out"][0, :9].ne(0).sum() > 3
    # the sample variant (no filter) on unfiltered sampled rows
    jstate = _jax_decode_state(jlm, S, [r for r in rows if r[4] == 50
                                        and r[5] == 1.0])
    state = _port_state(jstate)
    step = plm._build_decode_step(S, chunk, W, "sample")
    for _ in range(3):
        jstate = jstep(jlm.params, jstate)
        with torch.no_grad():
            step(plm.params, state)
    np.testing.assert_array_equal(state["out"].numpy(),
                                  np.asarray(jstate["out"]))


def test_gumbel_noise_is_a_pure_function_of_its_counters():
    base = torch.tensor(7)
    seeds = torch.tensor([1, 1, 2, -3])
    pos = torch.tensor([5, 5, 5, 9])
    a = gumbel_noise(base, seeds, pos, 1000)
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert torch.isfinite(a).all()
    # rows do not depend on their neighbours
    assert torch.equal(gumbel_noise(base, seeds[2:3], pos[2:3], 1000)[0],
                       a[2])
    # Gumbel(0, 1): mean 0.5772, variance pi^2/6
    big = gumbel_noise(base, torch.arange(64), torch.zeros(64,
                                                           dtype=torch.int64),
                       4096).double()
    assert abs(big.mean().item() - 0.5772) < 0.01
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.03


def test_generate_sampling_matches_the_softmax():
    """n_new 1 over 400 rows and 5 seeds: 2,000 draws from the first
    step's tempered, filtered distribution, held to it by chi-square."""
    _, plm = _pair("rope", seed=6)
    prompt = np.repeat(_prompts(1, 5, seed=6), 400, axis=0)
    logits = torch.tensor(plm.output(prompt[:1])[0, -1])
    for temperature, top_k, top_p in ((1.5, None, None), (1.0, 8, 0.9)):
        lg = TransformerLM._filter_logits(logits[None], top_k, top_p)[0]
        probs = torch.softmax(lg / temperature, -1).numpy().astype(
            np.float64)
        draws = np.concatenate([
            plm.generate(prompt, 1, temperature=temperature, seed=s,
                         top_k=top_k, top_p=top_p)[:, -1]
            for s in range(5)])
        counts = np.bincount(draws, minlength=50)
        assert counts[probs == 0].sum() == 0   # filtered tokens never drawn
        keep = probs * len(draws) >= 5          # pool the sparse bins
        f_obs = np.append(counts[keep], counts[~keep].sum())
        f_exp = np.append(probs[keep], probs[~keep].sum()) * len(draws)
        f_obs, f_exp = f_obs[f_exp > 0], f_exp[f_exp > 0]
        f_exp *= f_obs.sum() / f_exp.sum()   # the f32 softmax's rounding
        assert stats.chisquare(f_obs, f_exp).pvalue > 1e-3


def test_new_parameters_rebuild_the_program():
    """A program binds the parameter tree it was built over (on the card
    its graph binds their storage): assigning new parameters builds it
    anew instead of replaying the old tree."""
    jlm, plm = _pair("learned", seed=7)
    prompt = _prompts(1, 6, seed=7)
    first = plm.generate(prompt, 8, temperature=0.0)
    sig = next(iter(plm._jit_gen))
    jlm2, plm2 = _pair("learned", seed=8)
    plm.params = plm2.params
    again = plm.generate(prompt, 8, temperature=0.0)
    assert plm._jit_gen[sig].params is plm.params
    np.testing.assert_array_equal(
        again, np.asarray(jlm2.generate(prompt, 8, temperature=0.0)))
    assert not np.array_equal(first, again)
