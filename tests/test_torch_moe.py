"""The port's MoETransformerLM against the JAX package's, on the CPU.

Both sides start from one parameter tree (the JAX model's, carried over
by ``params_from_numpy``) and see the same numpy-seeded tokens. Compared,
with the tolerances and their reasons:

- ``moe_ffn_dense`` alone, top-1 and top-2, on numpy inputs: the output
  within 1e-5 of its max abs and the aux term within 1e-6 abs (f32; the
  two frameworks sum the expert products in another order);
- the LM's logits (2 layers, 2 experts top-1 and 4 experts top-2), within
  1e-5 of their max abs, and the routing (the argmax expert of every
  token in every MoE block), equal: the seeds are chosen so that every
  token's gate margin exceeds 1e-3, so a flipped route fails as a flip;
- one AdamW step: the loss (aux included) within 1e-5 abs, the gradients
  (read from the first moment, ``m = (1 - beta1) g``) within 1e-5 of each
  leaf's max abs, and the parameters within 1e-5 abs, except elements
  whose gradient is within 1e-4 of 0 relative to the leaf: AdamW's first
  update is close to ``lr·sign(g)``, so those may move by up to
  ``2·lr·(1.01 + wd·|p|)`` between two correct runs;
- ``eval_loss`` and ``perplexity`` without the aux term, 1e-5 relative;
- remat: the aux crosses ``torch.utils.checkpoint`` as an output, so the
  loss and every gradient equal those without remat within 1e-6 of
  their scale (the recomputed forward runs the same ops);
- the decay mask exempts the expert biases ``W1_b``/``W2_b`` (2-D, named
  ``*_b``), as the reference's ``test_expert_biases_not_decayed`` states;
- ``generate()``, ``beam_search()`` and a ``ContinuousLM`` over the MoE
  LM raise ``NotImplementedError`` with the reference's words, at once.

The port's MoE LM with ``block_size`` takes the LM's flash route (the
kernels' plain twins on the CPU); the reference side runs its dense
attention, which is the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import moe_transformer as jmoe
from deeplearning4j_tpu.models.moe_transformer import (
    MoETransformerConfig as JaxConfig, MoETransformerLM as JaxMoE)
from deeplearning4j_tpu_torch.models import moe_transformer as pmoe
from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM, moe_ffn_dense)
from deeplearning4j_tpu_torch.models.transformer import (
    _decay_mask, _flatten, opt_state_from_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.serving import ContinuousLM

# tools/cross_backend_parity.py's MoE shape, and a 4-expert top-2 copy
SMALL = dict(vocab_size=24, max_len=16, d_model=16, n_heads=2, n_layers=2,
             d_ff=32, n_experts=2, moe_every=2, learning_rate=1e-3, seed=0)
VARIANTS = {"e2_top1": {}, "e4_top2": dict(n_experts=4, router_top_k=2)}
# the port's side of each variant also rides the flash route (twins)
PORT_EXTRA = {"e2_top1": {}, "e4_top2": dict(block_size=8)}
OUT_REL = 1e-5
MARGIN = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _np_tree(tree):
    # copies: the JAX step donates its buffers
    return jax.tree.map(lambda a: np.array(a, np.float32, copy=True), tree)


def assert_one_step_matches(got_params, got_m, got_loss, want_params,
                            want_m, want_loss, lr, wd):
    """A port step against a JAX step from the same state (the module
    docstring's bars). ``*_m`` is the first moment after the step, which
    holds ``(1 - beta1) g`` when the step started from zero moments."""
    assert abs(got_loss - want_loss) <= 1e-5, (got_loss, want_loss)
    got_m, want_m = _flat(got_m), _flat(want_m)
    assert sorted(got_m) == sorted(want_m)
    for k, w in want_m.items():
        err = np.abs(got_m[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (k, err)
    got_p, want_p = _flat(got_params), _flat(want_params)
    bound = 2 * lr * (1.01 + wd * max(np.abs(p).max()
                                      for p in want_p.values()))
    for k, w in want_p.items():
        near_zero = np.abs(want_m[k]) <= 1e-4 * np.abs(want_m[k]).max()
        limit = np.where(near_zero, bound + 1e-5, 1e-5)
        assert (np.abs(got_p[k] - w) <= limit).all(), \
            (k, np.abs(got_p[k] - w).max())


def _tokens(seed, rows=2, t=11):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (rows, t)).astype(np.int32)


def _jax_lm(variant):
    return JaxMoE(JaxConfig(**dict(SMALL, **VARIANTS[variant]))).init()


def _port_lm(variant, jlm, **extra):
    c = MoETransformerConfig(**dict(SMALL, **VARIANTS[variant],
                                    **PORT_EXTRA[variant], **extra))
    lm = MoETransformerLM(c, device="cpu")
    lm.params = params_from_numpy(_np_tree(jlm.params), "cpu")
    return lm


class _Routes:
    """Spy on a package's ``moe_ffn_dense``: every call's argmax expert
    per token and the smallest gap between a token's two largest gate
    logits (the reference tool's routing export)."""

    def __init__(self, module, monkeypatch, to_np):
        self.eid, self.margin = [], np.inf
        real = module.moe_ffn_dense

        def spy(bp, h, n_experts, top_k=1):
            gl = to_np((h @ bp["gate"])).astype(np.float32).reshape(
                -1, n_experts)
            top2 = np.sort(gl, axis=-1)[:, -2:]
            self.margin = min(self.margin, float((top2[:, 1]
                                                  - top2[:, 0]).min()))
            self.eid.append(gl.argmax(-1))
            return real(bp, h, n_experts, top_k)
        monkeypatch.setattr(module, "moe_ffn_dense", spy)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_dense_matches_the_reference(top_k):
    r = np.random.RandomState(3 + top_k)
    B, T, d, h, E = 2, 5, 8, 12, 4
    bp = {"gate": r.randn(d, E).astype(np.float32),
          "W1": (0.3 * r.randn(E, d, h)).astype(np.float32),
          "W1_b": (0.1 * r.randn(E, h)).astype(np.float32),
          "W2": (0.3 * r.randn(E, h, d)).astype(np.float32),
          "W2_b": (0.1 * r.randn(E, d)).astype(np.float32)}
    x = r.randn(B, T, d).astype(np.float32)
    want_y, want_aux = jmoe.moe_ffn_dense(
        {k: jnp.asarray(v) for k, v in bp.items()}, jnp.asarray(x), E, top_k)
    got_y, got_aux = moe_ffn_dense(
        {k: torch.from_numpy(v) for k, v in bp.items()}, torch.from_numpy(x),
        E, top_k)
    want_y = np.asarray(want_y)
    assert np.abs(got_y.numpy() - want_y).max() <= OUT_REL * np.abs(
        want_y).max()
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_routing_and_one_step_match_the_reference(monkeypatch,
                                                         variant):
    jlm = _jax_lm(variant)
    lm = _port_lm(variant, jlm)
    x = _tokens(1)
    want_routes = _Routes(jmoe, monkeypatch, np.asarray)
    want = np.asarray(jlm.output(x))
    got_routes = _Routes(pmoe, monkeypatch, lambda t: t.detach().numpy())
    got = lm.output(x)
    assert want_routes.margin > MARGIN, want_routes.margin
    assert len(got_routes.eid) == len(want_routes.eid) == 1
    for g, w in zip(got_routes.eid, want_routes.eid):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got - want).max() <= OUT_REL * np.abs(want).max()
    monkeypatch.undo()

    toks = _tokens(2, t=12)
    want_loss = float(jlm.fit_batch(toks))
    got_loss = float(lm.fit_batch(toks))
    c = lm.conf
    assert_one_step_matches(lm.params, lm.opt_state["m"], got_loss,
                            _np_tree(jlm.params), _np_tree(jlm.opt_state["m"]),
                            want_loss, c.learning_rate, c.weight_decay)
    assert lm.iteration == int(jlm.iteration) == 1


def test_eval_loss_leaves_out_the_aux_term():
    jlm = _jax_lm("e4_top2")
    lm = _port_lm("e4_top2", jlm, aux_weight=5.0)
    toks = _tokens(4, rows=3, t=13)
    want = jlm.eval_loss(toks)
    got = lm.eval_loss(toks)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert lm.eval_ce(toks) == got
    assert abs(lm.perplexity(toks) - jlm.perplexity(toks)) \
        <= 1e-5 * jlm.perplexity(toks)
    # the training loss carries the (heavily weighted) aux term
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        train = float(lm._loss(lm.params, t[:, :-1], t[:, 1:], None))
        _, aux = lm._logits_aux(lm.params, t[:, :-1])
    assert abs(train - (got + 5.0 * float(aux))) <= 1e-5 * train
    assert float(aux) > 0.0


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_gives_the_loss_and_grads_of_no_remat(dropout):
    kw = dict(SMALL, n_experts=4, moe_every=1, dropout=dropout, seed=5)
    toks = torch.from_numpy(_tokens(6, t=12).astype(np.int64))
    runs = []
    for remat in (False, True):
        lm = MoETransformerLM(MoETransformerConfig(**kw, remat=remat),
                              device="cpu").init()
        rng = torch.Generator().manual_seed(9) if dropout else None
        runs.append(lm._value_and_grad(toks[:, :-1], toks[:, 1:], None,
                                       rng))
    (l0, g0), (l1, g1) = runs
    assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0))
    g0, g1 = _flat(g0), _flat(g1)
    assert sorted(g0) == sorted(g1)
    for k, w in g0.items():
        assert np.abs(g1[k] - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30)
        assert np.abs(w).max() > 0, k


def test_expert_biases_not_decayed():
    lm = MoETransformerLM(MoETransformerConfig(**SMALL), device="cpu").init()
    mask = _flatten(_decay_mask(lm.params))
    assert mask["b1.W1_b"] == mask["b1.W2_b"] == 0.0
    assert mask["b1.W1"] == mask["b1.W2"] == mask["b1.gate"] == 1.0
    assert "b1.fc" not in mask and mask["b0.fc"] == 1.0
    # and in a step from the same state, with and without decay: the
    # (non-zero) expert biases move alike, the expert weights do not
    a = MoETransformerLM(MoETransformerConfig(**dict(
        SMALL, weight_decay=0.5, learning_rate=0.1)), device="cpu").init()
    b = a.clone()
    b.conf = MoETransformerConfig(**dict(SMALL, weight_decay=0.0,
                                         learning_rate=0.1))
    for m in (a, b):
        with torch.no_grad():
            m.params["b1"]["W1_b"].fill_(0.25)
        m.fit_batch(_tokens(7))
    pa, pb = _flat(a.params), _flat(b.params)
    for k in ("b1.W1_b", "b1.W2_b"):
        np.testing.assert_array_equal(pa[k], pb[k])
    for k in ("b1.W1", "b1.W2", "b1.gate"):
        assert not np.array_equal(pa[k], pb[k]), k


def test_init_tree_and_state_carry_across():
    """The port's init has the reference's tree (the MoE block's
    ``gate``/``W1``/``W1_b``/``W2``/``W2_b`` in place of the FFN), and a
    JAX optimizer state carries over by ``opt_state_from_numpy``."""
    jlm = _jax_lm("e4_top2")
    jlm.fit_batch(_tokens(8))
    lm = MoETransformerLM(MoETransformerConfig(**dict(
        SMALL, **VARIANTS["e4_top2"])), device="cpu").init()
    got = {k: v.shape for k, v in _flat(lm.params).items()}
    want = {k: v.shape for k, v in _flat(_np_tree(jlm.params)).items()}
    assert got == want
    w = _flat(lm.params)
    # the gate at scale 0.1, the expert biases 0, as the reference draws
    assert np.abs(w["b1.W1_b"]).max() == 0 and 0.05 < w["b1.gate"].std() < 0.2
    lm.params = params_from_numpy(_np_tree(jlm.params), "cpu")
    lm.opt_state, lm.iteration = opt_state_from_numpy(
        {**_np_tree(jlm.opt_state), "iteration": int(jlm.iteration)}, "cpu")
    toks = _tokens(9)
    want_loss = float(jlm.fit_batch(toks))
    assert abs(float(lm.fit_batch(toks)) - want_loss) <= 1e-5
    assert lm.iteration == 2


def test_generation_and_decoding_raise_at_once():
    lm = MoETransformerLM(MoETransformerConfig(**SMALL), device="cpu").init()
    prompt = _tokens(10, rows=1, t=4)
    jlm = _jax_lm("e2_top1")
    with pytest.raises(NotImplementedError) as want:
        jlm.generate(prompt, 2)
    for call in (lambda: lm.generate(prompt, 2),
                 lambda: lm.beam_search(prompt, 2),
                 lambda: ContinuousLM(lm, slots=2, device="cpu")):
        with pytest.raises(NotImplementedError) as got:
            call()
        assert str(got.value) == str(want.value)
