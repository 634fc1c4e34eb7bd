"""The port's TransformerLM training against the JAX package's.

A JAX ``TransformerLM`` is initialised and takes three ``fit_batch``
steps on numpy-seeded token batches, with its attention on the Pallas
flash kernels (interpret mode) forward and backward. The port starts from
the same parameters (``params_from_numpy``) and takes the same three
steps on the CPU, where attention runs the kernels' plain twins.

Compared, with the tolerances and their reasons:
- the loss of every step. f32: 1e-5 abs (losses near 4; both sides sum
  in another order). bf16 compute: 2e-3 abs (activations rounded to bf16
  at places the two frameworks choose differently).
- the gradients of step 1, each leaf against its own max abs, read from
  the first moment after step 1 (``m = (1 - beta1) g`` from zero). f32:
  1e-5. bf16: 5e-2 (a bf16 step is 2^-7 of a value, and a gradient chains
  several such roundings).
- every parameter after step 3. AdamW's first update is close to
  ``lr·sign(g)``, so an element whose gradient is near 0 may move by
  ``2·lr`` between two correct runs; and every later update is at most
  ``lr·(1.01 + wd·|p|)`` (the bias-corrected ``|m̂|/√v̂`` is below 1.01
  for three steps). f32: 1e-5 abs, except elements whose step-1 gradient
  is within 1e-4 of 0 relative to the leaf, which may differ by that
  bound. bf16: that bound everywhere.
- the EMA after step 3, as the parameters (it mixes them).
- the moments ``m`` and ``v`` after step 3, each leaf against its own
  max abs. f32: 5e-5. bf16: by relative L2 norm per leaf, within 0.15
  (steps 2 and 3 take gradients at parameters that may differ by the
  bound above).
"""

import contextlib
import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import (
    TransformerConfig as JaxConfig, TransformerLM as JaxLM)
from deeplearning4j_tpu_torch.models import transformer as tr
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, opt_state_from_numpy, params_from_numpy)
from deeplearning4j_tpu_torch.ops import flash_attention as port_fa
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener, ScoreIterationListener)

SMALL = dict(vocab_size=64, max_len=32, d_model=32, n_heads=4, n_layers=2,
             d_ff=64, block_size=8, learning_rate=1e-3)
VARIANTS = {
    "learned": dict(),
    "rope_gqa_window": dict(pos_embed="rope", n_kv_heads=2, window=5),
    "dense": dict(block_size=None),
    "bf16": dict(compute_dtype="bfloat16"),
    "options": dict(grad_clip_norm=0.1, label_smoothing=0.1, z_loss=1e-3,
                    ema_decay=0.9, lr_schedule="cosine", warmup_steps=2,
                    total_steps=5),
}
STEPS = 3


def _kw(variant):
    return dict(SMALL, **VARIANTS[variant])


def _batches(variant):
    r = np.random.RandomState(1)
    toks = [r.randint(0, 64, (2, 17)).astype(np.int32) for _ in range(STEPS)]
    mask = (r.rand(2, 16) < 0.7).astype(np.float32) \
        if variant == "options" else None
    return toks, mask


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _np_tree(tree):
    # copies: the JAX step donates its buffers
    return jax.tree.map(lambda a: np.array(a, np.float32, copy=True), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(variant):
    """JAX's three steps: the initial parameters, then per step the loss
    and the state after it (params, opt_state, iteration)."""
    toks, mask = _batches(variant)
    with _env(DL4J_TPU_PALLAS_INTERPRET="1", DL4J_TPU_LM_ATTN="pallas"):
        jlm = JaxLM(JaxConfig(**_kw(variant))).init()
        init = _np_tree(jlm.params)
        losses, states = [], []
        for b in toks:
            losses.append(float(jlm.fit_batch(b, mask=mask)))
            states.append({"params": _np_tree(jlm.params),
                           "opt": _np_tree(jlm.opt_state),
                           "iteration": int(jlm.iteration)})
    return init, losses, states


def _check_run(variant, plm, losses, m1):
    """Hold a port run (model after three steps, its losses, its first
    moment after step 1) against JAX's run of ``variant``."""
    c = plm.conf
    _, want_losses, states = _jax_run(variant)
    bf16 = c.compute_dtype == "bfloat16"
    np.testing.assert_allclose(losses, want_losses, rtol=0,
                               atol=2e-3 if bf16 else 1e-5)
    g1 = _flat(states[0]["opt"]["m"])          # (1 - beta1) g at step 1
    for k, w in g1.items():
        err = np.abs(m1[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= (5e-2 if bf16 else 1e-5), (k, err)
    want_p = _flat(states[-1]["params"])
    bound = 2 * STEPS * c.learning_rate * (
        1.01 + c.weight_decay * max(np.abs(p).max() for p in want_p.values()))
    # the parameters, and their EMA (a convex mix of parameters, so held
    # to the same limits)
    pairs = [(plm.params, states[-1]["params"])]
    if "ema" in states[-1]["opt"]:
        pairs.append((plm.opt_state["ema"], states[-1]["opt"]["ema"]))
    for got, want in pairs:
        got = _flat(got)
        for k, w in _flat(want).items():
            near_zero = np.abs(g1[k]) <= 1e-4 * np.abs(g1[k]).max()
            limit = np.where(near_zero | bf16, bound + 1e-5, 1e-5)
            err = np.abs(got[k] - w)
            assert (err <= limit).all(), (k, err.max())
    assert plm.iteration == states[-1]["iteration"] == STEPS
    for part in ("m", "v"):
        got, want = _flat(plm.opt_state[part]), _flat(states[-1]["opt"][part])
        for k, w in want.items():
            if bf16:
                err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w),
                                                       1e-30)
                assert err <= 0.15, (part, k, err)
            else:
                err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= 5e-5, (part, k, err)


def _port_run(variant, params):
    toks, mask = _batches(variant)
    plm = TransformerLM(TransformerConfig(**_kw(variant)), device="cpu")
    plm.params = params_from_numpy(params, "cpu")
    losses, m1 = [], None
    for i, b in enumerate(toks):
        losses.append(float(plm.fit_batch(b, mask=mask)))
        if i == 0:
            m1 = {k: v.copy() for k, v in _flat(plm.opt_state["m"]).items()}
    return plm, losses, m1


# the port's routes: the flash route (the kernels' plain twins on the
# CPU), and the two CPU parity routes against the same JAX runs
CASES = [
    ("learned", {}), ("rope_gqa_window", {}), ("dense", {}), ("bf16", {}),
    ("options", {}),
    ("learned", {"DL4J_TORCH_LM_ATTN": "scan"}),
    ("learned", {"DL4J_TORCH_FLASH_BWD": "scan"}),
    ("rope_gqa_window", {"DL4J_TORCH_FLASH_BWD": "scan"}),
]


@pytest.mark.parametrize("variant,port_env", CASES,
                         ids=[f"{v}-{'-'.join(e.values()) or 'flash'}"
                              for v, e in CASES])
def test_three_steps_match_jax(monkeypatch, variant, port_env):
    for k, v in port_env.items():
        monkeypatch.setenv(k, v)
    init, _, _ = _jax_run(variant)
    plm, losses, m1 = _port_run(variant, init)
    _check_run(variant, plm, losses, m1)


def test_resume_from_jax_state_matches_jax_continuation():
    """``opt_state_from_numpy`` carries a JAX run after step 1 (moments,
    EMA and the step count, which the warmup/cosine schedule reads) into
    the port, whose steps 2 and 3 then match JAX's."""
    init, want_losses, states = _jax_run("options")
    toks, mask = _batches("options")
    plm = TransformerLM(TransformerConfig(**_kw("options")), device="cpu")
    plm.params = params_from_numpy(states[0]["params"], "cpu")
    plm.opt_state, plm.iteration = opt_state_from_numpy(
        {**states[0]["opt"], "iteration": states[0]["iteration"]}, "cpu")
    assert plm.iteration == 1 and set(plm.opt_state) == {"m", "v", "ema"}
    losses = [float(plm.fit_batch(b, mask=mask)) for b in toks[1:]]
    np.testing.assert_allclose(losses, want_losses[1:], rtol=0, atol=1e-5)
    # from one state, no step-1 sign question: parameters and EMA 1e-5
    # abs, moments 5e-5 of each leaf's max abs
    for part, got, want in (("params", plm.params, states[-1]["params"]),
                            ("ema", plm.opt_state["ema"],
                             states[-1]["opt"]["ema"])):
        for k, w in _flat(want).items():
            err = np.abs(_flat(got)[k] - w).max()
            assert err <= 1e-5, (part, k, err)
    for part in ("m", "v"):
        got = _flat(plm.opt_state[part])
        for k, w in _flat(states[-1]["opt"][part]).items():
            err = np.abs(got[k] - w).max() / np.abs(w).max()
            assert err <= 5e-5, (part, k, err)
    assert plm.iteration == 3


def test_eval_loss_and_perplexity_match_jax():
    init, _, _ = _jax_run("learned")
    toks = np.random.RandomState(3).randint(0, 64, (3, 20)).astype(np.int32)
    with _env(DL4J_TPU_PALLAS_INTERPRET="1", DL4J_TPU_LM_ATTN="pallas"):
        jlm = JaxLM(JaxConfig(**_kw("learned")))
        jlm.params = jax.tree.map(jax.numpy.asarray, init)
        want = jlm.eval_loss(toks)
    plm = TransformerLM(TransformerConfig(**_kw("learned")), device="cpu")
    plm.params = params_from_numpy(init, "cpu")
    assert abs(plm.eval_loss(toks) - want) <= 1e-5
    assert plm.perplexity(toks) == pytest.approx(np.exp(want), rel=1e-5)
    assert plm.iteration == 0   # no update


def _fresh(**kw):
    return TransformerLM(TransformerConfig(**dict(SMALL, **kw)),
                         device="cpu").init()


def _tokens(seed=0, b=2, t=17):
    return np.random.RandomState(seed).randint(0, 64, (b, t)).astype(
        np.int32)


def test_parameters_train_and_every_leaf_moves():
    """Parameters are trainable whether they come from init() or from a
    JAX tree, and one step moves every leaf."""
    lm = _fresh()
    carried = TransformerLM(TransformerConfig(**SMALL), device="cpu")
    carried.params = params_from_numpy(
        {k: v.detach().numpy() if isinstance(v, torch.Tensor) else
         {kk: vv.detach().numpy() for kk, vv in v.items()}
         for k, v in lm.params.items()}, "cpu")
    for model in (lm, carried):
        assert all(p.requires_grad for p in model.parameters())
        before = {k: v.copy() for k, v in _flat(model.params).items()}
        model.fit_batch(_tokens())
        for k, v in _flat(model.params).items():
            assert not np.array_equal(v, before[k]), k


def test_listeners_get_one_call_per_step():
    lm = _fresh()
    scores, lines = CollectScoresIterationListener(), []
    lm.set_listeners(scores, ScoreIterationListener(frequency=2,
                                                    log_fn=lines.append))
    got = [float(lm.fit_batch(_tokens(i))) for i in range(3)]
    assert [it for it, _ in scores.scores] == [1, 2, 3]
    assert [float(s) for _, s in scores.scores] == got
    assert lines == [f"Score at iteration 2 is {got[1]}"]


def test_listeners_log_what_the_reference_logs():
    """The port's listeners against the reference's on the same calls:
    the same lines, with throughputs and ETAs masked (host clock)."""
    from deeplearning4j_tpu.optimize import listeners as jax_listeners
    from deeplearning4j_tpu_torch.optimize import listeners as port_listeners

    class Model:
        score_ = 2.5
        _last_batch_size = 4

    def run(mod):
        out = []
        perf = mod.PerformanceListener(frequency=2, log_fn=out.append)
        lsts = [mod.ScoreIterationListener(frequency=2, log_fn=out.append),
                perf, mod.TimeIterationListener(6, log_fn=out.append,
                                                frequency=3),
                mod.CollectScoresIterationListener(frequency=3)]
        for it in range(1, 7):
            for lst in lsts:
                lst.iteration_done(Model, it)
        masked = [re.sub(r"ETA \d+s", "ETA #s",
                         re.sub(r"[\d.]+ (batches|samples)/sec", r"# \1/sec",
                                s)) for s in out]
        return masked, lsts[-1].scores, perf.last_samples_per_sec > 0

    assert run(port_listeners) == run(jax_listeners)


@pytest.mark.parametrize("shape", [(512, 512, 8, 2048, 32768),
                                   (17, 32, 2, 64, 64)])
def test_flop_accounting_matches_the_reference(shape):
    """``hw.py`` is the port's copy of the reference's MFU accounting."""
    from deeplearning4j_tpu import hw as jax_hw
    from deeplearning4j_tpu_torch import hw
    assert hw.transformer_fwd_flops_per_token(*shape) == \
        jax_hw.transformer_fwd_flops_per_token(*shape)
    assert hw.TRAIN_FLOPS_MULTIPLIER == jax_hw.TRAIN_FLOPS_MULTIPLIER


class _Resettable:
    def __init__(self, batches):
        self.batches, self.resets, self._i = batches, 0, 0

    def reset(self):
        self.resets += 1
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.batches):
            raise StopIteration
        self._i += 1
        return self.batches[self._i - 1]


def test_fit_over_list_iterator_and_generator_with_epochs():
    batches = [_tokens(i) for i in range(3)]
    manual = _fresh()
    for _ in range(2):
        for b in batches:
            manual.fit_batch(b)
    want = _flat(manual.params)
    it = _Resettable(batches)
    for data in (batches, it, (b for b in batches)):
        lm = _fresh().fit(data, epochs=2)
        assert lm.iteration == 6
        for k, v in _flat(lm.params).items():
            np.testing.assert_array_equal(v, want[k])
    assert it.resets == 2
    assert _fresh().fit(batches[0]).iteration == 1


def test_clone_is_independent_and_ema_model_holds_the_average():
    lm = _fresh(ema_decay=0.5)
    p0 = {k: v.copy() for k, v in _flat(lm.params).items()}
    lm.fit_batch(_tokens())
    p1 = {k: v.copy() for k, v in _flat(lm.params).items()}
    twin = lm.clone()
    twin.fit_batch(_tokens(1))
    assert (lm.iteration, twin.iteration) == (1, 2)
    for k, v in _flat(lm.params).items():
        np.testing.assert_array_equal(v, p1[k])
    ema = lm.ema_model()
    for k, v in _flat(ema.params).items():
        np.testing.assert_allclose(v, 0.5 * p0[k] + 0.5 * p1[k], rtol=0,
                                   atol=1e-7)
    assert ema.iteration == 1
    with pytest.raises(ValueError, match="ema_decay"):
        _fresh().ema_model()


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_gives_the_grads_of_no_remat(dropout):
    """``remat`` recomputes each block in the backward. Dropout masks are
    drawn before the blocks, so the recompute applies the same ones and
    the gradients equal those without remat (with dropout on, they also
    differ from the dropout-free gradients)."""
    toks = torch.from_numpy(_tokens(b=3, t=25).astype(np.int64))
    plain = _fresh(dropout=dropout)
    remat = _fresh(dropout=dropout, remat=True)
    remat.params = plain.clone().params

    def grads(lm, seed=5):
        _, g = lm._value_and_grad(toks[:, :-1], toks[:, 1:], None,
                                  torch.Generator().manual_seed(seed))
        return _flat(g)
    want, got = grads(plain), grads(remat)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    if dropout:
        off = _flat(plain._value_and_grad(toks[:, :-1], toks[:, 1:],
                                          None)[1])
        assert not np.allclose(off["b0.qkv"], want["b0.qkv"])


def test_dropout_keep_share_and_scaling():
    """torch's Philox and JAX's threefry draw different masks, so dropout
    is held by distribution: the share kept is 1 - rate within 5 sigma
    on both sides, and a kept value is scaled by 1 / (1 - rate)."""
    rate = 0.25
    lm = _fresh(dropout=rate)
    toks = torch.zeros((4, 128), dtype=torch.int64)
    masks = lm._keep_masks(toks, torch.Generator().manual_seed(0))
    assert len(masks) == SMALL["n_layers"]
    keep = torch.stack([m for pair in masks for m in pair])
    n = keep.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) <= 5 * sigma
    jlm = JaxLM(JaxConfig(**dict(SMALL, dropout=rate)))
    ones = jax.numpy.ones((n,))
    jout = np.asarray(jlm._drop(ones, jax.random.PRNGKey(0)))
    assert abs((jout > 0).mean() - (1 - rate)) <= 5 * sigma
    np.testing.assert_allclose(jout[jout > 0], 1 / (1 - rate), rtol=1e-6)
    x = torch.randn(masks[0][0].shape).to(torch.bfloat16)
    y = lm._drop(x, masks[0][0])
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[~masks[0][0]], torch.zeros_like(y[~masks[0][0]]))
    assert torch.equal(y[masks[0][0]], (x / (1 - rate))[masks[0][0]])


def test_dropout_draws_new_masks_each_step_from_the_seed():
    a, b = _fresh(dropout=0.3, seed=4), _fresh(dropout=0.3, seed=4)
    la = [float(a.fit_batch(_tokens())) for _ in range(2)]
    lb = [float(b.fit_batch(_tokens())) for _ in range(2)]
    assert la == lb                       # seeded: the same run twice
    frozen = _fresh(dropout=0.3, seed=4)
    frozen.conf.dropout = 0.0
    assert float(frozen.fit_batch(_tokens())) != la[0]


def test_flash_route_carries_the_gradient_through_the_kernel_seam(
        monkeypatch):
    """The kernels return tensors with no autograd graph. With graph-less
    stand-ins at the kernel entry points, a call through the model's
    flash route must still give ``qkv`` the scan route's gradient, by
    way of the backward kernels' entry points, never a plain twin."""
    c = TransformerConfig(**SMALL)
    b, t, d, h = 2, 24, SMALL["d_model"], SMALL["n_heads"]
    r = np.random.RandomState(0)
    qkv0 = torch.from_numpy(r.randn(b, t, 3 * d).astype(np.float32))
    cot = torch.from_numpy(r.randn(b, h, t, d // h).astype(np.float32))

    def attend(qkv):
        q, k, v = (x.reshape(b, t, h, d // h).transpose(1, 2)
                   for x in torch.split(qkv, d, dim=-1))
        return (tr._blockwise_route(c, q, k, v) * cot).sum()

    monkeypatch.setenv("DL4J_TORCH_LM_ATTN", "scan")
    qkv = qkv0.clone().requires_grad_()
    want = torch.autograd.grad(attend(qkv), qkv)[0]
    monkeypatch.delenv("DL4J_TORCH_LM_ATTN")

    calls = []
    plain_fwd = port_fa.flash_attention_plain
    plain_bwd = getattr(port_fa, "flash_attention_bwd_plain", None)

    def kernel_forward(q, k, v, *, causal, window=None, kv_group=1,
                       with_lse=True):
        calls.append("fwd")
        with torch.no_grad():   # as the ctypes kernel: no graph
            return plain_fwd(q, k, v, causal=causal, window=window,
                             kv_group=kv_group)

    def kernel_dq(q, k, v, do, lse, delta, **kw):
        calls.append("dq")
        with torch.no_grad():
            o = plain_fwd(q, k, v, **kw)[0]
            return plain_bwd(q, k, v, o, lse, do, **kw)[0]

    def kernel_dkv(q, k, v, do, lse, delta, **kw):
        calls.append("dkv")
        with torch.no_grad():
            o = plain_fwd(q, k, v, **kw)[0]
            return plain_bwd(q, k, v, o, lse, do, **kw)[1:]

    def kernel_route(*args, block_k, **kw):   # CPU tensors, kernel path
        return port_fa._kernel_backward(*args, **kw)

    def twin(*a, **kw):
        raise AssertionError("a plain twin ran on the kernel route")
    monkeypatch.setattr(port_fa, "_flash_forward", kernel_forward)
    monkeypatch.setattr(port_fa, "_kernel_dq", kernel_dq, raising=False)
    monkeypatch.setattr(port_fa, "_kernel_dkv", kernel_dkv, raising=False)
    monkeypatch.setattr(port_fa, "_flash_backward", kernel_route,
                        raising=False)
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(port_fa, name, twin, raising=False)
    qkv = qkv0.clone().requires_grad_()
    got = torch.autograd.grad(attend(qkv), qkv)[0]
    assert calls == ["fwd", "dq", "dkv"]
    assert got.abs().max().item() > 0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
