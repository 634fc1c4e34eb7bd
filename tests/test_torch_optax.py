"""The port's ``optax:*`` rules (``ops/optax_adapter.py``), written in
torch, against optax itself through the JAX package's adapter.

Mirrors ``tests/test_optax.py``. Tolerances, with their reasons:
- each rule's updates and state against optax over 1 and 5 updates:
  1e-6 of each leaf's max abs (the same f32 formulas; ``b ** count``,
  the square root and lamb's norms are rounded by another library);
- archives: the flat vectors equal bitwise in both directions (the
  optax state's leaves, its int32 count as f32, in ``jax.tree.leaves``
  order), and a resumed port run equals the uninterrupted one bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu.utils import flat_params as jflat
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, updater_state_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as players
from deeplearning4j_tpu_torch.ops import optax_adapter
from deeplearning4j_tpu_torch.ops import updaters as pupd
from deeplearning4j_tpu_torch.utils import flat_params, model_serializer

RULES = ["adam", "adamw", "lion", "lamb", "sgd", "rmsprop"]
REL = 1e-6


def _confs(rule, **kw):
    args = dict(rule=f"optax:{rule}", learning_rate=0.05,
                weight_decay=0.01, **kw)
    return jupd.UpdaterConfig(**args), pupd.UpdaterConfig(**args)


def _tree():
    r = np.random.RandomState(3)
    params = {"W": r.randn(4, 3).astype(np.float32),
              "b": np.zeros(3, np.float32)}      # lamb's zero-norm case
    grads = [{"W": r.randn(4, 3).astype(np.float32),
              "b": r.randn(3).astype(np.float32)} for _ in range(5)]
    grads[1]["b"] = np.zeros(3, np.float32)      # a zero update norm
    return params, grads


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= REL * scale, what


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("rule", RULES)
def test_rule_matches_optax(rule, n):
    """``n`` updates through the reference's ``compute_updates`` (optax)
    and the port's, the parameters moved by each: the updates, the
    parameters and every state leaf in ``jax.tree.leaves`` order."""
    jc, pc = _confs(rule)
    params, grads = _tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jupd.init_state(jc, jp), pupd.init_state(pc, pp)
    for i in range(n):
        jg = {k: jnp.asarray(v) for k, v in grads[i].items()}
        pg = {k: torch.from_numpy(v.copy()) for k, v in grads[i].items()}
        ju, js = jupd.compute_updates(jc, jg, js, i, params=jp)
        pu, ps = pupd.compute_updates(pc, pg, ps, i, params=pp)
        for k in params:
            _close(pu[k].numpy(), ju[k], f"{rule} update {i} {k}")
        jp = {k: jp[k] - ju[k] for k in jp}
        pp = {k: pp[k] - pu[k] for k in pp}
    leaves = jax.tree.leaves(js["optax"])
    assert len(ps["optax"]) == len(leaves)
    for got, want in zip(ps["optax"], leaves):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got.numpy(), want, f"{rule} state")
    for k in params:
        _close(pp[k].numpy(), jp[k], f"{rule} params {k}")


@pytest.mark.parametrize("rule", RULES)
def test_state_leaf_order_is_jax_tree_leaves(rule):
    """The state's leaves, their shapes and dtypes in the order of
    ``jax.tree.leaves`` of the optax state, before any update; so the
    flat updater vector is the reference's."""
    jc, pc = _confs(rule)
    params, _ = _tree()
    js = jupd.init_state(jc, {k: jnp.asarray(v) for k, v in params.items()})
    ps = pupd.init_state(pc, {k: torch.from_numpy(v) for k, v in
                              params.items()})
    want = [(tuple(a.shape), str(a.dtype)) for a in
            jax.tree.leaves(js["optax"])]
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in ps["optax"]]
    assert got == want


def test_clipping_composes_with_a_rule():
    """Gradient normalization applies before the rule, as in the
    reference."""
    jc, pc = _confs("adamw", gradient_normalization="clipl2perlayer",
                    gradient_normalization_threshold=0.5)
    params, grads = _tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    ju, _ = jupd.compute_updates(jc, {k: jnp.asarray(v) for k, v in
                                      grads[0].items()},
                                 jupd.init_state(jc, jp), 0, params=jp)
    pu, _ = pupd.compute_updates(pc, {k: torch.from_numpy(v) for k, v in
                                      grads[0].items()},
                                 pupd.init_state(pc, pp), 0, params=pp)
    for k in params:
        _close(pu[k].numpy(), ju[k], k)
    plain, _ = pupd.compute_updates(
        _confs("adamw")[1], {k: torch.from_numpy(v) for k, v in
                             grads[0].items()},
        pupd.init_state(pc, pp), 0, params=pp)
    assert not torch.equal(plain["W"], pu["W"])


def test_registered_factory_wins_and_unknown_names_raise():
    called = {}

    def factory(conf):
        called["lr"] = conf.learning_rate
        return optax_adapter.Transformation(
            lambda params: [],
            lambda grads, state, params: (
                {k: -conf.learning_rate * g for k, g in grads.items()},
                state))
    optax_adapter.register_optax("adam", factory)
    try:
        conf = pupd.UpdaterConfig(rule="optax:adam", learning_rate=0.25)
        assert pupd.init_state(conf, {"W": torch.zeros(2)}) == {"optax": []}
        upd, _ = pupd.compute_updates(conf, {"W": torch.ones(2)},
                                      {"optax": []}, 0,
                                      params={"W": torch.zeros(2)})
        assert called["lr"] == 0.25
        assert torch.equal(upd["W"], torch.full((2,), 0.25))
    finally:
        optax_adapter._REGISTRY.pop("adam", None)
    with pytest.raises(ValueError, match="doesnotexist") as err:
        pupd.init_state(pupd.UpdaterConfig(rule="optax:doesnotexist"),
                        {"W": torch.zeros(2)})
    assert "ROADMAP" in str(err.value) and "lamb" in str(err.value)


# ---------------------------------------------------------------------------
# a net under optax:adamw: training, archives both ways, resume
# ---------------------------------------------------------------------------
def _conf(builder, layers, rule="optax:adamw"):
    return (builder.seed(4).learning_rate(0.01).updater(rule).list()
            .layer(layers.DenseLayer(n_in=8, n_out=16, activation="relu"))
            # a layer without parameters still keeps an optax step count
            .layer(layers.ActivationLayer(activation="tanh"))
            .layer(layers.DenseLayer(n_in=16, n_out=8, activation="tanh"))
            .layer(layers.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss="mcxent"))
            .build())


def _data(seed, n=32):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8).astype(np.float32)
    w = r.randn(8, 3).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[np.argmax(x @ w, 1)]


@pytest.mark.parametrize("rule", RULES)
def test_net_matches_the_jax_net(rule):
    """Five ``fit_batch`` steps of a net under each rule against the JAX
    net from the same parameters."""
    jnet = JNet(_conf(JBuilder.Builder(), jlayers, f"optax:{rule}")).init()
    pnet = MultiLayerNetwork(_conf(NeuralNetConfiguration.Builder(),
                                   players, f"optax:{rule}"),
                             device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    s0 = None
    for i in range(5):
        x, y = _data(i)
        jnet.fit_batch(x, y)
        s = float(pnet.fit_batch(x, y))
        s0 = s if s0 is None else s0
    want = np.asarray(jnet.params())
    assert np.abs(pnet.params() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(
        flat_params.updater_state_to_vector_np(pnet.layers,
                                               pnet.updater_states),
        np.asarray(jflat.updater_state_to_vector_np(jnet.layers,
                                                    jnet.updater_states)),
        rtol=1e-5, atol=1e-6)


def test_adamw_archives_cross_both_ways(tmp_path):
    jnet = JNet(_conf(JBuilder.Builder(), jlayers)).init()
    for i in range(3):
        jnet.fit_batch(*_data(i))
    jpath = str(tmp_path / "jax.zip")
    jser.write_model(jnet, jpath)
    pnet = model_serializer.restore_model(jpath, device="cpu")
    np.testing.assert_array_equal(
        flat_params.updater_state_to_vector_np(pnet.layers,
                                               pnet.updater_states),
        np.asarray(jflat.updater_state_to_vector_np(jnet.layers,
                                                    jnet.updater_states)))
    assert pnet.updater_states[0]["optax"][0].dtype == torch.int32
    assert int(pnet.updater_states[0]["optax"][0]) == 3
    ppath = str(tmp_path / "port.zip")
    model_serializer.write_model(pnet, ppath)
    back = jser.restore_model(ppath)
    np.testing.assert_array_equal(
        np.asarray(jflat.updater_state_to_vector_np(back.layers,
                                                    back.updater_states)),
        np.asarray(jflat.updater_state_to_vector_np(jnet.layers,
                                                    jnet.updater_states)))
    # the numpy crossing keeps the count's dtype too
    again = updater_state_from_numpy(
        [{"optax": jax.tree.leaves(s["optax"])} for s in
         jnet.updater_states], device="cpu")
    assert again[0]["optax"][0].dtype == torch.int32


def test_adamw_resume_mid_fit_is_bitwise(tmp_path):
    """An archive written mid-fit resumes to the uninterrupted run's
    parameters and optax state, bitwise."""
    def net():
        return MultiLayerNetwork(_conf(NeuralNetConfiguration.Builder(),
                                       players), device="cpu").init()
    full, part = net(), net()
    for i in range(3):
        full.fit(DataSet(*_data(i)))
        part.fit(DataSet(*_data(i)))
    path = str(tmp_path / "mid.zip")
    model_serializer.write_model(part, path)
    resumed = model_serializer.restore_model(path, device="cpu")
    for i in range(3, 6):
        full.fit(DataSet(*_data(i)))
        resumed.fit(DataSet(*_data(i)))
    np.testing.assert_array_equal(resumed.params(), full.params())
    np.testing.assert_array_equal(
        flat_params.updater_state_to_vector_np(resumed.layers,
                                               resumed.updater_states),
        flat_params.updater_state_to_vector_np(full.layers,
                                               full.updater_states))
