"""The port's MultiLayerNetwork path against the JAX package's.

One ``MultiLayerConfiguration`` JSON builds both nets; the port takes the
JAX net's initial parameters (``params_from_numpy``) and both train on the
same numpy batches. On the CPU the port's LSTM cells run the kernels'
plain twins behind the same autograd Function a CUDA tensor takes; the
JAX side runs its default LSTM route.

Tolerances, with their reasons:
- parts (activations, losses, updater steps, lr schedules): 1e-6 of the
  value's scale (elementwise f32, the same formulas);
- training: parameters and updater state within 1e-5 of each leaf's max
  abs after every compared step (summation order only). The char-RNN
  trains at lr 0.01: rmsprop divides by sqrt(r + 1e-8), so an element
  whose gradient is near 0 moves by up to lr·1e4 times its gradient, and
  at the zoo's lr 0.1 a 1e-8 difference in a gradient (summation order)
  already moves a parameter by 1e-5;
- scores 1e-5 relative; outputs 1e-6 abs (probabilities);
- the NaN guard: bitwise (both runs are the port, on the same CPU ops).
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import (
    GravesBidirectionalLSTM as JBiLSTM, RnnOutputLayer as JRnnOut)
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.ops import schedules as jsched
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy, updater_state_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.ops import activations as pact
from deeplearning4j_tpu_torch.ops import lstm_cell as plc
from deeplearning4j_tpu_torch.ops import losses as ploss
from deeplearning4j_tpu_torch.ops import schedules as psched
from deeplearning4j_tpu_torch.ops import updaters as pupd
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)
from deeplearning4j_tpu_torch.testing import faults

V, HID, B, T, SEG = 16, 24, 4, 30, 10
LR = 0.01


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.array(tree)


def _charrnn_pair(seed=12345):
    jconf = jzoo.char_rnn(vocab_size=V, hidden=HID, tbptt_length=SEG,
                          learning_rate=LR, seed=seed)
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    return jnet, pnet


def _char_batches(n, t=T, seed=0):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = r.randint(0, V, (B, t + 1))
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _assert_trees_close(got, want, rtol=1e-5, what=""):
    got, want = _np_tree(got), _np_tree(want)
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], rtol, f"{what}.{k}")
            continue
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max()
        assert err <= rtol * scale, (f"{what}.{k}", err, scale)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build", ["char_rnn", "mlp_mnist"])
def test_one_json_builds_both_nets(build):
    jconf = getattr(jzoo, build)()
    pconf = getattr(zoo, build)()
    assert pconf.to_json() == jconf.to_json()
    again = MultiLayerConfiguration.from_json(jconf.to_json())
    assert again.to_json() == jconf.to_json()
    assert [type(l).__name__ for l in again.layers] == \
        [type(l).__name__ for l in jconf.layers]
    assert again.layers[0].param_shapes() == jconf.layers[0].param_shapes()


def test_reference_autoencoder_json_builds_a_port_net():
    """The reference's AutoEncoder JSON builds a port net (the pretrain
    layers are ported; this test asserted their refusal before)."""
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.layers.pretrain import AutoEncoder as JAE
    jconf = (JBuilder.Builder().list()
             .layer(JAE(n_in=10, n_out=4))
             .layer(JOut(n_out=3, activation="softmax", loss="mcxent"))
             .build())
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert pconf.to_json() == jconf.to_json()
    assert type(pconf.layers[0]).__name__ == "AutoEncoder"
    net = MultiLayerNetwork(pconf, device="cpu").init()
    assert net.num_params() == JNet(jconf).init().num_params()
    assert net.output(np.zeros((2, 10), np.float32)).shape == (2, 3)


def test_builder_cascade_and_auto_preprocessors_match_jax():
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, GravesLSTM,
                                                    RnnOutputLayer)

    def build(b, lstm, dense, out):
        return (b.seed(3).learning_rate(0.05).updater("adam").l2(1e-3)
                .regularization(True).dropout(0.8).list()
                .layer(lstm(n_in=5, n_out=7, activation="tanh"))
                .layer(dense(n_out=4, activation="relu"))
                .layer(out(n_out=3, activation="softmax", loss="mcxent"))
                .build())
    from deeplearning4j_tpu.nn.layers import GravesLSTM as JGraves
    j = build(JBuilder.Builder(), JGraves, JDense, JRnnOut)
    p = build(NeuralNetConfiguration.Builder(), GravesLSTM, DenseLayer,
              RnnOutputLayer)
    assert p.to_json() == j.to_json()
    assert sorted(p.input_preprocessors) == sorted(j.input_preprocessors)


# ---------------------------------------------------------------------------
# parts: activations, losses, updaters, schedules
# ---------------------------------------------------------------------------
def test_activation_registry_matches_jax():
    assert pact.names() == jact.names()


@pytest.mark.parametrize("name", jact.names())
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 97, dtype=np.float32).reshape(1, 97)
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = pact.get(name)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


_LOSS_ACT = {"mcxent": "softmax", "categorical_crossentropy": "softmax",
             "negativeloglikelihood": "softmax", "sparse_mcxent": "softmax",
             "xent": "sigmoid", "binary_crossentropy": "sigmoid",
             "kl_divergence": "softmax",
             "reconstruction_crossentropy": "softmax",
             "poisson": "softplus"}


def test_loss_registry_matches_jax():
    assert ploss.names() == jloss.names()


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", jloss.names())
def test_loss_matches_jax(name, masked):
    """Per-example scores ([B, T, C] time series: summed over time and
    classes) and compute_score, with a [B, T] label mask."""
    r = np.random.RandomState(11)
    act = _LOSS_ACT.get(name, "identity")
    preout = r.randn(3, 5, 4).astype(np.float32)
    if name == "sparse_mcxent":
        labels = r.randint(0, 4, (3, 5)).astype(np.float32)
    elif act in ("softmax",):
        labels = np.eye(4, dtype=np.float32)[r.randint(0, 4, (3, 5))]
    elif act == "sigmoid":
        labels = (r.rand(3, 5, 4) > 0.5).astype(np.float32)
    else:
        labels = r.rand(3, 5, 4).astype(np.float32) + 0.1
    mask = (r.rand(3, 5) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jloss.get(name)(jnp.asarray(labels),
                                      jnp.asarray(preout), act, jm))
    got = ploss.get(name)(torch.from_numpy(labels), torch.from_numpy(preout),
                          act, pm).numpy()
    assert got.shape == want.shape == (3,)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    ws = float(jloss.compute_score(name, jnp.asarray(labels),
                                   jnp.asarray(preout), act, jm))
    ps = float(ploss.compute_score(name, torch.from_numpy(labels),
                                   torch.from_numpy(preout), act, pm))
    assert abs(ps - ws) <= 1e-5 * max(1.0, abs(ws))


_RULES = ["sgd", "nesterovs", "rmsprop", "adagrad", "adadelta", "adam",
          "adamax", "none"]
_NORMS = [None, "renormalizel2perlayer", "renormalizel2perparamtype",
          "clipelementwiseabsolutevalue", "clipl2perlayer",
          "clipl2perparamtype"]


@pytest.mark.parametrize("norm", _NORMS)
@pytest.mark.parametrize("rule", _RULES)
def test_updater_step_matches_jax(rule, norm):
    """One ``compute_updates`` step from a non-zero state at iteration 3,
    with a bias learning rate, for every rule and gradient
    normalization."""
    r = np.random.RandomState(5)
    shapes = {"W": (4, 3), "b": (3,)}
    grads = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    conf_kw = dict(rule=rule, learning_rate=0.05, bias_learning_rate=0.02,
                   gradient_normalization=norm,
                   gradient_normalization_threshold=0.5)
    jc, pc = jupd.UpdaterConfig(**conf_kw), pupd.UpdaterConfig(**conf_kw)
    jstate = jupd.init_state(jc, {k: jnp.asarray(v)
                                  for k, v in params.items()})
    state = jax.tree.map(
        lambda z: jnp.asarray(np.abs(r.randn(*z.shape)).astype(np.float32)),
        jstate)
    want_u, want_s = jupd.compute_updates(
        jc, {k: jnp.asarray(v) for k, v in grads.items()}, state, 3,
        params={k: jnp.asarray(v) for k, v in params.items()})
    pstate = {key: {k: torch.from_numpy(np.array(v)) for k, v in sub.items()}
              for key, sub in state.items()}
    got_u, got_s = pupd.compute_updates(
        pc, {k: torch.from_numpy(v) for k, v in grads.items()}, pstate,
        torch.tensor(3, dtype=torch.int32),
        params={k: torch.from_numpy(v) for k, v in params.items()})
    _assert_trees_close(got_u, want_u, 1e-6, f"{rule} updates")
    _assert_trees_close(got_s, want_s, 1e-6, f"{rule} state")
    assert set(pupd.init_state(pc, {k: torch.zeros(s)
                                    for k, s in shapes.items()})) == \
        set(jstate)


def test_optax_rules_raise_and_name_the_roadmap():
    """The six optax rules are ported; a name outside them (and outside
    ``register_optax``) raises, naming the six rules and ROADMAP.md."""
    conf = pupd.UpdaterConfig(rule="optax:adamw")
    state = pupd.init_state(conf, {"W": torch.zeros(2)})
    assert set(state) == {"optax"} and len(state["optax"]) == 3
    with pytest.raises(ValueError, match="ROADMAP"):
        pupd.init_state(pupd.UpdaterConfig(rule="optax:adafactor"),
                        {"W": torch.zeros(2)})


@pytest.mark.parametrize("policy", ["none", "exponential", "inverse", "step",
                                    "torch_step", "poly", "sigmoid",
                                    "schedule"])
def test_lr_schedule_matches_jax(policy):
    kw = dict(decay_rate=0.9, steps=4.0, power=2.0, max_iterations=50,
              schedule={0: 0.1, 5: 0.05, 12: 0.01})
    for it in (0, 1, 4, 7, 12, 30):
        want = float(jsched.learning_rate(policy, 0.1, it, **kw))
        got = float(psched.learning_rate(policy, 0.1,
                                         torch.tensor(it), **kw))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (policy, it)


def test_l1_l2_score_matches_jax():
    r = np.random.RandomState(2)
    p = {"W": r.randn(3, 4).astype(np.float32),
         "b": r.randn(4).astype(np.float32)}
    kw = dict(l1=0.01, l2=0.02, l1_bias=0.003, l2_bias=0.004)
    want = float(jupd.l1_l2_score({k: jnp.asarray(v) for k, v in p.items()},
                                  **kw))
    got = float(pupd.l1_l2_score({k: torch.from_numpy(v)
                                  for k, v in p.items()}, **kw))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# training the char-RNN (tBPTT) against JAX
# ---------------------------------------------------------------------------
def test_charrnn_three_tbptt_fit_batches_match_jax():
    """3 ``fit_batch`` calls of T 30 = 9 tBPTT windows of 10 from the same
    parameters: scores, parameters and rmsprop state after every call."""
    jnet, pnet = _charrnn_pair()
    for x, y in _char_batches(3):
        ws = float(jnet.fit_batch(x, y))
        ps = float(pnet.fit_batch(x, y))
        assert abs(ps - ws) <= 1e-5 * abs(ws)
        for i in range(len(jnet.layers)):
            _assert_trees_close(pnet.params_list[i], jnet.params_list[i],
                                what=f"params[{i}]")
            _assert_trees_close(pnet.updater_states[i],
                                jnet.updater_states[i],
                                what=f"rmsprop[{i}]")
    assert pnet.iteration == jnet.iteration == 9
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               atol=1e-5 * np.abs(jnet.params()).max())


def test_charrnn_inference_matches_jax():
    """After training: score, output, feed_forward, stepwise
    rnn_time_step (equal to the whole-sequence output) and evaluate."""
    jnet, pnet = _charrnn_pair()
    for x, y in _char_batches(2):
        jnet.fit_batch(x, y)
        pnet.fit_batch(x, y)
    (x, y), = _char_batches(1, t=12, seed=3)
    ws = jnet.score(JDataSet(x, y))
    ps = pnet.score(DataSet(x, y))
    assert abs(ps - ws) <= 1e-5 * abs(ws)
    want = np.asarray(jnet.output(x))
    got = pnet.output(x)
    assert got.shape == want.shape == (B, 12, V)
    assert np.abs(got - want).max() <= 1e-6
    acts = pnet.feed_forward(x)
    assert [a.shape for a in acts] == [a.shape for a in jnet.feed_forward(x)]
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    steps = [pnet.rnn_time_step(x[:, t]) for t in range(12)]
    jsteps = [np.asarray(jnet.rnn_time_step(x[:, t])) for t in range(12)]
    assert np.abs(np.stack(steps, 1) - got).max() <= 1e-6
    assert np.abs(np.stack(steps, 1) - np.stack(jsteps, 1)).max() <= 1e-6
    # a [B, T, F] chunk continues from the carried state
    more = pnet.rnn_time_step(x[:, :3])
    assert more.shape == (B, 3, V)
    it = [DataSet(x, y)]
    jev = jnet.evaluate([JDataSet(x, y)])
    pev = pnet.evaluate(ListDataSetIterator(it))
    np.testing.assert_array_equal(pev.confusion.matrix, jev.confusion.matrix)
    assert pev.accuracy() == jev.accuracy()
    assert pev.stats() == jev.stats()


def test_gradient_and_score_without_update_match_jax():
    jnet, pnet = _charrnn_pair()
    (x, y), = _char_batches(1, t=SEG)
    jg, js = jnet.compute_gradient_and_score(x, y)
    before = pnet.params()
    pg, ps = pnet.compute_gradient_and_score(x, y)
    np.testing.assert_array_equal(pnet.params(), before)
    assert abs(ps - js) <= 1e-5 * abs(js)
    for a, b in zip(pg, jg):
        _assert_trees_close(a, b, what="grads")
    assert pnet.gradient() is pg
    np.testing.assert_allclose(
        pnet.gradient_vector(), np.asarray(jnet.gradient_vector()),
        atol=1e-5 * np.abs(np.asarray(jnet.gradient_vector())).max())


def test_jax_run_continues_in_the_port():
    """Flat params (``set_params(jax_net.params())``) and the rmsprop state
    (``updater_state_from_numpy``) carried across after two JAX calls: the
    port's third call equals the JAX net's."""
    jconf = jzoo.char_rnn(vocab_size=V, hidden=HID, tbptt_length=SEG,
                          learning_rate=LR)
    jnet = JNet(jconf).init()
    batches = _char_batches(3, seed=4)
    for x, y in batches[:2]:
        jnet.fit_batch(x, y)
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    np.testing.assert_array_equal(pnet.params(), np.asarray(jnet.params()))
    pnet.updater_states = updater_state_from_numpy(
        [_np_tree(s) for s in jnet.updater_states], "cpu")
    pnet.iteration = jnet.iteration
    x, y = batches[2]
    ws, ps = float(jnet.fit_batch(x, y)), float(pnet.fit_batch(x, y))
    assert abs(ps - ws) <= 1e-5 * abs(ws)
    for i in range(len(jnet.layers)):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])
        _assert_trees_close(pnet.updater_states[i], jnet.updater_states[i])


def test_params_from_numpy_keeps_the_layout_and_checks_shapes():
    """Dense W [n_in, n_out], LSTM W [n_in, 4H], RW [H, 4H] with gates
    [i, f, g, o], P [3, H]: copied as they are, nothing transposed."""
    jnet, pnet = _charrnn_pair()
    for jp, pp in zip(jnet.params_list, pnet.params_list):
        for k in jp:
            np.testing.assert_array_equal(pp[k].detach().numpy(),
                                          np.asarray(jp[k]))
    assert tuple(pnet.params_list[0]["W"].shape) == (V, 4 * HID)
    assert tuple(pnet.params_list[0]["RW"].shape) == (HID, 4 * HID)
    bad = [_np_tree(p) for p in jnet.params_list]
    bad[0]["W"] = bad[0]["W"].T
    with pytest.raises(ValueError, match="do not match"):
        params_from_numpy(pnet.layers, bad, "cpu")


def test_bidirectional_masked_fit_matches_jax():
    """A GravesBidirectionalLSTM net, standard backprop, with feature and
    label masks, through ``fit_batch`` twice."""
    def conf(builder, bi, out):
        return (builder.seed(7).learning_rate(0.05).updater("adam").list()
                .layer(bi(n_in=6, n_out=8, activation="tanh", mode="concat"))
                .layer(out(n_out=6, activation="softmax", loss="mcxent"))
                .build())
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (GravesBidirectionalLSTM,
                                                    RnnOutputLayer)
    jc = conf(JBuilder.Builder(), JBiLSTM, JRnnOut)
    pc = conf(NeuralNetConfiguration.Builder(), GravesBidirectionalLSTM,
              RnnOutputLayer)
    assert pc.to_json() == jc.to_json()
    jnet = JNet(jc).init()
    pnet = MultiLayerNetwork(pc, device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    pnet.reset_updater_state()
    r = np.random.RandomState(8)
    ids = r.randint(0, 6, (4, 10))
    x = np.eye(6, dtype=np.float32)[ids]
    y = np.eye(6, dtype=np.float32)[np.roll(ids, -1, 1)]
    fm = np.ones((4, 10), np.float32)
    fm[:, -3:] = 0.0
    for _ in range(2):
        ws = float(jnet.fit_batch(x, y, fmask=fm, lmask=fm))
        ps = float(pnet.fit_batch(x, y, fmask=fm, lmask=fm))
        assert abs(ps - ws) <= 1e-5 * abs(ws)
    for i in range(2):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])
        _assert_trees_close(pnet.updater_states[i], jnet.updater_states[i])


# ---------------------------------------------------------------------------
# standard backprop: the MLP with nesterovs
# ---------------------------------------------------------------------------
def test_mlp_nesterovs_with_l2_matches_jax():
    jconf = jzoo.mlp_mnist(hidden=32)
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    r = np.random.RandomState(9)
    for _ in range(3):
        x = r.rand(16, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 16)]
        ws, ps = float(jnet.fit_batch(x, y)), float(pnet.fit_batch(x, y))
        assert abs(ps - ws) <= 1e-5 * abs(ws)
    for i in range(2):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])
        _assert_trees_close(pnet.updater_states[i], jnet.updater_states[i])
    x = r.rand(5, 784).astype(np.float32)
    assert np.abs(pnet.output(x) - np.asarray(jnet.output(x))).max() <= 1e-6


# ---------------------------------------------------------------------------
# fit over iterators, listeners
# ---------------------------------------------------------------------------
def test_fit_over_a_list_iterator_matches_jax_and_counts_windows():
    jnet, pnet = _charrnn_pair()
    batches = _char_batches(3, seed=5)
    lst = CollectScoresIterationListener()
    pnet.set_listeners(lst)
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
             epochs=1)
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in batches]))
    assert pnet.iteration == 9 and len(lst.scores) == 9
    assert [it for it, _ in lst.scores] == list(range(1, 10))
    assert pnet.epoch_count == 1
    for i in range(len(jnet.layers)):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])


def test_fit_over_a_dataset_runs_conf_iterations():
    _, pnet = _charrnn_pair()
    pnet.conf.iterations = 2
    (x, y), = _char_batches(1)
    pnet.fit(DataSet(x, y))
    assert pnet.iteration == 2 * (T // SEG)


# ---------------------------------------------------------------------------
# the non-finite guard
# ---------------------------------------------------------------------------
def test_nan_step_fault_equals_the_stream_without_that_batch(monkeypatch):
    """A guarded run whose batch 1 is poisoned (``nan-step@1``: the
    per-batch loop's ``fit_batch`` call 1, so the fused loop is off here;
    ``tests/test_torch_fused.py`` holds its ``nan-step@0:1``) reverts
    every window of it: parameters, rmsprop state and the device
    iteration equal the same stream with batch 1 left out, bitwise."""
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "1")
    # each of the batch's T // SEG windows is a dispatch with a reverted
    # step; a patience above that keeps the divergence policy (held in
    # test_torch_serialization.py) from ending the run
    monkeypatch.setenv("DL4J_TORCH_NANGUARD_PATIENCE", str(T // SEG + 1))
    batches = [DataSet(x, y) for x, y in _char_batches(4, seed=6)]
    _, poisoned = _charrnn_pair()
    _, control = _charrnn_pair()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("nan-step@1"):
            poisoned.fit(ListDataSetIterator(batches))
    assert any("non-finite" in str(w.message) for w in caught)
    control.fit(ListDataSetIterator([batches[0]] + batches[2:]))
    np.testing.assert_array_equal(poisoned.params(), control.params())
    for a, b in zip(poisoned.updater_states, control.updater_states):
        for key in a:
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k])
    assert poisoned.nan_skipped_steps == T // SEG
    assert int(poisoned._iter_dev) == int(control._iter_dev)
    assert np.isfinite(poisoned.params()).all()


def test_guard_off_lets_the_nan_through(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_NANGUARD", "0")
    _, net = _charrnn_pair()
    (x, y), = _char_batches(1)
    with faults.inject("nan-step@0"):
        net.fit_batch(x, y)
    assert np.isnan(net.params()).any()


# ---------------------------------------------------------------------------
# init, clone, summary
# ---------------------------------------------------------------------------
def test_init_scale_and_distribution():
    """Weights are drawn from the config's seed by ``torch.Generator``
    (JAX's threefry values cannot be matched): xavier with the LSTM's fan
    override, std sqrt(2 / (fan_in + fan_out)); the forget-gate bias 1 and
    other biases 0; peepholes 0."""
    conf = zoo.char_rnn(vocab_size=77, hidden=200)
    net = MultiLayerNetwork(conf, device="cpu").init()
    p0, p1, p2 = net.params_list
    for w, (fi, fo) in ((p0["W"], (77, 200)), (p0["RW"], (200, 200)),
                        (p1["W"], (200, 200)), (p2["W"], (200, 77))):
        std = float(w.detach().std())
        want = math.sqrt(2.0 / (fi + fo))
        assert abs(std / want - 1) < 0.03, (std, want)
        assert abs(float(w.detach().mean())) < 0.05 * want
    b = p0["b"].detach()
    assert torch.equal(b[200:400], torch.ones(200))
    assert not b[:200].any() and not b[400:].any()
    assert not p0["P"].any() and not p2["b"].any()
    same = MultiLayerNetwork(conf, device="cpu").init()
    np.testing.assert_array_equal(same.params(), net.params())
    other = MultiLayerNetwork(zoo.char_rnn(vocab_size=77, hidden=200,
                                           seed=1), device="cpu").init()
    assert not np.array_equal(other.params(), net.params())
    assert net.num_params() == JNet(jzoo.char_rnn()).num_params()


def test_clone_is_independent_and_summary_lists_the_layers():
    _, net = _charrnn_pair()
    twin = net.clone()
    (x, y), = _char_batches(1)
    net.fit_batch(x, y)
    assert not np.array_equal(twin.params(), net.params())
    twin.fit_batch(x, y)
    np.testing.assert_array_equal(twin.params(), net.params())
    layer0 = net.get_layer_params(0)
    layer0["W"].zero_()
    assert net.params_list[0]["W"].abs().max() > 0
    text = net.summary()
    assert "GravesLSTM" in text and "RnnOutputLayer" in text
    assert f"total params: {net.num_params()}" in text


def test_dropout_draws_from_the_seeded_generator():
    """Dropout masks come from the net's seed and draw counter: the same
    seed gives the same run, and the retained share is the retain
    probability."""
    def run():
        conf = zoo.mlp_mnist(hidden=64)
        conf.layers[0].dropout = 0.5
        net = MultiLayerNetwork(conf, device="cpu").init()
        r = np.random.RandomState(1)
        x = r.rand(8, 784).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 8)]
        net.fit_batch(x, y)
        return net
    a, b = run(), run()
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.dropout_draws == b.dropout_draws == 1
    layer = a.layers[0]
    x = torch.ones(200, 500)
    kept = layer.apply_dropout(x, train=True, rng=a._dropout_keys()[0])
    share = float((kept != 0).float().mean())
    assert abs(share - 0.5) < 0.01
    assert torch.all(kept[kept != 0] == 2.0)


# ---------------------------------------------------------------------------
# the kernel seam: gradients must flow through graph-less kernel outputs
# ---------------------------------------------------------------------------
def test_lstm_route_carries_the_gradient_through_the_kernel_seam(
        monkeypatch):
    """The kernels return tensors with no autograd graph. With graph-less
    stand-ins at the kernel entry points (reached from CPU tensors by
    routing the Functions there), a GravesLSTM layer's parameters and input
    still get the builtin route's gradients, by way of one sequence launch
    forward and the step backward once a step, never a plain twin called
    by the route."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    layer = GravesLSTM(n_in=5, n_out=6, activation="tanh")
    r = np.random.RandomState(0)
    params0 = {k: (0.5 * r.randn(*s)).astype(np.float32)
               for k, s in layer.param_shapes().items()}
    x0 = r.randn(3, 7, 5).astype(np.float32)
    cot = torch.from_numpy(r.randn(3, 7, 6).astype(np.float32))

    def grads():
        p = {k: torch.from_numpy(v.copy()).requires_grad_()
             for k, v in params0.items()}
        x = torch.from_numpy(x0.copy()).requires_grad_()
        out, _ = layer.forward(p, x, {})
        return torch.autograd.grad((out * cot).sum(), [*p.values(), x])

    monkeypatch.setenv("DL4J_TORCH_LSTM_KERNEL", "builtin")
    want = grads()
    monkeypatch.delenv("DL4J_TORCH_LSTM_KERNEL")

    calls = []
    plain_seq, plain_bwd = plc.lstm_sequence_plain, plc.lstm_cell_bwd_plain

    def kernel_sequence(*a):
        calls.append("fwd")
        with torch.no_grad():   # as the ctypes kernel: no graph
            return plain_seq(*a, with_states=True)

    def step_backward(zx_t, rw, peep):
        def kernel_backward(zx, hp, cp, dh, dc, dzx, drw, dp):
            calls.append("bwd")
            with torch.no_grad():
                g = plain_bwd(zx, hp, cp, rw, peep, dh, dc)
                dzx.copy_(g[0])
                if drw is None:
                    return g[1:]
                return g[1], g[2], drw + g[3], dp + g[4]
        return kernel_backward

    def twin(*a, **kw):
        raise AssertionError("a plain twin ran on the kernel route")
    monkeypatch.setattr(plc, "_kernel_sequence", kernel_sequence)
    monkeypatch.setattr(plc, "lstm_sequence_plain", twin)
    monkeypatch.setattr(plc, "lstm_cell_bwd_plain", twin)
    monkeypatch.setattr(plc, "_sequence_forward",
                        lambda *a: plc._kernel_sequence(*a))
    monkeypatch.setattr(plc, "_step_backward", step_backward)
    got = grads()
    assert calls.count("fwd") == 1 and calls.count("bwd") == 7
    for g, w in zip(got, want):
        assert g is not None
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_remat_gives_the_plain_run_with_the_same_dropout_masks():
    """``conf.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); the recomputation reads the same draw
    counter, so it draws the same dropout masks, and two steps equal the
    plain run's."""
    def run(remat):
        conf = zoo.mlp_mnist(hidden=64)
        conf.layers[0].dropout = 0.5
        conf.remat = remat
        net = MultiLayerNetwork(conf, device="cpu").init()
        r = np.random.RandomState(2)
        for _ in range(2):
            x = r.rand(8, 784).astype(np.float32)
            y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 8)]
            net.fit_batch(x, y)
        return net
    plain, remat = run(False), run(True)
    np.testing.assert_allclose(remat.params(), plain.params(), rtol=0,
                               atol=1e-7)
    assert remat.dropout_draws == plain.dropout_draws == 2
