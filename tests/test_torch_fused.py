"""The port's fused loop against the JAX package's, and against its own
per-batch path.

``fit(iterator)`` of the port wraps the iterator in its prefetcher, which
stacks up to ``DL4J_TORCH_FUSE_STEPS`` batches into a ``StackedDataSet``,
and ``fit_fused`` trains each group one window step at a time over static
tensors (on the card a replayed CUDA graph; here the same function called
directly). The JAX side runs its fused scan (``DL4J_TPU_FUSE_STEPS``).

Tolerances, with their reasons:
- port against JAX: parameters and updater state within 1e-5 of each
  leaf's max abs, scores 1e-5 relative, as ``test_torch_mln.py`` holds
  its char-RNN fits (the same math; summation order only; lr 0.01);
- port fused against port per-batch: bitwise. Both run the same CPU ops
  on the same row-padded batches with the same example weights; a
  padding step is skipped, and a zero-weight row leaves the loss through
  the example weights in both;
- the NaN guard: bitwise against the stream without the bad batch.
"""

import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models._device_state import (
    fuse_allowed as jfuse_allowed)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.tuning.autotuner import (
    fuse_wrap_config as jfuse_wrap_config)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator,
                                                       StackedDataSet)
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.tuning.autotuner import fuse_wrap_config

V, HID, B, T, SEG = 7, 8, 4, 12, 5   # windows 5, 5 and a ragged 2
WINDOWS = 3
LR = 0.01
REL = 1e-5


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.array(tree)


def _assert_trees_close(got, want, rtol=REL, what=""):
    got, want = _np_tree(got), _np_tree(want)
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], rtol, f"{what}.{k}")
            continue
        scale = max(np.abs(want[k]).max(), 1e-30)
        err = np.abs(got[k] - want[k]).max()
        assert err <= rtol * scale, (f"{what}.{k}", err, scale)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert torch.equal(a, b)


def _charrnn_pair(seg=SEG, seed=12345):
    jconf = jzoo.char_rnn(vocab_size=V, hidden=HID, tbptt_length=seg,
                          learning_rate=LR, seed=seed)
    jnet = JNet(jconf).init()
    return jnet, _port_copy(jconf, jnet)


def _port_copy(jconf, jnet):
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    pnet.reset_updater_state()
    return pnet


def _port_charrnn(seg=SEG):
    return _charrnn_pair(seg)[1]


def _char_batches(n, seed=0, rows=B, t=T):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = r.randint(0, V, (rows, t + 1))
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _stream():
    """Six full batches (a ragged group at K 4) and a trailing 3-row batch
    (row padding)."""
    return _char_batches(6, seed=3) + _char_batches(1, seed=4, rows=3)


def _fit(net, batches, monkeypatch, k, **env):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    return net


def _assert_same_training(a, b):
    np.testing.assert_array_equal(a.params(), b.params())
    _assert_trees_equal(a.updater_states, b.updater_states)
    assert int(a._iter_dev) == int(b._iter_dev)
    assert a.iteration == b.iteration


# ---------------------------------------------------------------------------
# against the JAX fused fit
# ---------------------------------------------------------------------------
def test_fused_charrnn_fit_matches_jax_fused_fit(monkeypatch):
    """K 4 over six batches and a ragged 3-row trailer (groups of 4 and
    3 + 1 padding step), T 12 in windows of 5, 5 and 2: parameters,
    rmsprop state, score and the grouping telemetry match the JAX fused
    scan."""
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "4")
    batches = _stream()
    jnet, pnet = _charrnn_pair()
    _fit(pnet, batches, monkeypatch, 4)
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in batches]))
    assert pnet.iteration == jnet.iteration == 7 * WINDOWS
    assert pnet._last_fuse_stats == jnet._last_fuse_stats
    assert pnet._last_fuse_stats["fused_groups"] == 2
    assert pnet._last_fuse_stats["padded_steps"] == 1
    for i in range(len(jnet.layers)):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])
        _assert_trees_close(pnet.updater_states[i], jnet.updater_states[i])
    ws, ps = float(jnet.score_), float(pnet.score_)
    assert abs(ps - ws) <= REL * abs(ws)
    assert int(pnet._iter_dev) == int(jnet._iter_dev)


def test_fused_mlp_fit_matches_jax_fused_fit(monkeypatch):
    """Standard backprop: a batch is one window step. An MLP with
    nesterovs and l2 over 120 rows in batches of 32 (a 24-row trailer)."""
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "8")
    jconf = jzoo.mlp_mnist(hidden=16)
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    r = np.random.RandomState(9)
    x = r.rand(120, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 120)]
    batches = [(x[s:s + 32], y[s:s + 32]) for s in range(0, 120, 32)]
    _fit(pnet, batches, monkeypatch, 8)
    jnet.fit(JListIterator([JDataSet(a, b) for a, b in batches]))
    assert pnet.iteration == jnet.iteration == 4
    assert pnet._last_fuse_stats["fused_groups"] == 1
    for i in range(2):
        _assert_trees_close(pnet.params_list[i], jnet.params_list[i])
        _assert_trees_close(pnet.updater_states[i], jnet.updater_states[i])
    ws, ps = float(jnet.score_), float(pnet.score_)
    assert abs(ps - ws) <= REL * abs(ws)
    ga, gb = pnet.gradient_vector(), np.asarray(jnet.gradient_vector())
    assert np.abs(ga - gb).max() <= REL * np.abs(gb).max()


# ---------------------------------------------------------------------------
# against the port's own per-batch path
# ---------------------------------------------------------------------------
def test_fused_equals_per_batch_bitwise(monkeypatch):
    """The same stream through ``fit_fused`` (K 4) and through the
    per-batch loop (K 1): parameters, rmsprop state, device iteration,
    score and the last gradients are the same bits."""
    batches = _stream()
    fused = _fit(_port_charrnn(), batches, monkeypatch, 4)
    plain = _fit(_port_charrnn(), batches, monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 2
    assert plain._last_fuse_stats["fused_groups"] == 0
    assert plain._fused is None and fused._fused is not None
    _assert_same_training(fused, plain)
    assert fused.score_ == plain.score_
    _assert_trees_equal(fused._last_gradients, plain._last_gradients)


def test_fused_mlp_equals_per_batch_bitwise(monkeypatch):
    r = np.random.RandomState(2)
    x = r.rand(40, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 40)]
    batches = [(x[s:s + 16], y[s:s + 16]) for s in range(0, 40, 16)]

    def net():
        conf = (NeuralNetConfiguration.Builder().seed(4).learning_rate(0.05)
                .updater("adam").l2(1e-3).regularization(True).list()
                .layer(DenseLayer(n_in=6, n_out=5, activation="relu"))
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()
    fused = _fit(net(), batches, monkeypatch, 8)
    plain = _fit(net(), batches, monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 1
    _assert_same_training(fused, plain)


def test_masked_batches_take_the_per_batch_path_either_way(monkeypatch):
    """A masked batch cannot stack: it trains through ``fit_batch``
    whether the fused loop is on or not, with the same bits."""
    (x, y), = _char_batches(1, seed=8)
    fm = np.ones((B, T), np.float32)
    fm[:, -3:] = 0.0

    def fit(**env):
        net = _port_charrnn()
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        net.fit(ListDataSetIterator([DataSet(x, y, fm, fm)]))
        return net
    a = fit(DL4J_TORCH_FUSE_STEPS="4")
    b = fit(DL4J_TORCH_FUSE_TBPTT="0")
    direct = _port_charrnn()
    direct.fit_batch(x, y, fm, fm)
    assert a._last_fuse_stats["fused_groups"] == 0 and a._fused is None
    assert a.iteration == b.iteration == direct.iteration == WINDOWS
    np.testing.assert_array_equal(a.params(), b.params())
    np.testing.assert_array_equal(a.params(), direct.params())


def test_fuse_tbptt_off_gives_no_fused_groups(monkeypatch):
    """``DL4J_TORCH_FUSE_TBPTT=0`` keeps tBPTT models on the host window
    loop: no stacked group, no fused loop."""
    batches = _char_batches(4, seed=1)
    net = _fit(_port_charrnn(), batches, monkeypatch, 4,
               DL4J_TORCH_FUSE_TBPTT="0")
    assert net._last_fuse_stats["fused_groups"] == 0
    assert net._fused is None
    assert net.iteration == 4 * WINDOWS


def test_listener_replay_counts_every_window_update(monkeypatch):
    """Listeners are replayed after each group, one ``iteration_done`` per
    window update (k x windows), numbered 1..n, with the per-batch run's
    scores."""
    batches = _char_batches(4, seed=2)
    runs = []
    for k in (4, 1):
        lst = CollectScoresIterationListener()
        net = _port_charrnn()
        net.set_listeners(lst)
        _fit(net, batches, monkeypatch, k)
        runs.append(lst.scores)
    fused, plain = runs
    assert len(fused) == 4 * WINDOWS
    assert [i for i, _ in fused] == list(range(1, 4 * WINDOWS + 1))
    assert [s for _, s in fused] == [s for _, s in plain]


def test_single_window_plan_score_is_scalar(monkeypatch):
    """With tbptt_fwd_length >= T a batch is one window: the score and
    every listener score are scalars."""
    lst = CollectScoresIterationListener()
    net = _port_charrnn(seg=T)
    net.set_listeners(lst)
    _fit(net, _char_batches(2, seed=5), monkeypatch, 2)
    assert net.iteration == 2 and net._last_fuse_stats["fused_groups"] == 1
    assert net._score.ndim == 0 and np.ndim(net.score_) == 0
    assert len(lst.scores) == 2
    assert all(np.ndim(s) == 0 for _, s in lst.scores)


def test_nan_step_in_a_group_equals_the_stream_without_that_batch(
        monkeypatch):
    """``nan-step@0:1`` poisons step 1 of group 0 under the guard: every
    window of that batch is reverted, so parameters, rmsprop state and the
    device iteration equal the stream with batch 1 left out, bitwise, and
    the guard counts the batch's windows."""
    batches = _char_batches(4, seed=6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("nan-step@0:1"):
            poisoned = _fit(_port_charrnn(), batches, monkeypatch, 4)
    assert any("non-finite" in str(w.message) for w in caught)
    assert poisoned._last_fuse_stats["fused_groups"] == 1
    control = _fit(_port_charrnn(), [batches[0]] + batches[2:],
                   monkeypatch, 4)
    np.testing.assert_array_equal(poisoned.params(), control.params())
    _assert_trees_equal(poisoned.updater_states, control.updater_states)
    assert int(poisoned._iter_dev) == int(control._iter_dev)
    assert poisoned.nan_skipped_steps == WINDOWS
    assert poisoned.iteration == 4 * WINDOWS
    assert np.isfinite(poisoned.params()).all()


def test_dropout_model_is_declined(monkeypatch):
    """A model with dropout is no longer declined: its masks come from
    the device draw counter, so it fuses, and the fused run equals the
    per-batch run bitwise: parameters, updater state and the counter,
    which every kept update advanced once."""
    def net():
        conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
                .dropout(0.5).list()
                .layer(DenseLayer(n_in=6, n_out=8, activation="relu"))
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()
    a = net()
    assert fuse_allowed(a.conf, a.layers)
    assert fuse_wrap_config(a) == (8, None, True, False)
    r = np.random.RandomState(1)
    batches = [(r.rand(8, 6).astype(np.float32),
                np.eye(3, dtype=np.float32)[r.randint(0, 3, 8)])
               for _ in range(5)]
    _fit(a, batches, monkeypatch, 4)
    assert a._last_fuse_stats["fused_groups"] == 2 and a._fused is not None
    b = _fit(net(), batches, monkeypatch, 1)
    assert b._fused is None
    _assert_same_training(a, b)
    assert a.dropout_draws == b.dropout_draws == 5
    c = net()
    for x, y in batches:
        c.fit_batch(x, y, ew=np.ones(8, np.float32))
    np.testing.assert_array_equal(a.params(), c.params())


def test_set_params_after_a_fused_fit_is_honoured(monkeypatch):
    """The fused loop keeps the tensors its steps (and, on the card, its
    graphs) point at: ``set_params``, ``reset_updater_state`` and a
    per-batch step in between are copied into them when the next group
    binds. The next fused fit then equals a fresh net fitted from the same
    parameters, and the loop with its window signatures is kept."""
    first, second = _char_batches(4, seed=10), _char_batches(4, seed=11)
    start = _port_charrnn()
    p0 = start.params()
    net = _fit(_port_charrnn(), first, monkeypatch, 4)
    loop, sigs = net._fused, set(net._fused.graphs)
    assert not np.array_equal(net.params(), p0)
    net.set_params(p0)
    net.reset_updater_state()
    net.iteration = 0
    _fit(net, second, monkeypatch, 4)
    _fit(start, second, monkeypatch, 4)
    assert net._fused is loop and set(loop.graphs) == sigs
    _assert_same_training(net, start)
    # a per-batch step between two groups, then a group: as a net that ran
    # the same sequence
    (x, y), = _char_batches(1, seed=12)
    for n in (net, start):
        n.fit_batch(x, y)
        _fit(n, first, monkeypatch, 4)
    _assert_same_training(net, start)


def test_clone_starts_its_own_fused_loop(monkeypatch):
    batches = _char_batches(4, seed=13)
    net = _fit(_port_charrnn(), batches, monkeypatch, 4)
    twin = net.clone()
    assert twin._fused is None
    for n in (net, twin):
        _fit(n, batches, monkeypatch, 4)
    np.testing.assert_array_equal(net.params(), twin.params())
    assert twin._fused is not net._fused


# ---------------------------------------------------------------------------
# the gate and the wrap decision against the reference's
# ---------------------------------------------------------------------------
def _mlp_conf(start, dense, out, **kw):
    b = start.seed(1).learning_rate(0.1)
    if kw.get("algo"):
        b = b.optimization_algo(kw["algo"])
    if kw.get("iterations"):
        b = b.iterations(kw["iterations"])
    return (b.list()
            .layer(dense(n_in=4, n_out=8, activation="relu"))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .build())


GATE_CASES = {
    "char_rnn": dict(build=lambda m: m.char_rnn(vocab_size=V, hidden=HID)),
    "char_rnn_fuse_tbptt_off": dict(
        build=lambda m: m.char_rnn(vocab_size=V, hidden=HID),
        env={"FUSE_TBPTT": "0"}),
    "mlp_mnist": dict(build=lambda m: m.mlp_mnist(hidden=16)),
    "mlp_k1": dict(build=lambda m: m.mlp_mnist(hidden=16),
                   env={"FUSE_STEPS": "1"}),
    "two_iterations": dict(mlp=dict(iterations=2)),
    "line_search": dict(mlp=dict(algo="line_gradient_descent")),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_fuse_gate_and_wrap_config_agree_with_jax(monkeypatch, case):
    spec = GATE_CASES[case]
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "4")
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "4")
    for name, value in spec.get("env", {}).items():
        monkeypatch.setenv("DL4J_TPU_" + name, value)
        monkeypatch.setenv("DL4J_TORCH_" + name, value)
    if "mlp" in spec:
        jconf = _mlp_conf(JBuilder.Builder(), JDense, JOut, **spec["mlp"])
        pconf = _mlp_conf(NeuralNetConfiguration.Builder(), DenseLayer,
                          OutputLayer, **spec["mlp"])
    else:
        from deeplearning4j_tpu_torch.models import zoo
        jconf, pconf = spec["build"](jzoo), spec["build"](zoo)
    assert pconf.to_json() == jconf.to_json()
    assert fuse_allowed(pconf, pconf.layers) == \
        jfuse_allowed(jconf, jconf.layers)
    assert fuse_wrap_config(MultiLayerNetwork(pconf, device="cpu")) == \
        jfuse_wrap_config(JNet(jconf))


def test_gate_declines_dropout_where_the_reference_fuses():
    """The gate is the reference's: a dropout model fuses in both
    packages (the port's former difference is gone)."""
    def conf(start, dense, out):
        return (start.seed(1).dropout(0.5).list()
                .layer(dense(n_in=4, n_out=8, activation="relu"))
                .layer(out(n_out=3, activation="softmax", loss="mcxent"))
                .build())
    jconf = conf(JBuilder.Builder(), JDense, JOut)
    pconf = conf(NeuralNetConfiguration.Builder(), DenseLayer, OutputLayer)
    assert jfuse_allowed(jconf, jconf.layers)
    assert fuse_allowed(pconf, pconf.layers)


def test_autotune_raises_and_names_the_roadmap(monkeypatch, tmp_path):
    """The fusion autotuner is ported: with ``DL4J_TORCH_FUSE_AUTOTUNE=1``
    a fit arms it (groups of the probe size and a bucket resolver) and
    trains; an explicit K still wins over the tuner, as in the
    reference."""
    from deeplearning4j_tpu_torch.tuning import autotuner
    monkeypatch.delenv("DL4J_TORCH_FUSE_STEPS", raising=False)
    monkeypatch.setenv("DL4J_TORCH_FUSE_AUTOTUNE", "1")
    monkeypatch.setenv("DL4J_TORCH_FUSE_PROBE_KS", "1,2")
    monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
    autotuner._reset_for_tests()
    try:
        net = _port_charrnn()
        fuse, resolver, pad, armed = fuse_wrap_config(net)
        assert (fuse, pad, armed) == (2, True, True) and callable(resolver)
        net.fit(ListDataSetIterator([DataSet(x, y) for x, y in
                                     _char_batches(2)]))
        assert net.iteration == 2 * WINDOWS
        # an explicit K wins over the tuner, as in the reference
        monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "2")
        assert fuse_wrap_config(net) == (2, None, True, False)
    finally:
        autotuner._reset_for_tests()
