"""ComputationGraph's fused loop: ``StackedMultiDataSet``, the
prefetcher's stacking of MultiDataSet batches, ``fit_fused`` (standard
and tBPTT over the LSTM vertices) and the gate, against the JAX
package's and against the port's own per-batch path.

Tolerances, with their reasons:
- the prefetcher's groups against the reference's: equal arrays (the
  same numpy stacking and padding);
- port fused against port per-batch: bitwise (the same CPU ops on the
  same row-padded batches with the same example weights; a padding step
  is skipped in both);
- port fused against the JAX graph's fused scan: 1e-5 of each leaf's max
  abs, as ``test_torch_computation_graph.py`` holds its graphs (the same
  math; summation order only);
- the NaN guard: bitwise against the stream without the bad batch.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.datasets.async_iterator import (
    AsyncDataSetIterator as JAsync)
from deeplearning4j_tpu.datasets.dataset import (
    ArrayMultiDataSetIterator as JArrayMulti, MultiDataSet as JMulti)
from deeplearning4j_tpu.models._device_state import (
    fuse_allowed as jfuse_allowed)
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator)
from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayMultiDataSetIterator, MultiDataSet, StackedMultiDataSet)
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn import layers as players
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils import training_checkpoint

REL = 1e-5
V, HID, SEG, T = 6, 8, 5, 12      # windows 5, 5 and a ragged 2
WINDOWS = 3


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _close(got, want, what):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, what


def _same(a, b):
    np.testing.assert_array_equal(a.params(), b.params())
    for x, y in zip(a.updater_states, b.updater_states):
        for k in x:
            for n in x[k]:
                assert torch.equal(x[k][n], y[k][n])
    assert a.iteration == b.iteration
    assert int(a._device_iteration()) == int(b._device_iteration())
    assert a.dropout_draws == b.dropout_draws


# ---------------------------------------------------------------------------
# graphs and data
# ---------------------------------------------------------------------------
def _mlp_graph(builder, layers, vertices, dropout=0.0):
    """Two inputs, a merge, two outputs; adam with l2."""
    return (builder.seed(3).learning_rate(0.01).updater("adam")
            .regularization(True).l2(1e-3).graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", layers.DenseLayer(n_in=5, n_out=8,
                                               activation="tanh",
                                               dropout=dropout), "a")
            .add_layer("db", layers.DenseLayer(n_in=4, n_out=8,
                                               activation="relu"), "b")
            .add_vertex("cat", vertices.MergeVertex(), "da", "db")
            .add_layer("o1", layers.OutputLayer(n_in=16, n_out=3,
                                                activation="softmax",
                                                loss="mcxent"), "cat")
            .add_layer("o2", layers.OutputLayer(n_in=16, n_out=2,
                                                activation="identity",
                                                loss="mse"), "cat")
            .set_outputs("o1", "o2").build())


def _mlp_data(seed, n):
    r = np.random.RandomState(seed)
    xs = [r.randn(n, 5).astype(np.float32), r.randn(n, 4).astype(np.float32)]
    ys = [np.eye(3, dtype=np.float32)[r.randint(0, 3, n)],
          r.randn(n, 2).astype(np.float32)]
    return xs, ys


def _rnn_graph(builder, layers, vertices, dropout=0.0):
    """A DAG char-RNN: two GravesLSTM vertices, a skip merge, tBPTT;
    rmsprop at lr 0.01, as ``test_torch_fused.py`` holds its char-RNN."""
    return (builder.seed(0).learning_rate(0.01).updater("rmsprop")
            .graph_builder().add_inputs("in")
            .add_layer("l1", layers.GravesLSTM(n_in=V, n_out=HID,
                                               activation="tanh"), "in")
            .add_layer("l2", layers.GravesLSTM(n_in=HID, n_out=HID,
                                               activation="tanh",
                                               dropout=dropout), "l1")
            .add_vertex("skip", vertices.MergeVertex(), "l1", "l2")
            .add_layer("out", layers.RnnOutputLayer(
                n_in=2 * HID, n_out=V, activation="softmax",
                loss="mcxent"), "skip")
            .set_outputs("out").backprop_type("tbptt")
            .tbptt_fwd_length(SEG).tbptt_back_length(SEG).build())


def _rnn_data(seed, n):
    r = np.random.RandomState(seed)
    ids = r.randint(0, V, (n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return [eye[ids[:, :-1]]], [eye[ids[:, 1:]]]


GRAPHS = {"mlp": (_mlp_graph, _mlp_data, 1),
          "tbptt": (_rnn_graph, _rnn_data, WINDOWS)}


def _port(kind, dropout=0.0):
    conf = GRAPHS[kind][0](NeuralNetConfiguration.Builder(), players, pgraph,
                           dropout)
    return ComputationGraph(conf, device="cpu").init()


def _stream(kind, n=30, seed=1):
    """Batches of 4 and a ragged trailer of 2 from ``n`` rows."""
    xs, ys = GRAPHS[kind][1](seed, n)
    return ArrayMultiDataSetIterator(xs, ys, batch_size=4)


def _fit(net, it, monkeypatch, k, **kw):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    net.fit(it, **kw)
    return net


# ---------------------------------------------------------------------------
# StackedMultiDataSet and the prefetcher's groups
# ---------------------------------------------------------------------------
def _multi_batches(spec):
    out = []
    for i, (rows, w, masked) in enumerate(spec):
        r = np.random.RandomState(i)
        xs = [r.rand(rows, w).astype(np.float32),
              r.rand(rows, 3).astype(np.float32)]
        ys = [np.eye(2, dtype=np.float32)[r.randint(0, 2, rows)]]
        fm = [np.ones((rows, w), np.float32), None] if masked else None
        out.append((xs, ys, fm))
    return out


MULTI_STREAMS = {
    "ragged_rows": [(4, 5, False)] * 5 + [(3, 5, False)],
    "shape_change": [(4, 5, False), (4, 6, False)] * 3,
    "masked_between": [(4, 5, False)] * 3 + [(4, 5, True)]
    + [(4, 5, False)] * 2,
}


@pytest.mark.parametrize("stream", sorted(MULTI_STREAMS))
def test_multi_dataset_groups_match_the_reference(stream):
    """The prefetcher at fuse 4 over MultiDataSet batches: the same items,
    stacked groups as ``StackedMultiDataSet`` with the reference's arrays,
    weights and real steps; masked batches alone."""
    batches = _multi_batches(MULTI_STREAMS[stream])
    got = list(AsyncDataSetIterator(
        [MultiDataSet(x, y, m) for x, y, m in batches], fuse=4,
        device="cpu"))
    want = list(JAsync([JMulti(x, y, m) for x, y, m in batches], fuse=4))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        if isinstance(g, StackedMultiDataSet):
            assert g.n_steps == w.n_steps
            np.testing.assert_array_equal(g.weights.numpy(),
                                          np.asarray(w.weights))
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stacked_multi_dataset_contract():
    w = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], np.float32)
    st = StackedMultiDataSet([np.zeros((3, 3, 2))], [np.zeros((3, 3, 1))],
                             w, 2)
    assert st.num_steps() == 2 and st.num_examples() == 3


# ---------------------------------------------------------------------------
# the graph's fused loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_fit_fused_equals_per_batch_bitwise(monkeypatch, kind):
    """One stream (seven batches: groups of 4 and 3 + 1 padding step, the
    trailer row-padded) through the fused loop at K 4 and through the
    per-batch loop at K 1; and the full batches through ``fit_batch``
    with unit example weights one by one: the same bits."""
    fused = _fit(_port(kind), _stream(kind), monkeypatch, 4)
    plain = _fit(_port(kind), _stream(kind), monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 2
    assert plain._fused is None and fused._fused is not None
    assert fused.iteration == 8 * GRAPHS[kind][2]
    _same(fused, plain)
    xs, ys = GRAPHS[kind][1](5, 16)
    a = _fit(_port(kind), ArrayMultiDataSetIterator(xs, ys, batch_size=4),
             monkeypatch, 4)
    b = _port(kind)
    for s in range(0, 16, 4):
        b.fit_batch(MultiDataSet([x[s:s + 4] for x in xs],
                                 [y[s:s + 4] for y in ys]),
                    ew=np.ones(4, np.float32))
    _same(a, b)
    np.testing.assert_array_equal(a.gradient_vector(), b.gradient_vector())
    assert float(a.score_) == float(b.score_)


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_fused_matches_the_jax_graph_fused(monkeypatch, kind):
    """The JAX graph's fused scan (``DL4J_TPU_FUSE_STEPS`` 4) over the
    same stream from the same parameters: parameters, updater state,
    score and the grouping telemetry."""
    monkeypatch.setenv("DL4J_TPU_FUSE_STEPS", "4")
    build, data, n_w = GRAPHS[kind]
    jconf = build(JBuilder.Builder(), jlayers, jgraph)
    pconf = build(NeuralNetConfiguration.Builder(), players, pgraph)
    assert pconf.to_json() == jconf.to_json()
    jnet = JGraph(jconf).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_map = params_from_numpy(pnet.conf,
                                        _np_tree(jnet.params_map), "cpu")
    pnet.reset_updater_state()
    xs, ys = data(1, 30)
    jnet.fit(JArrayMulti(xs, ys, batch_size=4))
    _fit(pnet, _stream(kind), monkeypatch, 4)
    assert pnet.iteration == jnet.iteration == 8 * n_w
    assert pnet._last_fuse_stats == jnet._last_fuse_stats
    _close(pnet.params_map, jnet.params_map, "params")
    _close(pnet.updater_states_map, jnet.updater_states, "updater")
    assert abs(float(pnet.score_) - float(jnet.score_)) <= \
        REL * abs(float(jnet.score_))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_nan_guard_inside_the_graph_loop(monkeypatch, kind):
    """``nan-step@0:1`` poisons step 1 of group 0 under the guard: every
    window of that batch is reverted, and the run equals the stream
    without batch 1, bitwise; the guard counts the batch's windows."""
    xs, ys = GRAPHS[kind][1](7, 16)
    keep = np.r_[0:4, 8:16]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("nan-step@0:1"):
            poisoned = _fit(_port(kind), ArrayMultiDataSetIterator(
                xs, ys, batch_size=4), monkeypatch, 4)
    assert any("non-finite" in str(w.message) for w in caught)
    control = _fit(_port(kind), ArrayMultiDataSetIterator(
        [x[keep] for x in xs], [y[keep] for y in ys], batch_size=4),
        monkeypatch, 4)
    np.testing.assert_array_equal(poisoned.params(), control.params())
    assert int(poisoned._device_iteration()) == \
        int(control._device_iteration())
    assert poisoned.nan_skipped_steps == GRAPHS[kind][2]
    assert poisoned.dropout_draws == control.dropout_draws


def test_graph_loop_replays_listeners_and_keeps_one_window_graph(
        monkeypatch):
    """One ``iteration_done`` a window update with that window's score,
    and one window signature per window length (here 5 and the ragged
    2)."""
    net = _port("tbptt")
    lst = CollectScoresIterationListener()
    net.set_listeners(lst)
    _fit(net, _stream("tbptt"), monkeypatch, 4)
    assert [i for i, _ in lst.scores] == list(range(1, 8 * WINDOWS + 1))
    assert len(net._fused.graphs) == 2 and net._fused.captures == 0
    assert float(lst.scores[-1][1]) == float(net.score_)


def test_masked_multi_dataset_keeps_the_per_batch_path(monkeypatch):
    xs, ys = _mlp_data(2, 8)
    fm = [np.ones((8, 5), np.float32), None]
    net = _port("mlp")

    class It(ArrayMultiDataSetIterator):
        def __next__(self):
            mds = super().__next__()
            return MultiDataSet(mds.features, mds.labels, fm[:1] + [None]
                                if mds.features[0].shape[0] == 8 else None)
    _fit(net, It(xs, ys, batch_size=8), monkeypatch, 4)
    assert net._last_fuse_stats["fused_groups"] == 0 and net._fused is None
    assert net.iteration == 1


def test_graph_fused_resume_is_bitwise(tmp_path, monkeypatch):
    """A dropout graph through the fused loop with a checkpoint every
    group: a fresh graph resumed from the first checkpoint ends as the
    uninterrupted run, draw counter included."""
    monkeypatch.setenv("DL4J_TORCH_CKPT_KEEP", "100")
    full_dir, resume_dir = str(tmp_path / "full"), str(tmp_path / "res")
    full = _fit(_port("mlp", dropout=0.7), _stream("mlp"), monkeypatch, 4,
                epochs=2, checkpoint_every=4, checkpoint_dir=full_dir)
    files = training_checkpoint.checkpoint_files(full_dir)
    assert [i for i, _ in files] == [4, 8, 12, 16]
    os.makedirs(resume_dir)
    shutil.copy(os.path.join(full_dir, files[0][1]), resume_dir)
    net = _fit(_port("mlp", dropout=0.7), _stream("mlp"), monkeypatch, 4,
               epochs=2, checkpoint_every=4, resume_from=resume_dir)
    _same(net, full)
    assert full.dropout_draws == 16


# ---------------------------------------------------------------------------
# the gate against the reference's
# ---------------------------------------------------------------------------
def _gate_conf(builder, layers, vertices, case, graph):
    b = builder.seed(1)
    if case == "solver":
        b = b.optimization_algo("lbfgs")
    if case == "iterations_2":
        b = b.iterations(2)
    dense = layers.DenseLayer(n_in=4, n_out=8, activation="relu",
                              dropout=0.5 if case == "dropout" else None)
    mid = layers.BatchNormalization(n_out=8) if case == "bn" else \
        layers.DenseLayer(n_in=8, n_out=8, activation="tanh")
    out = layers.OutputLayer(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent")
    if not graph:
        return b.list().layer(dense).layer(mid).layer(out).build()
    return (b.graph_builder().add_inputs("in").add_layer("d", dense, "in")
            .add_layer("m", mid, "d").add_layer("o", out, "m")
            .set_outputs("o").build())


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("case", ["plain", "dropout", "bn", "solver",
                                  "iterations_2"])
def test_fuse_allowed_agrees_with_the_reference(case, graph):
    jconf = _gate_conf(JBuilder.Builder(), jlayers, jgraph, case, graph)
    pconf = _gate_conf(NeuralNetConfiguration.Builder(), players, pgraph,
                       case, graph)
    assert pconf.to_json() == jconf.to_json()
    jl = jconf.layer_confs() if graph else jconf.layers
    pl = pconf.layer_confs() if graph else pconf.layers
    assert fuse_allowed(pconf, pl) == jfuse_allowed(jconf, jl) == \
        (case in ("plain", "dropout"))
