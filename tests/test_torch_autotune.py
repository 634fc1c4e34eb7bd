"""The fusion autotuner (``tuning/autotuner.py``) against the JAX
package's, after ``tests/test_fuse_autotune.py``.

In the port K does not change what is captured (each window is one
graph whatever K is): K sets the group size only. So the checks that
stand for the reference's "losers leave the compile cache" are one
window graph per bucket and, on the card, 0 captures in a timed fit
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
``fused_autotune``). Tolerances: the ladder and the chunks equal the
reference's exactly; the autotuned fit equals the pinned winner bitwise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.tuning import autotuner as jtuner
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       StackedDataSet)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.tuning import autotuner


def make_data(n=256, d=4, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


def mlp(seed=1, dropout=None):
    conf = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
            .updater("sgd").list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="relu",
                              dropout=dropout))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def probes_total():
    return obs.metrics.value("fuse.autotune_probes_total")


@pytest.fixture
def tuned_env(monkeypatch, tmp_path):
    """The tuner armed with a small ladder and its own disk cache; the
    in-memory decisions are dropped on both sides of the test."""
    monkeypatch.delenv("DL4J_TORCH_FUSE_STEPS", raising=False)
    monkeypatch.setenv("DL4J_TORCH_FUSE_AUTOTUNE", "1")
    monkeypatch.setenv("DL4J_TORCH_FUSE_PROBE_KS", "1,2,4")
    monkeypatch.setenv("DL4J_TORCH_TUNE_CACHE_DIR", str(tmp_path))
    autotuner._reset_for_tests()
    yield tmp_path
    autotuner._reset_for_tests()


def test_explicit_fuse_steps_wins_over_autotune(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_FUSE_AUTOTUNE", "1")
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "8")
    assert not autotuner.autotune_active()
    monkeypatch.delenv("DL4J_TORCH_FUSE_STEPS")
    assert autotuner.autotune_active()
    monkeypatch.setenv("DL4J_TORCH_FUSE_AUTOTUNE", "0")
    assert not autotuner.autotune_active()


@pytest.mark.parametrize("raw", ["8,2,2,4", "16", " 3, 1 ,", "0,-2,5", "",
                                 "banana"])
def test_ladder_parses_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("DL4J_TORCH_FUSE_PROBE_KS", raw)
    monkeypatch.setenv("DL4J_TPU_FUSE_PROBE_KS", raw)
    with pytest.warns(UserWarning) if raw == "banana" else \
            _no_warning():
        got = autotuner.candidate_ladder()
    with pytest.warns(UserWarning) if raw == "banana" else _no_warning():
        want = jtuner.candidate_ladder()
    assert got == want
    assert autotuner.probe_group_steps() == jtuner.probe_group_steps()


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("n_real,k", [(4, 3), (4, 2), (3, 2), (1, 3),
                                      (4, 4), (2, 3)])
def test_chunk_matches_the_reference(n_real, k):
    """Re-chunking a 4-step group (two streams) to K: the same chunks,
    arrays, weights and real-step counts as the reference's ``_chunk``."""
    r = np.random.RandomState(n_real * 10 + k)
    xs = [r.rand(4, 3, 2).astype(np.float32), r.rand(4, 3).astype(np.float32)]
    ys = [r.rand(4, 3, 5).astype(np.float32)]
    ews = np.ones((4, 3), np.float32)
    ews[n_real:] = 0.0
    got = autotuner._chunk([torch.from_numpy(a) for a in xs],
                           [torch.from_numpy(a) for a in ys],
                           torch.from_numpy(ews), n_real, k)
    want = jtuner._chunk([jnp.asarray(a) for a in xs],
                         [jnp.asarray(a) for a in ys], jnp.asarray(ews),
                         n_real, k)
    assert len(got) == len(want)
    for (gx, gy, gw, gn), (wx, wy, ww, wn) in zip(got, want):
        assert gn == wn
        for a, b in zip(gx + gy + [gw], list(wx) + list(wy) + [ww]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_probe_decides_persists_and_keeps_one_window_graph(tuned_env):
    x, y = make_data()   # 8 batches of 32; the probe group is 4
    p0 = probes_total()
    net = mlp()
    net.fit(ArrayDataSetIterator(x, y, batch_size=32))
    assert probes_total() - p0 == 3          # ladder 1/2/4, once each
    assert net.iteration == 8                # probing trained no batch
    assert len(net._fused.graphs) == 1
    files = os.listdir(tuned_env)
    assert len(files) == 1 and files[0].endswith("_cpu.json")
    doc = json.loads((tuned_env / files[0]).read_text())
    ((bucket, entry),) = doc["decisions"].items()
    assert bucket == repr(("ds", (32, 4), (32, 3)))
    assert entry["k"] in (1, 2, 4)
    assert set(entry["per_step_s"]) == {"1", "2", "4"}
    assert obs.metrics.value("fuse.selected_k") == entry["k"]


def test_cache_roundtrip_restarted_process_skips_the_probe(tuned_env):
    x, y = make_data()
    mlp().fit(ArrayDataSetIterator(x, y, batch_size=32))
    p0 = probes_total()
    autotuner._reset_for_tests()              # a process restart
    net2 = mlp(seed=9)
    net2.fit(ArrayDataSetIterator(x, y, batch_size=32))
    assert probes_total() == p0
    assert net2.iteration == 8


@pytest.mark.parametrize("dropout", [None, 0.6])
def test_autotuned_fit_bitwise_equals_pinned_winner(tuned_env, monkeypatch,
                                                    dropout):
    """The probe's zero-weight groups leave no trace: the autotuned fit
    equals a fit pinned at the decided K, dropout counter included."""
    x, y = make_data()
    a = mlp(seed=5, dropout=dropout)
    a.fit(ArrayDataSetIterator(x, y, batch_size=32))
    (entry,) = json.loads(
        (tuned_env / os.listdir(tuned_env)[0]).read_text())[
            "decisions"].values()
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(entry["k"]))
    monkeypatch.setenv("DL4J_TORCH_FUSE_AUTOTUNE", "0")
    b = mlp(seed=5, dropout=dropout)
    b.fit(ArrayDataSetIterator(x, y, batch_size=32))
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.dropout_draws == b.dropout_draws == 8
    assert a.iteration == b.iteration == 8


def test_autotuned_fit_pinned_at_every_rung(tuned_env, monkeypatch):
    """Whatever K wins, the run is the pinned run at that K: force each
    rung by a decision recorded before the fit."""
    x, y = make_data()
    for k in (1, 2, 4):
        autotuner._reset_for_tests()
        a = mlp(seed=6)
        autotuner.record_decision(autotuner.model_key(a), "cpu",
                                  ("ds", (32, 4), (32, 3)), k, {k: 1e-3})
        p0 = probes_total()
        a.fit(ArrayDataSetIterator(x, y, batch_size=32))
        assert probes_total() == p0
        monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
        b = mlp(seed=6)
        b.fit(ArrayDataSetIterator(x, y, batch_size=32))
        monkeypatch.delenv("DL4J_TORCH_FUSE_STEPS")
        np.testing.assert_array_equal(a.params(), b.params())


def test_corrupt_cache_file_is_ignored_and_rewritten(tuned_env):
    x, y = make_data()
    mlp().fit(ArrayDataSetIterator(x, y, batch_size=32))
    (path,) = [tuned_env / f for f in os.listdir(tuned_env)]
    path.write_text("{ not json")
    autotuner._reset_for_tests()
    p0 = probes_total()
    with pytest.warns(UserWarning, match="tune cache"):
        mlp(seed=3).fit(ArrayDataSetIterator(x, y, batch_size=32))
    assert probes_total() - p0 == 3
    assert json.loads(path.read_text())["decisions"]


def test_inflight_probe_group_rechunked_to_decided_k(tuned_env):
    """``plan_fused`` on a probe-size group after a decision k < 4 splits
    it into chunks of k, the remainder padded with zero-weight steps; a
    partial group smaller than the decision passes through."""
    net = mlp()
    x, y = make_data(n=32, seed=2)
    xs = [torch.from_numpy(np.stack([x[i * 8:(i + 1) * 8]
                                     for i in range(4)]))]
    ys = [torch.from_numpy(np.stack([y[i * 8:(i + 1) * 8]
                                     for i in range(4)]))]
    ews = torch.ones(4, 8)
    bucket = ("ds", (8, 4), (8, 3))
    autotuner.record_decision(autotuner.model_key(net), "cpu", bucket, 3,
                              {3: 1e-3})
    plan = autotuner.plan_fused(net, xs, ys, ews, 4, True, bucket)
    assert [c[3] for c in plan] == [3, 1]
    assert all(tuple(c[0][0].shape) == (3, 8, 4) for c in plan)
    w = plan[1][2].numpy()
    assert w[0].min() == 1.0 and w[1:].max() == 0.0
    small = autotuner.plan_fused(net, [a[:2] for a in xs],
                                 [a[:2] for a in ys], ews[:2], 2, True,
                                 bucket)
    assert len(small) == 1 and tuple(small[0][0][0].shape) == (2, 8, 4)
    # through fit_fused: the 4 real steps train as the chunks say
    net._fuse_autotune = True
    try:
        net.fit_fused(StackedDataSet(xs[0], ys[0], ews, 4))
    finally:
        net._fuse_autotune = False
    assert net.iteration == 4


def test_partial_groups_warn_once_when_no_group_reaches_the_probe(
        tuned_env):
    """A bucket whose groups never reach the probe size stays untuned;
    the third such dispatch warns, once."""
    net = mlp()
    xs = [torch.zeros(2, 8, 4)]
    ys = [torch.zeros(2, 8, 3)]
    ews = torch.ones(2, 8)
    bucket = ("ds", (8, 4), (8, 3))
    with pytest.warns(UserWarning, match="below the probe size"):
        for _ in range(3):
            plan = autotuner.plan_fused(net, xs, ys, ews, 2, True, bucket)
            assert len(plan) == 1
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        autotuner.plan_fused(net, xs, ys, ews, 2, True, bucket)


def test_bucket_keys_agree_with_the_prefetcher():
    """The consumer's key of a stacked group is the worker's key of one
    of its batches, for DataSet and MultiDataSet groups."""
    from deeplearning4j_tpu_torch.datasets.async_iterator import (
        AsyncDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, MultiDataSet, StackedMultiDataSet)
    ds = DataSet(np.zeros((8, 4), np.float32), np.zeros((8, 3), np.float32))
    st = StackedDataSet(np.zeros((2, 8, 4)), np.zeros((2, 8, 3)),
                        np.ones((2, 8)), 2)
    assert autotuner.stacked_bucket_key(st) == \
        AsyncDataSetIterator._shapes_of(ds)
    mds = MultiDataSet([np.zeros((8, 4)), np.zeros((8, 2, 5))],
                       [np.zeros((8, 3))])
    smd = StackedMultiDataSet([np.zeros((2, 8, 4)), np.zeros((2, 8, 2, 5))],
                              [np.zeros((2, 8, 3))], np.ones((2, 8)), 2)
    assert autotuner.stacked_bucket_key(smd) == \
        AsyncDataSetIterator._shapes_of(mds)
