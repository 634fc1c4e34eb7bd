"""The port's scaleout stack (``parallel/training_master.py``,
``parallel/param_server_wrapper.py``, ``parallel/worker.py``,
``parallel/coordinator.py``) on the CPU, held against the reference's.

Mirrors ``tests/test_distributed.py`` and the coordinator cases of
``tests/test_elastic.py`` and ``tests/test_faults.py``:

- one worker with ``averaging_frequency=1`` is bit for bit the port's
  own ``fit_batch`` over the same batches (the updater vector within
  1e-6), and within 1e-5 of the reference's DistributedMultiLayerNetwork
  from the same starting parameters; several workers average as the
  reference's do (1e-5); three workers on SGD equal one big batch (1e-5);
- a worker's error surfaces instead of hanging; a short final split is
  not diluted; rebatching; the hooks; the JSON/YAML round trip (also
  read by the reference); a ComputationGraph; Export files read across
  packages; Export mode with two ``--device cpu`` worker processes;
- the parameter server: one trainer at ``pull_frequency=1`` equals
  sequential ``fit_batch`` (1e-5) and the reference's wrapper (1e-5);
  three trainers lower the loss; elastic departures;
- the Python coordinator: the re-form wave, a wave without a driver, a
  stale epoch, a non-elastic coordinator, an expelled straggler, the
  round deadline, a dead peer (``drop-conn``), a dead coordinator, a
  refused connection, size mismatches.

Both packages start from the reference's initial parameters (the flat
vector carried over); nothing is re-initialised and compared across
packages.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

import deeplearning4j_tpu as jpkg
import deeplearning4j_tpu.nn.conf.multi_layer  # noqa: F401
import deeplearning4j_tpu_torch as ppkg
import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JGraph
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import training_master as jtm
from deeplearning4j_tpu.parallel.param_server_wrapper import \
    ParameterServerParallelWrapper as JPS
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.errors import (CollectiveTimeoutError,
                                             PeerDeadError, WorldChangedError)
from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import training_master as ptm
from deeplearning4j_tpu_torch.parallel.coordinator import (
    PyCollectiveClient, PyCoordinator, _retry_connect)
from deeplearning4j_tpu_torch.parallel.param_server_wrapper import \
    ParameterServerParallelWrapper
from deeplearning4j_tpu_torch.parallel.training_master import (
    DistributedComputationGraph, DistributedMultiLayerNetwork,
    ParameterAveragingTrainingMaster, TrainingHook, _updater_vec)
from deeplearning4j_tpu_torch.testing import faults

HOST = "127.0.0.1"
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _conf(pkg, seed=12, updater="adam", lr=0.05):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(seed).learning_rate(lr).updater(updater)
            .list()
            .layer(L.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())


def _graph_conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(12).learning_rate(0.05).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("d", L.DenseLayer(n_in=4, n_out=8,
                                         activation="tanh"), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss="mcxent"), "d")
            .set_outputs("out").build())


def _data(n=64, seed=12345):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return X, Y


def _batches(X, Y, b=16, cls=DataSet):
    return [cls(X[i:i + b], Y[i:i + b]) for i in range(0, len(X), b)]


def _pair(**kw):
    """The reference's net and the port's (on the CPU) from the
    reference's initial parameters."""
    jnet = JNet(_conf(jpkg, **kw)).init()
    pnet = MultiLayerNetwork(_conf(ppkg, **kw), device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    return jnet, pnet


def _port_net(**kw):
    return MultiLayerNetwork(_conf(ppkg, **kw), device="cpu").init()


# ---- Export files ----------------------------------------------------------
class TestExportFiles:
    def test_dataset_roundtrip(self, tmp_path):
        X, Y = _data(8)
        mask = np.ones((8, 5), np.float32)
        p = str(tmp_path / "b.npz")
        ptm.save_dataset(DataSet(X, Y, features_mask=mask), p)
        back = ptm.load_dataset(p)
        np.testing.assert_array_equal(back.features, X)
        np.testing.assert_array_equal(back.labels, Y)
        np.testing.assert_array_equal(back.features_mask, mask)
        assert back.labels_mask is None

    def test_multidataset_roundtrip(self, tmp_path):
        rng = np.random.RandomState(1)
        mds = MultiDataSet([rng.rand(4, 3), rng.rand(4, 2)], [rng.rand(4, 1)])
        p = str(tmp_path / "m.npz")
        ptm.save_dataset(mds, p)
        back = ptm.load_dataset(p)
        assert isinstance(back, MultiDataSet)
        assert len(back.features) == 2 and len(back.labels) == 1
        np.testing.assert_array_equal(back.features[1], mds.features[1])

    @pytest.mark.parametrize("writer", ["port", "reference"])
    @pytest.mark.parametrize("kind", ["dataset", "multidataset"])
    def test_files_read_across_packages(self, tmp_path, writer, kind):
        rng = np.random.RandomState(2)
        mask = np.ones((4, 6), np.float32)
        wmod, rmod = (ptm, jtm) if writer == "port" else (jtm, ptm)
        if kind == "dataset":
            ds = (DataSet if writer == "port" else jpkg.datasets.dataset
                  .DataSet)(rng.rand(4, 6), rng.rand(4, 2), None, mask)
        else:
            ds = (MultiDataSet if writer == "port" else JMultiDataSet)(
                [rng.rand(4, 3), rng.rand(4, 2)], [rng.rand(4, 1)],
                [None, mask[:, :2]], None)
        p = str(tmp_path / "x.npz")
        wmod.save_dataset(ds, p)
        back = rmod.load_dataset(p)
        if kind == "dataset":
            for k in ("features", "labels", "labels_mask", "features_mask"):
                a, b = getattr(ds, k), getattr(back, k)
                assert (a is None) == (b is None), k
                if a is not None:
                    np.testing.assert_array_equal(b, a)
        else:
            for a, b in zip(ds.features + ds.labels,
                            back.features + back.labels):
                np.testing.assert_array_equal(b, a)
            assert back.features_masks[0] is None
            np.testing.assert_array_equal(back.features_masks[1], mask[:, :2])
            assert back.labels_masks is None

    def test_export_splits_clears_stale_batches(self, tmp_path):
        tm = ParameterAveragingTrainingMaster(n_workers=1,
                                              batch_size_per_worker=4)
        X, Y = _data(12)
        ds = _batches(X, Y, 4)
        tm._export_splits([ds], str(tmp_path))
        d = tmp_path / "worker_0" / "split_0"
        assert len(list(d.glob("batch_*.npz"))) == 3
        tm._export_splits([ds[:1]], str(tmp_path))  # a smaller re-export
        assert len(list(d.glob("batch_*.npz"))) == 1


# ---- parameter averaging ----------------------------------------------------
class TestParameterAveraging:
    def test_single_worker_bitwise_its_own_fit_batch(self):
        """The reference's gate on the port alone: one worker, averaging
        every batch, is plain fit_batch bit for bit."""
        X, Y = _data()
        batches = _batches(X, Y)
        local = _port_net()
        for ds in batches:
            local.fit_batch(ds.features, ds.labels)
        master = ParameterAveragingTrainingMaster(
            n_workers=1, batch_size_per_worker=16, averaging_frequency=1)
        dist = DistributedMultiLayerNetwork(_port_net(), master)
        dist.fit(batches)
        np.testing.assert_array_equal(local.params(), dist.network.params())
        np.testing.assert_allclose(_updater_vec(local),
                                   _updater_vec(dist.network), rtol=0,
                                   atol=1e-6)
        assert dist.network.iteration == local.iteration == 4
        assert master.coordinator_kind == "native"

    @pytest.mark.parametrize("n_workers,freq,n", [(1, 1, 64), (3, 2, 96),
                                                  (2, 1, 72)])
    def test_matches_reference_master(self, n_workers, freq, n):
        """The port's master and the reference's, from the same
        parameters over the same batches (72 rows: a short final split
        and a short last batch)."""
        X, Y = _data(n)
        jnet, pnet = _pair()
        kw = dict(n_workers=n_workers, batch_size_per_worker=16,
                  averaging_frequency=freq)
        jtm.DistributedMultiLayerNetwork(
            jnet, jtm.ParameterAveragingTrainingMaster(**kw)).fit(
                _batches(X, Y, cls=jpkg.datasets.dataset.DataSet))
        DistributedMultiLayerNetwork(
            pnet, ParameterAveragingTrainingMaster(**kw)).fit(_batches(X, Y))
        np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(_updater_vec(pnet),
                                   np.asarray(jtm._updater_vec(jnet)),
                                   rtol=0, atol=TOL)
        assert pnet.iteration == jnet.iteration
        assert abs(pnet.score_ - float(jnet.score_)) <= TOL

    def test_multi_worker_averaging(self):
        X, Y = _data(96)
        net = _port_net()
        p0 = net.params().copy()
        DistributedMultiLayerNetwork(net, ParameterAveragingTrainingMaster(
            n_workers=3, batch_size_per_worker=16,
            averaging_frequency=2)).fit(_batches(X, Y))
        assert not np.allclose(p0, net.params())
        assert net.score_ is not None and np.isfinite(net.score_)
        assert net.iteration == 2   # one split of 3 x 2 batches

    def test_three_workers_match_one_worker_big_batch(self):
        """N workers averaging every step are one step on the N-fold
        batch (SGD without momentum)."""
        X, Y = _data(48)
        dist = _port_net(seed=5, updater="sgd", lr=0.1)
        DistributedMultiLayerNetwork(dist, ParameterAveragingTrainingMaster(
            n_workers=3, batch_size_per_worker=16,
            averaging_frequency=1)).fit(_batches(X, Y))
        big = _port_net(seed=5, updater="sgd", lr=0.1)
        big.fit_batch(X, Y)
        np.testing.assert_allclose(dist.params(), big.params(), rtol=0,
                                   atol=TOL)

    def test_many_thread_workers_under_a_short_switch_interval(self):
        """More workers than cores, the interpreter switching threads
        every microsecond: twelve workers averaging every batch are still
        one SGD step on the twelve-fold batch."""
        import sys
        X, Y = _data(48)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            dist = _port_net(seed=5, updater="sgd", lr=0.1)
            DistributedMultiLayerNetwork(
                dist, ParameterAveragingTrainingMaster(
                    n_workers=12, batch_size_per_worker=4,
                    averaging_frequency=1, join_timeout=60.0)).fit(
                        _batches(X, Y, 4))
        finally:
            sys.setswitchinterval(interval)
        big = _port_net(seed=5, updater="sgd", lr=0.1)
        big.fit_batch(X, Y)
        np.testing.assert_allclose(dist.params(), big.params(), rtol=0,
                                   atol=TOL)
        assert dist.iteration == 1

    def test_iterator_input_and_stats(self, tmp_path):
        X, Y = _data()
        master = ParameterAveragingTrainingMaster(
            n_workers=2, batch_size_per_worker=16, averaging_frequency=1,
            collect_training_stats=True)
        DistributedMultiLayerNetwork(_port_net(), master).fit(
            ArrayDataSetIterator(X, Y, batch_size=16))
        assert {"split", "broadcast", "aggregate"} <= {p for p, _ in
                                                       master.stats}
        out = master.stats_html(str(tmp_path / "stats.html"))
        assert "Training phase timings" in open(out).read()

    def test_computation_graph_matches_reference(self):
        X, Y = _data(64)
        jg = JGraph(_graph_conf(jpkg)).init()
        pg = ComputationGraph(_graph_conf(ppkg), device="cpu").init()
        pg.set_params(np.asarray(jg.params()))
        kw = dict(n_workers=2, batch_size_per_worker=16,
                  averaging_frequency=1)
        jtm.DistributedComputationGraph(
            jg, jtm.ParameterAveragingTrainingMaster(**kw)).fit(
                [JMultiDataSet([X[i:i + 16]], [Y[i:i + 16]])
                 for i in range(0, 64, 16)])
        DistributedComputationGraph(
            pg, ParameterAveragingTrainingMaster(**kw)).fit(
                _batches(X, Y, cls=lambda x, y: MultiDataSet([x], [y])))
        np.testing.assert_allclose(pg.params(), np.asarray(jg.params()),
                                   rtol=0, atol=TOL)
        assert pg.iteration == 2

    def test_conf_builds_the_network_on_the_device(self):
        dist = DistributedMultiLayerNetwork(
            _conf(ppkg), ParameterAveragingTrainingMaster(n_workers=1),
            device="cpu")
        assert dist.network.device.type == "cpu"
        graph = DistributedComputationGraph(
            _graph_conf(ppkg), ParameterAveragingTrainingMaster(n_workers=1),
            device="cpu")
        assert graph.network.params_list is not None


class TestFailureHandling:
    def test_worker_exception_surfaces_not_hangs(self):
        X, Y = _data(32)
        bad = [DataSet(X[:16], Y[:16]),
               DataSet(np.random.RandomState(3).rand(16, 9).astype(
                   np.float32), Y[16:])]   # the wrong n_in
        t0 = time.monotonic()
        with pytest.raises(Exception):
            DistributedMultiLayerNetwork(
                _port_net(), ParameterAveragingTrainingMaster(
                    n_workers=2, batch_size_per_worker=16)).fit(bad)
        assert time.monotonic() - t0 < 60

    def test_partial_final_split_not_diluted(self):
        """One batch on three workers: only worker 0 trains, and the
        result is its fit, not a third of it."""
        X, Y = _data(16)
        local = _port_net()
        local.fit_batch(X, Y)
        net = _port_net()
        DistributedMultiLayerNetwork(net, ParameterAveragingTrainingMaster(
            n_workers=3, batch_size_per_worker=16)).fit([DataSet(X, Y)])
        np.testing.assert_array_equal(local.params(), net.params())

    def test_rebatch_honors_batch_size(self):
        X, Y = _data(64)
        master = ParameterAveragingTrainingMaster(n_workers=2,
                                                  batch_size_per_worker=16)
        batches = master._batches(ArrayDataSetIterator(X, Y, batch_size=64))
        assert len(batches) == 4
        assert all(b.num_examples() == 16 for b in batches)
        assert len(master._batches(DataSet(X, Y))) == 4

    def test_join_raises_on_hung_worker_thread(self):
        tm = ParameterAveragingTrainingMaster(n_workers=1, join_timeout=0.2)
        ev = threading.Event()
        hung = threading.Thread(target=ev.wait, daemon=True)
        hung.start()
        try:
            with pytest.raises(RuntimeError, match="still alive"):
                tm._join_workers(("thread", [hung], []))
        finally:
            ev.set()

    def test_hooks_refused_in_process_mode(self):
        with pytest.raises(ValueError, match="thread"):
            ParameterAveragingTrainingMaster(mode="process",
                                             training_hooks=[TrainingHook()])


def test_hooks_fire_per_minibatch():
    calls = []

    class Recorder(TrainingHook):
        def pre_update(self, minibatch, model):
            calls.append(("pre", minibatch.features.shape[0]))

        def post_update(self, minibatch, model):
            calls.append(("post", float(model.score_)))

    X, Y = _data(32)
    ParameterAveragingTrainingMaster(
        n_workers=2, batch_size_per_worker=8,
        training_hooks=[Recorder()]).execute_training(_port_net(),
                                                      DataSet(X, Y))
    pres = [c for c in calls if c[0] == "pre"]
    posts = [c for c in calls if c[0] == "post"]
    assert len(pres) == len(posts) == 4   # 32 examples, batch 8
    assert all(p[1] == 8 for p in pres)
    assert all(np.isfinite(p[1]) for p in posts)


@pytest.mark.parametrize("form", ["json", "yaml"])
def test_json_yaml_round_trip_read_by_reference(form):
    tm = ParameterAveragingTrainingMaster(
        n_workers=4, batch_size_per_worker=16, averaging_frequency=3,
        mode="process", average_updaters=False, collect_training_stats=True,
        worker_env={"OMP_NUM_THREADS": "1"})
    text = getattr(tm, f"to_{form}")()
    back = getattr(ParameterAveragingTrainingMaster, f"from_{form}")(text)
    assert back.to_dict() == tm.to_dict()
    ref = getattr(jtm.ParameterAveragingTrainingMaster, f"from_{form}")(text)
    assert ref.to_dict() == tm.to_dict()
    if form == "json":
        assert '"averaging_frequency": 3' in text


def test_export_mode_two_cpu_worker_processes(tmp_path):
    """Export mode with two worker processes on the CPU (``--device
    cpu``) gives the thread mode's parameters (1e-6), and each worker
    leaves its kernel launch counts beside its data."""
    X, Y = _data(64)
    batches = _batches(X, Y)
    kw = dict(n_workers=2, batch_size_per_worker=16, averaging_frequency=1)
    threads = _port_net()
    DistributedMultiLayerNetwork(
        threads, ParameterAveragingTrainingMaster(**kw)).fit(batches)
    procs = _port_net()
    master = ParameterAveragingTrainingMaster(
        mode="process", export_dir=str(tmp_path / "export"),
        worker_env={"OMP_NUM_THREADS": "1"}, **kw)
    DistributedMultiLayerNetwork(procs, master).fit(batches)
    assert sorted(p.name for p in (tmp_path / "export").iterdir()) == \
        ["worker_0", "worker_0.log", "worker_1", "worker_1.log"]
    np.testing.assert_allclose(procs.params(), threads.params(), rtol=0,
                               atol=1e-6)
    assert procs.iteration == threads.iteration == 2
    # each worker leaves its launch counts: none on the CPU
    for w in range(2):
        counts = json.loads((tmp_path / "export" / f"worker_{w}" /
                             "kernel_launches.json").read_text())
        assert set(counts.values()) == {0}, counts


# ---- the parameter server ---------------------------------------------------
class TestParameterServer:
    def test_single_trainer_matches_sequential_and_reference(self):
        X, Y = _data()
        jnet, pnet = _pair()
        local = _port_net()
        local.set_params(pnet.params())
        for ds in _batches(X, Y):
            local.fit_batch(ds.features, ds.labels)
        wrapper = ParameterServerParallelWrapper(pnet, workers=1)
        wrapper.fit(iter(_batches(X, Y)))
        assert wrapper.coordinator_kind == "native"
        JPS(jnet, workers=1).fit(iter(_batches(
            X, Y, cls=jpkg.datasets.dataset.DataSet)))
        np.testing.assert_allclose(pnet.params(), local.params(), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                                   rtol=0, atol=TOL)

    def test_async_training_reduces_loss(self):
        rng = np.random.RandomState(7)
        n = 128
        cls = rng.randint(0, 3, n)
        X = (rng.randn(n, 4) * 0.3 + np.stack(
            [cls, 2 - cls, cls * 0.5, 1 - cls], axis=1)).astype(np.float32)
        Y = np.eye(3, dtype=np.float32)[cls]
        base = _port_net()
        base.fit_batch(X, Y)
        start = base.score_
        net = _port_net()
        ParameterServerParallelWrapper(net, workers=3, pull_frequency=1).fit(
            ArrayDataSetIterator(X, Y, batch_size=16), epochs=6)
        net.fit_batch(X, Y)
        assert net.score_ < start * 0.7, (start, net.score_)

    def test_trainer_exception_surfaces(self):
        X, Y = _data(64)
        bad = _batches(X, Y)
        bad[2] = DataSet(np.random.RandomState(4).rand(16, 9).astype(
            np.float32), Y[:16])
        with pytest.raises(Exception):
            ParameterServerParallelWrapper(_port_net(), workers=2,
                                           prefetch_buffer=2).fit(iter(bad))


class TestElasticParamServer:
    """Departed trainers hand their batches to the survivors."""

    @staticmethod
    def _batches(n=12):
        X, Y = _data(n * 8, seed=3)
        return _batches(X, Y, 8)

    def test_departed_trainer_reassigns_batches(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_ELASTIC", "1")
        net = _port_net()
        p0 = net.params().copy()
        # worker 1's 3rd wire request fails: it departs, and the fit
        # still trains every batch on a survivor
        with faults.inject("drop-conn[1]@2"):
            ParameterServerParallelWrapper(net, workers=2,
                                           prefer_native=False).fit(
                iter(self._batches()))
        p1 = net.params()
        assert np.isfinite(p1).all() and np.abs(p1 - p0).max() > 0

    def test_all_departed_raises_typed(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_ELASTIC", "1")
        with faults.inject("drop-conn[0]@2,drop-conn[1]@2"):
            with pytest.raises(PeerDeadError, match="departed"):
                ParameterServerParallelWrapper(
                    _port_net(), workers=2, prefer_native=False).fit(
                        iter(self._batches(40)))

    def test_non_elastic_death_still_raises(self):
        with faults.inject("drop-conn[1]@2"):
            with pytest.raises((ConnectionError, OSError)):
                ParameterServerParallelWrapper(
                    _port_net(), workers=2, prefer_native=False).fit(
                        iter(self._batches(40)))


# ---- the Python coordinator's fault model ------------------------------------
def _coord(n, timeout=5.0, reform_timeout=6.0):
    return PyCoordinator(n, timeout=timeout, elastic=True,
                         reform_timeout=reform_timeout)


def _threads(fns):
    ts = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts), "a participant hung"


class TestReformProtocol:
    def test_wave_commits_contiguous_ranks_and_world(self):
        out = {}
        with _coord(3, reform_timeout=2.0) as coord:
            def member(wid, driver):
                c = PyCollectiveClient(HOST, coord.port, wid, timeout=5.0)
                out[wid] = c.reform(2.0, driver=driver)
                c.close()
            _threads([lambda w=w: member(w, w == 0) for w in (0, 5, 9)])
            assert all(v[0] == 1 and v[2] == 3 for v in out.values())
            assert [out[w][1] for w in (0, 5, 9)] == [0, 1, 2]
            assert coord.n_workers == 3 and coord.epoch == 1

    def test_wave_without_driver_fails_typed(self):
        with _coord(2, reform_timeout=0.5) as coord:
            with PyCollectiveClient(HOST, coord.port, 1, timeout=5.0) as c:
                with pytest.raises(CollectiveTimeoutError, match="driver"):
                    c.reform(0.5)

    def test_stale_epoch_connection_gets_world_changed(self):
        with _coord(2, reform_timeout=1.0) as coord:
            stale = PyCollectiveClient(HOST, coord.port, 1, timeout=5.0)
            fresh = PyCollectiveClient(HOST, coord.port, 0, timeout=5.0)
            try:
                fresh.reform(1.0, driver=True)   # the epoch moves to 1
                with pytest.raises(WorldChangedError, match="epoch"):
                    stale.allreduce(np.zeros(1, np.float32))
            finally:
                stale.close()
                fresh.close()

    def test_non_elastic_coordinator_rejects_reform(self):
        with PyCoordinator(1, elastic=False, timeout=5.0) as coord:
            with PyCollectiveClient(HOST, coord.port, 0, timeout=5.0) as c:
                with pytest.raises(RuntimeError, match="elastic"):
                    c.reform(1.0, driver=True)

    def test_straggler_is_expelled_not_retried(self):
        with _coord(2, timeout=0.6) as coord:
            a = PyCollectiveClient(HOST, coord.port, 0, timeout=0.6)
            b = PyCollectiveClient(HOST, coord.port, 1, timeout=0.6)
            try:
                with pytest.raises(CollectiveTimeoutError):
                    a.allreduce(np.zeros(1, np.float32))   # b never comes
                assert 1 in coord._dead
                with pytest.raises((ConnectionError, OSError,
                                    CollectiveTimeoutError)):
                    b.allreduce(np.zeros(1, np.float32))
            finally:
                a.close()
                b.close()


class TestCoordinatorFaults:
    def test_round_times_out_instead_of_hanging(self):
        with PyCoordinator(2, timeout=0.5) as coord:
            with PyCollectiveClient(HOST, coord.port, 0, timeout=0.5) as c:
                t0 = time.monotonic()
                with pytest.raises(CollectiveTimeoutError, match="timed out"):
                    c.barrier(tag="alone")
                assert time.monotonic() - t0 < 5.0

    def test_dropped_peer_fails_survivors_within_deadline(self):
        """Worker 2 drops its connection instead of sending its part: the
        survivors get a typed peer death well inside the deadline, and a
        fresh wave completes afterwards."""
        with PyCoordinator(3, timeout=30.0) as coord:
            out = {}

            def run(wid):
                try:
                    with PyCollectiveClient(HOST, coord.port, wid,
                                            timeout=30.0) as c:
                        out[wid] = c.allreduce(np.ones(4, np.float32),
                                               tag="doomed")
                except Exception as e:   # held below
                    out[wid] = e
            t0 = time.monotonic()
            with faults.inject("drop-conn[2]@1"):   # request 0 is the JOIN
                _threads([lambda w=w: run(w) for w in range(3)])
            assert time.monotonic() - t0 < coord.timeout
            for wid in (0, 1):
                assert isinstance(out[wid], PeerDeadError), out
                assert "peer death" in str(out[wid])
            assert isinstance(out[2], ConnectionError)
            clients = [PyCollectiveClient(HOST, coord.port, w, timeout=30.0)
                       for w in range(3)]
            healed = {}
            try:
                _threads([lambda w=w, c=c: healed.__setitem__(
                    w, c.allreduce(np.full(4, w + 1.0, np.float32),
                                   tag="healed"))
                    for w, c in enumerate(clients)])
            finally:
                for c in clients:
                    c.close()
            for wid in range(3):
                np.testing.assert_array_equal(healed[wid],
                                              np.full(4, 6.0, np.float32))

    def test_dead_coordinator_raises_on_client(self):
        srv = socket.socket()
        srv.bind((HOST, 0))
        srv.listen(1)
        try:
            with pytest.raises(CollectiveTimeoutError, match="no response"):
                PyCollectiveClient(HOST, srv.getsockname()[1], 0, timeout=0.3)
        finally:
            srv.close()

    def test_connect_refused_raises_after_retries(self):
        srv = socket.socket()
        srv.bind((HOST, 0))
        port = srv.getsockname()[1]
        srv.close()
        with pytest.raises(OSError):
            PyCollectiveClient(HOST, port, 0, timeout=1.0,
                               connect_timeout=0.2, connect_retries=2)

    def test_retry_connect_backs_off_then_succeeds(self):
        attempts = []

        def flaky():
            attempts.append(time.monotonic())
            if len(attempts) < 3:
                raise ConnectionRefusedError("not yet")
            return "up"
        assert _retry_connect(flaky, retries=4, what="test") == "up"
        assert len(attempts) == 3

    def test_size_mismatches_fail_whole_round(self):
        with PyCoordinator(2, timeout=5.0) as coord:
            results = {}

            def worker(wid, n):
                with PyCollectiveClient(HOST, coord.port, wid,
                                        timeout=5.0) as c:
                    try:
                        c.allreduce(np.ones(n, np.float32), tag="mism")
                        results[wid] = "ok"
                    except RuntimeError as e:
                        results[wid] = str(e)
            _threads([lambda: worker(0, 4), lambda: worker(1, 6)])
            assert all("mismatch" in results[w] for w in (0, 1)), results
            with PyCollectiveClient(HOST, coord.port, 0, timeout=5.0) as c:
                with pytest.raises(RuntimeError,
                                   match="ps_pull before ps_init"):
                    c.ps_pull(4)
                c.ps_init(np.zeros(4, np.float32))
                with pytest.raises(RuntimeError,
                                   match=r"got 6 floats.*holds 4"):
                    c.ps_push(np.zeros(6, np.float32))
