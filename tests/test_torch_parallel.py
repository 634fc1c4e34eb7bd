"""The port's data-parallel surface against the reference's, without a
world (the sharding core's rules, the iterator's and the wrapper's row
handling, a collective's failure) and with one: the CLI at world 2, two
processes over gloo on the CPU, against the reference's CLI at
``--workers 2`` on its virtual mesh. Mirrors ``tests/test_sharding_core.py``
and ``tests/test_multihost.py``; the training matrix is
``tests/test_torch_dp_shard.py``'s."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import sharding_core as jcore
from deeplearning4j_tpu.parallel.sharding_core import build_mesh as jmesh
from deeplearning4j_tpu_torch.datasets.async_iterator import \
    AsyncDataSetIterator
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel import sharding_core as pcore
from deeplearning4j_tpu_torch.parallel.parallel_wrapper import (
    ParallelWrapper, _pad_rows)
from deeplearning4j_tpu_torch.parallel.sharding_core import (DataMesh,
                                                             RowSharding,
                                                             ShardingCore)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 3), (3, 16), (3, 5, 8), (), (3, 5), (8,), (6, 4), (4, 6, 2),
          (0, 8)]


def _mesh(n, rank=0, axis="data"):
    """A port mesh of n ranks without a process group: the rules only."""
    return DataMesh(None, n, rank, (axis,))


class TestRules:
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_leaf_rule_equals_the_references(self, n):
        for lv in (0, 1, 2, 3):
            p = ShardingCore(_mesh(n), level=lv)
            j = jcore.ShardingCore(jmesh(n), level=lv)
            for shape in SHAPES:
                leaf = np.zeros(shape)
                for fn in ("leaf_spec", "param_spec", "state_spec",
                           "grad_spec", "updater_spec"):
                    assert getattr(p, fn)(leaf) == \
                        tuple(getattr(j, fn)(leaf)), (n, lv, shape, fn)
            assert p.batch_spec() == tuple(j.batch_spec())
            assert p.stacked_spec() == tuple(j.stacked_spec())

    def test_level_resolution_equals_the_references(self, monkeypatch):
        cases = [({}, None), ({"DP_SHARD": "3"}, None),
                 ({"DP_SHARD": "3"}, 2), ({"DP_SHARD_UPDATER": "0"}, None),
                 ({"DP_SHARD": "2", "DP_SHARD_UPDATER": "0"}, None),
                 ({"DP_SHARD": "0"}, None)]
        for env, arg in cases:
            for pre in ("DL4J_TPU_", "DL4J_TORCH_"):
                for k in ("DP_SHARD", "DP_SHARD_UPDATER"):
                    monkeypatch.delenv(pre + k, raising=False)
                for k, v in env.items():
                    monkeypatch.setenv(pre + k, v)
            assert pcore.resolve_level(arg) == jcore.resolve_level(arg), env
        for bad in (4, -1):
            with pytest.raises(ValueError, match="level must be one of"):
                pcore.resolve_level(bad)

    def test_malformed_knob_falls_back_to_the_flag(self, monkeypatch):
        monkeypatch.setenv("DL4J_TORCH_DP_SHARD", "two")
        monkeypatch.delenv("DL4J_TORCH_DP_SHARD_UPDATER", raising=False)
        with pytest.warns(UserWarning, match="not a valid int"):
            assert pcore.resolve_level() == 1
        monkeypatch.setenv("DL4J_TORCH_DP_SHARD_UPDATER", "0")
        with pytest.warns(UserWarning, match="not a valid int"):
            assert pcore.resolve_level() == 0

    def test_batchless_plan_is_level_0(self):
        m = _mesh(4, axis="seq")
        core = ShardingCore(m, batch_axis=None)
        assert core.level == 0 and core.n == 1
        assert core.param_spec(np.zeros((16, 4))) == ()
        with pytest.raises(ValueError, match="requires a batch axis"):
            ShardingCore(m, level=3, batch_axis=None)
        with pytest.raises(ValueError, match="no batch axis"):
            ShardingCore(m, level=1)

    def test_widths_and_padding(self):
        for n_live, n_dev in [(7, 8), (8, 8), (1, 8), (5, 4), (3, 16)]:
            assert pcore.elastic_width(n_live, n_dev) == \
                jcore.elastic_width(n_live, n_dev)
        for n, m in [(7, 8), (8, 8), (9, 8), (1, 3)]:
            assert pcore.pad_to_multiple(n, m) == jcore.pad_to_multiple(n, m)
        with pytest.raises(ValueError):
            pcore.elastic_width(0, 4)

    def test_signature_identity(self):
        a = ShardingCore(_mesh(8), level=2)
        assert a.signature() == ShardingCore(_mesh(8), level=2).signature()
        assert a.signature() != ShardingCore(_mesh(8), level=3).signature()
        assert a.signature() != ShardingCore(_mesh(4), level=2).signature()

    def test_place_takes_the_first_divisible_axis(self):
        """Each rank's shard is its slice along the leaf's shard axis; the
        ranks' shards side by side are the leaf."""
        leaf = torch.arange(3 * 8 * 2, dtype=torch.float32).view(3, 8, 2)
        parts = []
        for r in range(4):
            core = ShardingCore(_mesh(4, r), level=3)
            assert core.axes([leaf], core.param_spec) == [1]
            (s,) = core.place_params([leaf])
            assert s.shape == (3, 2, 2) and s.is_contiguous()
            parts.append(s)
        torch.testing.assert_close(torch.cat(parts, dim=1), leaf,
                                   rtol=0, atol=0)
        # below level 3 the parameters stay whole, the updater state not
        core = ShardingCore(_mesh(4, 1), level=1)
        assert core.place_params([leaf])[0] is leaf
        assert core.place_states([leaf])[0] is leaf
        assert core.place_updater([leaf])[0].shape == (3, 2, 2)


class TestRows:
    def test_padding_repeats_the_last_row_as_the_reference(self):
        """The reference's ``_shard_batch`` padding, numpy and tensor."""
        from deeplearning4j_tpu.parallel.parallel_wrapper import \
            ParallelWrapper as JPW

        class _Net:
            params_list = None
        jpw = JPW(_Net(), workers=4)
        x = np.arange(30 * 3, dtype=np.float32).reshape(30, 3)
        want = np.asarray(jpw._shard_batch(x))
        np.testing.assert_array_equal(_pad_rows(x, 4), want)
        np.testing.assert_array_equal(_pad_rows(torch.from_numpy(x), 4)
                                      .numpy(), want)
        assert _pad_rows(x[:28], 4) is not None and \
            _pad_rows(x[:28], 4).shape == (28, 3)

    def test_ranks_take_their_rows(self):
        x = np.arange(32).reshape(8, 4)
        got = [multihost.take_rows(x, r, 4) for r in range(4)]
        np.testing.assert_array_equal(np.concatenate(got), x)
        st = np.arange(3 * 8 * 2).reshape(3, 8, 2)
        rows = [RowSharding(r, 4, 1).take(st) for r in range(4)]
        np.testing.assert_array_equal(np.concatenate(rows, axis=1), st)
        with pytest.raises(ValueError, match="does not divide"):
            multihost.take_rows(np.zeros((6, 2)), 0, 4)

    def test_iterator_sharding_and_fuse_sharding(self):
        """Each rank's prefetcher copies only its rows: of each batch
        (masks too) under ``sharding``, of each stacked group's batch axis
        under ``fuse_sharding``; the ranks' rows make the batch."""
        rng = np.random.default_rng(3)
        X = rng.normal(size=(48, 5)).astype(np.float32)
        Y = rng.normal(size=(48, 2)).astype(np.float32)
        M = (rng.random((48, 5)) > 0.5).astype(np.float32)
        for kind in ("single", "stacked"):
            got = []
            for r in range(4):
                rs = RowSharding(r, 4, 0)
                if kind == "single":
                    it = AsyncDataSetIterator(
                        ArrayDataSetIterator(X, Y, batch_size=16,
                                             features_mask=M),
                        sharding=rs, device="cpu")
                else:
                    it = AsyncDataSetIterator(
                        ArrayDataSetIterator(X, Y, batch_size=16), fuse=3,
                        fuse_sharding=RowSharding(r, 4, 1), device="cpu")
                try:
                    got.append(list(it))
                finally:
                    it.shutdown()
            if kind == "single":
                for b in range(3):
                    rows = slice(16 * b, 16 * (b + 1))
                    for attr, full in (("features", X), ("labels", Y),
                                       ("features_mask", M)):
                        parts = [getattr(got[r][b], attr) for r in range(4)]
                        assert all(p.shape[0] == 4 for p in parts)
                        np.testing.assert_array_equal(
                            torch.cat(parts).numpy(), full[rows])
            else:
                (g0,) = got[0]
                assert g0.features.shape == (3, 4, 5)
                xs = torch.cat([g[0].features for g in got], dim=1)
                np.testing.assert_array_equal(xs.numpy(),
                                              X.reshape(3, 16, 5))
                ws = torch.cat([g[0].weights for g in got], dim=1)
                assert ws.shape == (3, 16)


def _conf(lr=0.05):
    return (NeuralNetConfiguration.Builder().seed(7).updater("sgd")
            .learning_rate(lr).list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="negativeloglikelihood")).build())


class TestFailures:
    def test_a_collective_error_propagates(self):
        """A plan of two ranks with no process group behind it: the
        step's first collective raises, the error reaches the caller and
        the parameters are untouched (no local or eager route)."""
        net = MultiLayerNetwork(_conf(), device="cpu").init()
        before = net.params()
        net._enter_plan(ShardingCore(_mesh(2), level=2))
        x = np.ones((4, 4), np.float32)
        y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
        with pytest.raises((RuntimeError, ValueError)):
            net.fit_batch(x, y)
        net._shard_plan = None
        np.testing.assert_array_equal(net.params(), before)
        assert net.iteration == 0

    def test_width_beyond_the_group_raises(self):
        with pytest.raises(ValueError, match="need 2 ranks"):
            pcore.build_mesh(2)
        net = MultiLayerNetwork(_conf(), device="cpu")
        with pytest.raises(ValueError, match="need 4 ranks"):
            ParallelWrapper(net, workers=4, device="cpu")
        with pytest.raises(ValueError, match="lives on"):
            ParallelWrapper(MultiLayerNetwork(_conf(), device="cpu"),
                            device="meta")

    def test_width_1_changes_nothing(self):
        """Without a group the wrapper is a plan of width 1: the step is
        the unsharded step, bitwise, and the fused loop runs."""
        rng = np.random.default_rng(1)
        X = rng.normal(size=(32, 4)).astype(np.float32)
        Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
        a = MultiLayerNetwork(_conf(), device="cpu").init()
        b = MultiLayerNetwork(_conf(), device="cpu").init()
        a.fit(ArrayDataSetIterator(X, Y, batch_size=8), epochs=2)
        pw = ParallelWrapper(b, dp_shard=3, device="cpu")
        pw.fit(ArrayDataSetIterator(X, Y, batch_size=8), epochs=2)
        assert pw.workers == 1 and b._shard_plan.level == 3
        np.testing.assert_array_equal(a.params(), b.params())
        np.testing.assert_array_equal(pw.output(X[:5]), a.output(X[:5]))


# ---- the CLI at world 2 ------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_at_world_2_equals_the_references(tmp_path):
    """Two CLI processes (ranks 0 and 1 over gloo) train a port archive on
    an export directory and rank 0 writes it back; the reference's CLI
    trains the same archive at ``--workers 2``. The written models agree
    within 1e-5 of each leaf's max abs and restore in the port."""
    from deeplearning4j_tpu.parallel import parallel_wrapper_main as jmain
    from deeplearning4j_tpu.parallel.training_master import save_dataset
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.utils import model_serializer as pser

    rng = np.random.default_rng(11)
    data = tmp_path / "export"
    data.mkdir()
    for i in range(4):   # 30 rows: each batch padded to 32 on both sides
        x = rng.normal(size=(30, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 30)]
        save_dataset(JDataSet(x, y), str(data / f"batch_{i}.npz"))
    net = MultiLayerNetwork(_conf(0.1), device="cpu").init()
    model = str(tmp_path / "model.zip")
    pser.write_model(net, model)

    port = _free_port()
    out = str(tmp_path / "port.zip")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.parallel.parallel_wrapper_main",
         "--model", model, "--output", out, "--dataset", str(data),
         "--epochs", "2", "--world", "2", "--rank", str(r),
         "--coordinator", f"127.0.0.1:{port}", "--device", "cpu",
         "--dp-shard", "2"], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + 120
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the CLI's ranks timed out")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    assert "saved ->" in logs[0] and "saved ->" not in logs[1]

    ref_out = str(tmp_path / "ref.zip")
    assert jmain.main(["--model", model, "--output", ref_out, "--dataset",
                       str(data), "--workers", "2", "--epochs", "2"]) == 0
    got = pser.restore_model(out, device="cpu")
    want = pser.restore_model(ref_out, device="cpu")
    assert got.iteration == want.iteration == 8
    for gl, wl in zip(got.params_list, want.params_list):
        for k in wl:
            w = wl[k].detach().numpy()
            np.testing.assert_allclose(
                gl[k].detach().numpy(), w, rtol=0,
                atol=1e-5 * float(np.abs(w).max()), err_msg=k)
