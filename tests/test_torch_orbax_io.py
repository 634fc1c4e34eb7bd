"""Per-rank shard checkpoints (``utils/orbax_io.py``), held against the
reference's ``tests/test_orbax_io.py``.

The six reference tests have their counterparts here: resume parity of
a MultiLayerNetwork, a TransformerLM and a ComputationGraph (each port
net started from the reference's initial parameters, its resumed run
bitwise the uninterrupted one and its scores at the reference's within
1e-5), a sharded LM restored onto the same placement, the manager's
rolling retention, and the missing directory. On top: a level-3 save
at width 4 restored at width 2 and at width 1, bitwise the gathered
state; a damaged newest step skipped with a warning; and a kill between
the temporary write and the rename that leaves the previous step
intact.

The sharded cases run in one world of 4 gloo ranks for the whole file
(the module fixture ``world``; rank 0 writes the results). Run as a
script, this file is one rank of it:
``python tests/test_torch_orbax_io.py <rank> <world> <port> <dir>``.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LM_KW = dict(vocab_size=30, max_len=16, d_model=16, n_heads=2, n_layers=1,
             d_ff=32, seed=0)


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    return X, Y


def _conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(7).updater("adam").learning_rate(1e-2).list()
            .layer(L.DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss="negativeloglikelihood"))
            .build())


def _graph_conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    gb = (nnc.Builder().seed(4).updater("adam").learning_rate(1e-2)
          .graph_builder().add_inputs("in"))
    gb.add_layer("d", L.DenseLayer(n_in=6, n_out=12, activation="tanh"),
                 "in")
    gb.add_layer("out", L.OutputLayer(n_in=12, n_out=3,
                                      activation="softmax", loss="mcxent"),
                 "d")
    return gb.set_outputs("out").build()


def _port():
    import deeplearning4j_tpu_torch as pkg
    import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
    return pkg


def _ref():
    import deeplearning4j_tpu as jpkg
    import deeplearning4j_tpu.nn.conf.multi_layer  # noqa: F401
    return jpkg


def _mln(params=None):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    return MultiLayerNetwork(_conf(_port()), device="cpu").init(
        params=params)


# ---- one rank of the world -------------------------------------------------
def _scenarios(rank, world, port, out):
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding_core import (
        ShardingCore, build_mesh)
    from deeplearning4j_tpu_torch.utils import orbax_io

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    init = np.load(os.path.join(out, "init.npz"))
    X, Y = _data()
    ck = os.path.join(out, "shards")

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    def state(net, trees):
        return {f"{t}{i}": a.detach().numpy()
                for t in trees for i, a in enumerate(net._gathered(t))}

    # an MLN trained at level 3, width 4, saved as shards
    trees = ("params_list", "updater_states")
    net = _mln(init["mln"])
    ParallelWrapper(net, dp_shard=3, device="cpu").fit(
        ArrayDataSetIterator(X, Y, batch_size=16), epochs=2)
    orbax_io.save_checkpoint(net, ck, step=1)
    save("mln_saved", iteration=net.iteration, **state(net, trees))
    sizes = {name: os.path.getsize(os.path.join(ck, "step_1", name))
             for name in os.listdir(os.path.join(ck, "step_1"))}
    save("mln_files", names=np.array(sorted(sizes)),
         sizes=np.array([sizes[n] for n in sorted(sizes)]))

    # restored at width 2 (ranks 0-1, level 3) and width 1 (no plan)
    narrow = ShardingCore(build_mesh(), level=3).with_width(2)
    if narrow is not None:
        other = _mln()
        other._enter_plan(narrow)
        orbax_io.restore_checkpoint(other, ck, step=1)
        save("mln_w2", iteration=other.iteration,
             frac=sum(t.numel() for t in other._plan_leaves("params_list"))
             / sum(t.numel() for t in other._gathered("params_list")),
             **state(other, trees))
    if rank == 0:
        alone = _mln()
        orbax_io.restore_checkpoint(alone, ck, step=1)
        save("mln_w1", iteration=alone.iteration, **state(alone, trees))
    torch.distributed.barrier()

    # a sharded LM restored onto the same placement, and at level 1
    toks = np.random.RandomState(2).randint(0, 30, (16, 12))
    lm = TransformerLM(TransformerConfig(**LM_KW), device="cpu").init()
    lm.shard(level=3, device="cpu")
    lm.fit_batch(toks)
    orbax_io.save_checkpoint(lm, os.path.join(out, "lm"))
    lm_trees = ("params", "opt_state")
    save("lm_saved", **state(lm, lm_trees))
    back = TransformerLM(TransformerConfig(**dict(LM_KW, seed=5)),
                         device="cpu").init()
    back.shard(level=3, device="cpu")
    orbax_io.restore_checkpoint(back, os.path.join(out, "lm"))
    same = all(a.shape == b.shape for a, b in zip(
        back._plan_leaves("params"), lm._plan_leaves("params")))
    save("lm_same", same=same, **state(back, lm_trees))
    lvl1 = TransformerLM(TransformerConfig(**dict(LM_KW, seed=5)),
                         device="cpu").init()
    lvl1.shard(level=1, device="cpu")
    orbax_io.restore_checkpoint(lvl1, os.path.join(out, "lm"))
    save("lm_level1", **state(lvl1, lm_trees))
    multihost.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the port's world of 4 ranks once; returns a loader of rank 0's
    results and the run's directory."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as RefMLN
    out = str(tmp_path_factory.mktemp("orbax_world"))
    np.savez(os.path.join(out, "init.npz"), mln=np.asarray(
        RefMLN(_conf(_ref())).init().params()))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, me, str(r), str(WORLD), str(port), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + 240
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the port's world of 4 ranks timed out")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "ranks %s failed:\n%s" % (failed, "\n".join(
        f"--- rank {r}:\n{logs[r][-3000:]}" for r in failed))

    def load(name):
        with np.load(os.path.join(out, f"{name}.npz")) as z:
            return {k: z[k] for k in z.files}
    load.dir = out
    return load


def _assert_state_equal(got, want):
    keys = [k for k in want if k != "iteration"]
    assert keys and all(k in got for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- the reference's six, in the port --------------------------------------
def test_mln_resume_parity(tmp_path):
    """Saved after 4 fits, restored into a net of another init, both go
    on alike (bitwise), and at the reference's uninterrupted run."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as RefDataSet
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as RefMLN
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.utils.orbax_io import (
        restore_checkpoint, save_checkpoint)
    X, Y = _data()
    jnet = RefMLN(_conf(_ref())).init()
    net = _mln(np.asarray(jnet.params()))
    for _ in range(4):
        net.fit(DataSet(X, Y))
        jnet.fit(RefDataSet(X, Y))
    save_checkpoint(net, str(tmp_path / "ck"))
    other = _mln()
    restore_checkpoint(other, str(tmp_path / "ck"))
    assert other.iteration == net.iteration == 4
    for _ in range(3):
        net.fit(DataSet(X, Y))
        other.fit(DataSet(X, Y))
        jnet.fit(RefDataSet(X, Y))
    np.testing.assert_array_equal(other.params(), net.params())
    assert float(other.score_) == float(net.score_)
    assert float(other.score_) == pytest.approx(float(jnet.score_),
                                                rel=1e-5)


def test_transformer_lm_resume(tmp_path):
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig as RefConfig, TransformerLM as RefLM)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, params_from_numpy)
    from deeplearning4j_tpu_torch.utils.orbax_io import (
        restore_checkpoint, save_checkpoint)
    import jax
    toks = np.random.RandomState(1).randint(0, 30, (8, 12))
    jlm = RefLM(RefConfig(**LM_KW)).init()
    lm = TransformerLM(TransformerConfig(**LM_KW), device="cpu")
    lm.params = params_from_numpy(jax.tree.map(np.asarray, jlm.params),
                                  device="cpu")
    lm.fit_batch(toks)
    jlm.fit_batch(toks)
    save_checkpoint(lm, str(tmp_path / "ck"))
    lm2 = TransformerLM(TransformerConfig(**dict(LM_KW, seed=5)),
                        device="cpu").init()
    restore_checkpoint(lm2, str(tmp_path / "ck"))
    l1, l2 = float(lm.fit_batch(toks)), float(lm2.fit_batch(toks))
    assert l1 == l2
    assert l2 == pytest.approx(float(jlm.fit_batch(toks)), rel=1e-5)


def test_sharded_params_restore_onto_mesh(world):
    """A level-3 LM at width 4 saved as shards restores onto the same
    placement bitwise (parameters and AdamW moments), and onto level 1
    (moments sharded, parameters whole) bitwise too."""
    saved = world("lm_saved")
    got = world("lm_same")
    assert bool(got["same"])
    _assert_state_equal(got, saved)
    _assert_state_equal(world("lm_level1"), saved)


def test_manager_rolls_and_restores_latest(tmp_path):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.utils.orbax_io import (
        CheckpointManagerLike, latest_step)
    X, Y = _data()
    net = _mln()
    mgr = CheckpointManagerLike(str(tmp_path / "runs"), keep=2)
    for step in (1, 2, 3, 4):
        net.fit(DataSet(X, Y))
        mgr.save(net, step)
    assert latest_step(str(tmp_path / "runs")) == 4
    kept = sorted(n for n in os.listdir(tmp_path / "runs")
                  if n.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    other = _mln()
    _, step = mgr.restore_latest(other)
    assert step == 4
    np.testing.assert_array_equal(other.params(), net.params())


def test_restore_missing_raises(tmp_path):
    from deeplearning4j_tpu_torch.utils.orbax_io import CheckpointManager
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "nope")).restore_latest(_mln())


def test_computation_graph_resume_parity(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as RefMDS
    from deeplearning4j_tpu.models.computation_graph import \
        ComputationGraph as RefCG
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.utils.orbax_io import (
        restore_checkpoint, save_checkpoint)
    rng = np.random.RandomState(0)
    x = rng.rand(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    jg = RefCG(_graph_conf(_ref())).init()
    g = ComputationGraph(_graph_conf(_port()), device="cpu").init(
        params=np.asarray(jg.params()))
    for _ in range(4):
        g.fit_batch(MultiDataSet([x], [y]))
        jg.fit_batch(RefMDS([x], [y]))
    save_checkpoint(g, str(tmp_path / "cg"))
    other = ComputationGraph(_graph_conf(_port()), device="cpu").init()
    restore_checkpoint(other, str(tmp_path / "cg"))
    for _ in range(3):
        g.fit_batch(MultiDataSet([x], [y]))
        other.fit_batch(MultiDataSet([x], [y]))
        jg.fit_batch(RefMDS([x], [y]))
    np.testing.assert_array_equal(other.params(), g.params())
    np.testing.assert_allclose(other.params(), np.asarray(jg.params()),
                               rtol=0, atol=1e-5 * float(np.max(np.abs(
                                   np.asarray(jg.params())))))


# ---- the shard checkpoint's own contract -----------------------------------
class TestShards:
    def test_level3_width4_restores_bitwise_at_widths_2_and_1(self, world):
        """Each rank wrote only its shards (four rank files a sharded
        tree, no gathered copy); the restores at width 2 (level 3: half
        the parameters a rank) and width 1 hold the gathered state
        bitwise."""
        saved = world("mln_saved")
        files = [str(n) for n in world("mln_files")["names"]]
        for tree in ("params_list", "updater_states"):
            assert {f"{tree}.rank{r}.bin" for r in range(WORLD)} <= \
                set(files), files
        for name in ("mln_w2", "mln_w1"):
            got = world(name)
            assert int(got["iteration"]) == int(saved["iteration"])
            _assert_state_equal(got, saved)
        # half of each leaf a rank; the output bias (3) stays whole
        assert float(world("mln_w2")["frac"]) == pytest.approx(
            (8 * 16 / 2 + 16 / 2 + 16 * 3 / 2 + 3) / (8 * 16 + 16 + 48 + 3))

    def test_damaged_newest_step_is_skipped_with_a_warning(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.testing import faults
        from deeplearning4j_tpu_torch.utils.orbax_io import (
            CheckpointManager, verified_steps)
        X, Y = _data()
        net = _mln()
        mgr = CheckpointManager(str(tmp_path / "runs"), keep=5)
        net.fit(DataSet(X, Y))
        mgr.save(net, 1)
        want = net.params()
        net.fit(DataSet(X, Y))
        with faults.inject("corrupt-ckpt[bitflip]@0"):
            mgr.save(net, 2)
        assert verified_steps(str(tmp_path / "runs")) == [1]
        other = _mln()
        with pytest.warns(RuntimeWarning, match="step_2"):
            _, step = mgr.restore_latest(other)
        assert step == 1
        np.testing.assert_array_equal(other.params(), want)

    def test_kill_before_rename_leaves_the_previous_step(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.testing import faults
        from deeplearning4j_tpu_torch.utils.orbax_io import (
            latest_step, restore_checkpoint, save_checkpoint)
        X, Y = _data()
        net = _mln()
        d = str(tmp_path / "ck")
        net.fit(DataSet(X, Y))
        save_checkpoint(net, d, step=1)
        want = net.params()
        net.fit(DataSet(X, Y))
        with faults.inject("kill-during-ckpt@0"):
            with pytest.raises(RuntimeError, match="kill-during-ckpt"):
                save_checkpoint(net, d, step=2)
        assert os.path.isdir(os.path.join(d, "step_2.tmp"))
        assert latest_step(d) == 1
        other = _mln()
        restore_checkpoint(other, d, step=1)
        np.testing.assert_array_equal(other.params(), want)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
