"""Elastic training in the port (``parallel/elastic.py``), held against
the reference's ``tests/test_elastic.py`` and its ParallelWrapper.

In the port a trainer is a process and a width is a process group, so
re-forming a world tears a gloo group down and starts a new one among
the survivors. The file has two parts:

- in this process, against the Python coordinator: width planning, an
  ``ElasticMember`` thread with a client of the test standing in for the
  trainers (the completion flag, ``kill-peer``, ``slow-peer`` expelled, a
  bounded ``stop``), and the missing ``checkpoint_dir`` error;
- one world of 4 processes for the whole file (the module fixture
  ``world`` spawns them and hosts one elastic coordinator a scenario),
  which runs, in order: a scale-up from 2 trainers to 4; a member that
  sleeps past a 1 s round deadline and is expelled; a member killed;
  and last a trainer process killed mid-fit at ZeRO level 3, which ends
  that process (exit code ``KILLED_EXIT``). Each scenario's end state is
  held against a ``ParallelWrapper`` run resumed from the checkpoint the
  last wave resumed from, in the same group; the kill's death checkpoint
  also against the reference's ``ParallelWrapper(workers=4,
  dp_shard=3)`` over the same batches up to its cursor.

Run as a script, this file is one process of that world:
``python tests/test_torch_elastic.py <rank> <world> <dir>``.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
HOST = "127.0.0.1"
# short deadlines: the round deadline bounds every heartbeat (and every
# process group's collectives), the re-form deadline every wave (its
# settle window is 1/20 of it)
TIMEOUT = 5.0
REFORM = 6.0
SLOW_TIMEOUT = 1.0
KILL_AT = 3          # the killed trainer's heartbeat
SCENARIOS = {"scale": 2, "slow": 3, "member": 4, "kill": 4}


def _conf(pkg, seed=12, lr=0.05):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(seed).learning_rate(lr).updater("adam")
            .list()
            .layer(L.DenseLayer(n_in=16, n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=8, activation="softmax",
                                 loss="mcxent"))
            .build())


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 16)).astype(np.float32)
    Y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
    return X, Y


# ---- one process of the world ----------------------------------------------
def _scenarios(rank, world, out):
    import torch
    import deeplearning4j_tpu_torch as pkg
    import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.elastic import (ElasticMember,
                                                           ElasticTrainer)
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.testing import faults
    from deeplearning4j_tpu_torch.utils.training_checkpoint import \
        checkpoint_files

    torch.set_num_threads(1)
    os.environ["DL4J_TORCH_FUSE_STEPS"] = "1"
    os.environ["DL4J_TORCH_CKPT_KEEP"] = "50"
    init = np.load(os.path.join(out, "init.npz"))["mln"]
    with open(os.path.join(out, "ports.json")) as fh:
        ports = json.load(fh)
    X, Y = _data()

    def data():
        return ArrayDataSetIterator(X, Y, batch_size=16)

    def net():
        return MultiLayerNetwork(_conf(pkg), device="cpu").init(params=init)

    def sync(name):
        """All four processes in one group again (a barrier; the group
        also runs the oracles)."""
        multihost.reform(os.path.join(out, "sync", name), world, rank,
                         device="cpu", timeout=60)
        torch.distributed.barrier()

    def trainer(name, wid, timeout=TIMEOUT):
        return ElasticTrainer(net(), HOST, ports[name], worker_id=wid,
                              dp_shard=3, timeout=timeout,
                              reform_timeout=REFORM, device="cpu")

    def member(name, wid, timeout=TIMEOUT):
        return ElasticMember(HOST, ports[name], wid, timeout=timeout,
                             reform_timeout=REFORM).start()

    def report(name, **kw):
        with open(os.path.join(out, f"{name}_r{rank}.json"), "w") as fh:
            json.dump(kw, fh)

    def oracle(tr, name, width, epochs=2):
        """The end state against a ParallelWrapper resumed from a copy of
        the checkpoint the last wave resumed from, in that wave's group
        (the first ``width`` ranks of it)."""
        src = tr.reform_log[-1]["checkpoint"]
        if tr.group_rank is None:
            return
        d = os.path.join(out, f"{name}_oracle")
        if tr.group_rank == 0:
            os.makedirs(d)
            shutil.copy(src, d)
        torch.distributed.barrier()
        other = net()
        ParallelWrapper(other, dp_shard=3, device="cpu").fit(
            data(), epochs=epochs, resume_from=d)
        np.savez(os.path.join(out, f"oracle_{name}_r{rank}.npz"),
                 elastic=tr.model.params(), oracle=other.params())
        assert torch.distributed.get_world_size() == width

    ck = {n: os.path.join(out, f"ck_{n}") for n in SCENARIOS}

    # 1. scale-up: trainers 0-1 start at world 2; 2-3 join once a
    # checkpoint past the start has landed
    sync("scale")
    if rank < 2:
        tr = trainer("scale", rank)
    else:
        while not [i for i, _ in checkpoint_files(ck["scale"]) if i > 0]:
            time.sleep(0.01)
        tr = trainer("scale", None)
    tr.fit(data, epochs=8, checkpoint_dir=ck["scale"], checkpoint_every=1)
    report("scale", log=tr.reform_log)
    oracle(tr, "scale", 4, epochs=8)
    tr.close()

    # 2. a member that sleeps 3 s past a 1 s round deadline
    sync("slow")
    if rank < 2:
        tr = trainer("slow", rank, SLOW_TIMEOUT)
        tr.fit(data, epochs=2, checkpoint_dir=ck["slow"],
               checkpoint_every=1)
        report("slow", log=tr.reform_log)
        tr.close()
    elif rank == 2:
        faults.install("slow-peer[2]@3:3.0")
        m = member("slow", 2, SLOW_TIMEOUT)
        m.join(timeout=60)
        m.stop()
        faults.clear()
        report("slow", expelled=m.expelled is not None,
               error=repr(m.error))

    # 3. a member killed
    sync("member")
    if rank < 2:
        tr = trainer("member", rank)
        tr.fit(data, epochs=2, checkpoint_dir=ck["member"],
               checkpoint_every=1)
        report("member", log=tr.reform_log)
        oracle(tr, "member", 2)
        tr.close()
    else:
        if rank == 3:
            faults.install("kill-peer[3]@2")
        m = member("member", rank)
        m.join(timeout=60)
        m.stop()
        faults.clear()
        report("member", killed=m.killed, error=repr(m.error))

    # 4. a trainer process killed mid-fit, last (it ends that process)
    sync("kill")
    if rank == 2:
        faults.install(f"kill-peer[2]@{KILL_AT}")
    tr = trainer("kill", rank)
    tr.fit(data, epochs=2, checkpoint_dir=ck["kill"], checkpoint_every=1)
    report("kill", log=tr.reform_log)
    np.savez(os.path.join(out, f"final_kill_r{rank}.npz"),
             params=tr.model.params())
    oracle(tr, "kill", 2)
    tr.close()


# ---- the harness -----------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once: four processes, one elastic Python coordinator
    a scenario in this process. Returns a loader of the processes'
    reports and the run's directory."""
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as RefMLN
    import deeplearning4j_tpu as jpkg
    import deeplearning4j_tpu.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu_torch.parallel.coordinator import PyCoordinator
    from deeplearning4j_tpu_torch.parallel.elastic import KILLED_EXIT
    out = str(tmp_path_factory.mktemp("elastic_world"))
    init = np.asarray(RefMLN(_conf(jpkg)).init().params())
    np.savez(os.path.join(out, "init.npz"), mln=init)
    coords = {name: PyCoordinator(
        n, elastic=True, min_workers=1, reform_timeout=REFORM,
        timeout=SLOW_TIMEOUT if name == "slow" else TIMEOUT)
        for name, n in SCENARIOS.items()}
    with open(os.path.join(out, "ports.json"), "w") as fh:
        json.dump({n: c.port for n, c in coords.items()}, fh)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, me, str(r), str(WORLD), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + 240
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("the port's elastic world timed out:\n" +
                            "\n".join(q.communicate()[0][-2000:]
                                      for q in procs))
    finally:
        for c in coords.values():
            c.stop()
    want = [0, 0, KILLED_EXIT, 0]
    failed = [r for r, p in enumerate(procs) if p.returncode != want[r]]
    assert not failed, "processes %s failed:\n%s" % (failed, "\n".join(
        f"--- process {r} (exit {procs[r].returncode}):\n{logs[r][-3000:]}"
        for r in failed))

    def load(name, rank=0):
        path = os.path.join(out, f"{name}_r{rank}")
        if os.path.exists(path + ".json"):
            with open(path + ".json") as fh:
                return json.load(fh)
        with np.load(path + ".npz") as z:
            return {k: z[k] for k in z.files}
    load.dir = out
    load.init = init
    return load


# ---- width planning and the member, in this process -------------------------
class TestWidthPlanning:
    def test_elastic_width_largest_power_of_two(self):
        from deeplearning4j_tpu.parallel.sharding_core import \
            elastic_width as ref_width
        from deeplearning4j_tpu_torch.parallel.sharding_core import \
            elastic_width
        for live, dev in [(8, 8), (7, 8), (5, 8), (3, 8), (1, 8), (9, 8),
                          (8, 4), (3, 2)]:
            assert elastic_width(live, dev) == ref_width(live, dev)
        assert elastic_width(7, 8) == 4 and elastic_width(9, 8) == 8

    def test_elastic_width_rejects_empty_world(self):
        from deeplearning4j_tpu_torch.parallel.sharding_core import \
            elastic_width
        with pytest.raises(ValueError):
            elastic_width(0, 8)

    def test_with_width_keeps_level_and_axis(self):
        from deeplearning4j_tpu_torch.parallel.sharding_core import (
            DataMesh, ShardingCore)
        core = ShardingCore(DataMesh(None, 1, 0), level=3)
        one = core.with_width(1)
        assert one.n == 1 and one.level == 3
        assert one.batch_axis == core.batch_axis

    def test_backend_is_chosen_explicitly(self):
        from deeplearning4j_tpu_torch.parallel.multihost import \
            choose_backend
        assert choose_backend("cpu", 4)[0] == "gloo"


def _coord(n, **kw):
    from deeplearning4j_tpu_torch.parallel.coordinator import PyCoordinator
    kw.setdefault("elastic", True)
    kw.setdefault("min_workers", 1)
    kw.setdefault("timeout", TIMEOUT)
    kw.setdefault("reform_timeout", 2.0)
    return PyCoordinator(n, **kw)


def _driver(coord, timeout=TIMEOUT):
    """A client of this test in the trainers' place: the wave as a
    driver and the census with its mark."""
    from deeplearning4j_tpu_torch.parallel.coordinator import \
        PyCollectiveClient
    from deeplearning4j_tpu_torch.parallel.elastic import CENSUS_TAG
    c = PyCollectiveClient(HOST, coord.port, 0, timeout=timeout)
    _, rank, world = c.reform(2.0, driver=True)
    mark = np.zeros(world, np.float32)
    mark[rank] = 1.0
    census = c.allreduce(mark, tag=CENSUS_TAG)
    assert census.sum() == 1.0 and world == 2
    return c


def _beat(c, value=0.0):
    from deeplearning4j_tpu_torch.parallel.elastic import HEARTBEAT_TAG
    return float(c.allreduce(np.full(1, value, np.float32),
                             tag=HEARTBEAT_TAG)[0])


@pytest.fixture
def clean_faults():
    from deeplearning4j_tpu_torch.testing import faults
    faults.clear()
    yield faults
    faults.clear()


class TestMember:
    def _member(self, coord, timeout=TIMEOUT):
        from deeplearning4j_tpu_torch.parallel.elastic import ElasticMember
        return ElasticMember(HOST, coord.port, 1, timeout=timeout,
                             reform_timeout=2.0).start()

    def test_completion_flag_ends_the_member(self, clean_faults):
        coord = _coord(2)
        m = self._member(coord)
        c = _driver(coord)
        try:
            assert [_beat(c) for _ in range(3)] == [0.0, 0.0, 0.0]
            assert _beat(c, 1.0) == 1.0
            m.join(timeout=10)
            assert not m._thread.is_alive()
            assert not m.killed and m.expelled is None and m.error is None
            assert (m.epoch, m.world) == (1, 2)
        finally:
            c.close()
            m.stop()
            coord.stop()

    def test_kill_peer_leaves_and_fails_the_round(self, clean_faults):
        from deeplearning4j_tpu_torch.errors import PeerDeadError
        coord = _coord(2)
        clean_faults.install("kill-peer[1]@1")
        m = self._member(coord)
        c = _driver(coord)
        try:
            assert _beat(c) == 0.0
            with pytest.raises(PeerDeadError):
                _beat(c)
            m.join(timeout=10)
            assert m.killed and m.error is None
        finally:
            c.close()
            m.stop()
            coord.stop()

    def test_slow_peer_is_expelled(self, clean_faults):
        from deeplearning4j_tpu_torch.errors import CollectiveTimeoutError
        coord = _coord(2, timeout=0.5)
        clean_faults.install("slow-peer[1]@1:1.5")
        m = self._member(coord, timeout=0.5)
        c = _driver(coord, timeout=0.5)
        try:
            assert _beat(c) == 0.0
            with pytest.raises(CollectiveTimeoutError):
                _beat(c)
            m.join(timeout=10)
            assert m.expelled is not None and m.error is None
            assert not m.killed
        finally:
            c.close()
            m.stop()
            coord.stop()

    def test_stop_is_bounded_without_a_driver(self, clean_faults):
        coord = _coord(2)
        m = self._member(coord)
        try:
            time.sleep(0.2)   # in a wave that cannot commit
            t0 = time.monotonic()
            m.stop(timeout=10)
            assert not m._thread.is_alive()
            assert time.monotonic() - t0 < 10
        finally:
            coord.stop()

    def test_elastic_fit_requires_checkpoint_dir(self):
        import deeplearning4j_tpu_torch as pkg
        import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
        from deeplearning4j_tpu_torch.models.multi_layer_network import \
            MultiLayerNetwork
        from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
        net = MultiLayerNetwork(_conf(pkg), device="cpu").init()
        tr = ElasticTrainer(net, HOST, 1, worker_id=0, device="cpu")
        with pytest.raises(ValueError, match="checkpoint_dir"):
            tr.fit(lambda: iter([]), epochs=1)


class TestFailureKinds:
    """Only a peer's failure re-forms the world; anything else is raised
    as it is."""

    def test_peer_errors_are_gloo_transport_and_dist_errors(self):
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.parallel.multihost import \
            is_peer_error
        # gloo's own texts for a dead peer and a wait past the timeout
        assert is_peer_error(RuntimeError(
            "[/x/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
            "Connection closed by peer [127.0.0.1]:45224. This is "
            "typically caused by a remote worker crashing."))
        assert is_peer_error(RuntimeError(
            "[/x/third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:78]"
            " Timed out waiting 3000ms for recv operation to complete"))
        assert is_peer_error(dist.DistError("store wait timed out"))
        for text in ("CUDA error: the launch timed out and was terminated",
                     "connection timed out", "unexpected end of file",
                     "[gloo/transport/tcp/pair.cc:1] some other failure"):
            assert not is_peer_error(RuntimeError(text)), text
        assert not is_peer_error(
            OSError("[gloo/transport/] Connection closed by peer"))

    def test_non_collective_error_propagates_unchanged(self, tmp_path):
        """A failure inside the fit that is not a collective's (here a
        CUDA launch timeout's text) leaves fit as it is: no re-form, and
        no process group left behind."""
        import torch.distributed as dist
        import deeplearning4j_tpu_torch as pkg
        import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
        from deeplearning4j_tpu_torch.models.multi_layer_network import \
            MultiLayerNetwork
        from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
        boom = RuntimeError("CUDA error: the launch timed out and was "
                            "terminated")

        def data():
            raise boom
            yield
        coord = _coord(1)
        net = MultiLayerNetwork(_conf(pkg), device="cpu").init()
        tr = ElasticTrainer(net, HOST, coord.port, worker_id=0,
                            timeout=TIMEOUT, reform_timeout=2.0,
                            prefetch_buffer=0, device="cpu")
        try:
            with pytest.raises(RuntimeError) as got:
                tr.fit(data, epochs=1, checkpoint_dir=str(tmp_path))
            assert got.value is boom
            assert len(tr.reform_log) == 1
            assert not dist.is_initialized()
        finally:
            tr.close()
            coord.stop()


# ---- the world ---------------------------------------------------------------
def _widths(log):
    return [e["width"] for e in log]


class TestElasticWorld:
    def test_scale_up_2_to_4(self, world):
        """Two joiners re-form the world 2 -> 4 wide mid-fit: one wave a
        new width, every process ends in the width-4 group, and the end
        state equals a width-4 run resumed from the re-form checkpoint."""
        log = world("scale")["log"]
        assert [e["world"] for e in log] == [2, 4]
        assert _widths(log) == [2, 4]
        assert log[0]["checkpoint"] is None and log[1]["checkpoint"]
        for r in (2, 3):
            assert _widths(world("scale", r)["log"]) == [4]
        for r in range(WORLD):
            res = world("oracle_scale", r)
            np.testing.assert_allclose(res["elastic"], res["oracle"],
                                       rtol=0, atol=1e-6)

    def test_slow_peer_is_expelled_and_run_finishes(self, world):
        log = world("slow")["log"]
        assert log[0]["world"] == 3 and log[-1]["world"] == 2
        assert world("slow", 2)["expelled"]
        assert world("slow", 2)["error"] == "None"

    def test_member_killed_run_completes(self, world):
        log = world("member")["log"]
        assert [e["world"] for e in log] == [4, 3]
        assert _widths(log) == [2, 2]
        assert world("member", 3)["killed"]
        assert world("member", 2)["error"] == "None"
        res = world("oracle_member")
        np.testing.assert_allclose(res["elastic"], res["oracle"], rtol=0,
                                   atol=1e-6)

    def test_trainer_killed_reforms_4_to_2(self, world):
        """A trainer process dies mid-fit at level 3: the survivors
        re-form at world 3, width 2, within the re-form deadline, and
        end within 1e-6 of a width-2 run resumed from the death
        checkpoint, which is stamped with the world it was committed
        under."""
        from deeplearning4j_tpu_torch.utils.training_checkpoint import \
            TRAIN_STATE_NAME
        log = world("kill")["log"]
        assert [e["world"] for e in log] == [4, 3]
        assert _widths(log) == [4, 2]
        assert log[1]["seconds"] < REFORM
        assert [e["backend"] for e in log] == ["gloo", "gloo"]
        death = log[1]["checkpoint"]
        with zipfile.ZipFile(death) as z:
            state = json.loads(z.read(TRAIN_STATE_NAME))
        assert state["world"] == {"size": 4, "epoch": 1, "width": 4}
        for r in (0, 1):
            res = world("oracle_kill", r)
            np.testing.assert_allclose(res["elastic"], res["oracle"],
                                       rtol=0, atol=1e-6)
        # the survivor past the width heartbeated to the end, and took
        # the group's final state (it held its width-4 shards before)
        assert _widths(world("kill", 3)["log"]) == [4, 2]
        assert world("kill", 3)["log"][1]["rank"] is None
        final = world("final_kill", 0)["params"]
        assert final.shape == world.init.shape
        for r in (1, 3):
            np.testing.assert_array_equal(world("final_kill", r)["params"],
                                          final)

    def test_death_checkpoint_matches_the_reference(self, world):
        """The death checkpoint's parameters against the reference's
        ParallelWrapper(workers=4, dp_shard=3) over the same batches up
        to its cursor: within 1e-5 of their max abs."""
        import deeplearning4j_tpu as jpkg
        import deeplearning4j_tpu.nn.conf.multi_layer  # noqa: F401
        from deeplearning4j_tpu.datasets.dataset import (DataSet,
                                                         ListDataSetIterator)
        from deeplearning4j_tpu.models.multi_layer_network import \
            MultiLayerNetwork as RefMLN
        from deeplearning4j_tpu.parallel.parallel_wrapper import \
            ParallelWrapper as RefPW
        from deeplearning4j_tpu_torch.utils import model_serializer
        from deeplearning4j_tpu_torch.utils.training_checkpoint import \
            TRAIN_STATE_NAME
        death = world("kill")["log"][1]["checkpoint"]
        with zipfile.ZipFile(death) as z:
            cursor = json.loads(z.read(TRAIN_STATE_NAME))["cursor"]
        got = model_serializer.restore_model(death, device="cpu").params()
        X, Y = _data()
        batches = [DataSet(X[i:i + 16], Y[i:i + 16]) for i in
                   range(0, 64, 16)]
        seq = batches * cursor["epoch"] + batches[:cursor["batch"]]
        assert 0 < len(seq) < 8
        net = RefMLN(_conf(jpkg)).init(params=world.init)
        before = os.environ.get("DL4J_TPU_FUSE_STEPS")
        os.environ["DL4J_TPU_FUSE_STEPS"] = "1"
        try:
            RefPW(net, workers=4, dp_shard=3).fit(ListDataSetIterator(seq))
        finally:
            if before is None:
                del os.environ["DL4J_TPU_FUSE_STEPS"]
            else:
                os.environ["DL4J_TPU_FUSE_STEPS"] = before
        want = np.asarray(net.params())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(
            np.max(np.abs(want))))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
