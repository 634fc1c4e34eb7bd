"""Data parallelism in the port, held against the reference's.

The port runs one process a rank over gloo on the CPU: one world of 4
ranks for the whole file (the module fixture ``world`` spawns it, the
ranks run every scenario of :func:`_scenarios` and write their results,
and the tests compare those with the reference computed here). The
reference runs its ParallelWrapper at ``workers=4`` on its 8-device
virtual mesh. Both start from the reference's initial parameters and
draw no random numbers in training (no dropout), so their results agree
to f32 rounding: each parameter leaf within 1e-5 of its max abs.

The matrix mirrors ``tests/test_dp_shard.py``: every ZeRO level after 2
epochs of a seeded 64-row stream (level 2 bitwise level 1 in the port),
the at-rest fractions, a 30-row batch padded by repeating its last row,
a BatchNormalization net's running moments (the global batch's), a
masked LM step whose ranks hold unequal token counts (the loss takes the
global count), the guard on sharded state (the stream without the bad
batch), resume bitwise at the same level and width and within
tolerance across levels and widths 4 -> 2 and 2 -> 4 (a width-2 group
of ranks 0-1 inside the same world), ``TransformerLM.shard(level=3)``
and ``fsdp_trainer`` on a 2-layer narrow LM (dense attention on both
sides), ``FSDPMLP``, a ComputationGraph with an injected level-3
plan, the line-search solvers under the plan (``lbfgs`` and
``conjugate_gradient`` at levels 0 and 3, against the reference's
ParallelWrapper, which runs them over its mesh), and layer-wise
pretraining under an injected plan (an AutoEncoder with corruption, an
RBM and a VAE in one net, and a graph's VAE vertex, against the port at
world 1 on the global batch: the reference pretrains under no plan, and
the ranks draw their rows of the global batch's draws).

Run as a script, this file is one rank of that world:
``python tests/test_torch_dp_shard.py <rank> <world> <port> <dir>``.
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
LEVELS = (0, 1, 2, 3)
LM_KW = dict(vocab_size=50, d_model=32, n_heads=2, d_ff=64, n_layers=2,
             max_len=32, dropout=0.0, seed=3)
# the masked step also clips and takes a z-loss: both over the global batch
LM_MASK_KW = dict(LM_KW, grad_clip_norm=0.05, z_loss=1e-3)


# ---- the shared inputs ---------------------------------------------------
def _stream(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 16)).astype(np.float32)
    Y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
    return X, Y


def _tokens():
    return np.random.RandomState(5).randint(0, 50, (16, 21))


def _lm_mask():
    """Rows of different lengths: the four ranks' rows hold 39, 56, 63
    and 30 real tokens."""
    lens = np.array([3, 20, 7, 9, 20, 18, 1, 17, 20, 15, 8, 20, 5, 2, 11, 12])
    return (np.arange(20)[None, :] < lens[:, None]).astype(np.float32)


def _conf(pkg, bn=False, seed=12):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    b = (nnc.Builder().seed(seed).learning_rate(0.05).updater("adam").list()
         .layer(L.DenseLayer(n_in=16, n_out=8, activation="tanh")))
    if bn:
        b = b.layer(L.BatchNormalization(n_out=8))
    return b.layer(L.OutputLayer(n_out=8, activation="softmax",
                                 loss="mcxent")).build()


def _solver_conf(pkg, algo):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(12).learning_rate(0.05)
            .optimization_algo(algo).iterations(3).list()
            .layer(L.DenseLayer(n_in=16, n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=8, activation="softmax",
                                 loss="mcxent")).build())


def _pretrain_conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(5).learning_rate(0.05).updater("adam")
            .list()
            .layer(L.AutoEncoder(n_in=16, n_out=12, corruption_level=0.3,
                                 activation="sigmoid"))
            .layer(L.RBM(n_in=12, n_out=10, k=2))
            .layer(L.VariationalAutoencoder(
                n_in=10, n_out=4, encoder_layer_sizes=(8,),
                decoder_layer_sizes=(8,), activation="leakyrelu"))
            .layer(L.OutputLayer(n_out=8, activation="softmax",
                                 loss="mcxent")).build())


def _pretrain_graph_conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(6).learning_rate(0.05).updater("rmsprop")
            .graph_builder().add_inputs("in")
            .add_layer("vae", L.VariationalAutoencoder(
                n_in=16, n_out=4, encoder_layer_sizes=(8,),
                decoder_layer_sizes=(8,), activation="leakyrelu"), "in")
            .add_layer("out", L.OutputLayer(n_in=4, n_out=8,
                                            activation="softmax",
                                            loss="mcxent"), "vae")
            .set_outputs("out").build())


SOLVERS = ("lbfgs", "conjugate_gradient")


def _pretrain_batches(X, take=lambda a: a):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(take(X[i:i + 16]), None) for i in range(0, 64, 16)]


def _graph_conf(pkg):
    nnc = pkg.nn.conf.multi_layer.NeuralNetConfiguration
    L = pkg.nn.layers
    return (nnc.Builder().seed(12).learning_rate(0.05).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("d", L.DenseLayer(n_in=16, n_out=8,
                                         activation="tanh"), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=8,
                                            activation="softmax",
                                            loss="mcxent"), "d")
            .set_outputs("out").build())


# ---- one rank of the world -------------------------------------------------
def _scenarios(rank, world, port, out):
    import torch
    import deeplearning4j_tpu_torch as pkg
    import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet, MultiDataSet)
    from deeplearning4j_tpu_torch.models._layered import tensor_leaves
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, _flatten, _unflatten,
        params_from_numpy)
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
        ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.sharding_core import (
        ShardingCore, build_mesh)
    from deeplearning4j_tpu_torch.testing import faults

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    init = np.load(os.path.join(out, "init.npz"))
    X, Y = _stream()

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    def frac(tree, whole):
        return sum(t.numel() for t in tensor_leaves(tree)) / whole

    def mln(key="mln", bn=False):
        return MultiLayerNetwork(_conf(pkg, bn), device="cpu").init(
            params=init[key])

    def fit(level, epochs=2, mesh=None, net=None, **kw):
        net = net if net is not None else mln()
        pw = ParallelWrapper(net, mesh=mesh, dp_shard=level, device="cpu")
        pw.fit(ArrayDataSetIterator(X, Y, batch_size=16), epochs=epochs,
               **kw)
        return net

    # every ZeRO level, and the at-rest fractions
    n_p = sum(int(np.prod(s)) for s in (16 * 8, 8, 8 * 8, 8))
    for lv in LEVELS:
        net = fit(lv)
        fp = frac(net.params_list, n_p)
        fu = frac(net.updater_states, 2 * n_p)
        np.savez(os.path.join(out, f"level{lv}_r{rank}.npz"),
                 params=net.params(), frac_params=fp, frac_updater=fu,
                 score=float(net.score_))

    # a 30-row batch: padded to 32 by repeating its last row
    net = mln()
    ParallelWrapper(net, dp_shard=1, device="cpu").fit(DataSet(X[:30],
                                                               Y[:30]))
    save("pad30", params=net.params())

    # BatchNormalization over the global batch
    net = mln("bn", bn=True)
    ParallelWrapper(net, dp_shard=2, device="cpu").fit(
        ArrayDataSetIterator(X, Y, batch_size=16), epochs=1)
    save("bn", params=net.params(), mean=net.states_list[1]["mean"].numpy(),
         var=net.states_list[1]["var"].numpy())

    # the guard on sharded state: batch 1 poisoned on every rank (level
    # 2), on rank 1 alone (level 3: every rank must skip the step)
    for lv in (2, 3):
        faults.clear()
        with faults.inject("nan-step@1" if lv == 2 or rank == 1 else ""):
            net = fit(lv, epochs=1)
        np.savez(os.path.join(out, f"guard{lv}_r{rank}.npz"),
                 params=net.params(), skipped=net.nan_skipped_steps)
    faults.clear()

    # resume: the same level and width, another level, another width
    def ckdir(name):
        return os.path.join(out, name)
    fit(3, epochs=1, checkpoint_every=4, checkpoint_dir=ckdir("ck4"))
    net = fit(3, resume_from=ckdir("ck4"), checkpoint_every=4)
    save("resume_same", params=net.params(), level=net._shard_plan.level)
    net = fit(2, resume_from=ckdir("ck4"), checkpoint_every=4)
    save("resume_level", params=net.params(),
         frac_updater=frac(net.updater_states, 2 * n_p))
    # ranks 0 and 1; every rank of the world builds the group
    narrow = ShardingCore(build_mesh(), level=2).with_width(2)
    assert (narrow is None) == (rank >= 2)
    if narrow is not None:
        narrow = narrow.mesh
        net = fit(2, mesh=narrow, resume_from=ckdir("ck4"),
                  checkpoint_every=4)
        save("resume_4to2", params=net.params())
        fit(3, epochs=1, mesh=narrow, checkpoint_every=4,
            checkpoint_dir=ckdir("ck2"))
        net = fit(3, mesh=narrow)
        save("width2", params=net.params())
    torch.distributed.barrier()   # ranks 2-3 wait for ck2
    net = fit(2, resume_from=ckdir("ck2"), checkpoint_every=4)
    save("resume_2to4", params=net.params())

    # the LM: a masked step with unequal token counts a rank, clipped
    def lm(key, kw):
        m = TransformerLM(TransformerConfig(**kw), device="cpu")
        tree = {k[len(key) + 1:]: init[k] for k in init.files
                if k.startswith(key + "/")}
        m.params = params_from_numpy(_unflatten(tree), device="cpu")
        return m
    toks = _tokens()
    m = lm("lm", LM_MASK_KW).shard(level=2, device="cpu")
    losses = [float(m.fit_batch(toks, mask=_lm_mask())) for _ in range(2)]
    save("lm_mask", losses=np.array(losses),
         **{k: v.detach().numpy() for k, v in _flatten(m.params).items()})

    # TransformerLM.shard(level=3) and fsdp_trainer
    m = lm("lm", LM_KW).shard(level=3, device="cpu")
    losses = [float(m.fit_batch(toks)) for _ in range(3)]
    whole_p = sum(init[k].size for k in init.files if k.startswith("lm/"))
    fp = sum(v.numel() for v in m._plan_leaves("params"))
    fo = sum(v.numel() for v in m._plan_leaves("opt_state"))
    names = list(_flatten(m.params))
    wte = m._shard_plan.host_view(m._plan_leaves("params"),
                                  m._dp_rest["params"])[names.index("wte")]
    save("lm3", losses=np.array(losses), wte=wte, frac_params=fp / whole_p,
         frac_opt=fo / (2 * whole_p))
    tr = lm("lm", LM_KW).fsdp_trainer(device="cpu")
    losses = [float(tr.fit_batch(toks[:, :-1], toks[:, 1:]))
              for _ in range(3)]
    got = _flatten(tr.gathered_params())
    save("fsdp", losses=np.array(losses), frac=tr.shard_fraction(),
         **{k: np.asarray(v) for k, v in got.items()})

    # FSDPMLP from the reference's initial parameters
    from deeplearning4j_tpu_torch.parallel.fsdp import FSDPMLP
    mlp = FSDPMLP(None, 16, 32, 8, n_layers=3, lr=0.1, device="cpu",
                  params={k[4:]: init[k] for k in init.files
                          if k.startswith("mlp/")})
    losses = [float(mlp.fit_batch(X[:32], Y[:32])) for _ in range(3)]
    save("fsdp_mlp", losses=np.array(losses), frac=mlp.shard_fraction(),
         predict=mlp.predict(X[:8]), **mlp.gathered_params())

    # ComputationGraph with an injected level-3 plan
    core = ShardingCore(build_mesh(), level=3)
    cg = ComputationGraph(_graph_conf(pkg), device="cpu").init(
        params=init["cg"])
    cg._enter_plan(core)
    rows = core.data_sharding()
    for i in range(0, 32, 16):
        cg.fit_batch(MultiDataSet([rows.take(X[i:i + 16])],
                                  [rows.take(Y[i:i + 16])]))
    save("graph", params=cg.params(),
         frac=frac(cg.params_list, n_p))

    # the line-search solvers under the plan: the global batch's loss and
    # gradient in every probe, so every rank takes the same steps
    for algo in SOLVERS:
        for lv in (0, 3):
            net = MultiLayerNetwork(_solver_conf(pkg, algo),
                                    device="cpu").init(params=init["mln"])
            fit(lv, epochs=1, net=net)
            save(f"solver_{algo}_{lv}", params=net.params(),
                 score=float(net.score_))

    # layer-wise pretraining under an injected plan, this rank's rows
    for lv in (0, 3):
        core = ShardingCore(build_mesh(), level=lv)
        net = MultiLayerNetwork(_pretrain_conf(pkg), device="cpu").init(
            params=init["pretrain"])
        net._enter_plan(core)
        net.pretrain(_pretrain_batches(X, core.data_sharding().take))
        assert net._shard_plan is core
        np.savez(os.path.join(out, f"pretrain{lv}_r{rank}.npz"),
                 params=net.params(), score=float(net.score_))
    core = ShardingCore(build_mesh(), level=3)
    cg = ComputationGraph(_pretrain_graph_conf(pkg), device="cpu").init(
        params=init["pretrain_cg"])
    cg._enter_plan(core)
    cg.pretrain_vertex("vae", _pretrain_batches(X, core.data_sharding().take))
    save("pretrain_cg", params=cg.params())
    multihost.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the reference ---------------------------------------------------------
def _ref_pw(level, epochs=2, workers=4, fuse="1", X=None, Y=None, net=None,
            data=None, **kw):
    from deeplearning4j_tpu.datasets.dataset import ArrayDataSetIterator
    from deeplearning4j_tpu.parallel.parallel_wrapper import ParallelWrapper
    if X is None:
        X, Y = _stream()
    before = os.environ.get("DL4J_TPU_FUSE_STEPS")
    os.environ["DL4J_TPU_FUSE_STEPS"] = fuse
    try:
        pw = ParallelWrapper(net, workers=workers, dp_shard=level)
        pw.fit(data if data is not None else
               ArrayDataSetIterator(X, Y, batch_size=16), epochs=epochs,
               **kw)
    finally:
        if before is None:
            del os.environ["DL4J_TPU_FUSE_STEPS"]
        else:
            os.environ["DL4J_TPU_FUSE_STEPS"] = before
    return net


def _ref_fraction(tree):
    import jax
    total = per_dev = 0
    for leaf in jax.tree.leaves(tree):
        total += leaf.size
        per_dev += int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
    return per_dev / total


def _lm_close(got, want, msg=""):
    """The LM's parameters after AdamW steps, at the reference's own bar
    for them (``tests/test_dp_shard.py``'s transformer test: rtol 1e-4,
    atol 1e-6). AdamW divides each gradient element by its own scale, so
    an element whose gradient is rounding noise moves by a noisy step of
    up to the learning rate on both sides: the key bias's gradient is
    zero in exact arithmetic (a shift of every score of a row leaves its
    softmax unchanged). The loss, which holds the global denominator, is
    held at rtol 1e-5."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                               err_msg=msg)


def _close(got, want, msg=""):
    """Within 1e-5 of the leaf's max abs."""
    want = np.asarray(want, np.float64)
    tol = 1e-5 * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def ref():
    """The reference's side: initial parameters (handed to the port) and
    its nets."""
    import deeplearning4j_tpu as jpkg
    import deeplearning4j_tpu.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu.models.computation_graph import ComputationGraph
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)

    def mln(bn=False):
        return MultiLayerNetwork(_conf(jpkg, bn)).init()

    lm = TransformerLM(TransformerConfig(**LM_KW)).init()
    lm_params = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                lm_params[f"lm/{prefix}{k}"] = np.asarray(v)
    walk(lm.params, "")
    def mlp():
        from deeplearning4j_tpu.parallel.fsdp import FSDPMLP
        from deeplearning4j_tpu.parallel.sharding_core import build_mesh
        return FSDPMLP(build_mesh(4), 16, 32, 8, n_layers=3, lr=0.1, seed=4)

    return dict(mln=mln, lm_params=lm_params, jpkg=jpkg, mlp=mlp,
                graph=lambda: ComputationGraph(_graph_conf(jpkg)).init(),
                lm=lambda kw: TransformerLM(TransformerConfig(**kw)).init())


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """Run the port's world of 4 ranks once; returns a loader of rank 0's
    (or rank r's) results."""
    out = str(tmp_path_factory.mktemp("dp_world"))
    np.savez(os.path.join(out, "init.npz"),
             **{f"mlp/{k}": v for k, v in ref["mlp"]().gathered_params()
                .items()},
             mln=np.asarray(ref["mln"]().params()),
             bn=np.asarray(ref["mln"](bn=True).params()),
             cg=np.asarray(ref["graph"]().params()),
             pretrain=_port_pretrain_net().params(),
             pretrain_cg=_port_pretrain_graph().params(),
             **ref["lm_params"])
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
    with np.load(os.path.join(out, "init.npz")) as z:
        load.init = {k: z[k] for k in z.files}
    return load


def _port_pretrain_net(params=None):
    import deeplearning4j_tpu_torch as pkg
    import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    return MultiLayerNetwork(_pretrain_conf(pkg), device="cpu").init(
        params=params)


def _port_pretrain_graph(params=None):
    import deeplearning4j_tpu_torch as pkg
    import deeplearning4j_tpu_torch.nn.conf.multi_layer  # noqa: F401
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    return ComputationGraph(_pretrain_graph_conf(pkg), device="cpu").init(
        params=params)


# ---- the matrix --------------------------------------------------------------
class TestLevels:
    def test_every_level_matches_the_reference(self, ref, world):
        """Each level against the reference's ParallelWrapper at that
        level (its fused loop, K 4, and its per-batch loop)."""
        for lv in LEVELS:
            got = world(f"level{lv}_r0")["params"]
            for fuse in ("4", "1"):
                want = np.asarray(_ref_pw(lv, fuse=fuse,
                                          net=ref["mln"]()).params())
                _close(got, want, f"level {lv}, reference K {fuse}")

    def test_levels_agree_bitwise_and_ranks_agree(self, world):
        """ZeRO-2 is bitwise ZeRO-1: the levels differ only in where the
        updater runs; every rank ends with the same parameters."""
        p = {lv: world(f"level{lv}_r0")["params"] for lv in LEVELS}
        np.testing.assert_array_equal(p[1], p[2])
        for lv in LEVELS:
            for r in range(1, WORLD):
                np.testing.assert_array_equal(
                    world(f"level{lv}_r{r}")["params"], p[lv])

    def test_at_rest_fractions_equal_the_references(self, ref, world):
        for lv in LEVELS:
            net = _ref_pw(lv, epochs=1, net=ref["mln"]())
            got = world(f"level{lv}_r0")
            assert float(got["frac_params"]) == pytest.approx(
                _ref_fraction(net.params_list))
            assert float(got["frac_updater"]) == pytest.approx(
                _ref_fraction(net.updater_states))

    def test_score_is_the_global_loss(self, ref, world):
        want = float(_ref_pw(0, net=ref["mln"]()).score_)
        for r in range(WORLD):
            assert float(world(f"level0_r{r}")["score"]) == pytest.approx(
                want, rel=1e-5)


class TestBatches:
    def test_30_rows_pad_by_repeating_the_last(self, ref, world):
        from deeplearning4j_tpu.datasets.dataset import DataSet
        from deeplearning4j_tpu.parallel.parallel_wrapper import \
            ParallelWrapper
        X, Y = _stream()
        net = ref["mln"]()
        ParallelWrapper(net, workers=4, dp_shard=1).fit(DataSet(X[:30],
                                                                Y[:30]))
        _close(world("pad30")["params"], np.asarray(net.params()))

    def test_batchnorm_takes_the_global_moments(self, ref, world):
        net = _ref_pw(2, epochs=1, net=ref["mln"](bn=True))
        got = world("bn")
        _close(got["params"], np.asarray(net.params()))
        _close(got["mean"], np.asarray(net.states_list[1]["mean"]), "mean")
        _close(got["var"], np.asarray(net.states_list[1]["var"]), "var")

    def test_masked_lm_loss_takes_the_global_count(self, ref, world):
        """Unequal token counts a rank: the port's sharded step equals the
        reference's unsharded step on the global batch (clip and z-loss
        included)."""
        jlm = ref["lm"](LM_MASK_KW)
        want = [float(jlm.fit_batch(_tokens(), mask=_lm_mask()))
                for _ in range(2)]
        got = world("lm_mask")
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[prefix + k] = np.asarray(v)
        walk(jlm.params, "")
        for k, v in flat.items():
            _lm_close(got[k], v, k)


class TestGuard:
    @pytest.mark.parametrize("level", [2, 3])
    def test_poisoned_step_is_the_stream_without_it(self, ref, world,
                                                    level):
        """On sharded state a reverted step is the stream without that
        batch, on every rank, also when one rank's rows alone went
        non-finite: the same math as the reference's ParallelWrapper fed
        the three other batches."""
        from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator
        from deeplearning4j_tpu.datasets.dataset import DataSet
        X, Y = _stream()
        keep = [DataSet(X[i:i + 16], Y[i:i + 16]) for i in (0, 32, 48)]
        net = _ref_pw(level, epochs=1, net=ref["mln"](),
                      data=ListDataSetIterator(keep))
        for r in range(WORLD):
            got = world(f"guard{level}_r{r}")
            assert int(got["skipped"]) == 1, r
            _close(got["params"], np.asarray(net.params()), f"rank {r}")


class TestResume:
    def test_same_level_and_width_is_bitwise(self, world):
        np.testing.assert_array_equal(world("resume_same")["params"],
                                      world("level3_r0")["params"])

    def test_another_level_is_a_continuation(self, world):
        got = world("resume_level")
        _close(got["params"], world("level3_r0")["params"])
        # restored onto its level-2 placement: the moments 1/4 a rank
        assert float(got["frac_updater"]) == pytest.approx(0.25)

    def test_4_to_2_and_2_to_4(self, ref, world):
        _close(world("resume_4to2")["params"], world("level3_r0")["params"])
        _close(world("resume_2to4")["params"], world("width2")["params"])
        want = np.asarray(_ref_pw(3, workers=2, net=ref["mln"]()).params())
        _close(world("width2")["params"], want)


class TestModels:
    def test_transformer_shard_level3(self, ref, world):
        jlm = ref["lm"](LM_KW)
        want = [float(jlm.fit_batch(_tokens())) for _ in range(3)]
        got = world("lm3")
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        _lm_close(got["wte"], np.asarray(jlm.params["wte"]))
        from deeplearning4j_tpu.parallel.sharding_core import build_mesh
        sh = ref["lm"](LM_KW).shard(build_mesh(4), level=3)
        assert float(got["frac_params"]) == pytest.approx(
            _ref_fraction(sh.params))
        assert float(got["frac_opt"]) == pytest.approx(
            _ref_fraction(sh.opt_state))

    def test_fsdp_trainer(self, ref, world):
        from deeplearning4j_tpu.parallel.sharding_core import build_mesh
        toks = _tokens()
        tr = ref["lm"](LM_KW).fsdp_trainer(build_mesh(4))
        want = [float(tr.fit_batch(toks[:, :-1], toks[:, 1:]))
                for _ in range(3)]
        got = world("fsdp")
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert float(got["frac"]) == pytest.approx(tr.shard_fraction())
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[prefix + k] = np.asarray(v)
        walk(tr.gathered_params(), "")
        for k, v in flat.items():
            _lm_close(got[k], v, k)

    def test_fsdp_mlp(self, ref, world):
        mlp = ref["mlp"]()
        X, Y = _stream()
        want = [float(mlp.fit_batch(X[:32], Y[:32])) for _ in range(3)]
        got = world("fsdp_mlp")
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert float(got["frac"]) == pytest.approx(mlp.shard_fraction())
        for k, v in mlp.gathered_params().items():
            _close(got[k], v, k)
        _close(got["predict"], mlp.predict(X[:8]))

    def test_graph_injected_plan(self, ref, world):
        from deeplearning4j_tpu.datasets.dataset import MultiDataSet
        cg = ref["graph"]()
        X, Y = _stream()
        for i in range(0, 32, 16):
            cg.fit_batch(MultiDataSet([X[i:i + 16]], [Y[i:i + 16]]))
        got = world("graph")
        _close(got["params"], np.asarray(cg.params()))
        assert float(got["frac"]) == pytest.approx(0.25)


class TestSolversAndPretrainUnderAPlan:
    @pytest.mark.parametrize("level", [0, 3])
    @pytest.mark.parametrize("algo", SOLVERS)
    def test_line_search_solvers(self, ref, world, algo, level):
        """Each solver at 4 ranks against the reference's ParallelWrapper
        at ``workers=4`` over its mesh (one epoch of 16-row batches, 3
        solver iterations a batch): the parameters within 1e-5 of their
        max abs, the score at rtol 1e-5."""
        from deeplearning4j_tpu.models.multi_layer_network import \
            MultiLayerNetwork
        net = MultiLayerNetwork(_solver_conf(ref["jpkg"], algo)).init(
            params=np.asarray(ref["mln"]().params()))
        _ref_pw(level, epochs=1, net=net)
        got = world(f"solver_{algo}_{level}")
        _close(got["params"], np.asarray(net.params()), f"{algo} {level}")
        assert float(got["score"]) == pytest.approx(float(net.score_),
                                                    rel=1e-5)

    @pytest.mark.parametrize("level", [0, 3])
    def test_layerwise_pretraining(self, world, level):
        """An AutoEncoder with corruption, an RBM (CD-2) and a VAE
        pretrained at 4 ranks, each on its rows: the net of one process
        pretrained on the global batches, within 1e-5 of the max abs;
        every rank alike."""
        got = {r: np.load(os.path.join(world.dir, f"pretrain{level}_r{r}"
                                       ".npz")) for r in range(WORLD)}
        start = got[0]
        X, _ = _stream()
        one = _port_pretrain_net(params=world.init["pretrain"])
        one.pretrain(_pretrain_batches(X))
        want = one.params()
        assert not np.array_equal(want, world.init["pretrain"])
        _close(start["params"], want, f"level {level}")
        assert float(start["score"]) == pytest.approx(float(one.score_),
                                                      rel=1e-4)
        for r in range(1, WORLD):
            np.testing.assert_array_equal(got[r]["params"],
                                          start["params"])

    def test_graph_vertex_pretraining(self, world):
        X, _ = _stream()
        one = _port_pretrain_graph(params=world.init["pretrain_cg"])
        one.pretrain_vertex("vae", _pretrain_batches(X))
        _close(world("pretrain_cg")["params"], one.params())


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
