"""GPipe pipeline parallelism in the port, held against the reference's.

The port runs one process a rank over gloo on the CPU: one world of 4
ranks for the whole file (the module fixture ``world``; every rank runs
every scenario of :func:`_scenarios`, grids of 2 or 4 ranks formed
inside it, and rank 0 writes the results). The reference runs its
``PPTransformerLM`` and ``PipelineParallelNet`` on its 8-device virtual
mesh at the same shapes. Both start from the reference's initial
parameters (carried across through ``params=``) and draw nothing in
training, so they agree to f32 rounding.

The matrix mirrors ``tests/test_model_parallelism.py``'s
``TestPPTransformer`` and ``TestPipelineParallel``: (stages, micro) (2,
4) and (4, 2) after 3 steps against the reference's trainer and the
port's single-device LM (losses and logits within 1e-5 of their max
abs, parameters within ``torch_world.drift_bars``), bf16 with remat and
blockwise attention (the ``scan`` route) at the reference's 5e-2 loss
bar, the blocks really sharded, the MLP pipeline alone and under data
parallelism, and every refusal with the reference's message.
"""

import os
import sys

import numpy as np
import pytest

import torch_world as tw

WORLD = 4
CONF = dict(vocab_size=40, max_len=32, d_model=32, n_heads=4, n_layers=4,
            d_ff=64, learning_rate=1e-3, seed=0)
BF16 = dict(CONF, remat=True, compute_dtype="bfloat16", block_size=16)
STEPS = 3
NET_STEPS = 5
# (name, data rows, stages, microbatches) of the MLP pipeline
NETS = [("net14", 1, 4, 4), ("net22", 2, 2, 2)]


def _tokens(seed=0, rows=8):
    return np.random.RandomState(seed).randint(0, 40, (rows, 17))


def _net_data(rows):
    rng = np.random.RandomState(5)
    x = rng.randn(rows, 6).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.randint(0, 3, rows)]


# ---- one rank of the world -------------------------------------------------
def _scenarios(rank, world, port, out):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (
        PipelineParallelNet, pp_mesh)
    from deeplearning4j_tpu_torch.parallel.pp_transformer import \
        PPTransformerLM

    tw.join(rank, world, port)
    init = np.load(os.path.join(out, "init.npz"))
    params = tw.unflat({k[3:]: init[k] for k in init.files
                        if k.startswith("lm/")})

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    for name, S, M, kw, toks in (("pp24", 2, 4, CONF, _tokens(0)),
                                 ("pp42", 4, 2, CONF, _tokens(0)),
                                 ("bf16", 2, 2, BF16, _tokens(2, 4))):
        mesh = pp_mesh(1, S)
        if mesh is None:
            continue
        if name == "bf16":
            os.environ["DL4J_TORCH_LM_ATTN"] = "scan"
        pp = PPTransformerLM(mesh, TransformerConfig(**kw), M,
                             params=params, device="cpu")
        losses = [float(pp.fit_batch(toks)) for _ in range(STEPS)]
        os.environ.pop("DL4J_TORCH_LM_ATTN", None)
        save(name, losses=np.array(losses), frac=pp.shard_fraction(),
             logits=pp.gathered_logits(toks[:, :-1]),
             **tw.flat(pp.gathered_params()))

    for name, n_data, S, M in NETS:
        mesh = pp_mesh(n_data, S)
        if mesh is None:
            continue
        net = PipelineParallelNet(mesh, 6, 16, 3, M, lr=0.5, device="cpu",
                                  params={k.split("/", 1)[1]: init[k]
                                          for k in init.files
                                          if k.startswith(f"{name}/")})
        x, y = _net_data(24 if n_data == 2 else 32)
        first = net.reference_loss(x, y)
        losses = [float(net.fit_batch(x, y)) for _ in range(NET_STEPS)]
        save(name, losses=np.array(losses), first=first,
             **net.gathered_params())
    multihost.shutdown()


# ---- the reference ---------------------------------------------------------
def _pipe_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("pipe",))


def _lm_layout(params, n_layers):
    """The reference PP trainer's stacked (S, bps, ...) blocks as the
    LM's ``b0`` ... leaves."""
    out = {k: np.asarray(params[k]) for k in ("wte", "wpe", "lnf_g",
                                              "lnf_b")}
    for key, a in params["blocks"].items():
        a = np.asarray(a, np.float32)
        a = a.reshape((n_layers,) + a.shape[2:])
        for i in range(n_layers):
            out[f"b{i}.{key}"] = a[i]
    return out


def _ref_net(n_data, S, M):
    import jax
    from deeplearning4j_tpu.parallel.pipeline_parallel import (
        PipelineParallelNet, pp_mesh)
    return PipelineParallelNet(
        pp_mesh(n_data, S, jax.devices()[:n_data * S]), n_in=6, d=16,
        n_out=3, n_micro=M, lr=0.5, seed=1)


@pytest.fixture(scope="module")
def init():
    """The reference's initial parameters, handed to the port: the LM's
    and each MLP pipeline's."""
    import jax
    from deeplearning4j_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    out = {"lm": tw.flat(jax.tree.map(np.asarray, TransformerLM(
        TransformerConfig(**CONF)).init().params))}
    for name, n_data, S, M in NETS:
        out[name] = {k: np.asarray(v)
                     for k, v in _ref_net(n_data, S, M).params.items()}
    return out


@pytest.fixture(scope="module")
def world(init, tmp_path_factory):
    """Start the port's world of 4 ranks once; a loader of its results
    (which waits for the world)."""
    out = str(tmp_path_factory.mktemp("pp_world"))
    np.savez(os.path.join(out, "init.npz"),
             **{f"{name}/{k}": v for name, tree in init.items()
                for k, v in tree.items()})
    return tw.spawn(os.path.abspath(__file__), out, WORLD)


@pytest.fixture(scope="module")
def ref(init, world):
    """The reference's trainers' results, computed while the port's
    world runs."""
    import jax
    from deeplearning4j_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from deeplearning4j_tpu.parallel.pp_transformer import PPTransformerLM

    lm = TransformerLM(TransformerConfig(**CONF)).init()
    for _ in range(STEPS):
        lm.fit_batch(_tokens(0))
    out = {"init": init["lm"],
           "single": tw.flat(jax.tree.map(np.asarray, lm.params))}
    for name, S, M, kw, toks in (("pp24", 2, 4, CONF, _tokens(0)),
                                 ("pp42", 4, 2, CONF, _tokens(0)),
                                 ("bf16", 2, 2, BF16, _tokens(2, 4))):
        pp = PPTransformerLM(_pipe_mesh(S), TransformerConfig(**kw),
                             n_micro=M)
        losses = [float(pp.fit_batch(toks)) for _ in range(STEPS)]
        out[name] = dict(losses=np.array(losses), frac=pp.shard_fraction(),
                         params=_lm_layout(pp.params, kw["n_layers"]))
    for name, n_data, S, M in NETS:
        net = _ref_net(n_data, S, M)
        x, y = _net_data(24 if n_data == 2 else 32)
        first = net.reference_loss(x, y)
        losses = [float(net.fit_batch(x, y)) for _ in range(NET_STEPS)]
        out[name] = dict(losses=np.array(losses), first=first,
                         **{k: np.asarray(v) for k, v in net.params.items()})
    return out


# ---- the matrix --------------------------------------------------------------
class TestPPTransformer:
    @pytest.mark.parametrize("name", ["pp24", "pp42"])
    def test_matches_reference_and_single_device(self, ref, world, name):
        """(S, M) = (2, 4) and (4, 2) after 3 steps: the losses within
        1e-5 of their max abs of the reference's PP trainer and of the
        port's single-device LM, the logits of the single-device LM's,
        and every parameter within its drift bar of both."""
        got = world(name)
        toks = _tokens(0)
        single = tw.single_lm(ref["init"], CONF, STEPS, toks)
        for other, what in ((ref[name], "reference PP"),
                            (single, "port LM")):
            tw.close(got["losses"], other["losses"], f"{name} {what}")
        tw.close(got["logits"], single["logits"], f"{name} logits")
        bars = tw.drift_bars(ref["init"], CONF, STEPS, toks,
                             single["params"], ref["single"])
        for k, v in single["params"].items():
            for other, what in ((v, "the port's LM"),
                                (ref[name]["params"][k], "the reference")):
                np.testing.assert_allclose(
                    got[k], other, rtol=0, atol=bars[k],
                    err_msg=f"{name} {k} against {what}")

    def test_remat_bf16_blockwise_variant_matches(self, ref, world):
        """remat, bf16 compute and blockwise attention are kept: the
        reference's bar (5e-2 on the loss) against the reference's PP run
        and the port's single-device run of the same configuration."""
        got = world("bf16")["losses"]
        os.environ["DL4J_TORCH_LM_ATTN"] = "scan"
        try:
            single = tw.single_lm(ref["init"], BF16, STEPS, _tokens(2, 4))
        finally:
            os.environ.pop("DL4J_TORCH_LM_ATTN")
        np.testing.assert_allclose(got, ref["bf16"]["losses"], atol=5e-2)
        np.testing.assert_allclose(got, single["losses"], atol=5e-2)

    @pytest.mark.parametrize("name", ["pp24", "pp42"])
    def test_block_params_actually_sharded(self, ref, world, name):
        frac = float(world(name)["frac"])
        assert frac == pytest.approx(float(ref[name]["frac"]))
        assert 0.25 < frac < 0.8, frac


class TestPipelineParallelNet:
    @pytest.mark.parametrize("name", [n for n, *_ in NETS])
    def test_matches_reference_with_weights_carried(self, ref, world, name):
        """One stage a rank (1 x 4, M 4) and pipes under data
        parallelism (2 x 2, M 2), 5 SGD steps from the reference's
        weights: the unpipelined loss before the first step equals the
        pipelined step's (GPipe is math-preserving), and the losses and
        every leaf are within 1e-5 of their max abs of the reference's."""
        got, want = world(name), ref[name]
        assert float(got["first"]) == pytest.approx(float(want["first"]),
                                                    rel=1e-5)
        assert got["losses"][0] == pytest.approx(float(got["first"]),
                                                 rel=1e-4)
        tw.close(got["losses"], want["losses"], "losses")
        for k in ("W", "b", "Win", "Wout"):
            tw.close(got[k], want[k], k)
        assert got["losses"][-1] < got["losses"][0]


def _pp_conf(**kw):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**dict(CONF, **kw))


def _ref_conf(**kw):
    from deeplearning4j_tpu.models.transformer import TransformerConfig
    return TransformerConfig(**dict(CONF, **kw))


def _grid(n_data, n_pipe):
    """A grid of one rank's view, no process group: every refusal is
    raised before any collective."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    return TPMesh(n_data, n_pipe, 0, 0, axis_names=("data", "pipe"))


class TestRefusals:
    @pytest.mark.parametrize("kw,stages,micro,words", [
        (dict(dropout=0.1), 2, 2, "dropout"),
        (dict(pos_embed="rope"), 2, 2, "wpe"),
        ({}, 2, 0, "microbatch"),
        ({}, 3, 2, "stages"),
    ])
    def test_constructor_refusals(self, kw, stages, micro, words):
        from deeplearning4j_tpu.parallel.pp_transformer import \
            PPTransformerLM as RefPP
        from deeplearning4j_tpu_torch.parallel.pp_transformer import \
            PPTransformerLM
        msg = tw.refusal(
            lambda: RefPP(_pipe_mesh(stages), _ref_conf(**kw), n_micro=micro),
            lambda: PPTransformerLM(_grid(1, stages), _pp_conf(**kw), micro,
                                    device="cpu"))
        assert words in msg

    def test_batch_microbatch_divisibility(self):
        from deeplearning4j_tpu.parallel.pp_transformer import \
            PPTransformerLM as RefPP
        from deeplearning4j_tpu_torch.parallel.pp_transformer import \
            PPTransformerLM
        toks = np.zeros((8, 17), np.int32)
        msg = tw.refusal(
            lambda: RefPP(_pipe_mesh(2), _ref_conf(), n_micro=3)
            .fit_batch(toks),
            lambda: PPTransformerLM(_grid(1, 2), _pp_conf(), 3, device="cpu")
            .fit_batch(toks))
        assert "multiple" in msg

    def test_net_refusals(self):
        import jax
        from deeplearning4j_tpu.parallel.pipeline_parallel import (
            PipelineParallelNet as RefNet, pp_mesh)
        from deeplearning4j_tpu_torch.parallel.pipeline_parallel import \
            PipelineParallelNet
        mesh = pp_mesh(2, 4, jax.devices()[:8])
        tw.refusal(lambda: RefNet(mesh, 6, 16, 3, n_micro=0),
                   lambda: PipelineParallelNet(_grid(2, 4), 6, 16, 3, 0,
                                               device="cpu"))
        x, y = np.zeros((8, 6), np.float32), np.zeros((8, 3), np.float32)
        msg = tw.refusal(
            lambda: RefNet(mesh, 6, 16, 3, n_micro=3).fit_batch(x, y),
            lambda: PipelineParallelNet(_grid(2, 4), 6, 16, 3, 3,
                                        device="cpu").fit_batch(x, y))
        assert "multiple" in msg


if __name__ == "__main__":
    sys.path.insert(0, tw.REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
