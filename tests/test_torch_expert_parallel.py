"""Expert parallelism in the port, held against the reference's and the
port's dense MoE LM.

One world of 4 CPU ranks over gloo for the whole file (the module
fixture ``world``; expert grids of 2 and 4 ranks formed inside it, rank
0 writes the results). The reference runs ``EPTransformerLM`` and
``ExpertParallelMoE`` on its 8-device virtual mesh from the same
parameters (carried across through ``params=``) and batches.

The matrix mirrors ``tests/test_model_parallelism.py``'s
``TestEPTransformer`` and ``TestExpertParallel``: top-1 and top-2 at 4
experts after 3 steps (``aux_weight`` 0, where the math is exact)
against the reference's trainer and the port's dense
``MoETransformerLM`` (losses within 1e-5 of their max abs, parameters
within ``torch_world.drift_bars``); the aux term's local approximation
against the reference's; a capacity of 1 against the reference's drops;
the tokens a expert summing to the batch; the residual MoE block's
sharded forward against its dense oracle, its training against the
reference's, and a dropped token riding the residual; and every refusal
with the reference's message.
"""

import os
import sys

import numpy as np
import pytest

import torch_world as tw

WORLD = 4
CONF = dict(vocab_size=40, max_len=32, d_model=32, n_heads=4, n_layers=2,
            d_ff=64, n_experts=4, moe_every=2, aux_weight=0.0,
            learning_rate=1e-3, seed=0)
STEPS = 3
MOE_STEPS = 10
# (name, configuration changes, capacity, token seed)
RUNS = [("top1", {}, 0, 0), ("top2", dict(router_top_k=2), 0, 3),
        ("aux", dict(aux_weight=0.01), 0, 1), ("cap1", {}, 1, 2)]


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, 40, (8, 17))


def _moe_data():
    rng = np.random.RandomState(4)
    x = rng.randn(32, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[
        (x[:, 0] > 0).astype(int) + (x[:, 1] > 0).astype(int)]
    return x, y


def _same_tokens():
    return np.tile(np.random.RandomState(6).randn(1, 8).astype(np.float32),
                   (8, 1))


# ---- one rank of the world -------------------------------------------------
def _scenarios(rank, world, port, out):
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerConfig
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.ep_transformer import \
        EPTransformerLM
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        ExpertParallelMoE, ep_mesh)

    tw.join(rank, world, port)
    init = np.load(os.path.join(out, "init.npz"))
    params = tw.unflat({k[3:]: init[k] for k in init.files
                        if k.startswith("lm/")})
    moe_init = {k[4:]: init[k] for k in init.files if k.startswith("moe/")}

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    meshes = {n: ep_mesh(n) for n in (2, 4)}
    mesh = meshes[4]
    for name, kw, cap, seed in RUNS:
        ep = EPTransformerLM(mesh, MoETransformerConfig(**dict(CONF, **kw)),
                             capacity=cap, params=params, device="cpu")
        losses = [float(ep.fit_batch(_tokens(seed))) for _ in range(STEPS)]
        save(name, losses=np.array(losses), routed=ep.routed.numpy(),
             **tw.flat(ep.gathered_params()))

    moe = ExpertParallelMoE(mesh, 8, 16, 3, lr=0.5, params=moe_init,
                            device="cpu")
    x, y = _moe_data()
    before = moe.predict(x)
    oracle = moe.reference_forward(x)
    losses = [float(moe.fit_batch(x, y)) for _ in range(MOE_STEPS)]
    save("moe", predict=before, oracle=oracle, losses=np.array(losses),
         **moe.gathered_params())

    if meshes[2] is not None:
        two = {k: (v[:2] if k in ("W1", "W2") else
                   (v[:, :2] if k == "gate" else v))
               for k, v in moe_init.items()}
        moe = ExpertParallelMoE(meshes[2], 8, 16, 3, capacity=1,
                                params=two, device="cpu")
        x = _same_tokens()
        save("moe_cap1", predict=moe.predict(x, capacity=1),
             loss=float(moe.fit_batch(x, np.eye(3, dtype=np.float32)[
                 np.zeros(8, int)])), **moe.gathered_params())
    multihost.shutdown()


# ---- the reference ---------------------------------------------------------
def _expert_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("expert",))


def _ref_moe(E, **kw):
    import jax
    from deeplearning4j_tpu.parallel.expert_parallel import (
        ExpertParallelMoE, ep_mesh)
    return ExpertParallelMoE(ep_mesh(E, jax.devices()[:E]), d=8, hidden=16,
                             n_out=3, seed=1, **kw)


@pytest.fixture(scope="module")
def init():
    import jax
    from deeplearning4j_tpu.models.moe_transformer import (
        MoETransformerConfig, MoETransformerLM)
    return {"lm": tw.flat(jax.tree.map(np.asarray, MoETransformerLM(
        MoETransformerConfig(**CONF)).init().params)),
        "moe": {k: np.asarray(v) for k, v in _ref_moe(4).params.items()}}


@pytest.fixture(scope="module")
def world(init, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep_world"))
    np.savez(os.path.join(out, "init.npz"),
             **{f"{name}/{k}": v for name, tree in init.items()
                for k, v in tree.items()})
    return tw.spawn(os.path.abspath(__file__), out, WORLD)


@pytest.fixture(scope="module")
def ref(init, world):
    """The reference's results, computed while the port's world runs."""
    import jax
    from deeplearning4j_tpu.models.moe_transformer import (
        MoETransformerConfig, MoETransformerLM)
    from deeplearning4j_tpu.parallel.ep_transformer import EPTransformerLM

    out = {}
    for name, kw, cap, seed in RUNS:
        conf = MoETransformerConfig(**dict(CONF, **kw))
        ep = EPTransformerLM(_expert_mesh(4), conf, capacity=cap)
        losses = [float(ep.fit_batch(_tokens(seed))) for _ in range(STEPS)]
        out[name] = dict(losses=np.array(losses))
        if name in ("top1", "top2"):
            lm = MoETransformerLM(conf).init()
            for _ in range(STEPS):
                lm.fit_batch(_tokens(seed))
            out[name]["single"] = tw.flat(jax.tree.map(np.asarray,
                                                       lm.params))
            out[name]["params"] = tw.flat(jax.tree.map(np.asarray,
                                                       ep.params))
    moe = _ref_moe(4, lr=0.5)
    x, y = _moe_data()
    out["moe"] = dict(oracle=moe.reference_forward(x), losses=np.array(
        [float(moe.fit_batch(x, y)) for _ in range(MOE_STEPS)]),
        **{k: np.asarray(v) for k, v in moe.params.items()})
    return out


# ---- the matrix --------------------------------------------------------------
class TestEPTransformer:
    @pytest.mark.parametrize("name,kw,seed", [("top1", {}, 0),
                                              ("top2", dict(router_top_k=2),
                                               3)])
    def test_matches_reference_and_dense_moe(self, init, ref, world, name,
                                             kw, seed):
        """Top-1 (Switch) and top-2 (GShard) after 3 steps at lossless
        capacity, aux off: the losses within 1e-5 of their max abs of the
        reference's EP trainer and of the port's dense MoETransformerLM,
        every parameter within its drift bar of both."""
        got = world(name)
        kw = dict(CONF, **kw)
        single = tw.single_lm(init["lm"], kw, STEPS, _tokens(seed), moe=True)
        for other, what in ((ref[name], "reference EP"),
                            (single, "port dense MoE")):
            tw.close(got["losses"], other["losses"], f"{name} {what}")
        bars = tw.drift_bars(init["lm"], kw, STEPS, _tokens(seed),
                             single["params"], ref[name]["single"],
                             moe=True)
        for k, v in single["params"].items():
            for other, what in ((v, "the port's dense MoE"),
                                (ref[name]["params"][k], "the reference")):
                np.testing.assert_allclose(
                    got[k], other, rtol=0, atol=bars[k],
                    err_msg=f"{name} {k} against {what}")

    @pytest.mark.parametrize("name", ["aux", "cap1"])
    def test_aux_and_capacity_match_reference(self, ref, world, name):
        """The load-balance term's local approximation (aux 0.01), and a
        capacity of 1 whose dropped tokens ride the residual: the losses
        within 1e-5 of their max abs of the reference's."""
        got = world(name)["losses"]
        assert np.all(np.isfinite(got))
        tw.close(got, ref[name]["losses"], name)

    def test_tokens_per_expert(self, world):
        """Every token routed once a MoE layer: the first choices over
        the experts sum to the batch (8 rows x 16 tokens)."""
        routed = world("top1")["routed"]
        assert routed.shape == (1, 4)
        assert routed.sum() == 8 * 16


class TestExpertParallelMoE:
    def test_sharded_forward_matches_dense_oracle(self, ref, world):
        """All-to-all dispatch at lossless capacity reproduces the dense
        per-token routing (the reference's oracle, on the reference's
        weights) within 1e-5."""
        got = world("moe")
        np.testing.assert_allclose(got["predict"], got["oracle"], atol=1e-5)
        np.testing.assert_allclose(got["oracle"], ref["moe"]["oracle"],
                                   atol=1e-5)

    def test_training_matches_reference(self, ref, world):
        """10 SGD steps from the reference's weights: losses and every
        leaf within 1e-5 of their max abs of the reference's; the loss
        falls."""
        got, want = world("moe"), ref["moe"]
        tw.close(got["losses"], want["losses"], "losses")
        for k in ("gate", "W1", "W2", "head"):
            tw.close(got[k], want[k], k)
        assert got["losses"][-1] < 0.7 * got["losses"][0]

    def test_capacity_overflow_drops_to_residual(self, init, world):
        """Capacity 1 and eight identical tokens on two experts: on each
        rank the first token gets its expert's output and the other three
        pass through as the residual alone (within 1e-5 of the max abs of
        the numpy forward from the carried-in weights); the step stays
        finite."""
        got = world("moe_cap1")
        p = init["moe"]
        x = _same_tokens()[0]

        def softmax(a):
            e = np.exp(a - a.max(-1, keepdims=True))
            return e / e.sum(-1, keepdims=True)
        probs = softmax(x @ p["gate"][:, :2])
        e = int(probs.argmax())
        moe = probs[e] * (np.maximum(x @ p["W1"][e], 0.0) @ p["W2"][e])
        routed, residual = softmax((x + moe) @ p["head"]), \
            softmax(x @ p["head"])
        tw.close(got["predict"], np.stack([routed] + [residual] * 3
                                          + [routed] + [residual] * 3))
        assert np.isfinite(float(got["loss"]))


def _grid(n, names=("data", "expert")):
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    return TPMesh(1, n, 0, 0, axis_names=names)


def _confs(**kw):
    from deeplearning4j_tpu.models.moe_transformer import \
        MoETransformerConfig as RefConf
    from deeplearning4j_tpu_torch.models.moe_transformer import \
        MoETransformerConfig
    return RefConf(**dict(CONF, **kw)), MoETransformerConfig(
        **dict(CONF, **kw))


class TestRefusals:
    @pytest.mark.parametrize("kw,n,words", [
        (dict(dropout=0.1), 4, "dropout"),
        (dict(block_size=16), 4, "block_size"),
        ({}, 2, "n_experts")])
    def test_constructor_refusals(self, kw, n, words):
        from deeplearning4j_tpu.parallel.ep_transformer import \
            EPTransformerLM as RefEP
        from deeplearning4j_tpu_torch.parallel.ep_transformer import \
            EPTransformerLM
        ref_conf, conf = _confs(**kw)
        msg = tw.refusal(lambda: RefEP(_expert_mesh(n), ref_conf),
                         lambda: EPTransformerLM(_grid(n), conf,
                                                 device="cpu"))
        assert words in msg

    def test_missing_axis(self):
        """Both name the missing axis (each lists its own mesh's
        axes)."""
        import jax
        from jax.sharding import Mesh
        from deeplearning4j_tpu.parallel.ep_transformer import \
            EPTransformerLM as RefEP
        from deeplearning4j_tpu_torch.parallel.ep_transformer import \
            EPTransformerLM
        ref_conf, conf = _confs()
        for fn in (lambda: RefEP(Mesh(np.array(jax.devices()[:4]), ("seq",)),
                                 ref_conf),
                   lambda: EPTransformerLM(_grid(4, ("data", "seq")), conf,
                                           device="cpu")):
            with pytest.raises(ValueError, match="mesh has no 'expert' axis"):
                fn()

    def test_batch_divisibility(self):
        from deeplearning4j_tpu.parallel.ep_transformer import \
            EPTransformerLM as RefEP
        from deeplearning4j_tpu_torch.parallel.ep_transformer import \
            EPTransformerLM
        ref_conf, conf = _confs()
        toks = np.zeros((6, 17), np.int32)
        msg = tw.refusal(
            lambda: RefEP(_expert_mesh(4), ref_conf).fit_batch(toks),
            lambda: EPTransformerLM(_grid(4), conf, device="cpu")
            .fit_batch(toks))
        assert "multiple" in msg

    def test_moe_batch_divisibility(self):
        from deeplearning4j_tpu_torch.parallel.expert_parallel import \
            ExpertParallelMoE
        x = np.zeros((6, 8), np.float32)
        y = np.zeros((6, 3), np.float32)
        msg = tw.refusal(
            lambda: _ref_moe(4).fit_batch(x, y),
            lambda: ExpertParallelMoE(_grid(4), 8, 16, 3, device="cpu")
            .fit_batch(x, y))
        assert "multiple" in msg


if __name__ == "__main__":
    sys.path.insert(0, tw.REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
