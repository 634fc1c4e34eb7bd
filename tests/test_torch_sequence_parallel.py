"""Ring and Ulysses sequence parallelism in the port, held against the
reference's and against dense attention.

One world of 4 CPU ranks over gloo for the whole file (the module
fixture ``world``; grids of 2 and 4 ranks along a ``seq`` axis formed
inside it, rank 0 writes the results), as
``test_torch_tensor_parallel.py`` runs its own. The reference runs
``SPTransformerLM``, ``sequence_parallel_attention`` and
``ulysses_attention`` on its 8-device virtual mesh at the same shapes,
from the same parameters and inputs (made with numpy from a seed).

The matrix mirrors ``tests/test_model_parallelism.py``'s
``TestSPTransformer`` and ``tests/test_sequence_parallel.py``: SP 2 and
4 after 3 steps against the reference's trainer and the port's
single-device LM (losses within 1e-5 of their max abs, parameters within
``torch_world.drift_bars``), bf16 with remat at the reference's 5e-2;
ring attention against ``dense_attention`` (causal, a key mask, 4-D
heads, and the gradients of q, k and v) within 1e-5 of the max abs;
Ulysses causal and not; ``SelfAttentionLayer(sequence_axis="seq")``
against its dense branch with a mask, output and parameter gradients;
and every refusal with the reference's message.
"""

import os
import sys

import numpy as np
import pytest

import torch_world as tw

WORLD = 4
CONF = dict(vocab_size=40, max_len=32, d_model=32, n_heads=4, n_layers=2,
            d_ff=64, learning_rate=1e-3, seed=0)
BF16 = dict(CONF, remat=True, compute_dtype="bfloat16")
STEPS = 3


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 40, (4, 17))


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _mask(b, t):
    m = np.ones((b, t), np.float32)
    m[0, 5:9] = 0.0       # keys inside the first rank's and the second's
    m[1, t - 6:] = 0.0    # a padded tail
    return m


LAYER = dict(n_in=8, n_out=8, n_heads=2, causal=True)


def _layer_params():
    rng = np.random.RandomState(7)
    p = {k: (0.3 * rng.randn(8, 8)).astype(np.float32)
         for k in ("Wq", "Wk", "Wv", "Wo")}
    p["b"] = (0.1 * rng.randn(8)).astype(np.float32)
    return p


def _layer_input():
    return np.random.RandomState(8).randn(2, 16, 8).astype(np.float32)


# ---- one rank of the world -------------------------------------------------
def _ring_cases(rank, mesh, save):
    """ring_attention on local shards inside ``with mesh:`` (forward and
    the gradients of a weighted sum), gathered whole."""
    import torch
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
        ring_attention
    n = mesh.axis_size("seq")
    for name, shape, causal, masked in (
            ("causal", (2, 16, 8), True, False),
            ("full", (2, 16, 8), False, False),
            ("masked", (2, 16, 8), True, True),
            ("heads", (2, 4, 16, 8), True, True)):
        T = shape[-2]
        q, k, v = (torch.tensor(a).chunk(n, dim=-2)[mesh.axis_index("seq")]
                   .clone().requires_grad_(True)
                   for a in _qkv(shape, 11))
        w = torch.tensor(_qkv(shape, 12)[0]).chunk(n, dim=-2)[
            mesh.axis_index("seq")]
        mask = None
        if masked:
            mask = torch.tensor(_mask(shape[0], T)).chunk(n, dim=-1)[
                mesh.axis_index("seq")]
        with mesh:
            o = ring_attention(q, k, v, axis_name="seq", causal=causal,
                               mask=mask)
            gq, gk, gv = torch.autograd.grad((o * w).sum(), (q, k, v))
        whole = {key: mesh.all_gather(a.detach(), "seq", dim=a.ndim - 2)
                 .numpy() for key, a in (("o", o), ("dq", gq), ("dk", gk),
                                         ("dv", gv))}
        save(f"ring{n}_{name}", **whole)


def _scenarios(rank, world, port, out):
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        sequence_parallel_attention, ulysses_attention)
    from deeplearning4j_tpu_torch.parallel.sp_transformer import \
        SPTransformerLM
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import tp_mesh

    tw.join(rank, world, port)
    init = np.load(os.path.join(out, "init.npz"))
    params = tw.unflat({k: init[k] for k in init.files})

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    meshes = {n: tp_mesh(1, n, ("data", "seq")) for n in (2, 4)}
    for name, n, kw, toks in (("sp2", 2, CONF, _tokens(0)),
                              ("sp4", 4, CONF, _tokens(0)),
                              ("bf16", 2, BF16, _tokens(2))):
        if meshes[n] is None:
            continue
        sp = SPTransformerLM(meshes[n], TransformerConfig(**kw),
                             params=params, device="cpu")
        losses = [float(sp.fit_batch(toks)) for _ in range(STEPS)]
        save(name, losses=np.array(losses), **tw.flat(sp.gathered_params()))

    for n, mesh in meshes.items():
        if mesh is None:
            continue
        _ring_cases(rank, mesh, save)
        q, k, v = (torch.tensor(a) for a in _qkv((2, 16, 8), 21))
        save(f"host{n}", o=sequence_parallel_attention(
            q, k, v, mesh, causal=True).numpy())
        q, k, v = (torch.tensor(a) for a in _qkv((2, 16, 4, 8), 22))
        for causal in (True, False):
            save(f"ulysses{n}_{causal}", o=ulysses_attention(
                q, k, v, mesh, causal=causal).numpy())

    mesh = meshes[2]
    if mesh is not None:
        layer = SelfAttentionLayer(**LAYER, sequence_axis="seq") \
            .apply_global_defaults({})
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in _layer_params().items()}
        i = mesh.axis_index("seq")
        x = torch.tensor(_layer_input()).chunk(2, dim=1)[i]
        m = torch.tensor(_mask(2, 16)).chunk(2, dim=1)[i]
        with mesh:
            o, _ = layer.forward(p, x, {}, mask=m)
            grads = torch.autograd.grad(o.sum(), list(p.values()))
        # each rank's parameter gradients cover its rows: their sum is the
        # whole sequence's
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce(flat, "seq")
        save("layer", o=mesh.all_gather(o.detach(), "seq", dim=1).numpy(),
             grads=flat.numpy())
    multihost.shutdown()


# ---- the reference ---------------------------------------------------------
def _seq_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


@pytest.fixture(scope="module")
def init():
    import jax
    from deeplearning4j_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    return tw.flat(jax.tree.map(np.asarray, TransformerLM(
        TransformerConfig(**CONF)).init().params))


@pytest.fixture(scope="module")
def world(init, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sp_world"))
    np.savez(os.path.join(out, "init.npz"), **init)
    return tw.spawn(os.path.abspath(__file__), out, WORLD)


@pytest.fixture(scope="module")
def ref(init, world):
    """The reference's results, computed while the port's world runs."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from deeplearning4j_tpu.parallel.sequence_parallel import (
        sequence_parallel_attention, ulysses_attention)
    from deeplearning4j_tpu.parallel.sp_transformer import SPTransformerLM

    lm = TransformerLM(TransformerConfig(**CONF)).init()
    for _ in range(STEPS):
        lm.fit_batch(_tokens(0))
    out = {"single": tw.flat(jax.tree.map(np.asarray, lm.params))}
    for name, n, kw, toks in (("sp2", 2, CONF, _tokens(0)),
                              ("sp4", 4, CONF, _tokens(0)),
                              ("bf16", 2, BF16, _tokens(2))):
        sp = SPTransformerLM(_seq_mesh(n), TransformerConfig(**kw))
        losses = [float(sp.fit_batch(toks)) for _ in range(STEPS)]
        out[name] = dict(losses=np.array(losses), params=tw.flat(
            jax.tree.map(np.asarray, sp.params)))
    for n in (2, 4):
        q, k, v = (jnp.asarray(a) for a in _qkv((2, 16, 8), 21))
        out[f"host{n}"] = np.asarray(sequence_parallel_attention(
            q, k, v, _seq_mesh(n), causal=True))
        q, k, v = (jnp.asarray(a) for a in _qkv((2, 16, 4, 8), 22))
        for causal in (True, False):
            out[f"ulysses{n}_{causal}"] = np.asarray(ulysses_attention(
                q, k, v, _seq_mesh(n), causal=causal))
    return out


# ---- the matrix --------------------------------------------------------------
class TestSPTransformer:
    @pytest.mark.parametrize("name", ["sp2", "sp4"])
    def test_matches_reference_and_single_device(self, init, ref, world,
                                                 name):
        """SP 2 and 4 after 3 steps: the losses within 1e-5 of their max
        abs of the reference's SP trainer and of the port's single-device
        LM, every parameter within its drift bar of both."""
        got = world(name)
        single = tw.single_lm(init, CONF, STEPS, _tokens(0))
        for other, what in ((ref[name], "reference SP"),
                            (single, "port LM")):
            tw.close(got["losses"], other["losses"], f"{name} {what}")
        bars = tw.drift_bars(init, CONF, STEPS, _tokens(0),
                             single["params"], ref["single"])
        for k, v in single["params"].items():
            for other, what in ((v, "the port's LM"),
                                (ref[name]["params"][k], "the reference")):
                np.testing.assert_allclose(
                    got[k], other, rtol=0, atol=bars[k],
                    err_msg=f"{name} {k} against {what}")

    def test_remat_bf16_variant_matches(self, init, ref, world):
        """remat and bf16 compute are kept: the reference's bar (5e-2 on
        the loss) against the reference's SP run and the port's
        single-device run of the same configuration."""
        got = world("bf16")["losses"]
        single = tw.single_lm(init, BF16, STEPS, _tokens(2))
        np.testing.assert_allclose(got, ref["bf16"]["losses"], atol=5e-2)
        np.testing.assert_allclose(got, single["losses"], atol=5e-2)


def _dense(shape, causal, masked):
    """dense_attention on the whole sequence, and the gradients of the
    same weighted sum."""
    import torch
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
        dense_attention
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(shape, 11))
    w = torch.tensor(_qkv(shape, 12)[0])
    mask = torch.tensor(_mask(shape[0], shape[-2])) if masked else None
    o = dense_attention(q, k, v, causal=causal, mask=mask)
    grads = torch.autograd.grad((o * w).sum(), (q, k, v))
    return dict(o=o.detach().numpy(),
                **{key: g.numpy() for key, g in zip(("dq", "dk", "dv"),
                                                    grads)})


class TestRingAttention:
    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("name,shape,causal,masked", [
        ("causal", (2, 16, 8), True, False),
        ("full", (2, 16, 8), False, False),
        ("masked", (2, 16, 8), True, True),
        ("heads", (2, 4, 16, 8), True, True)])
    def test_matches_dense(self, world, n, name, shape, causal, masked):
        """The ring's output and the gradients of q, k and v (each rank's
        shard, gathered) within 1e-5 of the max abs of dense
        attention's on the whole sequence."""
        got, want = world(f"ring{n}_{name}"), _dense(shape, causal, masked)
        for key in ("o", "dq", "dk", "dv"):
            tw.close(got[key], want[key], f"ring {n} {name} {key}")

    @pytest.mark.parametrize("n", [2, 4])
    def test_host_entry_matches_reference(self, ref, world, n):
        """sequence_parallel_attention (the whole q/k/v in, the whole
        output out) against the reference's on its mesh."""
        tw.close(world(f"host{n}")["o"], ref[f"host{n}"])


class TestUlysses:
    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference_and_dense(self, ref, world, n, causal):
        import torch
        from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
            dense_attention
        got = world(f"ulysses{n}_{causal}")["o"]
        q, k, v = (torch.tensor(a).transpose(1, 2)
                   for a in _qkv((2, 16, 4, 8), 22))
        dense = dense_attention(q, k, v, causal=causal).transpose(1, 2)
        tw.close(got, dense.numpy(), "dense")
        tw.close(got, ref[f"ulysses{n}_{causal}"], "reference")


class TestSelfAttentionLayer:
    def test_sequence_axis_matches_dense_branch(self, world):
        """SelfAttentionLayer(sequence_axis="seq") on two ranks' shards,
        with a key mask that rotates with K/V: the output and the
        parameter gradients (summed over the ranks) within 1e-5 of the
        max abs of the dense branch's on the whole sequence."""
        import torch
        from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer
        got = world("layer")
        layer = SelfAttentionLayer(**LAYER).apply_global_defaults({})
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in _layer_params().items()}
        o, _ = layer.forward(p, torch.tensor(_layer_input()), {},
                             mask=torch.tensor(_mask(2, 16)))
        grads = torch.autograd.grad(o.sum(), list(p.values()))
        tw.close(got["o"], o.detach().numpy(), "output")
        tw.close(got["grads"], torch.cat([g.reshape(-1) for g in grads])
                 .numpy(), "gradients")


def _grid(n):
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
    return TPMesh(1, n, 0, 0, axis_names=("data", "seq"))


class TestRefusals:
    @pytest.mark.parametrize("kw,words", [
        (dict(dropout=0.1), "dropout"), (dict(block_size=16), "block_size"),
        (dict(window=4), "window"), (dict(pos_embed="rope"), "wpe")])
    def test_constructor_refusals(self, kw, words):
        from deeplearning4j_tpu.models.transformer import \
            TransformerConfig as RefConf
        from deeplearning4j_tpu.parallel.sp_transformer import \
            SPTransformerLM as RefSP
        from deeplearning4j_tpu_torch.models.transformer import \
            TransformerConfig
        from deeplearning4j_tpu_torch.parallel.sp_transformer import \
            SPTransformerLM
        msg = tw.refusal(
            lambda: RefSP(_seq_mesh(2), RefConf(**dict(CONF, **kw))),
            lambda: SPTransformerLM(_grid(2), TransformerConfig(
                **dict(CONF, **kw)), device="cpu"))
        assert words in msg

    @pytest.mark.parametrize("rows,words", [(18, "multiple"),
                                            (41, "max_len")])
    def test_sequence_refusals(self, rows, words):
        """T % N, and T past max_len (which the reference refuses rather
        than clamp the shards' wpe offsets): raised before any
        collective."""
        from deeplearning4j_tpu.models.transformer import \
            TransformerConfig as RefConf
        from deeplearning4j_tpu.parallel.sp_transformer import \
            SPTransformerLM as RefSP
        from deeplearning4j_tpu_torch.models.transformer import \
            TransformerConfig
        from deeplearning4j_tpu_torch.parallel.sp_transformer import \
            SPTransformerLM
        toks = np.zeros((2, rows), np.int32)
        msg = tw.refusal(
            lambda: RefSP(_seq_mesh(4), RefConf(**CONF)).fit_batch(toks),
            lambda: SPTransformerLM(_grid(4), TransformerConfig(**CONF),
                                    device="cpu").fit_batch(toks))
        assert words in msg

    @pytest.mark.parametrize("shape,words", [((2, 16, 3, 8), "heads"),
                                             ((2, 18, 4, 8), "sequence")])
    def test_ulysses_refusals(self, shape, words):
        import jax.numpy as jnp
        import torch
        from deeplearning4j_tpu.parallel.sequence_parallel import \
            ulysses_attention as ref_ulysses
        from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
            ulysses_attention
        x = np.zeros(shape, np.float32)
        msg = tw.refusal(
            lambda: ref_ulysses(*(jnp.asarray(x),) * 3, _seq_mesh(4)),
            lambda: ulysses_attention(*(torch.tensor(x),) * 3, _grid(4)))
        assert words in msg

    def test_ring_outside_a_grid(self):
        import torch
        from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
            ring_attention
        q = torch.zeros(1, 4, 2)
        with pytest.raises(ValueError, match="'seq'"):
            ring_attention(q, q, q, axis_name="seq")


if __name__ == "__main__":
    sys.path.insert(0, tw.REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
