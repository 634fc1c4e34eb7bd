"""Megatron tensor parallelism in the port, held against the reference's.

The port runs one process a rank over gloo on the CPU: one world of 4
ranks for the whole file (the module fixture ``world`` spawns it, every
rank runs every scenario of :func:`_scenarios`, and rank 0 writes the
results). The reference runs its ``TPTransformerLM`` and
``TensorParallelMLP`` on its 8-device virtual mesh, at the same grid
shapes. Both start from the reference's initial parameters (the port
takes them through ``params_from_numpy``) and draw nothing in training,
so they agree to f32 rounding.

The matrix mirrors ``tests/test_model_parallelism.py``'s
``TestTensorParallel`` and ``TestTPTransformer``: TP 4 and TP 2 x DP 2
after 3 steps against the reference's trainer of the same shape and
against the port's single-device LM (losses, logits and parameters),
bf16 with the cosine schedule, the parameters really sharded, every
refusal with the reference's message, and the MLP with its weights
carried across.

Run as a script, this file is one rank of that world:
``python tests/test_torch_tensor_parallel.py <rank> <world> <port> <dir>``.
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
CONF = dict(vocab_size=40, max_len=32, d_model=32, n_heads=4, n_layers=2,
            d_ff=64, learning_rate=1e-3, seed=0)
BF16 = dict(CONF, compute_dtype="bfloat16", lr_schedule="cosine",
            warmup_steps=2, total_steps=10)
STEPS = 3
BF16_STEPS = 4
MLP_STEPS = 10


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 40, (8, 17))


def _mlp_data():
    rng = np.random.RandomState(11)
    X = rng.normal(size=(64, 12)).astype(np.float32)
    W = rng.normal(size=(12, 3)).astype(np.float32)
    return X, np.eye(3, dtype=np.float32)[np.argmax(X @ W, 1)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for path, leaf in flat.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return tree


# ---- one rank of the world -------------------------------------------------
def _scenarios(rank, world, port, out):
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        TensorParallelMLP, tp_mesh)
    from deeplearning4j_tpu_torch.parallel.tp_transformer import \
        TPTransformerLM

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    init = np.load(os.path.join(out, "init.npz"))
    params = _unflat({k[3:]: init[k] for k in init.files
                      if k.startswith("lm/")})

    def save(name, **arrays):
        if rank == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)

    def lm_run(name, n_data, n_model, kw, steps, toks):
        mesh = tp_mesh(n_data, n_model)
        if mesh is None:
            return
        tp = TPTransformerLM(mesh, TransformerConfig(**kw), params=params,
                             device="cpu")
        losses = [float(tp.fit_batch(toks)) for _ in range(steps)]
        got = _flat(tp.gathered_params())
        save(name, losses=np.array(losses), frac=tp.shard_fraction(),
             logits=tp.gathered_logits(toks[:, :-1]), **got)
        if name == "tp22":
            try:
                tp.fit_batch(np.zeros((5, 9), np.int64))
            except ValueError as e:
                save("tp22_odd", message=np.array(str(e)))

    lm_run("tp4", 1, 4, CONF, STEPS, _tokens(0))
    lm_run("tp22", 2, 2, CONF, STEPS, _tokens(3))
    lm_run("bf16", 1, 2, BF16, BF16_STEPS, _tokens(1))

    X, Y = _mlp_data()
    mesh = tp_mesh(2, 2)
    mlp = TensorParallelMLP(mesh, 12, 32, 3, lr=0.5, device="cpu",
                            params={k[4:]: init[k] for k in init.files
                                    if k.startswith("mlp/")})
    losses = [float(mlp.fit_batch(X, Y)) for _ in range(MLP_STEPS)]
    save("mlp", losses=np.array(losses), predict=mlp.predict(X[:8]),
         **mlp.gathered_params())
    multihost.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the reference ---------------------------------------------------------
def _ref_conf(kw):
    from deeplearning4j_tpu.models.transformer import TransformerConfig
    return TransformerConfig(**kw)


def _ref_mesh(n_data, n_model, names=("data", "model")):
    import jax
    from deeplearning4j_tpu.parallel.parallel_wrapper import mesh_2d
    return mesh_2d(n_data, n_model, names,
                   jax.devices()[:n_data * n_model])


def _model_mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("model",))


@pytest.fixture(scope="module")
def ref():
    """The reference's side: its initial parameters (handed to the port)
    and its trainers' results."""
    from deeplearning4j_tpu.models.transformer import TransformerLM
    from deeplearning4j_tpu.parallel.tensor_parallel import (
        TensorParallelMLP, tp_mesh)
    from deeplearning4j_tpu.parallel.tp_transformer import TPTransformerLM

    def tp_run(mesh, kw, steps, toks):
        tp = TPTransformerLM(mesh, _ref_conf(kw))
        losses = [float(tp.fit_batch(toks)) for _ in range(steps)]
        return dict(losses=np.array(losses), frac=tp.shard_fraction(),
                    logits=tp.gathered_logits(toks[:, :-1]),
                    params=_flat({k: (v if not isinstance(v, dict) else
                                      {kk: np.asarray(vv)
                                       for kk, vv in v.items()})
                                  for k, v in tp.params.items()}))

    lm = TransformerLM(_ref_conf(CONF)).init()
    mlp = TensorParallelMLP(tp_mesh(2, 2), 12, 32, 3, lr=0.5, seed=1)
    mlp_init = {k: np.asarray(v) for k, v in mlp.params.items()}
    X, Y = _mlp_data()
    mlp_losses = [float(mlp.fit_batch(X, Y)) for _ in range(MLP_STEPS)]
    return dict(
        init=_flat(lm.params), mlp_init=mlp_init,
        tp4=tp_run(_model_mesh(4), CONF, STEPS, _tokens(0)),
        tp22=tp_run(_ref_mesh(2, 2), CONF, STEPS, _tokens(3)),
        bf16=tp_run(_model_mesh(2), BF16, BF16_STEPS, _tokens(1)),
        mlp=dict(losses=np.array(mlp_losses), predict=mlp.predict(X[:8]),
                 **{k: np.asarray(v) for k, v in mlp.params.items()}))


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """Run the port's world of 4 ranks once; returns a loader of rank 0's
    results."""
    out = str(tmp_path_factory.mktemp("tp_world"))
    np.savez(os.path.join(out, "init.npz"),
             **{f"lm/{k}": v for k, v in ref["init"].items()},
             **{f"mlp/{k}": v for k, v in ref["mlp_init"].items()})
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
    return load


def _single(init, kw, steps, toks):
    """The port's single-device LM from the reference's initial
    parameters: losses, logits and parameters (the TP layout's leaves
    named as the LM's) after ``steps``."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, _flatten, params_from_numpy)
    lm = TransformerLM(TransformerConfig(**kw), device="cpu")
    lm.params = params_from_numpy(_unflat(init), device="cpu")
    losses = [float(lm.fit_batch(toks)) for _ in range(steps)]
    logits = np.asarray(lm.output(toks[:, :-1]))
    return dict(losses=np.array(losses), logits=logits,
                params={k: v.detach().numpy()
                        for k, v in _flatten(lm.params).items()})


def _lm_layout(flat):
    """The reference TP trainer's leaves (separate ``wq``/``wk``/``wv``)
    in the LM's layout (``qkv`` concatenated)."""
    out = {}
    for k, v in flat.items():
        block, _, leaf = k.rpartition(".")
        if leaf in ("wk", "wv", "bk", "bv"):
            continue
        if leaf in ("wq", "bq"):
            w = "w" if leaf == "wq" else "b"
            parts = [flat[f"{block}.{w}{c}"] for c in "qkv"]
            out[f"{block}.qkv" + ("" if w == "w" else "_b")] = \
                np.concatenate(parts, axis=-1)
        else:
            out[k] = v
    return out


def _close(got, want, msg="", rel=1e-5):
    """Within ``rel`` of the array's max abs."""
    want = np.asarray(want, np.float64)
    tol = rel * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


def _drift_bars(init, toks, params):
    """Each parameter leaf's bar after the steps: 10 times the largest
    change of that leaf in the port's single-device run started from the
    initial parameters perturbed by 1e-7 of their scale (at least 1e-5 of
    the leaf's max abs). AdamW divides each gradient element by its own
    scale, so where a gradient is rounding noise (the key bias's is zero
    in exact arithmetic: one vector added to every key of a row shifts
    all its scores alike) a step of the learning rate's size follows it,
    and how far depends on the order of every sum before it: a bar that
    follows from rounding, as phase ``dp``'s bars on the card do."""
    rng = np.random.RandomState(123)
    bumped = {k: (v * (1 + 1e-7 * rng.choice([-1.0, 1.0], v.shape)))
              .astype(np.float32) for k, v in init.items()}
    moved = _single(bumped, CONF, STEPS, toks)["params"]
    return {k: max(10 * float(np.max(np.abs(moved[k] - v))),
                   1e-5 * float(np.max(np.abs(v))))
            for k, v in params.items()}


# ---- the matrix --------------------------------------------------------------
class TestTPTransformer:
    @pytest.mark.parametrize("name", ["tp4", "tp22"])
    def test_matches_reference_and_single_device(self, ref, world, name):
        """TP 4 and TP 2 x DP 2 after 3 steps: the losses and the logits
        within 1e-5 of their max abs of the reference's trainer of the
        same grid and of the port's single-device LM; the parameters at
        the reference's LM bar."""
        got, want = world(name), ref[name]
        toks = _tokens(0 if name == "tp4" else 3)
        single = _single(ref["init"], CONF, STEPS, toks)
        for other, what in ((want, "reference TP"), (single, "port LM")):
            _close(got["losses"], other["losses"], f"{name} {what} losses")
            _close(got["logits"], other["logits"], f"{name} {what} logits")
        ref_params = _lm_layout(want["params"])
        bars = _drift_bars(ref["init"], toks, single["params"])
        for k, v in single["params"].items():
            for other, what in ((v, "the port's LM"),
                                (ref_params[k], "the reference")):
                np.testing.assert_allclose(
                    got[k], other, rtol=0, atol=bars[k],
                    err_msg=f"{name} {k} against {what}")

    def test_bf16_and_cosine_schedule(self, ref, world):
        """bf16 compute and the schedule are kept: the reference's bar
        (5e-2 on the loss) against the reference's TP run and the port's
        single-device run of the same configuration."""
        got = world("bf16")["losses"]
        single = _single(ref["init"], BF16, BF16_STEPS, _tokens(1))
        np.testing.assert_allclose(got, ref["bf16"]["losses"], atol=5e-2)
        np.testing.assert_allclose(got, single["losses"], atol=5e-2)

    def test_params_actually_sharded(self, ref, world):
        frac = float(world("tp4")["frac"])
        assert frac == pytest.approx(float(ref["tp4"]["frac"]))
        assert 0.25 < frac < 0.8, frac
        assert float(world("tp22")["frac"]) == pytest.approx(
            float(ref["tp22"]["frac"]))

    def test_odd_batch_rejected(self, world):
        assert "multiple" in str(world("tp22_odd")["message"])


def _refusal(fn_ref, fn_port):
    """Both packages refuse with the same message."""
    with pytest.raises(ValueError) as want:
        fn_ref()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return str(got.value)


class TestRefusals:
    """Every refusal of the reference's constructor, with its message
    (no world needed: each is raised before any collective)."""

    @pytest.mark.parametrize("kw,words", [
        (dict(dropout=0.1), "dropout"),
        (dict(block_size=16), "block_size"),
        (dict(n_kv_heads=2), "GQA"),
        (dict(window=8), "window"),
        (dict(pos_embed="rope"), "wpe"),
        (dict(d_ff=66), "d_ff"),
    ])
    def test_config_refusals(self, kw, words):
        from deeplearning4j_tpu.parallel.tp_transformer import \
            TPTransformerLM as RefTP
        from deeplearning4j_tpu_torch.models.transformer import \
            TransformerConfig
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
        from deeplearning4j_tpu_torch.parallel.tp_transformer import \
            TPTransformerLM
        msg = _refusal(
            lambda: RefTP(_model_mesh(4), _ref_conf(dict(CONF, **kw))),
            lambda: TPTransformerLM(TPMesh(1, 4, 0, 0),
                                    TransformerConfig(**dict(CONF, **kw)),
                                    device="cpu"))
        assert words in msg

    def test_head_alignment(self):
        from deeplearning4j_tpu.parallel.tp_transformer import \
            TPTransformerLM as RefTP
        from deeplearning4j_tpu_torch.models.transformer import \
            TransformerConfig
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
        from deeplearning4j_tpu_torch.parallel.tp_transformer import \
            TPTransformerLM
        msg = _refusal(
            lambda: RefTP(_model_mesh(8), _ref_conf(CONF)),
            lambda: TPTransformerLM(TPMesh(1, 8, 0, 0),
                                    TransformerConfig(**CONF), device="cpu"))
        assert "head" in msg

    @pytest.mark.parametrize("names,words", [
        (("batch", "model"), "neither"), (("data", "tensor"), "model axis")])
    def test_misnamed_axes(self, names, words):
        from deeplearning4j_tpu.parallel.tp_transformer import \
            TPTransformerLM as RefTP
        from deeplearning4j_tpu_torch.models.transformer import \
            TransformerConfig
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import TPMesh
        from deeplearning4j_tpu_torch.parallel.tp_transformer import \
            TPTransformerLM
        msg = _refusal(
            lambda: RefTP(_ref_mesh(2, 2, names), _ref_conf(CONF)),
            lambda: TPTransformerLM(TPMesh(2, 2, 0, 0, axis_names=names),
                                    TransformerConfig(**CONF), device="cpu"))
        assert words in msg

    def test_mlp_hidden_must_divide(self):
        from deeplearning4j_tpu.parallel.tensor_parallel import (
            TensorParallelMLP as RefMLP, tp_mesh as ref_tp_mesh)
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            TPMesh, TensorParallelMLP)
        _refusal(lambda: RefMLP(ref_tp_mesh(2, 4), 12, 30, 3),
                 lambda: TensorParallelMLP(TPMesh(2, 4, 0, 0), 12, 30, 3,
                                           device="cpu"))


class TestTensorParallelMLP:
    def test_matches_reference_with_weights_carried(self, ref, world):
        """TP 2 x DP 2, 10 SGD steps from the reference's initial weights:
        each leaf within 1e-5 of its max abs, the losses and the
        probabilities too."""
        got, want = world("mlp"), ref["mlp"]
        for k in ("W1", "b1", "W2", "b2"):
            _close(got[k], want[k], k)
        _close(got["losses"], want["losses"], "losses")
        _close(got["predict"], want["predict"], "predict")
        assert got["losses"][-1] < got["losses"][0]


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _scenarios(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
