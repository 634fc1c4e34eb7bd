"""Helpers of the port's model-parallel parity tests
(``test_torch_pipeline_parallel.py``, ``test_torch_sequence_parallel.py``,
``test_torch_expert_parallel.py``): one world of CPU ranks over gloo a
test file, and the tree and tolerance helpers they share.

A test file runs as a rank of its world when started as a script
(``python <file> <rank> <world> <port> <dir>``); :func:`spawn` starts the
world and returns a loader of the ``.npz`` files its rank 0 wrote, which
waits for the world at its first call (so the reference's side can be
computed meanwhile).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script, out, world=4, timeout=240):
    """Start ``script`` as ``world`` rank processes writing into ``out``.
    Returns ``load(name)``: the arrays of ``<out>/<name>.npz``; its first
    call waits for the world and fails the test with the failed ranks'
    logs (or on the timeout, killing them all)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    done = []

    def wait():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                pytest.fail(f"the port's world of {world} ranks timed out")
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        assert not failed, "ranks %s failed:\n%s" % (failed, "\n".join(
            f"--- rank {r}:\n{logs[r][-3000:]}" for r in failed))
        done.append(True)

    def load(name):
        if not done:
            wait()
        with np.load(os.path.join(out, f"{name}.npz")) as z:
            return {k: z[k] for k in z.files}
    return load


def join(rank, world, port):
    """This rank's process group on the CPU (one thread a rank)."""
    import torch
    from deeplearning4j_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")


def flat(tree, prefix=""):
    """{"b0.qkv": array, ...} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(
                v.detach().cpu() if hasattr(v, "detach") else v,
                dtype=np.float32)
    return out


def unflat(flat_tree):
    tree = {}
    for path, leaf in flat_tree.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return tree


def close(got, want, msg="", rel=1e-5):
    """Within ``rel`` of ``want``'s max abs."""
    want = np.asarray(want, np.float64)
    tol = rel * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


def single_lm(init, kw, steps, toks, moe=False):
    """The port's single-device (MoE) LM from ``init`` (flat numpy
    leaves): losses, logits and flat parameters after ``steps``."""
    from deeplearning4j_tpu_torch.models.moe_transformer import (
        MoETransformerConfig, MoETransformerLM)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, params_from_numpy)
    cls, conf = (MoETransformerLM, MoETransformerConfig) if moe \
        else (TransformerLM, TransformerConfig)
    lm = cls(conf(**kw), device="cpu")
    lm.params = params_from_numpy(unflat(init), device="cpu")
    losses = [float(lm.fit_batch(toks)) for _ in range(steps)]
    return dict(losses=np.array(losses),
                logits=np.asarray(lm.output(toks[:, :-1])),
                params=flat(lm.params))


def drift_bars(init, kw, steps, toks, params, ref_params, moe=False):
    """Each leaf's bar after the steps, for ``params`` (the port's
    single-device run from ``init``): 10 times the larger of that leaf's
    largest change in the same run from ``init`` perturbed by 1e-7 of
    its scale and its largest difference from ``ref_params`` (the
    reference's single-device run: the two frameworks' rounding), and at
    least 1e-5 of the leaf's max abs. AdamW divides each gradient
    element by its own scale, so where a gradient is rounding noise (the
    key bias's is zero in exact arithmetic) a learning-rate-sized step
    follows it, in a direction set by the order of every sum before it:
    a bar that follows from rounding."""
    rng = np.random.RandomState(123)
    bumped = {k: (v * (1 + 1e-7 * rng.choice([-1.0, 1.0], v.shape)))
              .astype(np.float32) for k, v in init.items()}
    moved = single_lm(bumped, kw, steps, toks, moe)["params"]
    return {k: max(10 * float(np.max(np.abs(moved[k] - v))),
                   10 * float(np.max(np.abs(ref_params[k] - v))),
                   1e-5 * float(np.max(np.abs(v))))
            for k, v in params.items()}


def refusal(fn_ref, fn_port):
    """Both packages refuse with the same message; returns it."""
    with pytest.raises(ValueError) as want:
        fn_ref()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return str(got.value)
