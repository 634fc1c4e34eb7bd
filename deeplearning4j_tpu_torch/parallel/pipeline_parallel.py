"""Pipeline (stage) parallelism over a grid of ranks: the port of
``deeplearning4j_tpu/parallel/pipeline_parallel.py``.

The reference lays S stages along a ``pipe`` mesh axis and streams M
microbatches through them GPipe-style: one ``lax.scan`` over ``M + S -
1`` ticks inside ``shard_map``, activations handed on by ``ppermute``,
and the backward derived by ``jax.grad`` (``ppermute``'s transpose is
the reverse rotation). Here a stage is a process (a rank of the grid
``pp_mesh`` makes: one process group a data row along ``pipe``, one a
pipe column along ``data``), and the schedule is written out:

- forward: microbatch by microbatch, stage 0 embeds its input, every
  stage applies its block and sends its activation to the next stage
  (``TPMesh.exchange``: a point-to-point send, staged through host
  memory under gloo); the last stage adds the microbatch's loss sum.
  The blocking receives make the fill bubble of the reference's ticks;
- backward: the microbatches in reverse order; the last stage
  differentiates its loss, every other stage receives the gradient of
  its output from the next stage, calls ``torch.autograd.backward`` on
  its output with it and sends the gradient of its input to the stage
  before, the reverse rotation the reference's transpose makes;
- the stage's own parameters keep their gradients; the replicated ones
  (used on one stage each) and the loss are summed over ``pipe``, and
  everything over ``data`` (the batch split over data rows).

``PipelineParallelNet`` is the reference's trainable residual-MLP
pipeline: ``tanh(x @ Win)`` on stage 0, ``h + tanh(h @ W_s + b_s)`` on
stage s, a softmax head ``Wout`` on the last, plain SGD.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    host_f32, tp_mesh)

__all__ = ["PipelineParallelNet", "pipeline_backward", "pp_mesh"]


def pp_mesh(n_data, n_pipe):
    """The ``(data, pipe)`` grid over the first ``n_data * n_pipe``
    ranks (rank ``d * n_pipe + s`` holds stage s of data row d); every
    rank of the process group calls it, a rank outside gets None."""
    return tp_mesh(n_data, n_pipe, axis_names=("data", "pipe"))


def pipeline_backward(mesh, axis, ins, outs, leaves):
    """The reverse GPipe schedule on this rank's stage: the microbatches
    in reverse order, each output's gradient its own (the last stage's
    loss) or the one the next stage sends, ``torch.autograd.backward``
    into ``leaves`` (and the stage's input), the input's gradient sent
    to the stage before: ``ppermute``'s transpose in the reference."""
    s, S = mesh.axis_index(axis), mesh.axis_size(axis)
    for m in reversed(range(len(outs))):
        grad = None
        if s < S - 1:
            grad = torch.empty_like(outs[m])
            mesh.exchange(axis, recvs=[(grad, s + 1)])
        torch.autograd.backward(outs[m], grad,
                                inputs=leaves + ([ins[m]] if s > 0 else []))
        if s > 0:
            mesh.exchange(axis, sends=[(ins[m].grad, s - 1)])


class PipelineParallelNet:
    """S-stage residual-MLP pipeline trained by one SGD step a batch
    over a ``(data, pipe)`` grid with M microbatches a step. ``params``
    (``W`` (S, d, d), ``b`` (S, d), ``Win`` (n_in, d), ``Wout`` (d,
    n_out), numpy arrays or tensors: the reference's, carried across)
    sets the initial weights; without them they are drawn at the
    reference's scales from a ``torch.Generator`` seeded ``seed``.
    ``device`` is this rank's (the card unless ``"cpu"``)."""

    def __init__(self, mesh, n_in, d, n_out, n_micro, lr=0.1, seed=0, *,
                 params=None, device=None):
        self.mesh = mesh
        self.n_stages = mesh.axis_size("pipe")
        self.n_micro = int(n_micro)
        if self.n_micro < 1:
            raise ValueError("need at least one microbatch")
        self.n_in, self.d, self.n_out = n_in, d, n_out
        self.lr = lr
        self.device = multihost.rank_device(device)
        S = self.n_stages
        if params is None:
            g = torch.Generator().manual_seed(int(seed))
            params = {
                "W": (2.0 / (2 * d)) ** 0.5 * torch.randn(S, d, d,
                                                          generator=g),
                "b": torch.zeros(S, d),
                "Win": (2.0 / (n_in + d)) ** 0.5
                * torch.randn(n_in, d, generator=g),
                "Wout": (2.0 / (d + n_out)) ** 0.5
                * torch.randn(d, n_out, generator=g)}
        whole = {k: host_f32(v) for k, v in params.items()}
        s = mesh.axis_index("pipe")
        local = {"W": whole["W"][s], "b": whole["b"][s],
                 "Win": whole["Win"], "Wout": whole["Wout"]}
        self.params = {k: v.contiguous().to(self.device).requires_grad_(True)
                       for k, v in local.items()}

    def param_specs(self):
        return {"W": ("pipe", None, None), "b": ("pipe", None),
                "Win": (), "Wout": ()}

    def _rows(self, a, width):
        a = torch.as_tensor(np.asarray(a, np.float32)) \
            if not isinstance(a, torch.Tensor) else a.float()
        M, n_data = self.n_micro, self.mesh.axis_size("data")
        mb = a.shape[0] // (M * n_data)
        # the reference's (M, data * mb, ...) layout, data-sharded
        a = a.reshape(M, n_data * mb, width)
        i = self.mesh.axis_index("data")
        return a[:, i * mb:(i + 1) * mb].contiguous().to(self.device)

    def fit_batch(self, x, y):
        """One pipelined step. x: (N, n_in), y: (N, n_out) one-hot; N must
        split into n_micro microbatches x the data axis. Returns the
        global mean loss (a device scalar)."""
        mesh = self.mesh
        n_data = mesh.axis_size("data")
        N = x.shape[0]
        if N % (self.n_micro * n_data) != 0:
            raise ValueError(
                f"batch {N} must be a multiple of n_micro*data "
                f"({self.n_micro}*{n_data})")
        xs, ys = self._rows(x, self.n_in), self._rows(y, self.n_out)
        p = self.params
        S, s = self.n_stages, mesh.axis_index("pipe")
        first, last = s == 0, s == S - 1
        mb = xs.shape[1]
        ins, outs = [], []
        local_sum = torch.zeros((), device=self.device)
        with torch.enable_grad():
            for m in range(self.n_micro):
                if first:
                    h_in = torch.tanh(xs[m] @ p["Win"])
                else:
                    h_in = torch.empty(mb, self.d, device=self.device)
                    mesh.exchange("pipe", recvs=[(h_in, s - 1)])
                    h_in.requires_grad_(True)
                h = h_in + torch.tanh(h_in @ p["W"] + p["b"])
                if last:
                    logp = torch.log_softmax(h @ p["Wout"], -1)
                    h = -(ys[m] * logp).sum()
                    local_sum = local_sum + h.detach()
                else:
                    mesh.exchange("pipe", sends=[(h.detach(), s + 1)])
                ins.append(h_in)
                outs.append(h)
            pipeline_backward(mesh, "pipe", ins, outs, list(p.values()))
        n_global = float(N)
        with torch.no_grad():
            names = list(p)
            # a replicated leaf another stage uses has no gradient here
            grads = [p[k].grad if p[k].grad is not None
                     else torch.zeros_like(p[k]) for k in names]
            rep = [names.index("Win"), names.index("Wout")]
            # replicated leaves and the loss over pipe, then all over data
            tail = torch.cat([grads[i].reshape(-1) for i in rep]
                             + [local_sum.reshape(1)])
            mesh.all_reduce(tail, "pipe")
            off = 0
            for i in rep:
                grads[i] = tail[off:off + grads[i].numel()].view_as(grads[i])
                off += grads[i].numel()
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [tail[-1:]])
            mesh.all_reduce(flat, "data")
            flat /= n_global
            off = 0
            for k in names:
                n = p[k].numel()
                p[k].sub_(self.lr * flat[off:off + n].view_as(p[k]))
                p[k].grad = None
                off += n
        return flat[-1]

    def gathered_params(self):
        """The whole parameters as numpy arrays (a collective over the
        pipe)."""
        p = {k: v.detach() for k, v in self.params.items()}
        return {"W": self.mesh.all_gather(p["W"][None], "pipe")
                .cpu().numpy(),
                "b": self.mesh.all_gather(p["b"][None], "pipe")
                .cpu().numpy(),
                "Win": p["Win"].cpu().numpy(),
                "Wout": p["Wout"].cpu().numpy()}

    def predict(self, x):
        """Gathered unpipelined forward (the parity oracle; a collective
        over the pipe)."""
        host = self.gathered_params()
        h = np.tanh(np.asarray(x, np.float32) @ host["Win"])
        for s in range(self.n_stages):
            h = h + np.tanh(h @ host["W"][s] + host["b"][s])
        logits = h @ host["Wout"]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def reference_loss(self, x, y):
        """Unpipelined loss for the same parameters and batch: GPipe is
        math-preserving, so the pipelined step computes exactly this."""
        p = np.asarray(self.predict(x))
        return float(-np.sum(np.asarray(y) * np.log(p + 1e-12))
                     / x.shape[0])
