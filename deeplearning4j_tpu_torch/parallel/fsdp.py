"""Fully sharded data parallelism (ZeRO-3) over a process group: the
port of ``deeplearning4j_tpu/parallel/fsdp.py``.

Every parameter is flattened, padded to a multiple of N and kept 1/N a
rank at rest, its Adam moments too. A step gathers the shards just in
time, through an all-gather whose backward is a reduce-scatter
(``ShardingCore.all_gather_flat``, a ``torch.autograd.Function`` over
``torch.distributed``), so autograd hands each rank exactly its gradient
shard, summed over the ranks: the reference's ``all_gather`` under
``shard_map`` and its transpose. The update is shard-local. All the
parameters travel in one gather and their gradients in one
reduce-scatter a step (one ``[N, C]`` buffer, row r every leaf's r-th
chunk).

Each rank feeds the whole global batch and keeps its own rows; the loss
function returns the LOCAL mean over them, and with equal rows a rank
the mean over ranks of the local means is the global mean.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import _flatten, _unflatten
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.sharding_core import (ShardingCore,
                                                             as_mesh,
                                                             pad_to_multiple)

__all__ = ["FSDPMLP", "FSDPTrainer"]


class _FlatShards:
    """The leaves of a tree, each flattened and padded to a multiple of
    N, this rank's chunk of each (``shards``, trainable) and the way back
    to whole leaves."""

    def __init__(self, core, tree, device):
        self.core = core
        flat = _flatten(tree)
        self.names = list(flat)
        self.shapes = [tuple(v.shape) for v in flat.values()]
        self.dtypes = [v.dtype for v in flat.values()]
        n = core.n
        self.chunks = [pad_to_multiple(math.prod(s), n) // n
                       for s in self.shapes]
        self.shards = []
        for v, c in zip(flat.values(), self.chunks):
            v = torch.as_tensor(v).detach().to(device, torch.float32)
            padded = torch.zeros(c * n, device=device)
            padded[:v.numel()] = v.reshape(-1)
            self.shards.append(padded[core.rank * c:(core.rank + 1) * c]
                               .clone().requires_grad_(True))

    def whole(self, shards):
        """The whole leaves as a tree, from one differentiable all-gather
        of every shard (its backward reduce-scatters the gradients)."""
        core = self.core
        buf = core.all_gather_flat(torch.cat(shards)) if core.n > 1 \
            else torch.cat(shards)
        rows = buf.view(core.n, -1)
        out, off = {}, 0
        for name, shape, dt, c in zip(self.names, self.shapes, self.dtypes,
                                      self.chunks):
            leaf = rows[:, off:off + c].reshape(-1)[:math.prod(shape)]
            out[name] = leaf.view(shape).to(dt)
            off += c
        return _unflatten(out)

    def host(self):
        """Whole leaves as a tree of numpy arrays (a collective)."""
        with torch.no_grad():
            tree = self.whole([s.detach() for s in self.shards])
        return {k: v.cpu().numpy() for k, v in _flatten(tree).items()}

    def fraction(self):
        """Elements this rank holds over the padded whole: 1/N."""
        return sum(self.chunks) / (self.core.n * sum(self.chunks))


def _local_rows(core, device, *batch):
    out = []
    for a in batch:
        if a.shape[0] % core.n:
            raise ValueError(f"batch dim {a.shape[0]} must divide over "
                             f"the {core.n} ranks")
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        if not t.is_floating_point():
            t = t.long()   # token ids index with int64
        out.append(multihost.take_rows(t, core.rank, core.n).to(device))
    return out


class FSDPTrainer:
    """ZeRO-3 training of any parameter tree under ``loss_fn(params,
    *batch_rows) -> LOCAL mean loss``: parameters and Adam moments 1/N a
    rank at rest; AdamW (``weight_decay`` gated per leaf by
    ``weight_decay_mask``, a tree of 0/1 like ``params``) on the shards.
    ``mesh``: a ``DataMesh``, a process group or None (the default
    group); ``device``: this rank's device, the card unless ``"cpu"`` is
    asked for."""

    def __init__(self, mesh, params, loss_fn, *, lr=1e-3, beta1=0.9,
                 beta2=0.999, eps=1e-8, weight_decay=0.0,
                 weight_decay_mask=None, device=None):
        self.device = multihost.rank_device(device)
        self.core = ShardingCore(as_mesh(mesh), level=3)
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.wd = weight_decay
        self.loss_fn = loss_fn
        self._flat = _FlatShards(self.core, params, self.device)
        if weight_decay_mask is None:
            self.wd_gates = [1.0] * len(self._flat.names)
        else:
            gates = _flatten(weight_decay_mask)
            if len(gates) != len(self._flat.names):
                raise ValueError(
                    f"weight_decay_mask has {len(gates)} leaves for "
                    f"{len(self._flat.names)} params")
            self.wd_gates = [float(gates[n]) for n in self._flat.names]
        self.m = [torch.zeros_like(s).detach() for s in self.shards]
        self.v = [torch.zeros_like(s).detach() for s in self.shards]
        self.iteration = 0
        self.score_ = float("nan")

    @property
    def shards(self):
        return self._flat.shards

    def fit_batch(self, *batch):
        """One step on a global batch (arrays of equal leading size, a
        multiple of N). Returns the global mean loss (a device scalar)."""
        core, n = self.core, self.core.n
        rows = _local_rows(core, self.device, *batch)
        with torch.enable_grad():
            local = self.loss_fn(self._flat.whole(self.shards), *rows)
            grads = torch.autograd.grad(local, self.shards)
        t = self.iteration + 1
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            for s, g, m, v, wg in zip(self.shards, grads, self.m, self.v,
                                      self.wd_gates):
                g = g / n   # the reduce-scatter summed the ranks' grads
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m / (1 - b1 ** t)
                vhat = v / (1 - b2 ** t)
                s.sub_(self.lr * (mhat / (torch.sqrt(vhat) + self.eps)
                                  + self.wd * wg * s))
            loss = local.detach().clone()
            if n > 1:
                loss = core.all_reduce_sum(loss) / n
        self.iteration = t
        self.score_ = loss
        return loss

    def gathered_params(self):
        """The whole parameters as a tree of host arrays (a collective)."""
        return _unflatten(self._flat.host())

    def shard_fraction(self):
        return self._flat.fraction()


class FSDPMLP:
    """An L-layer tanh MLP with a softmax head (widths n_in -> hidden *
    (L-1) -> n_out), every parameter flattened, padded and 1/N a rank,
    trained by SGD on the summed cross-entropy over the global batch's
    rows. ``params`` ({"W0", "b0", ...} host arrays) replaces the seeded
    draw (Glorot-normal weights, zero biases, from a ``torch.Generator``
    seeded ``seed``)."""

    def __init__(self, mesh, n_in, hidden, n_out, n_layers=2, lr=0.1,
                 seed=0, *, params=None, device=None):
        if n_layers < 1:
            raise ValueError("need at least one layer")
        self.device = multihost.rank_device(device)
        self.core = ShardingCore(as_mesh(mesh), level=3)
        self.lr = lr
        self.n_layers = n_layers
        dims = [n_in] + [hidden] * (n_layers - 1) + [n_out]
        if params is None:
            g = torch.Generator().manual_seed(seed)
            params = {}
            for i in range(n_layers):
                scale = (2.0 / (dims[i] + dims[i + 1])) ** 0.5
                params[f"W{i}"] = scale * torch.randn(
                    (dims[i], dims[i + 1]), generator=g)
                params[f"b{i}"] = torch.zeros(dims[i + 1])
        else:
            params = {k: torch.as_tensor(np.asarray(v, np.float32))
                      for k, v in params.items()}
        self._flat = _FlatShards(self.core, params, self.device)

    def _forward(self, p, x):
        h = x
        for i in range(self.n_layers):
            z = h @ p[f"W{i}"] + p[f"b{i}"]
            h = torch.tanh(z) if i < self.n_layers - 1 else z
        return h

    def fit_batch(self, x, y):
        core = self.core
        if y.shape[0] != x.shape[0]:
            raise ValueError(
                f"labels have {y.shape[0]} rows for {x.shape[0]} examples")
        xs, ys = _local_rows(core, self.device, np.asarray(x, np.float32),
                             np.asarray(y, np.float32))
        shards = self._flat.shards
        with torch.enable_grad():
            logits = self._forward(self._flat.whole(shards), xs)
            local_sum = -(ys * torch.log_softmax(logits, -1)).sum()
            grads = torch.autograd.grad(local_sum, shards)
        n_global = float(x.shape[0])
        with torch.no_grad():
            for s, g in zip(shards, grads):
                s.sub_(self.lr * g / n_global)
            loss = local_sum.detach().clone()
            if core.n > 1:
                loss = core.all_reduce_sum(loss)
        return loss / n_global

    def gathered_params(self):
        return self._flat.host()

    def shard_fraction(self):
        return self._flat.fraction()

    def predict(self, x):
        p = self.gathered_params()
        h = np.asarray(x, np.float32)
        for i in range(self.n_layers):
            z = h @ p[f"W{i}"] + p[f"b{i}"]
            h = np.tanh(z) if i < self.n_layers - 1 else z
        e = np.exp(h - h.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
