"""Tensor (model) parallelism over a 2-D grid of ranks: the port of
``deeplearning4j_tpu/parallel/tensor_parallel.py``.

The reference shards the feature dimension of wide layers over the
``model`` axis of a device mesh and lets ``shard_map`` place the
collectives. Here every rank is a process of a ``torch.distributed``
group (``parallel/multihost.py``), and :func:`tp_mesh` lays the group
out as a grid of ``n_data`` rows by ``n_model`` columns (rank ``d *
n_model + m``, the reference's device order), with one process group per
row (the ranks that share a data shard and split the model: the
``model`` axis) and one per column (the ranks that hold the same model
shard: the ``data`` axis).

The Megatron column/row pair:

- column-parallel linear: W ``(in, out/M)`` a rank, a local matmul, the
  activations stay split over ``model``, no collective;
- row-parallel linear: W ``(in/M, out)`` a rank on the split
  activations: the partial products are summed by one all-reduce over
  ``model``;
- the conjugate operators as ``torch.autograd.Function``s:
  :func:`copy_to_model` (identity forward, all-reduce backward: the
  reference's ``_identity_allreduce_bwd``, Megatron's ``f``) in front of
  a column-parallel region, :func:`reduce_from_model` (all-reduce
  forward, identity backward: ``_allreduce_identity_bwd``, ``g``) after
  the row-parallel one;
- the loss and labels whole across ``model``, split over ``data``; the
  gradients summed over ``data`` once a step.

``TensorParallelMLP`` is the reference's trainable column -> row MLP with
a replicated softmax head.

The grid is the port's mesh for every model-parallel strategy: an axis
is named by ``axis_names`` (``tp_mesh(1, N, ("data", "seq"))`` is the
sequence-parallel ring, ``pipeline_parallel.pp_mesh`` and
``expert_parallel.ep_mesh`` name theirs ``pipe`` and ``expert``).
Where the reference names an axis inside ``shard_map`` (``ring_attention
(..., axis_name="seq")``), the port resolves the name through the grids
entered with ``with mesh:`` (:func:`active_axis`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import multihost

__all__ = ["TPMesh", "TensorParallelMLP", "active_axis", "all_to_all",
           "copy_to_model",
           "tp_mesh", "reduce_from_model"]

# the grids entered with ``with mesh:``, innermost last
_ACTIVE = []


@dataclass
class TPMesh:
    """A grid of ``n_data`` x ``n_model`` ranks. ``model_group`` is this
    rank's row (the ranks of its data shard), ``data_group`` its column
    (the ranks of its model shard); an axis of size 1 has no group and
    no collective. An axis is named by ``axis_names`` (the second is the
    row's, the first the column's) or by its role, ``"model"`` or
    ``"data"``. ``collective_seconds`` adds up the host time of every
    all-reduce and all-to-all made on the grid (gloo's collectives are
    synchronous on the host), ``p2p_seconds`` that of its point-to-point
    exchanges, for the share of a step they take."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    model_group: object = None
    data_group: object = None
    axis_names: tuple = ("data", "model")
    collective_seconds: float = field(default=0.0)
    p2p_seconds: float = field(default=0.0)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()   # ``with`` blocks nest: the innermost is last

    def _axis(self, axis):
        """(size, group, this rank's index) along ``axis``."""
        if axis in (self.axis_names[1], "model"):
            return self.n_model, self.model_group, self.model_index
        if axis in (self.axis_names[0], "data"):
            return self.n_data, self.data_group, self.data_index
        raise ValueError(f"the grid has no axis {axis!r} (axes: "
                         f"{self.axis_names})")

    def axis_size(self, axis):
        return self._axis(axis)[0]

    def axis_index(self, axis):
        return self._axis(axis)[2]

    def peer(self, axis, index):
        """The global rank of the rank at ``index`` along ``axis`` in
        this rank's line of the grid."""
        n, _, _ = self._axis(axis)
        if axis in (self.axis_names[1], "model"):
            return self.data_index * self.n_model + index % n
        return (index % n) * self.n_model + self.model_index

    def exchange(self, axis, sends=(), recvs=()):
        """Point-to-point along ``axis``: ``sends`` and ``recvs`` are
        ``(tensor, index along the axis)`` pairs, posted together and
        waited for (``multihost.exchange``)."""
        group = self._axis(axis)[1]
        t0 = time.perf_counter()
        multihost.exchange([(t, self.peer(axis, i)) for t, i in sends],
                           [(t, self.peer(axis, i)) for t, i in recvs],
                           group)
        self.p2p_seconds += time.perf_counter() - t0

    def all_to_all_single(self, t, axis):
        """``t``'s leading dim split over ``axis``: chunk ``p`` goes to
        the rank at index ``p`` and the chunk from that rank lands in its
        place (``dist.all_to_all_single``)."""
        n, group, _ = self._axis(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        self.collective_seconds += time.perf_counter() - t0
        return out

    def all_gather(self, t, axis, dim=0):
        """The ranks' ``t`` along ``axis``, joined along ``dim``."""
        n, group, _ = self._axis(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        self.collective_seconds += time.perf_counter() - t0
        return torch.cat(parts, dim=dim)

    @property
    def shape(self):
        return {self.axis_names[0]: self.n_data,
                self.axis_names[1]: self.n_model}

    @property
    def size(self):
        return self.n_data * self.n_model

    def all_reduce(self, t, axis):
        """Sum ``t`` over the grid's ``axis``, in place (bf16 is summed
        in f32 and rounded once)."""
        n, group, _ = self._axis(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        if t.dtype in (torch.bfloat16, torch.float16):
            w = t.float()
            dist.all_reduce(w, group=group)
            t.copy_(w)
        else:
            dist.all_reduce(t, group=group)
        self.collective_seconds += time.perf_counter() - t0
        return t

    def gather_model(self, t, axis):
        """The whole leaf from this row's ``model`` shards of ``t``, cut
        along ``axis``."""
        return self.all_gather(t, "model", axis)


def active_axis(name):
    """The innermost grid entered with ``with mesh:`` that has an axis
    called ``name``: how a function called inside a model-parallel step
    (``ring_attention(..., axis_name="seq")``) finds its process group."""
    for mesh in reversed(_ACTIVE):
        if name in mesh.axis_names:
            return mesh
    raise ValueError(
        f"no grid with an axis {name!r} is active: build one with "
        f"tp_mesh(..., axis_names=(..., {name!r})) and call inside "
        "'with mesh:'")


def tp_mesh(n_data, n_model, axis_names=("data", "model")):
    """The ``(data, model)`` grid over the first ``n_data * n_model``
    ranks of the process group (every rank of the world must call it:
    each row and column group is a new group; a rank outside the grid
    gets None). Width 1 needs no group."""
    n_data, n_model = int(n_data), int(n_model)
    size = n_data * n_model
    world = multihost.process_count()
    if size > world:
        raise ValueError(
            f"a {n_data} x {n_model} grid needs {size} ranks, the process "
            f"group has {world} (join it with parallel.multihost."
            "initialize)")
    me = multihost.process_index()
    rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    cols = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model_group = data_group = None
    if dist.is_initialized() and size > 1:
        # every rank builds every group, in the same order
        for ranks in rows:
            g = dist.new_group(ranks) if n_model > 1 else None
            if me in ranks:
                model_group = g
        for ranks in cols:
            g = dist.new_group(ranks) if n_data > 1 else None
            if me in ranks:
                data_group = g
    if me >= size:
        return None
    return TPMesh(n_data, n_model, me // n_model, me % n_model,
                  model_group, data_group, tuple(axis_names))


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce over ``model`` backward (Megatron's
    ``f``): a whole activation entering a column-parallel region gets
    only this rank's share of its gradient; the whole gradient is the
    sum over the row."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over ``model`` forward, identity backward (Megatron's
    ``g``): the partial products of a row-parallel linear summed into a
    whole activation whose gradient is already whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.detach().contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_to_all(x, mesh, axis, split, concat):
    n = mesh.axis_size(axis)
    send = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    recv = mesh.all_to_all_single(send.contiguous(), axis)
    return recv.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    """The reference's tiled ``lax.all_to_all``: its backward is the
    inverse exchange (split and concat swapped)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, concat, split)
        return _all_to_all(x.detach(), mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x, mesh, axis, split_dim, concat_dim):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over the grid's ``axis`` of N ranks: ``x``'s ``split_dim`` is cut in
    N chunks, chunk p goes to the rank at index p, and the N chunks this
    rank receives are joined along ``concat_dim`` in rank order.
    Differentiable."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def copy_to_model(x, mesh):
    return x if mesh.n_model == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return x if mesh.n_model == 1 else _ReduceFromModel.apply(x, mesh)


def host_f32(a):
    """A float32 host copy of a numpy array or tensor: weights handed in
    (the reference's, carried across) are never trained in place."""
    return a.detach().cpu().float().clone() if isinstance(a, torch.Tensor) \
        else torch.tensor(np.asarray(a, np.float32))


class TensorParallelMLP:
    """A 2-layer MLP, column -> row parallel hidden layer and a
    replicated softmax head, trained by plain SGD over a ``(data,
    model)`` grid. ``params`` (``W1``, ``b1``, ``W2``, ``b2``, whole, as
    numpy arrays or tensors: the reference's, carried across) sets the
    initial weights; without them they are drawn with the reference's
    scales from a ``torch.Generator`` seeded ``seed`` (other values than
    ``jax.random``'s). ``device`` is this rank's (the card unless
    ``"cpu"``)."""

    def __init__(self, mesh, n_in, hidden, n_out, lr=0.1, seed=0, *,
                 params=None, device=None):
        n_model = mesh.shape[mesh.axis_names[1]]
        if hidden % n_model != 0:
            raise ValueError("hidden must divide the model axis")
        self.mesh = mesh
        self.lr = lr
        self.device = multihost.rank_device(device)
        if params is None:
            g = torch.Generator().manual_seed(int(seed))
            s1 = (2.0 / (n_in + hidden)) ** 0.5
            s2 = (2.0 / (hidden + n_out)) ** 0.5
            params = {"W1": s1 * torch.randn(n_in, hidden, generator=g),
                      "b1": torch.zeros(hidden),
                      "W2": s2 * torch.randn(hidden, n_out, generator=g),
                      "b2": torch.zeros(n_out)}
        whole = {k: host_f32(v) for k, v in params.items()}
        c = hidden // n_model
        lo = mesh.model_index * c
        local = {"W1": whole["W1"][:, lo:lo + c],   # column-parallel
                 "b1": whole["b1"][lo:lo + c],
                 "W2": whole["W2"][lo:lo + c],      # row-parallel
                 "b2": whole["b2"]}                 # replicated
        self.params = {k: v.contiguous().to(self.device).requires_grad_(True)
                       for k, v in local.items()}

    def param_specs(self):
        return {"W1": (None, "model"), "b1": ("model",),
                "W2": ("model", None), "b2": ()}

    def fit_batch(self, x, y):
        """One SGD step on the global batch ``(x, y)``; this rank takes
        its data shard's rows. Returns the global mean loss (a device
        scalar)."""
        mesh = self.mesh
        if x.shape[0] % mesh.n_data != 0:
            raise ValueError(
                f"batch size {x.shape[0]} must be a multiple of the data "
                f"axis ({mesh.n_data})")
        n_global = float(x.shape[0])
        x = self._rows(x)
        y = self._rows(y)
        p = self.params
        with torch.enable_grad():
            partial = self._forward(p, x)
            logits = reduce_from_model(partial, mesh) + p["b2"]
            local_sum = -(y * torch.log_softmax(logits, -1)).sum()
            names = list(p)
            grads = torch.autograd.grad(local_sum, [p[k] for k in names])
        with torch.no_grad():
            # every leaf is replicated over data: its gradient is the sum
            # of the data shards' over the global batch
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [local_sum.detach().reshape(1)])
            mesh.all_reduce(flat, "data")
            flat /= n_global
            off = 0
            for k, g in zip(names, grads):
                p[k].sub_(self.lr * flat[off:off + g.numel()].view(g.shape))
                off += g.numel()
        return flat[-1]

    def _rows(self, a):
        a = torch.as_tensor(np.asarray(a, np.float32)) \
            if not isinstance(a, torch.Tensor) else a.float()
        rows = multihost.take_rows(a, self.mesh.data_index, self.mesh.n_data)
        return rows.to(self.device)

    @staticmethod
    def _forward(params, x):
        """The model function: under the grid the W2 product is this
        rank's partial sum, which the row's all-reduce completes."""
        return torch.tanh(x @ params["W1"] + params["b1"]) @ params["W2"]

    def gathered_params(self):
        """The whole parameters as numpy arrays (a collective over the
        row)."""
        m = self.mesh
        p = {k: v.detach() for k, v in self.params.items()}
        return {"W1": m.gather_model(p["W1"], 1).cpu().numpy(),
                "b1": m.gather_model(p["b1"], 0).cpu().numpy(),
                "W2": m.gather_model(p["W2"], 0).cpu().numpy(),
                "b2": p["b2"].cpu().numpy()}

    def predict(self, x):
        """Softmax probabilities of the whole model on ``x`` (a
        collective over the row)."""
        whole = {k: torch.as_tensor(v, device=self.device)
                 for k, v in self.gathered_params().items()}
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        with torch.no_grad():
            logits = self._forward(whole, x) + whole["b2"]
            return torch.softmax(logits, -1).cpu().numpy()
