"""The sharding core: one process group, one per-leaf rule, one ZeRO
knob for every data-parallel trainer of the port. The port of
``deeplearning4j_tpu/parallel/sharding_core.py`` onto
``torch.distributed``.

The reference runs one program over a device mesh and lets GSPMD turn
its ``with_sharding_constraint`` annotations into collectives. Here each
rank is a process (``parallel/multihost.py``), the mesh is its process
group (:class:`DataMesh`), and the models call the collectives
themselves, in the places where the reference's annotations sit:

========  ======================================================
level     at-rest placement (``DL4J_TORCH_DP_SHARD``)
========  ======================================================
0         params, grads, updater state whole on every rank
1         updater state sharded 1/N; params and grads whole
2         + gradients reduce-scattered to shards inside the step
          (the updater math runs on the rank's shard; the updated
          shards are all-gathered back onto the whole params)
3         + params (and layer states) sharded 1/N between steps,
          all-gathered just in time for the forward pass
========  ======================================================

The per-leaf rule is the reference's, unchanged (:meth:`ShardingCore.
leaf_spec`): a leaf shards on its first axis that N divides; scalars and
indivisible leaves stay whole. So a rank's share of each state kind is
the reference's per-device share. Specs are tuples in the reference's
``PartitionSpec`` form (``()`` whole, ``(None, "data")`` the second axis).

The collectives are bucketed, never one a leaf: the sharded leaves of
one dtype travel as one ``[N, C]`` buffer whose row r holds every leaf's
r-th chunk (moved to the front along its shard axis), so the row a rank
owns is its shards, contiguous; the whole leaves travel as one flat
buffer. Gradients are the mean over the ranks (each rank's gradient is
that of its equal share of the global batch). The ``[N, C]`` buffer is
all-reduced at levels 0-1 and reduce-scattered at 2-3 with the same row
layout, so the shards a rank updates carry the same sums at every level.

At N = 1 a plan changes nothing: every leaf's one shard is the leaf,
and the models skip every collective and every slice (as XLA does for a
one-device mesh), so a world-1 step is the unsharded step.

Checkpoints: saves read the host view (whole leaves, gathered), so an
archive is independent of level and width; a restore places the whole
state under the restoring plan (``place``), which is the re-shard.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.config import env_flag, env_int, env_is_set
from deeplearning4j_tpu_torch.parallel import multihost

__all__ = ["BATCH_AXIS", "DataMesh", "RowSharding", "ShardingCore",
           "as_mesh", "build_mesh", "current_batch_plan", "elastic_width",
           "global_batch", "pad_to_multiple", "resolve_level"]

BATCH_AXIS = "data"

_LEVELS = (0, 1, 2, 3)

# torch 2.13 names these two ``*_single`` and deprecates the older names,
# which torch 2.11 (the card's) has alone
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def resolve_level(level=None):
    """The effective ZeRO level: an explicit argument wins, then
    ``DL4J_TORCH_DP_SHARD``; with both unset (or that knob malformed)
    the legacy ``DL4J_TORCH_DP_SHARD_UPDATER`` flag maps to level 1 (on,
    the default) or 0. Out of range raises."""
    if level is None:
        if env_is_set("DL4J_TORCH_DP_SHARD"):
            # no minimum clamp: a negative level must reach the range
            # check below, not become 0
            level = env_int("DL4J_TORCH_DP_SHARD")
        if level is None:
            level = 1 if env_flag("DL4J_TORCH_DP_SHARD_UPDATER") else 0
    level = int(level)
    if level not in _LEVELS:
        raise ValueError(
            f"DL4J_TORCH_DP_SHARD level must be one of {_LEVELS}, got "
            f"{level} (0 replicated, 1 updater-state, 2 +gradients, "
            "3 +params)")
    return level


def elastic_width(n_live, n_devices=None):
    """The data-parallel width a world of ``n_live`` participants trains
    at: the largest power of two <= min(n_live, n_devices), so every
    width halves or doubles into another without an uneven split.

    In the port a width is a process group, so the "devices" are the
    live trainer processes of the wave (``parallel/elastic.py`` passes
    their count), not the devices of one process's mesh as in the
    reference, and not ``process_count()`` of a group that has just
    lost a member. With ``n_devices=None`` it is the current group's
    size."""
    if n_devices is None:
        n_devices = multihost.process_count()
    n = min(int(n_live), int(n_devices))
    if n < 1:
        raise ValueError(f"elastic width needs >= 1 live participant and "
                         f"device, got n_live={n_live}, "
                         f"n_devices={n_devices}")
    return 1 << (n.bit_length() - 1)


def pad_to_multiple(n, m):
    """Smallest multiple of ``m`` >= ``n``."""
    return (n + m - 1) // m * m


@dataclass(frozen=True)
class DataMesh:
    """A pure data-parallel mesh: the process group of its ranks (None:
    the default group, or no group at all at width 1), its size, this
    process's rank in it (-1 outside it) and the axis name."""
    group: object
    size: int
    rank: int
    axis_names: tuple = (BATCH_AXIS,)


def build_mesh(n_batch=None, *, batch_axis=BATCH_AXIS):
    """The pure-DP mesh over the first ``n_batch`` ranks of the process
    group (all of them when None; width 1 needs no group). A narrower
    mesh is a new group, which every rank of the world must build."""
    world = multihost.process_count()
    n = world if n_batch is None else int(n_batch)
    if n < 1 or n > world:
        raise ValueError(
            f"need {n} ranks, the process group has {world} (join it with "
            "parallel.multihost.initialize)")
    me = multihost.process_index()
    group = None if n == world else dist.new_group(list(range(n)))
    return DataMesh(group, n, me if me < n else -1, (batch_axis,))


def as_mesh(mesh=None, batch_axis=BATCH_AXIS):
    """A ``DataMesh`` from a ``DataMesh``, a process group, or None (the
    whole default group)."""
    if isinstance(mesh, DataMesh):
        return mesh
    if mesh is None:
        return build_mesh(batch_axis=batch_axis)
    return DataMesh(mesh, dist.get_world_size(mesh), dist.get_rank(mesh),
                    (batch_axis,))


@dataclass(frozen=True)
class RowSharding:
    """A batch placement: rank ``rank`` of ``n`` keeps its rows along
    ``axis`` (0 for [B, ...] batches, 1 for stacked [K, B, ...] groups)."""
    rank: int
    n: int
    axis: int

    def take(self, arr):
        return multihost.take_rows(arr, self.rank, self.n, self.axis)


_BATCH_PLAN = contextvars.ContextVar("dl4j_torch_batch_plan", default=None)


@contextlib.contextmanager
def global_batch(plan):
    """Within: layers with batch statistics (BatchNormalization) take the
    moments of the global batch over ``plan``'s ranks (a plan of width 1,
    or None, leaves them local)."""
    token = _BATCH_PLAN.set(plan if plan is not None and plan.n > 1
                            else None)
    try:
        yield
    finally:
        _BATCH_PLAN.reset(token)


def current_batch_plan():
    """The plan a train step runs its global batch under, or None."""
    return _BATCH_PLAN.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the upstream gradients over
    the ranks too (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, core):
        ctx.core = core
        y = x.detach().clone()
        dist.all_reduce(y, group=core.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.core.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """[C] shard -> [N * C] whole; its backward is the reduce-scatter of
    the whole gradient (the sum over ranks of each rank's chunk)."""

    @staticmethod
    def forward(ctx, shard, core):
        ctx.core = core
        out = shard.new_empty(core.n * shard.numel())
        _all_gather(out, shard.detach().contiguous(), group=core.group)
        return out

    @staticmethod
    def backward(ctx, g):
        core = ctx.core
        out = g.new_empty(g.numel() // core.n)
        _reduce_scatter(out, g.contiguous(), group=core.group)
        return out, None


def _moved_shape(shape, axis):
    return (shape[axis],) + tuple(d for i, d in enumerate(shape)
                                  if i != axis)


def _by_dtype(leaves, idx):
    groups = {}
    for i in idx:
        groups.setdefault(leaves[i].dtype, []).append(i)
    return groups.values()


class ShardingCore:
    """One trainer's plan: the mesh (a process group), the batch axis and
    the ZeRO level. ``batch_axis=None`` is the degenerate plan of a mesh
    that shards no batch: every placement whole, level 0."""

    def __init__(self, mesh=None, *, level=None, batch_axis=BATCH_AXIS):
        mesh = as_mesh(mesh, batch_axis or BATCH_AXIS)
        if batch_axis is not None and batch_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has no batch axis {batch_axis!r} (axes: "
                f"{mesh.axis_names}); pass batch_axis=None for a mesh "
                "that shards no batch dimension")
        if mesh.rank < 0:
            raise ValueError("this process is not a rank of the mesh")
        self.mesh = mesh
        self.group = mesh.group
        self.batch_axis = batch_axis
        self.n = int(mesh.size) if batch_axis else 1
        self.rank = int(mesh.rank) if batch_axis else 0
        if batch_axis is None:
            if level is not None and resolve_level(level) != 0:
                raise ValueError(
                    f"level={level} requires a batch axis to shard "
                    "over; a batch_axis=None plan is always level 0")
            self.level = 0
        else:
            self.level = resolve_level(level)
        self._signature = ("dpshard", self.level, self.batch_axis,
                           tuple(mesh.axis_names), (int(mesh.size),))

    # ---- the per-leaf rule --------------------------------------------
    def leaf_axis(self, shape):
        """The axis a leaf of ``shape`` shards on: the first that N
        divides, or None (scalars and indivisible leaves stay whole)."""
        if self.batch_axis is None:
            return None
        for i, d in enumerate(shape):
            if d > 0 and d % self.n == 0:
                return i
        return None

    def leaf_spec(self, leaf):
        i = self.leaf_axis(tuple(getattr(leaf, "shape", ())))
        return () if i is None else (None,) * i + (self.batch_axis,)

    def param_spec(self, leaf):
        """Parameters shard at rest at level 3 only."""
        return self.leaf_spec(leaf) if self.level >= 3 else ()

    def state_spec(self, leaf):
        """Layer state (BatchNormalization's running moments) rides with
        the parameters."""
        return self.param_spec(leaf)

    def grad_spec(self, leaf):
        """Gradients are reduce-scattered to shards from level 2."""
        return self.leaf_spec(leaf) if self.level >= 2 else ()

    def updater_spec(self, leaf):
        """Updater state shards from level 1 (ZeRO-1)."""
        return self.leaf_spec(leaf) if self.level >= 1 else ()

    def batch_spec(self):
        return (self.batch_axis,) if self.batch_axis else ()

    def stacked_spec(self):
        return (None, self.batch_axis) if self.batch_axis else ()

    def data_sharding(self):
        """This rank's rows of a [B, ...] batch."""
        return RowSharding(self.rank, self.n, 0)

    def stacked_sharding(self):
        """This rank's rows of a stacked [K, B, ...] group (axis 1)."""
        return RowSharding(self.rank, self.n, 1)

    def axes(self, leaves, spec_fn):
        """Each leaf's shard axis under ``spec_fn`` (None: whole)."""
        out = []
        for t in leaves:
            spec = spec_fn(t)
            out.append(spec.index(self.batch_axis)
                       if self.batch_axis in spec else None)
        return out

    # ---- placement ------------------------------------------------------
    def shard(self, t, axis):
        """This rank's slice of a whole leaf (a view; the leaf when
        ``axis`` is None)."""
        if axis is None:
            return t
        c = t.shape[axis] // self.n
        return t.narrow(axis, self.rank * c, c)

    def place(self, leaves, axes):
        """Each whole leaf at rest: its shard, as a tensor of its own,
        where ``axes`` says; the leaf itself elsewhere."""
        out = []
        for t, a in zip(leaves, axes):
            if a is None or self.n == 1:
                out.append(t)
                continue
            s = self.shard(t.detach(), a).contiguous().clone()
            out.append(s.requires_grad_(t.requires_grad))
        return out

    def gather_params(self, leaves, axes):
        """Whole leaves from this rank's shards (where ``axes`` says;
        other leaves pass through): one all-gather a dtype."""
        out = list(leaves)
        idx = [i for i, a in enumerate(axes) if a is not None]
        if self.n == 1 or not idx:
            return out
        for group in _by_dtype(leaves, idx):
            rows = torch.cat([leaves[i].detach().movedim(axes[i], 0)
                              .reshape(-1) for i in group])
            buf = rows.new_empty(self.n * rows.numel())
            _all_gather(buf, rows, group=self.group)
            buf = buf.view(self.n, -1)
            off = 0
            for i in group:
                k, a = leaves[i].numel(), axes[i]
                shape = list(leaves[i].shape)
                shape[a] *= self.n
                out[i] = buf[:, off:off + k].reshape(
                    _moved_shape(shape, a)).movedim(0, a).contiguous()
                off += k
        return out

    def place_params(self, leaves):
        """Parameter leaves at rest: shards at level 3."""
        return self.place(leaves, self.axes(leaves, self.param_spec))

    def place_states(self, leaves):
        """Layer-state leaves at rest: with the parameters."""
        return self.place(leaves, self.axes(leaves, self.state_spec))

    def place_updater(self, leaves):
        """Updater-state leaves at rest: shards from level 1."""
        return self.place(leaves, self.axes(leaves, self.updater_spec))

    def host_view(self, leaves, axes=None):
        """Whole leaves as numpy arrays (a collective when any leaf is a
        shard): the level- and width-independent save payload."""
        if axes is not None:
            leaves = self.gather_params(leaves, axes)
        return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t) for t in leaves]

    # ---- in-step collectives ------------------------------------------
    def constrain_grads(self, grads, axes, scalars=()):
        """The mean over the ranks of each rank's whole gradient leaves:
        at levels 0-1 every leaf comes back whole; at levels 2-3 a leaf
        with a shard axis comes back as this rank's shard
        (reduce-scatter). ``scalars`` (0-dim tensors, e.g. the loss) ride
        with the whole leaves' all-reduce and come back as their means.
        Returns (gradients, scalars)."""
        out = list(grads)
        n = self.n
        sharded = [i for i, a in enumerate(axes) if a is not None]
        for group in _by_dtype(grads, sharded):
            buf = torch.cat([grads[i].movedim(axes[i], 0).reshape(n, -1)
                             for i in group], dim=1)
            if self.level >= 2:
                mine = buf.new_empty(buf.shape[1])
                _reduce_scatter(mine, buf.reshape(-1), group=self.group)
                mine.div_(n)
                off = 0
                for i in group:
                    a, shape = axes[i], list(grads[i].shape)
                    shape[a] //= n
                    k = int(np.prod(shape))
                    out[i] = mine[off:off + k].reshape(
                        _moved_shape(shape, a)).movedim(0, a).contiguous()
                    off += k
            else:
                dist.all_reduce(buf, group=self.group)
                buf.div_(n)
                off = 0
                for i in group:
                    a, shape = axes[i], tuple(grads[i].shape)
                    k = grads[i].numel() // n
                    out[i] = buf[:, off:off + k].reshape(
                        _moved_shape(shape, a)).movedim(0, a).contiguous()
                    off += k
        whole = [i for i, a in enumerate(axes) if a is None]
        scalars = list(scalars)
        flat = [grads[i].reshape(-1).float() for i in whole] + \
            [s.detach().reshape(1).float() for s in scalars]
        if flat:
            buf = torch.cat(flat)
            dist.all_reduce(buf, group=self.group)
            buf.div_(n)
            off = 0
            for i in whole:
                k = grads[i].numel()
                out[i] = buf[off:off + k].view(grads[i].shape).to(
                    grads[i].dtype)
                off += k
            scalars = [buf[off + j].to(s.dtype)
                       for j, s in enumerate(scalars)]
        return out, scalars

    def gather_rows(self, t):
        """[b, ...] on each rank -> [N * b, ...], the ranks' rows in
        rank order."""
        if self.n == 1:
            return t
        out = t.new_empty((self.n * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather(out, t.contiguous(), group=self.group)
        return out

    def all_reduce_sum(self, t):
        """The sum over the ranks, differentiable (its backward sums the
        upstream gradients over the ranks)."""
        return _AllReduceSum.apply(t, self)

    def all_gather_flat(self, shard):
        """[C] shard -> [N * C], differentiable: the backward is a
        reduce-scatter (FSDP's just-in-time gather)."""
        return _AllGather.apply(shard, self)

    def broadcast(self, t, src=0):
        """``t`` from rank ``src`` of the mesh, in place."""
        src = src if self.group is None else \
            dist.get_global_rank(self.group, src)
        dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self):
        if self.n > 1:
            dist.barrier(group=self.group)

    # ---- width change / identity ---------------------------------------
    def with_width(self, n_batch):
        """The same plan at another width: the first ``n_batch`` ranks
        (a new group every rank of the world builds; a rank outside it
        gets None). A restore placed under it is the re-shard."""
        if self.batch_axis is None:
            raise ValueError("with_width re-plans data-parallel meshes "
                             "only; this plan shards no batch")
        mesh = build_mesh(n_batch, batch_axis=self.batch_axis)
        if mesh.rank < 0:
            return None
        return ShardingCore(mesh, level=self.level,
                            batch_axis=self.batch_axis)

    def signature(self):
        """Hashable plan identity: level and axis layout."""
        return self._signature
