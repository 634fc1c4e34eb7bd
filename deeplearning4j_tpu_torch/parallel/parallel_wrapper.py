"""Synchronous data-parallel training of a MultiLayerNetwork: the port of
``deeplearning4j_tpu/parallel/parallel_wrapper.py``
(``ParallelWrapper.java:44``).

The reference shards each global batch over a device mesh and runs one
compiled step over it; XLA places the gradient all-reduce. Here each
rank is a process of a ``torch.distributed`` group
(``parallel/multihost.py``); every rank reads the same global stream,
keeps its own rows of each batch, and the model's step reduces the
gradients over the group (``models/_layered.py`` under the plan of
``parallel/sharding_core.py``). One step over the global batch equals one
single-device step on that batch: ``averaging_frequency = 1``, the
semantics the reference's own parity test takes as ground truth, with
the updater seeing only the reduced gradient. ``workers`` is the size of
the group.

Launch one process a rank, e.g. ``torchrun --nproc-per-node 4
script.py``, or call :func:`parallel.multihost.initialize` in each
process; every rank builds the same model from the same seed and calls
the same methods in the same order (each step, save, ``output`` and, at
ZeRO level 3, each read of the parameters is a collective).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator, default_fuse)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       StackedDataSet)
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.sharding_core import (ShardingCore,
                                                             build_mesh)

__all__ = ["ParallelWrapper", "data_parallel_mesh"]


def data_parallel_mesh(workers=None, axis="data"):
    """The pure-DP mesh over the first ``workers`` ranks (all when None)."""
    return build_mesh(workers, batch_axis=axis)


def _pad_rows(arr, n):
    """``arr`` with its last row repeated up to a multiple of ``n`` rows
    (the reference's padding: the copies count as examples)."""
    short = -arr.shape[0] % n
    if not short:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(short, *arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], short, axis=0)])


class ParallelWrapper:
    """The reference's knobs over a process group: ``workers``
    (the group's size; the whole default group when None),
    ``prefetch_buffer``, ``averaging_frequency`` (kept; the semantics are
    those of 1, as in the reference) and ``dp_shard``, the ZeRO level
    (``DL4J_TORCH_DP_SHARD`` when None). ``device`` is this rank's device:
    the card unless ``"cpu"`` is asked for (``multihost.rank_device``),
    and the model must live on it."""

    def __init__(self, model, *, mesh=None, workers=None, prefetch_buffer=2,
                 averaging_frequency=1, report_score_after_averaging=True,
                 dp_shard=None, device=None):
        self.model = model
        self.device = multihost.rank_device(device)
        own = getattr(model, "device", None)
        if own is not None and torch.device(own) != self.device:
            raise ValueError(f"the model lives on {own}, this rank trains "
                             f"on {self.device}")
        if mesh is None:
            mesh = data_parallel_mesh(workers)
        elif workers is not None and workers != mesh.size:
            raise ValueError(f"workers={workers} but the mesh has "
                             f"{mesh.size} ranks")
        self.mesh = mesh
        # the mesh's first axis is the batch axis, whatever its name
        self.core = ShardingCore(mesh, level=dp_shard,
                                 batch_axis=mesh.axis_names[0])
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = averaging_frequency

    @property
    def workers(self):
        return self.core.n

    @property
    def score_(self):
        """The last step's loss over the global batch."""
        return self.model.score_

    def _place_model(self):
        """Inject the plan into the model, its trees at the level's rest
        placements: one path for fresh fits and restores at every level
        and width (``_enter_plan`` leaves any plan the model held)."""
        self.model._enter_plan(self.core)

    def _shard_batch(self, arr):
        """This rank's rows of a global batch on the model's device. A
        batch that the ranks do not divide is padded by repeating its last
        row, as in the reference; a zero-weight tail in the example
        weights is extended the same way."""
        if arr is None:
            return None
        core = self.core
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        rows = multihost.take_rows(_pad_rows(arr, core.n), core.rank, core.n)
        return self.model._tensor(rows)

    def _fit_batch(self, ds):
        net = self.model
        net.fit_batch(self._shard_batch(ds.features),
                      self._shard_batch(ds.labels),
                      self._shard_batch(ds.features_mask),
                      self._shard_batch(ds.labels_mask),
                      ew=self._shard_batch(getattr(ds, "example_weights",
                                                   None)))

    def fit(self, data, *, epochs=1, checkpoint_every=None,
            checkpoint_dir=None, resume_from=None, on_group=None):
        """Train on a DataSet or a DataSetIterator (the reference's
        ``fit``). Checkpoints hold the whole trees (gathered; rank 0
        writes), so an archive does not depend on the level or the width;
        ``resume_from`` restores it and the placement re-shards it under
        this wrapper's plan: an exact continuation at the same level and
        width, within f32 rounding at another. ``on_group(epoch,
        batches)`` runs after every dispatch, after the checkpoint check;
        an exception from it ends the fit with the prefetcher stopped."""
        net = self.model
        if net.params_list is None:
            net.init()
        every, ck_dir, keep = net._resolve_ckpt_args(
            checkpoint_every, checkpoint_dir, resume_from)
        start_epoch = skip = 0
        if resume_from is not None:
            cursor = net._resume_fit_checkpoint(resume_from)
            if cursor:
                start_epoch = min(int(cursor.get("epoch", 0)), epochs)
                skip = int(cursor.get("batch", 0))
        self._place_model()
        if isinstance(data, DataSet):
            if every or resume_from:
                raise ValueError(
                    "checkpoint_every/resume_from need a data ITERATOR "
                    "(the checkpoint cursor is a stream position)")
            self._fit_batch(data)
            return self
        it = data
        if isinstance(it, DataSetIterator) and self.prefetch_buffer:
            it = AsyncDataSetIterator(
                it, queue_size=self.prefetch_buffer,
                fuse=self._fuse_steps(it),
                fuse_sharding=self.core.stacked_sharding(),
                device=net.device)
        try:
            last_ck = net.iteration
            for ep in range(start_epoch, epochs):
                to_skip, skip = (skip, 0) if ep == start_epoch else (0, 0)
                batches = to_skip
                if to_skip and it is not data:
                    it.skip_next(to_skip)
                    to_skip = 0
                for ds in it:
                    if to_skip:
                        n = getattr(ds, "n_steps", 1)
                        if n > to_skip:
                            raise ValueError(
                                "resume cursor does not align with this "
                                "iterator's grouping; resume with the same "
                                "iterator configuration the checkpoint was "
                                "written under")
                        to_skip -= n
                        continue
                    if isinstance(ds, StackedDataSet):
                        # width 1 only (_fuse_steps): the fused loop
                        net.fit_fused(ds)
                        batches += ds.n_steps
                    else:
                        self._fit_batch(ds)
                        batches += 1
                    if every and net.iteration - last_ck >= every:
                        net._save_fit_checkpoint(ck_dir, ep, batches, keep)
                        last_ck = net.iteration
                    if on_group is not None:
                        on_group(ep, batches)
            net._nanguard_flush()
        finally:
            if it is not data:
                it.shutdown()
        return self

    def _fuse_steps(self, it):
        """The fused loop's group size K: ``DL4J_TORCH_FUSE_STEPS``, gated
        by the model's ``fuse_allowed`` (the single-device rule). Where
        the group spans more than one rank K is 1: every rank is a
        process of its own, as in the reference's multi-process mesh,
        whose fused path is 1 too; and a collective over gloo cannot sit
        in the captured window graphs. So the fused, captured loop runs
        at width 1 and the per-batch step at width N."""
        if self.core.n > 1 or not fuse_allowed(self.model.conf,
                                               self.model.layers):
            return 1
        try:
            b = int(it.batch_size())
        except (AttributeError, NotImplementedError, TypeError):
            return 1
        return default_fuse() if b > 0 else 1

    def output(self, x):
        """The model's output on a global batch, the same on every rank:
        each rank runs its rows (padded as in ``fit``), the rows are
        gathered and the padding dropped."""
        core = self.core
        rows = x.shape[0]
        out = self.model.output(self._shard_batch(x))
        if core.n == 1:
            return out[:rows]
        t = torch.as_tensor(out, device=self.model.device).contiguous()
        return core.gather_rows(t)[:rows].cpu().numpy()
