"""Async prefetching iterator: a background thread, a bounded queue, and
one host-to-device copy a group on the consumer's thread. The port of
``deeplearning4j_tpu/datasets/async_iterator.py``
(``AsyncDataSetIterator.java``, ``MultipleEpochsIterator``).

The worker thread touches numpy only: it pulls, pre-processes, buckets
by shape, row-pads ragged batches and stacks fused groups. The copy to
the device happens when the consumer dequeues a group, so no CUDA call is
ever made from the worker.

``fuse`` > 1 is the fused loop's input side: up to ``fuse`` consecutive
batches of one shape bucket travel as one :class:`StackedDataSet` [K, B,
...] (a ComputationGraph's ``MultiDataSet`` batches as one
:class:`StackedMultiDataSet`, every stream stacked, the bucket keyed by
every stream's shape) with [K, B] example weights (zero on padded rows
and steps), which ``fit_fused`` trains in one pass. ``k_resolver`` is
the fusion autotuner's seam: it gives each bucket its group size.

``sharding`` and ``fuse_sharding`` are data parallelism's input side
(``parallel/sharding_core.py``'s ``data_sharding()`` and
``stacked_sharding()``): each rank reads the whole global stream and
copies only its own rows of each batch, or of each stacked group (batch
axis 1), to its device.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_flag, env_int
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, DataSetIterator, MultiDataSet, MultiDataSetIterator,
    StackedDataSet, StackedMultiDataSet)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.errors import PrefetchWorkerDiedError
from deeplearning4j_tpu_torch.testing import faults

__all__ = ["AsyncDataSetIterator", "MultipleEpochsIterator", "default_fuse",
           "default_stage"]

_SENTINEL = object()

# process-wide prefetch metrics under the reference's names; each
# per-instance increment below also lands here, while ``fuse_stats()``
# stays per iterator (and so per fit: fit() wraps a fresh iterator)
_OBS_REBUCKETS = obs.counter(
    "prefetch.rebucket_flushes_total",
    "Mid-stream shape-change flushes of a fused bucket")
_OBS_FUSED_GROUPS = obs.counter(
    "prefetch.fused_groups_total", "StackedDataSet groups emitted")
_OBS_PADDED_STEPS = obs.counter(
    "prefetch.padded_steps_total",
    "Zero-weight dummy steps added to pad short fused groups")
_OBS_PARTIAL_BATCHES = obs.counter(
    "prefetch.partial_flush_batches_total",
    "Batches adaptive grouping emitted under the per-batch contract "
    "instead of inside a padded fused group")
_OBS_PAD_SAVED = obs.counter(
    "fuse.padding_steps_saved_total",
    "Zero-weight padding steps adaptive grouping avoided relative to the "
    "always-pad-to-K contract")
_OBS_QUEUE_DEPTH = obs.gauge(
    "prefetch.queue_depth",
    "Prefetch queue occupancy (groups) after the worker's latest enqueue")
_OBS_CONSUMER_WAIT = obs.histogram(
    "prefetch.consumer_wait_seconds",
    "Time the training loop blocked waiting for the prefetch queue")

# how long one bounded queue.get waits before the consumer re-checks that
# the worker is alive: it trades only fault-detection latency, since a
# live worker's batch is returned the moment it is enqueued
_LIVENESS_POLL_S = 0.2

class _WorkerKilled(Exception):
    """The ``kill-worker`` fault: the worker exits WITHOUT its sentinel,
    which is what a crashed thread looks like to the consumer."""


class _Staged:
    """A host-side batch group awaiting its device copy on the consumer
    thread: a lone batch (``single``) or one concatenation or stack
    (``concat``), never both, so queued host memory is not doubled."""

    __slots__ = ("single", "concat")

    def __init__(self, single=None, concat=None):
        self.single = single
        self.concat = concat


def default_stage():
    """Super-batch staging factor for fit() (``DL4J_TORCH_TRANSFER_STAGE``,
    read at call time)."""
    return env_int("DL4J_TORCH_TRANSFER_STAGE", minimum=1)


def default_fuse():
    """Fused-loop group size for fit() (``DL4J_TORCH_FUSE_STEPS``, read at
    call time); 1 keeps the per-batch loop."""
    return env_int("DL4J_TORCH_FUSE_STEPS", minimum=1)


def _is_multi(ds):
    """A MultiDataSet-shaped batch (lists of feature and label arrays)."""
    return hasattr(ds, "features_masks")


class AsyncDataSetIterator(DataSetIterator):
    def __init__(self, base, queue_size=2, sharding=None, stage=1, fuse=1,
                 fuse_sharding=None, k_resolver=None, bucket_pad=False,
                 device=None):
        """``stage`` > 1: the worker concatenates up to ``stage``
        consecutive equal-shape maskless batches, the consumer copies the
        concatenation to ``device`` in one transfer and hands out slices.
        Partial groups and masked batches go one by one. With ``stage`` 1
        and ``fuse`` 1, batches pass through as the base iterator made
        them.

        ``fuse`` > 1 supersedes ``stage``: the worker groups up to
        ``fuse`` consecutive batches of one bucket shape (ragged batches
        padded up to the bucket's batch size with zero-weight copies of
        their last row; the stream's trailing group padded up to ``fuse``
        steps with zero-weight copies of its last batch) and emits each
        group as one :class:`StackedDataSet` on ``device``. A batch that
        cannot stack (masks, tensors already on a device) keeps the
        single-batch contract, after the pending group. Adaptive grouping
        (``DL4J_TORCH_FUSE_ADAPT``) is the reference's: a mid-stream
        shape change emits the partial group at the next power of 2 (a
        lone batch per batch, with its row weights as
        ``example_weights``), and a bucket that keeps thrashing halves its
        K toward 1 and doubles it back once full groups return.

        ``k_resolver`` (optional) maps a bucket key (``_shapes_of``) to
        that bucket's group size: the fusion autotuner's seam
        (``tuning/autotuner.py``), the probe size while the bucket is
        undecided and the decided K after. It runs on the worker thread
        and touches no device. ``bucket_pad`` row-pads ragged batches in
        the per-batch (``fuse`` 1) path too, with the zero-weight tail as
        ``example_weights``. ``device`` is where staged batches go (None:
        ``cuda``).

        ``sharding`` (a ``RowSharding``, e.g. a plan's
        ``data_sharding()``) copies each batch that does not stack, as
        this rank's rows only (masks and example weights too; ``stage``
        is 1); ``fuse_sharding`` (``stacked_sharding()``) does the same
        for stacked groups along their batch axis 1. The batch must
        divide over the ranks: padding is the caller's."""
        self.base = base
        self.sharding = sharding
        self.fuse_sharding = fuse_sharding
        self._k_resolver = k_resolver
        self.device = resolve_device(device)
        self.fuse = max(1, int(fuse))
        self._bucket_pad = bool(bucket_pad)
        # a staged super-batch is sliced per batch after its copy, which
        # a rank's rows of each batch are not: sharding stages nothing
        self.stage = 1 if sharding is not None else max(1, int(stage))
        # one staged transfer stays under stage_bytes, and the worker keeps
        # at most ~2 * stage_bytes of batches queued (_worker.emit)
        self.stage_bytes = env_int("DL4J_TORCH_TRANSFER_STAGE_BYTES",
                                   minimum=1)
        # a whole group is ONE queue item, so the byte budget, not the
        # item count, bounds queued host memory
        self.queue_size = max(queue_size, 2)
        self._device_stage = sharding is not None or self.stage > 1
        self._queue = None
        self._thread = None
        self._stop = None
        self._error = None
        self._ready = None   # consumer-side batches of a staged group
        self._lingering = None
        # grouping telemetry, cumulative over the iterator's life (reset()
        # keeps it: the interesting number is per fit). Plain int
        # increments from the worker thread: a stale read costs a count
        self.rebucket_flushes = 0
        self.fused_groups = 0
        self.padded_steps = 0
        self.partial_flush_batches = 0
        self.padded_steps_saved = 0
        # per-bucket adaptation, cumulative across resets:
        # _bucket_k[key] the adaptive K ceiling, _bucket_stats[key] =
        # [mid-stream flushes, full groups], _bucket_streak[key] the run
        # of per-batch emissions of a degraded bucket, _bucket_cf[key] the
        # always-pad counterfactual K (byte-capped)
        self._bucket_k = {}
        self._bucket_stats = {}
        self._bucket_streak = {}
        self._bucket_cf = {}
        # one-shot resume cursor: the next run's worker discards this many
        # base batches before grouping
        self._skip_next = 0

    # ---- consumer-side device copy ------------------------------------

    def _put(self, a, sharding=None):
        """``a`` (this rank's rows of it under ``sharding``) as a tensor
        on the iterator's device (float64 arrays become f32, as the
        models take them)."""
        if a is None:
            return None
        if sharding is not None:
            a = sharding.take(a)
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    # ---- worker-side helpers (numpy only) -----------------------------

    def _stageable(self, ds):
        if _is_multi(ds):
            # masks do not stack; device tensors are already staged
            return (ds.features_masks is None and ds.labels_masks is None
                    and all(isinstance(a, np.ndarray)
                            for a in list(ds.features) + list(ds.labels)))
        # a batch already on a device is staged: concatenating would copy
        # it back to the host
        return (isinstance(ds, DataSet) and ds.features is not None
                and ds.labels is not None and ds.features_mask is None
                and ds.labels_mask is None
                and isinstance(ds.features, np.ndarray)
                and isinstance(ds.labels, np.ndarray))

    @staticmethod
    def _nbytes(ds):
        try:
            if _is_multi(ds):
                return sum(a.nbytes for a in ds.features + ds.labels)
            return ds.features.nbytes + ds.labels.nbytes
        except AttributeError:
            return 0    # masked / odd batches: exempt from the budget

    def _bucket_base_k(self, key):
        """The bucket's group size before adaptation and byte caps: the
        resolver's (the tuner's decision, or its probe size) when one is
        wired, else ``fuse``."""
        if self._k_resolver is not None:
            return max(1, int(self._k_resolver(key)))
        return self.fuse

    def _always_pad_k(self, key):
        """The byte-capped, undegraded group size the always-pad contract
        would have padded this bucket's flush to: the counterfactual of
        ``padded_steps_saved``."""
        return self._bucket_cf.get(key) or self._bucket_base_k(key)

    def _group_target(self, ds, key=None):
        """How many batches like ``ds`` one group may hold: the stage (or
        the bucket's fused K, possibly degraded), shrunk so the transfer
        stays under ``stage_bytes``; at least 1. Taken when a group
        opens."""
        per = max(1, self._nbytes(ds))
        if self.fuse > 1:
            key = self._shapes_of(ds) if key is None else key
            group_n = self._bucket_base_k(key)
            self._bucket_cf[key] = max(1, min(group_n,
                                              self.stage_bytes // per))
            cap = self._bucket_k.get(key)
            if cap is not None:
                group_n = min(group_n, cap)
        else:
            group_n = self.stage
        return max(1, min(group_n, self.stage_bytes // per))

    def _degrade_bucket(self, key):
        """One mid-stream flush of ``key``'s bucket: while flushes
        outnumber full groups, its K halves toward 1."""
        st = self._bucket_stats.setdefault(key, [0, 0])
        st[0] += 1
        if st[0] > st[1]:
            cur = self._bucket_k.get(key) or self._bucket_base_k(key)
            if cur > 1:
                self._bucket_k[key] = max(1, cur // 2)

    def _maybe_recover(self, key):
        """Once full groups (or per-batch streaks worth one) outweigh the
        bucket's flushes, its K doubles back toward base."""
        cap = self._bucket_k.get(key)
        if cap is None:
            return
        st = self._bucket_stats.setdefault(key, [0, 0])
        if st[1] > st[0]:
            if cap * 2 >= self._bucket_base_k(key):
                self._bucket_k.pop(key, None)
            else:
                self._bucket_k[key] = cap * 2
            self._bucket_streak.pop(key, None)

    def _settle_streak(self, key):
        """Account an ended per-batch streak against the always-pad
        counterfactual: ``s`` same-bucket batches would have made s // K
        full groups and one flush padded by K - s % K steps; only that
        remainder counts as saved."""
        s = self._bucket_streak.pop(key, 0)
        r = s % self._always_pad_k(key) if s else 0
        if r:
            saved = self._always_pad_k(key) - r
            self.padded_steps_saved += saved
            _OBS_PAD_SAVED.inc(saved)

    @staticmethod
    def _shapes_of(ds):
        """Grouping key: every array's shape must match (a MultiDataSet's
        every stream)."""
        if _is_multi(ds):
            return ("mds", tuple(a.shape for a in ds.features),
                    tuple(a.shape for a in ds.labels))
        return ("ds", ds.features.shape, ds.labels.shape)

    @staticmethod
    def _pad_rows(ds, bucket):
        """Pad a ragged (smaller) batch up to the bucket's batch size with
        copies of its last row and a zero weight tail. Returns
        (padded batch, weights [B]) or None when ``ds`` differs from the
        bucket in more than the batch dimension."""
        def pad_to(a, bn):
            n = a.shape[0]
            return np.concatenate([a, np.repeat(a[-1:], bn - n, axis=0)])

        if _is_multi(ds):
            if bucket[0] != "mds":
                return None
            _, fshapes, lshapes = bucket
            bn = fshapes[0][0]
            n = ds.features[0].shape[0]
            if (n >= bn or len(ds.features) != len(fshapes)
                    or len(ds.labels) != len(lshapes)
                    or not all(a.shape == (n,) + ref[1:] for a, ref in
                               zip(list(ds.features) + list(ds.labels),
                                   list(fshapes) + list(lshapes)))):
                return None
            w = np.zeros(bn, np.float32)
            w[:n] = 1.0
            return (MultiDataSet([pad_to(a, bn) for a in ds.features],
                                 [pad_to(a, bn) for a in ds.labels]), w)
        if bucket[0] != "ds":
            return None
        _, fshape, lshape = bucket
        bn = fshape[0]
        n = ds.features.shape[0]
        if (n >= bn or ds.features.shape[1:] != fshape[1:]
                or ds.labels.shape != (n,) + lshape[1:]):
            return None
        w = np.zeros(bn, np.float32)
        w[:n] = 1.0
        return DataSet(pad_to(ds.features, bn), pad_to(ds.labels, bn)), w

    @staticmethod
    def _host_stack(group, k_target):
        """Stack a fused group, a list of (batch, weights [B] or None), to
        [K, B, ...] arrays (one per stream of a MultiDataSet), padding it
        up to ``k_target`` steps with zero-weight copies of its last
        batch."""
        first = group[0][0]
        multi = _is_multi(first)
        bn = (first.features[0] if multi else first.features).shape[0]
        ws = [np.ones(bn, np.float32) if w is None else w for _, w in group]
        n_real = len(group)
        pad_steps = k_target - n_real
        dss = [d for d, _ in group] + [group[-1][0]] * pad_steps
        w = np.stack(ws + [np.zeros(bn, np.float32)] * pad_steps)
        if multi:
            xs = [np.stack([d.features[i] for d in dss])
                  for i in range(len(first.features))]
            ys = [np.stack([d.labels[i] for d in dss])
                  for i in range(len(first.labels))]
            return ("fmds", xs, ys, w, n_real)
        xs = np.stack([np.asarray(d.features) for d in dss])
        ys = np.stack([np.asarray(d.labels) for d in dss])
        return ("fds", xs, ys, w, n_real)

    @staticmethod
    def _host_concat(group):
        if _is_multi(group[0]):
            xs = [np.concatenate([d.features[i] for d in group])
                  for i in range(len(group[0].features))]
            ys = [np.concatenate([d.labels[i] for d in group])
                  for i in range(len(group[0].labels))]
            return ("mds", xs, ys, [d.features[0].shape[0] for d in group])
        xs = np.concatenate([np.asarray(d.features) for d in group])
        ys = np.concatenate([np.asarray(d.labels) for d in group])
        return ("ds", xs, ys, [d.features.shape[0] for d in group])

    def _emit_single(self, ds):
        if not self._device_stage:
            return ds
        sh = self.sharding
        if _is_multi(ds):
            def put_all(arrs):
                return None if arrs is None else \
                    [self._put(a, sh) for a in arrs]
            out = MultiDataSet(put_all(ds.features), put_all(ds.labels),
                               put_all(ds.features_masks),
                               put_all(ds.labels_masks))
        elif sh is None:
            out = DataSet(self._put(ds.features), self._put(ds.labels),
                          ds.features_mask, ds.labels_mask)
        else:
            out = DataSet(self._put(ds.features, sh),
                          self._put(ds.labels, sh),
                          self._put(ds.features_mask, sh),
                          self._put(ds.labels_mask, sh))
        w = getattr(ds, "example_weights", None)
        if w is not None:   # a row-padded ragged batch's weights ride along
            out.example_weights = self._put(w, sh)
        return out

    def _stage_group(self, staged):
        """Consumer side: one device copy per array stream of the group,
        then its batches (slices) or its one StackedDataSet. The only
        method that touches the device; it runs on the consumer thread."""
        if staged.single is not None:
            return [self._emit_single(staged.single)]
        kind = staged.concat[0]
        fs = self.fuse_sharding
        if kind == "fmds":
            _, xs, ys, w, n_real = staged.concat
            return [StackedMultiDataSet([self._put(x, fs) for x in xs],
                                        [self._put(y, fs) for y in ys],
                                        self._put(w, fs), n_real)]
        if kind == "fds":
            _, xs, ys, w, n_real = staged.concat
            return [StackedDataSet(self._put(xs, fs), self._put(ys, fs),
                                   self._put(w, fs), n_real)]
        if kind == "mds":
            _, xs, ys, sizes = staged.concat
            dxs, dys = [self._put(x) for x in xs], [self._put(y) for y in ys]
            out, pos = [], 0
            for n in sizes:
                out.append(MultiDataSet([x[pos:pos + n] for x in dxs],
                                        [y[pos:pos + n] for y in dys]))
                pos += n
            return out
        _, xs, ys, sizes = staged.concat
        dxs, dys = self._put(xs), self._put(ys)
        out, pos = [], 0
        for n in sizes:
            out.append(DataSet(dxs[pos:pos + n], dys[pos:pos + n]))
            pos += n
        return out

    def skip_next(self, n):
        """Arm a one-shot fast-forward: the next run discards its first
        ``n`` base batches in the worker, before grouping."""
        self._skip_next = max(0, int(n))

    def _worker(self, q, stop, errbox, skip=0):
        # q/stop/errbox belong to this run: after a reset() this thread can
        # fill only its own abandoned queue and error box. The thread
        # touches numpy only; the device copy is the consumer's.
        def emit(items, nbytes=0):
            for item in items:
                while not stop.is_set():
                    # queued batches total at most ~2 * stage_bytes
                    if nbytes and q.qsize() > 0 and \
                            (q.qsize() + 1) * nbytes > 2 * self.stage_bytes:
                        stop.wait(0.05)
                        continue
                    try:
                        q.put(item, timeout=0.1)
                        _OBS_QUEUE_DEPTH.set(q.qsize())
                        break
                    except queue.Full:
                        continue

        def staged_single(d):
            return [_Staged(single=d)] if self._device_stage else [d]

        def nbytes_of(d):
            return self._nbytes(d) if self._device_stage else 0

        def flush(group, full=False):
            if len(group) > 1 and full:
                emit([_Staged(concat=self._host_concat(group))],
                     sum(nbytes_of(d) for d in group))
                return
            # partial stage groups go one by one: only full groups share
            # the one super-batch shape
            for d in group:
                emit(staged_single(d), nbytes_of(d))

        def emit_weighted_single(d, w):
            # the per-batch contract for a fused-mode single: a row-padded
            # ragged batch carries its zero-weight tail as example_weights
            if w is not None:
                d.example_weights = w
            emit(staged_single(d), nbytes_of(d))

        def flush_fused(group, k_target):
            if not group:
                return
            k = max(k_target, len(group))
            self.fused_groups += 1
            self.padded_steps += k - len(group)
            _OBS_FUSED_GROUPS.inc()
            _OBS_PADDED_STEPS.inc(k - len(group))
            nb = sum(self._nbytes(d) for d, _ in group)
            with obs.span("prefetch.stack_group", steps=len(group), k=k):
                staged = _Staged(concat=self._host_stack(group, k))
            emit([staged], nb)

        def flush_partial(group, k_target, bucket_key):
            # a mid-stream flush under adaptive grouping: the partial group
            # at the next power of 2 steps, or a lone batch per batch;
            # padding steps are identity updates either way
            if not group:
                return
            n = len(group)
            base_k = self._always_pad_k(bucket_key)
            if n == 1:
                d, w = group[0]
                self.partial_flush_batches += 1
                _OBS_PARTIAL_BATCHES.inc()
                saved = max(0, base_k - 1)
                emit_weighted_single(d, w)
            else:
                k = min(1 << (n - 1).bit_length(), k_target)
                saved = max(0, base_k - k)
                flush_fused(group, k)
            self.padded_steps_saved += saved
            _OBS_PAD_SAVED.inc(saved)

        def emit_k1(entry, key):
            # a bucket degraded to K 1: per batch, on arrival; a streak
            # worth a full group counts toward recovery, and its savings
            # settle at the next bucket switch or the stream's end
            d, w = entry
            self.partial_flush_batches += 1
            _OBS_PARTIAL_BATCHES.inc()
            emit_weighted_single(d, w)
            if key in self._bucket_k:
                s = self._bucket_streak.get(key, 0) + 1
                if s >= self._always_pad_k(key):
                    self._bucket_stats.setdefault(key, [0, 0])[1] += 1
                    self._bucket_streak[key] = 0
                    self._maybe_recover(key)
                else:
                    self._bucket_streak[key] = s

        try:
            it = iter(self.base)
            adapt = env_flag("DL4J_TORCH_FUSE_ADAPT")
            n_pulled = 0
            group = []     # stageable batches awaiting one transfer
            fgroup = []    # (ds, weights) pairs awaiting a fused stack
            bucket = None  # the open fused bucket's shapes key
            ftarget = 1    # the open fused group's K, taken at open
            ubucket = None  # bucket_pad shapes key of the fuse 1 path
            while not stop.is_set():
                # a base iterator's failure surfaces on the consumer
                if faults.fire("iter-raise") is not None:
                    raise RuntimeError("fault injected: base iterator "
                                       f"failure at pull {n_pulled}")
                try:
                    with obs.span("prefetch.pull"):
                        ds = next(it)
                except StopIteration:
                    break
                n_pulled += 1
                if skip > 0:
                    skip -= 1    # resume fast-forward, before grouping
                    continue
                if faults.fire("kill-worker") is not None:
                    raise _WorkerKilled
                spec = faults.fire("slow-batch")
                if spec is not None:
                    time.sleep(spec.param_float(0.1))
                # the pre-processor runs here, on the worker, before staging
                ds = self._run_pp(ds)
                nb = nbytes_of(ds)
                stageable = self._stageable(ds)
                if self.fuse > 1 and stageable:
                    shp = self._shapes_of(ds)
                    if bucket is None:
                        bucket = shp
                    if shp == bucket:
                        entry = (ds, None)
                    else:
                        entry = self._pad_rows(ds, bucket)
                        if entry is None:
                            # a new shape: flush and rebucket (a change on
                            # a group boundary costs nothing)
                            if fgroup:
                                self.rebucket_flushes += 1
                                _OBS_REBUCKETS.inc()
                                if adapt:
                                    self._degrade_bucket(bucket)
                                    flush_partial(fgroup, ftarget, bucket)
                                else:
                                    flush_fused(fgroup, ftarget)
                            self._settle_streak(bucket)
                            fgroup = []
                            bucket = shp
                            entry = (ds, None)
                    if not fgroup:
                        ftarget = self._group_target(ds, bucket)
                    if adapt and ftarget <= 1:
                        emit_k1(entry, bucket)
                        continue
                    fgroup.append(entry)
                    if len(fgroup) >= ftarget:
                        flush_fused(fgroup, ftarget)
                        self._bucket_stats.setdefault(bucket, [0, 0])[1] += 1
                        self._maybe_recover(bucket)
                        fgroup = []
                elif self.fuse > 1:
                    # cannot stack (masks, device tensors): keep the order,
                    # the pending group first, then this batch alone
                    if adapt:
                        flush_partial(fgroup, ftarget, bucket)
                    else:
                        flush_fused(fgroup, ftarget)
                    self._settle_streak(bucket)
                    fgroup = []
                    emit(staged_single(ds), nb)
                elif (padded := (
                        self._pad_rows(ds, ubucket)
                        if (self._bucket_pad and ubucket is not None
                            and stageable
                            and self._shapes_of(ds) != ubucket)
                        else None)) is not None:
                    # fuse 1 with bucket padding: a ragged batch is
                    # row-padded, its zero tail as example_weights
                    if group:
                        flush(group)
                        group = []
                    emit_weighted_single(*padded)
                elif self.stage > 1 and stageable and (
                        not group
                        or self._shapes_of(ds) == self._shapes_of(group[0])):
                    if self._bucket_pad:
                        ubucket = self._shapes_of(ds)
                    group.append(ds)
                    if len(group) >= self._group_target(ds):
                        flush(group, full=True)
                        group = []
                else:
                    if group:
                        flush(group)
                        group = []
                    if self._bucket_pad and stageable:
                        ubucket = self._shapes_of(ds)
                    emit(staged_single(ds), nb)
            if not stop.is_set():
                if group:
                    flush(group)
                # the stream's trailing group keeps its padding to K: that
                # is what holds a homogeneous stream to one signature
                flush_fused(fgroup, ftarget)
                for key in list(self._bucket_streak):
                    self._settle_streak(key)
        except _WorkerKilled:
            return   # a simulated crash: no sentinel, no error box
        except Exception as e:   # surfaced on next()
            errbox.append(e)
            emit([_SENTINEL])
        else:
            emit([_SENTINEL])

    def _apply_pp(self, item):
        # the worker already applied the pre-processor
        return item

    @staticmethod
    def _pp_copy(item):
        if _is_multi(item):
            return MultiDataSetIterator._pp_copy(item)
        return DataSetIterator._pp_copy(item)

    def fuse_stats(self):
        """Grouping telemetry of this iterator: mid-stream rebucket
        flushes, fused groups, padding steps, batches adaptive grouping
        emitted per batch, and padding steps it avoided. Models keep it
        per fit as ``_last_fuse_stats``."""
        return {"rebucket_flushes": self.rebucket_flushes,
                "fused_groups": self.fused_groups,
                "padded_steps": self.padded_steps,
                "partial_flush_batches": self.partial_flush_batches,
                "padded_steps_saved": self.padded_steps_saved}

    def shutdown(self):
        """Stop the worker and detach it from the base iterator, so an
        abandoned epoch does not leave a worker racing the next one."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # blocked inside the base iterator: the next run waits
                self._lingering = self._thread
        self._queue = None
        self._thread = None
        self._stop = None
        self._ready = None

    def reset(self):
        self.shutdown()
        if self._lingering is not None:
            self._lingering.join()
            self._lingering = None
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._ready = []
        self._error = []
        self._stop = threading.Event()
        skip, self._skip_next = self._skip_next, 0
        self._thread = threading.Thread(
            target=self._worker,
            args=(self._queue, self._stop, self._error, skip),
            name="dl4j-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self):
        self.reset()
        return self

    def _get_checked(self):
        """Bounded ``queue.get`` with a liveness check: a worker that died
        without its sentinel raises instead of wedging the consumer."""
        q, thread = self._queue, self._thread
        t0 = time.perf_counter()

        def got(item):
            dt = time.perf_counter() - t0
            _OBS_CONSUMER_WAIT.record(dt)
            obs.add_span("prefetch.wait", t0, dt)
            return item

        while True:
            try:
                return got(q.get(timeout=_LIVENESS_POLL_S))
            except queue.Empty:
                pass
            if thread is not None and thread.is_alive():
                continue
            # dead worker: take what landed between the timeout and the check
            try:
                return got(q.get_nowait())
            except queue.Empty:
                if self._error:
                    raise self._error[0]
                name = "<unstarted>" if thread is None else thread.name
                raise PrefetchWorkerDiedError(
                    f"prefetch worker thread {name!r} died without emitting "
                    "its end-of-stream sentinel (hard crash?); the stream "
                    "is broken: reset() the iterator to restart it")

    def __next__(self):
        if self._queue is None:
            self.reset()
        if self._ready:
            return self._ready.pop(0)
        item = self._get_checked()
        if item is _SENTINEL:
            if self._error:
                raise self._error[0]
            raise StopIteration
        if isinstance(item, _Staged):
            self._ready = self._stage_group(item)   # the device copy
            return self._ready.pop(0)
        return item

    def batch_size(self):
        return self.base.batch_size()


class MultipleEpochsIterator(DataSetIterator):
    """Repeat a base iterator for ``epochs`` passes
    (MultipleEpochsIterator.java)."""

    def __init__(self, epochs, base):
        self.epochs = epochs
        self.base = base
        self._epoch = 0
        self._inner = None

    def reset(self):
        self._epoch = 0
        self._inner = None

    def batch_size(self):
        return self.base.batch_size()

    def __next__(self):
        if self._inner is None:
            self._inner = iter(self.base)
        while True:
            try:
                return next(self._inner)
            except StopIteration:
                self._epoch += 1
                if self._epoch >= self.epochs:
                    raise
                self._inner = iter(self.base)
