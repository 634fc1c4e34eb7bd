"""The port's prefetching iterator against the JAX package's.

On the same stream both iterators must emit the same items: the same
kinds (a stacked group or a single batch), group sizes, ``n_steps``,
weights, row-padding weights and grouping telemetry, with the same
values. The port's items are torch tensors (here on the CPU), the
reference's numpy or JAX arrays; values are compared exactly, since
grouping only copies them. Also held: the fault points (``kill-worker``,
``iter-raise``, ``slow-batch``), ``skip_next``, ``shutdown``/``reset``,
and that the worker thread makes no torch call at all.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.async_iterator import (
    AsyncDataSetIterator as JAsync)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import (
    ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.datasets.dataset import StackedDataSet as JStacked
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator, MultipleEpochsIterator, default_fuse,
    default_stage)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator,
                                                       StackedDataSet,
                                                       StackedMultiDataSet)
from deeplearning4j_tpu_torch.errors import PrefetchWorkerDiedError
from deeplearning4j_tpu_torch.testing import faults


def _batch(rows, width, seed, masked=False):
    r = np.random.RandomState(seed)
    x = r.rand(rows, width).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, rows)]
    m = np.ones((rows, width), np.float32) if masked else None
    return x, y, m


def _stream(name):
    """Lists of (rows, width[, masked]) batch specs."""
    if name == "ragged_rows":
        return [(8, 4)] * 3 + [(5, 4)]
    if name == "short_trailing":
        return [(8, 4)] * 2
    if name == "shape_change":
        return [(8, 2), (8, 4)] * 3
    if name == "masked_between":
        return [(8, 4)] * 3 + [(8, 4, True)] + [(8, 4)] * 5 + [(6, 4)]
    if name == "thrash_then_recover":
        return [(8, 2), (8, 4)] * 4 + [(8, 4)] * 12 + [(8, 2)] * 3
    raise KeyError(name)


STREAMS = ["ragged_rows", "short_trailing", "shape_change",
           "masked_between", "thrash_then_recover"]


def _make(specs, ds_cls):
    out = []
    for i, spec in enumerate(specs):
        x, y, m = _batch(spec[0], spec[1], i, len(spec) > 2)
        out.append(ds_cls(x, y, m, None))
    return out


def _np(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _describe(item, stacked_cls):
    """A comparable record of one emitted item."""
    if isinstance(item, stacked_cls):
        return ("stacked", item.n_steps, _np(item.features),
                _np(item.labels), _np(item.weights))
    return ("single", _np(item.features), _np(item.labels),
            _np(item.features_mask),
            _np(getattr(item, "example_weights", None)))


def _assert_same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if a is None or b is None or isinstance(a, int):
                assert a == b if isinstance(a, int) else (a is b is None)
            else:
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("adapt", ["1", "0"], ids=["adapt", "always_pad"])
@pytest.mark.parametrize("stream", STREAMS)
def test_grouping_matches_the_reference(monkeypatch, stream, adapt):
    monkeypatch.setenv("DL4J_TPU_FUSE_ADAPT", adapt)
    monkeypatch.setenv("DL4J_TORCH_FUSE_ADAPT", adapt)
    specs = _stream(stream)
    port = AsyncDataSetIterator(ListDataSetIterator(_make(specs, DataSet)),
                                fuse=4, device="cpu")
    ref = JAsync(JListIterator(_make(specs, JDataSet)), fuse=4)
    got = [_describe(d, StackedDataSet) for d in port]
    want = [_describe(d, JStacked) for d in ref]
    _assert_same_items(got, want)
    assert port.fuse_stats() == ref.fuse_stats()
    # an epoch loop re-iterates: the adaptive state carries over alike
    got = [_describe(d, StackedDataSet) for d in port]
    want = [_describe(d, JStacked) for d in ref]
    _assert_same_items(got, want)
    assert port.fuse_stats() == ref.fuse_stats()


@pytest.mark.parametrize("mode", ["stage", "bucket_pad"])
def test_per_batch_contracts_match_the_reference(mode):
    """``fuse`` 1: super-batch staging (``stage`` 4) hands out the same
    batches; ``bucket_pad`` row-pads a ragged batch with a zero weight
    tail as ``example_weights``."""
    specs = [(8, 4)] * 5 + [(5, 4)] + [(8, 2)] * 2
    kw = dict(stage=4) if mode == "stage" else dict(bucket_pad=True)
    port = AsyncDataSetIterator(ListDataSetIterator(_make(specs, DataSet)),
                                device="cpu", **kw)
    ref = JAsync(JListIterator(_make(specs, JDataSet)), **kw)
    _assert_same_items([_describe(d, StackedDataSet) for d in port],
                       [_describe(d, JStacked) for d in ref])


def test_stacked_group_lands_on_the_device_as_tensors():
    specs = [(8, 4)] * 3 + [(5, 4)]
    out = list(AsyncDataSetIterator(
        ListDataSetIterator(_make(specs, DataSet)), fuse=4, device="cpu"))
    assert len(out) == 1 and isinstance(out[0], StackedDataSet)
    st = out[0]
    assert isinstance(st.features, torch.Tensor)
    assert tuple(st.features.shape) == (4, 8, 4) and st.n_steps == 4
    assert st.weights.sum(1).tolist() == [8.0, 8.0, 8.0, 5.0]
    assert st.num_examples() == 29


def test_kill_worker_raises_prefetch_worker_died():
    it = AsyncDataSetIterator(
        ListDataSetIterator(_make([(8, 4)] * 6, DataSet)), fuse=2,
        device="cpu")
    with faults.inject("kill-worker@3"):
        with pytest.raises(PrefetchWorkerDiedError, match="died"):
            list(it)
    it.shutdown()


def test_iter_raise_surfaces_on_the_consumer():
    base = ListDataSetIterator(_make([(8, 4)] * 4, DataSet))
    got = []
    with faults.inject("iter-raise@2"):
        with pytest.raises(RuntimeError, match="fault injected"):
            for d in AsyncDataSetIterator(base, fuse=2, device="cpu"):
                got.append(d.n_steps)
    # the group the worker finished before the failure was delivered
    assert got == [2]


def test_slow_batch_delays_but_keeps_the_stream():
    specs = [(8, 4)] * 3
    with faults.inject("slow-batch@1:0.05"):
        out = list(AsyncDataSetIterator(
            ListDataSetIterator(_make(specs, DataSet)), device="cpu"))
    assert len(out) == 3


def test_skip_next_discards_batches_before_grouping():
    batches = _make([(8, 4)] * 5, DataSet)
    it = AsyncDataSetIterator(ListDataSetIterator(batches), fuse=2,
                              device="cpu")
    it.skip_next(2)
    skipped = list(it)
    rest = list(AsyncDataSetIterator(ListDataSetIterator(batches[2:]),
                                     fuse=2, device="cpu"))
    _assert_same_items([_describe(d, StackedDataSet) for d in skipped],
                       [_describe(d, StackedDataSet) for d in rest])
    # one-shot: the next run starts from the top again
    assert sum(d.n_steps for d in it) == 5


def test_shutdown_and_reset_restart_the_stream():
    batches = _make([(8, 4)] * 6, DataSet)
    it = AsyncDataSetIterator(ListDataSetIterator(batches), fuse=2,
                              device="cpu")
    first = next(iter(it))
    it.shutdown()
    assert it._thread is None and it._queue is None
    again = list(it)   # __iter__ resets
    assert len(again) == 3
    np.testing.assert_array_equal(first.features.numpy(),
                                  again[0].features.numpy())
    it.reset()
    assert it._thread.is_alive() or not it._queue.empty()
    assert len(list(it)) == 3
    it.shutdown()


def test_worker_thread_makes_no_torch_call(monkeypatch):
    """Every torch entry point the iterator reaches is watched: the worker
    thread calls none, and the device copy runs on the consumer's
    thread."""
    seen = []

    def watch(owner, name):
        real = getattr(owner, name)

        def call(*a, **kw):
            seen.append((name, threading.current_thread().name))
            return real(*a, **kw)
        monkeypatch.setattr(owner, name, call)
    for name in ("from_numpy", "as_tensor", "tensor", "empty", "zeros",
                 "stack", "cat"):
        watch(torch, name)
    watch(torch.Tensor, "to")
    specs = _stream("masked_between")
    out = list(AsyncDataSetIterator(
        ListDataSetIterator(_make(specs, DataSet)), fuse=4, stage=4,
        device="cpu"))
    assert any(isinstance(d, StackedDataSet) for d in out)
    threads = {t for _, t in seen}
    assert seen and threads == {threading.current_thread().name}, threads


def test_not_ported_options_raise_and_name_the_roadmap():
    """Every option is ported: ``sharding`` and ``fuse_sharding`` copy a
    rank's rows (of a batch, of a stacked group's batch axis),
    ``k_resolver`` sets each bucket's group size, and MultiDataSet batches
    stack into a ``StackedMultiDataSet``."""
    from deeplearning4j_tpu_torch.parallel.sharding_core import RowSharding
    batches = _make([(8, 4)] * 2, DataSet)
    (one, _) = list(AsyncDataSetIterator(
        ListDataSetIterator(batches), sharding=RowSharding(1, 2, 0),
        device="cpu"))
    np.testing.assert_array_equal(one.features.numpy(),
                                  batches[0].features[4:])
    (st,) = list(AsyncDataSetIterator(
        ListDataSetIterator(batches), fuse=2,
        fuse_sharding=RowSharding(1, 2, 1), device="cpu"))
    assert tuple(st.features.shape) == (2, 4, 4)
    np.testing.assert_array_equal(st.features[1].numpy(),
                                  batches[1].features[4:])
    seen = []

    def resolver(key):
        seen.append(key)
        return 3
    out = list(AsyncDataSetIterator(
        ListDataSetIterator(_make([(8, 4)] * 6, DataSet)), fuse=8,
        k_resolver=resolver, device="cpu"))
    assert [d.n_steps for d in out] == [3, 3]
    assert seen and all(k == ("ds", (8, 4), (8, 3)) for k in seen)

    class Multi:
        features, labels = [np.zeros((2, 3))], [np.zeros((2, 1))]
        features_masks = labels_masks = None
    (st,) = list(AsyncDataSetIterator([Multi()], fuse=2, device="cpu"))
    assert isinstance(st, StackedMultiDataSet) and st.n_steps == 1
    assert tuple(st.features[0].shape) == (2, 2, 3)


def test_defaults_read_the_knobs(monkeypatch):
    assert (default_fuse(), default_stage()) == (8, 8)
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "3")
    monkeypatch.setenv("DL4J_TORCH_TRANSFER_STAGE", "0")
    assert (default_fuse(), default_stage()) == (3, 1)


def test_multiple_epochs_iterator_repeats_the_base():
    base = ListDataSetIterator(_make([(8, 4)] * 2, DataSet))
    assert len(list(MultipleEpochsIterator(3, base))) == 6
