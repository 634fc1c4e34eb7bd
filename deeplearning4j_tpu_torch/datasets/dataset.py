"""DataSet + iterator contracts: the port of
``deeplearning4j_tpu/datasets/dataset.py`` (ND4J ``DataSet``,
``MultiDataSet`` and their iterators), numpy only.

Layouts: FF [batch, size]; RNN [batch, time, size] with masks
[batch, time]. A batch already on a device (a ``torch.Tensor``) is kept as
it is; everything else becomes a numpy array. A ``MultiDataSet`` holds
lists of these, one per network input and output (ComputationGraph's
data contract).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ArrayDataSetIterator", "ArrayMultiDataSetIterator", "DataSet",
           "DataSetIterator", "ListDataSetIterator", "MultiDataSet",
           "MultiDataSetIterator", "StackedDataSet", "StackedMultiDataSet"]


def _as_batch_array(a):
    """numpy-ify host inputs (lists, scalars) but keep tensors as they
    are: ``np.asarray`` on a card tensor would copy it to the host."""
    if a is None or isinstance(a, np.ndarray):
        return a
    if hasattr(a, "device") and hasattr(a, "data_ptr"):   # torch.Tensor
        return a
    return np.asarray(a)


class DataSet:
    """One minibatch: features, labels, optional masks.

    """

    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = _as_batch_array(features)
        self.labels = _as_batch_array(labels)
        self.features_mask = _as_batch_array(features_mask)
        self.labels_mask = _as_batch_array(labels_mask)

    def num_examples(self):
        return self.features.shape[0]

    def split_test_and_train(self, n_train):
        tr = DataSet(self.features[:n_train],
                     None if self.labels is None else self.labels[:n_train],
                     None if self.features_mask is None else self.features_mask[:n_train],
                     None if self.labels_mask is None else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:],
                     None if self.labels is None else self.labels[n_train:],
                     None if self.features_mask is None else self.features_mask[n_train:],
                     None if self.labels_mask is None else self.labels_mask[n_train:])
        return tr, te

    def shuffle(self, seed=None):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    @staticmethod
    def merge(datasets):
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            None if datasets[0].labels is None else np.concatenate([d.labels for d in datasets]),
            None if datasets[0].features_mask is None else np.concatenate([d.features_mask for d in datasets]),
            None if datasets[0].labels_mask is None else np.concatenate([d.labels_mask for d in datasets]),
        )


class StackedDataSet:
    """K same-shape minibatches stacked on a leading step axis [K, B, ...]:
    the unit of the fused training loop (``MultiLayerNetwork.fit_fused``).

    ``weights`` is a [K, B] per-example weight array: shape-bucket padding
    (a ragged batch padded up to B rows, a short trailing group padded up
    to K steps) carries zero weight, so padded rows and steps contribute
    no loss, no gradient and no update. ``n_steps`` is the number of REAL
    steps, which lead the stack; listeners are replayed for exactly
    those."""

    def __init__(self, features, labels, weights, n_steps):
        self.features = features
        self.labels = labels
        self.weights = weights
        self.n_steps = int(n_steps)

    def num_steps(self):
        return self.n_steps

    def num_examples(self):
        """Real examples across the whole stack (the weights' sum)."""
        return int(float(self.weights[:self.n_steps].sum()))


class StackedMultiDataSet:
    """K same-shape multi-minibatches stacked on a leading step axis: the
    unit of ComputationGraph's fused loop. Every feature and label stream
    is [K, B, ...]; ``weights`` and ``n_steps`` keep the contract of
    :class:`StackedDataSet`. Masks do not stack: a masked MultiDataSet
    keeps the per-batch path."""

    def __init__(self, features, labels, weights, n_steps):
        self.features = list(features)
        self.labels = list(labels)
        self.weights = weights
        self.n_steps = int(n_steps)

    def num_steps(self):
        return self.n_steps

    def num_examples(self):
        """Real examples across the whole stack (the weights' sum)."""
        return int(float(self.weights[:self.n_steps].sum()))


class MultiDataSet:
    """Multi-input/multi-output minibatch (ComputationGraph's data
    contract): lists of features and labels, and optional lists of masks
    (an entry may be None)."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        self.features = [_as_batch_array(f) for f in features]
        self.labels = [_as_batch_array(l) for l in labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self):
        return self.features[0].shape[0]


class _PreProcessorMixin:
    """setPreProcessor plumbing shared by both iterator bases.

    Subclass ``__next__`` implementations are wrapped automatically so the
    pre-processor applies to every emitted batch — concrete iterators never
    call it themselves. Before applying, the batch is re-wrapped in a fresh
    container object (``_pp_copy``): normalizers reassign attributes rather
    than mutating arrays in place, so this keeps iterators that hand out
    *stored* DataSets (ListDataSetIterator and wrappers over it) safe from
    being re-normalized every epoch.
    """

    pre_processor = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        nxt = cls.__dict__.get("__next__")
        if nxt is not None and not getattr(nxt, "_pp_wrapped", False):
            def wrapped(self, _inner=nxt):
                return self._apply_pp(_inner(self))
            wrapped._pp_wrapped = True
            cls.__next__ = wrapped

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        pass

    def set_pre_processor(self, pp):
        self.pre_processor = pp
        return self

    @staticmethod
    def _pp_copy(item):
        raise NotImplementedError

    def _run_pp(self, item):
        if self.pre_processor is not None:
            item = self._pp_copy(item)
            self.pre_processor.pre_process(item)
        return item

    def _apply_pp(self, item):
        return self._run_pp(item)


class DataSetIterator(_PreProcessorMixin):
    """Iterator base mirroring ND4J DataSetIterator (hasNext/next/reset,
    setPreProcessor — normalizers attach here and run on every minibatch)."""

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def batch_size(self):
        raise NotImplementedError

    @staticmethod
    def _pp_copy(item):
        return DataSet(item.features, item.labels,
                       item.features_mask, item.labels_mask)


class ArrayDataSetIterator(DataSetIterator):
    """Iterate minibatches from in-memory arrays (ND4J's INDArrayDataSetIterator)."""

    def __init__(self, features, labels, batch_size=32, features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self._batch = batch_size
        self._pos = 0

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch

    def __next__(self):
        if self._pos >= self.features.shape[0]:
            raise StopIteration
        sl = slice(self._pos, self._pos + self._batch)
        self._pos += self._batch
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])


class ListDataSetIterator(DataSetIterator):
    """Iterate over a list of pre-built DataSets (reference ListDataSetIterator)."""

    def __init__(self, datasets, batch_size=None):
        self.datasets = list(datasets)
        self._pos = 0
        self._batch = batch_size

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch or (self.datasets[0].num_examples() if self.datasets else 0)

    def __next__(self):
        if self._pos >= len(self.datasets):
            raise StopIteration
        d = self.datasets[self._pos]
        self._pos += 1
        return d


class MultiDataSetIterator(_PreProcessorMixin):
    """Iterator base for MultiDataSet streams (ND4J MultiDataSetIterator);
    the same automatic pre-processor wrapping as DataSetIterator
    (MultiDataSetPreProcessor's role)."""

    def __next__(self) -> MultiDataSet:
        raise NotImplementedError

    @staticmethod
    def _pp_copy(item):
        mds = MultiDataSet.__new__(MultiDataSet)
        mds.features = list(item.features)
        mds.labels = list(item.labels)
        mds.features_masks = item.features_masks
        mds.labels_masks = item.labels_masks
        return mds


class ArrayMultiDataSetIterator(MultiDataSetIterator):
    """Minibatches of in-memory multi-input/multi-output arrays."""

    def __init__(self, features, labels, batch_size=32, features_masks=None,
                 labels_masks=None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks
        self._batch = batch_size
        self._pos = 0

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch

    def __next__(self):
        if self._pos >= self.features[0].shape[0]:
            raise StopIteration
        sl = slice(self._pos, self._pos + self._batch)
        self._pos += self._batch

        def cut(arrs):
            if arrs is None:
                return None
            return [None if a is None else np.asarray(a)[sl] for a in arrs]

        return MultiDataSet(cut(self.features), cut(self.labels),
                            cut(self.features_masks), cut(self.labels_masks))
