"""Data normalizers (ND4J's ``DataNormalization`` family): the port of
``deeplearning4j_tpu/datasets/normalizers.py``.

``NormalizerStandardize`` (per-feature mean and standard deviation),
``NormalizerMinMaxScaler`` (rescale to [lo, hi]) and
``ImagePreProcessingScaler`` (pixels in [0, max] to [a, b]): the
pre-processors a user attaches with ``iterator.set_pre_processor`` and
that a model archive keeps as ``preprocessor.bin``
(``ModelSerializer.java:94-99``). ``register_normalizer`` lets another
class round-trip through :meth:`DataNormalization.from_bytes`.

Statistics are gathered in one streaming pass in float64 (the Chan et
al. merge of per-batch moments), so ``fit(iterator)`` never holds the
dataset; masked RNN data ([batch, time, size] with a [batch, time] mask)
counts only the kept steps. A host batch (numpy) is normalised in numpy
in float64, as the reference does, so both packages give the same bits.
A batch already on a device (a ``torch.Tensor``, e.g. from a staging
iterator) is fitted and normalised there, in float64, and never copied to
the host: only the per-feature moments of a fitted batch come back.

``to_bytes`` writes the reference's JSON (``{"type": class name,
"state": the public attributes}``), so ``preprocessor.bin`` reads the
same in both packages.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["DataNormalization", "ImagePreProcessingScaler",
           "NormalizerMinMaxScaler", "NormalizerStandardize",
           "register_normalizer"]


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def _flat2d(x, mask=None):
    """[batch, ...feat] or [batch, time, size] (+ mask) as float64
    [rows, feat]: numpy for a host batch, a tensor on its device for a
    device batch."""
    if _is_tensor(x):
        x = x.to(torch.float64)
        if x.ndim == 3:
            rows = x.reshape(-1, x.shape[-1])
            if mask is not None:
                keep = torch.as_tensor(mask, device=x.device).reshape(-1) > 0
                rows = rows[keep]
            return rows
        return x.reshape(x.shape[0], -1)
    x = np.asarray(x, np.float64)
    if x.ndim == 3:
        rows = x.reshape(-1, x.shape[-1])
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            rows = rows[keep]
        return rows
    return x.reshape(x.shape[0], -1)


class _RunningMoments:
    """Streaming per-column mean and variance (Chan et al. merge), in
    float64 on the host; a device batch's moments are taken on its device
    and merged here."""

    def __init__(self):
        self.n, self.mean, self.m2 = 0, None, None

    def update(self, rows):
        if rows.shape[0] == 0:
            return
        bn = rows.shape[0]
        if _is_tensor(rows):
            bmean_t = rows.mean(dim=0)
            bm2_t = ((rows - bmean_t) ** 2).sum(dim=0)
            bmean, bm2 = bmean_t.cpu().numpy(), bm2_t.cpu().numpy()
        else:
            bmean = rows.mean(axis=0)
            bm2 = ((rows - bmean) ** 2).sum(axis=0)
        if self.mean is None:
            self.n, self.mean, self.m2 = bn, bmean, bm2
        else:
            delta = bmean - self.mean
            tot = self.n + bn
            self.mean = self.mean + delta * (bn / tot)
            self.m2 = self.m2 + bm2 + delta ** 2 * (self.n * bn / tot)
            self.n = tot

    def finalize(self):
        if self.mean is None:
            raise ValueError("fit() saw no data")
        std = np.sqrt(self.m2 / max(self.n, 1))
        std[std < 1e-12] = 1.0
        return self.mean, std


def _col_extremes(rows):
    """(min, max) per column, numpy on the host."""
    if _is_tensor(rows):
        return (rows.amin(dim=0).cpu().numpy(),
                rows.amax(dim=0).cpu().numpy())
    return rows.min(axis=0), rows.max(axis=0)


def _on(x, stat):
    """A float64 statistic vector beside ``x``: numpy for a host batch, a
    tensor on the batch's device (one small copy a call) for a device
    batch."""
    if _is_tensor(x):
        return torch.as_tensor(np.asarray(stat, np.float64), device=x.device)
    return stat


def _rows_view(x):
    """[rows, feat] of a batch, as the reference reshapes it."""
    shape = x.shape
    return (x.reshape(-1, shape[-1]) if x.ndim == 3
            else x.reshape(shape[0], -1))


def _f64(x):
    return x.to(torch.float64) if _is_tensor(x) else np.asarray(x, np.float64)


def _f32(x, shape):
    if _is_tensor(x):
        return x.reshape(shape).to(torch.float32)
    return x.reshape(shape).astype(np.float32)


class DataNormalization:
    """``fit(iterator | DataSet)`` gathers statistics; ``pre_process(ds)``
    normalises a batch (reassigning its arrays); ``revert`` undoes it."""

    fit_labels = False

    def fit_label(self, fit_labels=True):
        self.fit_labels = fit_labels
        return self

    def fit(self, data):
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet, DataSetIterator)
        if isinstance(data, DataSet):
            self._fit_batches([data])
        elif isinstance(data, DataSetIterator):
            data.reset()
            self._fit_batches(iter(data))
            data.reset()
        else:
            self._fit_batches(iter(data))
        return self

    def _fit_batches(self, batches):
        raise NotImplementedError

    def pre_process(self, ds):
        raise NotImplementedError

    def transform(self, ds):
        self.pre_process(ds)
        return ds

    def revert(self, ds):
        raise NotImplementedError

    # --- persistence (preprocessor.bin) ---
    def to_bytes(self) -> bytes:
        state = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in self._state().items()}
        return json.dumps({"type": type(self).__name__,
                           "state": state}).encode()

    @staticmethod
    def from_bytes(data: bytes) -> "DataNormalization":
        obj = json.loads(data.decode())
        cls = _REGISTRY[obj["type"]]
        inst = cls.__new__(cls)
        inst.__dict__.update({k: (np.asarray(v) if isinstance(v, list) else v)
                              for k, v in obj["state"].items()})
        return inst

    def _state(self):
        return dict(self.__dict__)


class NormalizerStandardize(DataNormalization):
    """(x - mean) / std per feature column (ND4J NormalizerStandardize)."""

    def __init__(self):
        self.mean = None
        self.std = None
        self.label_mean = None
        self.label_std = None
        self.fit_labels = False

    def _fit_batches(self, batches):
        facc, lacc = _RunningMoments(), _RunningMoments()
        for ds in batches:
            facc.update(_flat2d(ds.features, ds.features_mask))
            if self.fit_labels and ds.labels is not None:
                lacc.update(_flat2d(ds.labels, ds.labels_mask))
        self.mean, self.std = facc.finalize()
        if lacc.n > 0:
            self.label_mean, self.label_std = lacc.finalize()

    def _apply(self, x, mean, std, invert=False):
        shape = x.shape
        flat = _rows_view(x)
        mean, std = _on(x, mean), _on(x, std)
        flat = flat * std + mean if invert else (flat - mean) / std
        return _f32(flat, shape)

    def _labels_too(self, ds):
        return (self.fit_labels and ds.labels is not None
                and self.label_mean is not None)

    def pre_process(self, ds):
        ds.features = self._apply(_f64(ds.features), self.mean, self.std)
        if self._labels_too(ds):
            ds.labels = self._apply(_f64(ds.labels), self.label_mean,
                                    self.label_std)
        return ds

    def revert(self, ds):
        ds.features = self._apply(_f64(ds.features), self.mean, self.std,
                                  invert=True)
        if self._labels_too(ds):
            ds.labels = self._apply(_f64(ds.labels), self.label_mean,
                                    self.label_std, invert=True)
        return ds

    def revert_labels(self, labels):
        if self.label_mean is None:
            return labels
        shape = labels.shape
        flat = _f64(labels).reshape(-1, shape[-1])
        return _f32(flat * _on(flat, self.label_std)
                    + _on(flat, self.label_mean), shape)


class NormalizerMinMaxScaler(DataNormalization):
    """Rescale features to [lo, hi] per column (ND4J
    NormalizerMinMaxScaler)."""

    def __init__(self, lo=0.0, hi=1.0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.col_min = None
        self.col_max = None
        self.label_min = None
        self.label_max = None
        self.fit_labels = False

    def _fit_batches(self, batches):
        cmin = cmax = lmin = lmax = None
        for ds in batches:
            rows = _flat2d(ds.features, ds.features_mask)
            if rows.shape[0]:
                bmin, bmax = _col_extremes(rows)
                cmin = bmin if cmin is None else np.minimum(cmin, bmin)
                cmax = bmax if cmax is None else np.maximum(cmax, bmax)
            if self.fit_labels and ds.labels is not None:
                lrows = _flat2d(ds.labels, ds.labels_mask)
                if lrows.shape[0]:
                    bmin, bmax = _col_extremes(lrows)
                    lmin = bmin if lmin is None else np.minimum(lmin, bmin)
                    lmax = bmax if lmax is None else np.maximum(lmax, bmax)
        if cmin is None:
            raise ValueError("fit() saw no data")
        self.col_min, self.col_max = cmin, cmax
        self.label_min, self.label_max = lmin, lmax

    def _scale(self, x, lo_v, hi_v, invert=False):
        shape = x.shape
        flat = _rows_view(x)
        span = hi_v - lo_v
        span = np.where(span < 1e-12, 1.0, span)
        lo_v, span = _on(x, lo_v), _on(x, span)
        if invert:
            flat = (flat - self.lo) / (self.hi - self.lo) * span + lo_v
        else:
            flat = (flat - lo_v) / span * (self.hi - self.lo) + self.lo
        return _f32(flat, shape)

    def _labels_too(self, ds):
        return (self.fit_labels and ds.labels is not None
                and self.label_min is not None)

    def pre_process(self, ds):
        ds.features = self._scale(_f64(ds.features), self.col_min,
                                  self.col_max)
        if self._labels_too(ds):
            ds.labels = self._scale(_f64(ds.labels), self.label_min,
                                    self.label_max)
        return ds

    def revert(self, ds):
        ds.features = self._scale(_f64(ds.features), self.col_min,
                                  self.col_max, invert=True)
        if self._labels_too(ds):
            ds.labels = self._scale(_f64(ds.labels), self.label_min,
                                    self.label_max, invert=True)
        return ds


class ImagePreProcessingScaler(DataNormalization):
    """Pixels in [0, max_pixel] to [a, b] (ND4J ImagePreProcessingScaler;
    by default 0-255 to [0, 1]). It needs no statistics."""

    def __init__(self, a=0.0, b=1.0, max_pixel=255.0):
        self.a = float(a)
        self.b = float(b)
        self.max_pixel = float(max_pixel)

    def _fit_batches(self, batches):
        pass

    def pre_process(self, ds):
        x = _f64(ds.features)
        ds.features = _f32(x / self.max_pixel * (self.b - self.a) + self.a,
                           x.shape)
        return ds

    def revert(self, ds):
        x = _f64(ds.features)
        ds.features = _f32((x - self.a) / (self.b - self.a) * self.max_pixel,
                           x.shape)
        return ds


_REGISTRY = {c.__name__: c for c in
             (NormalizerStandardize, NormalizerMinMaxScaler,
              ImagePreProcessingScaler)}


def register_normalizer(cls):
    """Let another ``DataNormalization`` class round-trip through
    :meth:`DataNormalization.from_bytes` (the ``preprocessor.bin``
    seam)."""
    _REGISTRY[cls.__name__] = cls
    return cls
