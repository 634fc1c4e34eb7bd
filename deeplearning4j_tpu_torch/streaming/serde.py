"""Array and DataSet wire serde: the port of
``deeplearning4j_tpu/streaming/serde.py`` (the ``streaming/serde/*`` role).

Format: magic ``DLSA`` (array) or ``DLSD`` (dataset) and an npz body:
dense, self-describing, dtype- and shape-preserving, standard library and
numpy only. The frames are the reference's, so each package decodes the
other's bytes. Arrays are host arrays: a model's output is host numpy.
"""

from __future__ import annotations

import io

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

_ARRAY_MAGIC = b"DLSA"
_DATASET_MAGIC = b"DLSD"


def serialize_array(arr) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, arr=np.asarray(arr))
    return _ARRAY_MAGIC + buf.getvalue()


def deserialize_array(data: bytes) -> np.ndarray:
    if data[:4] != _ARRAY_MAGIC:
        raise ValueError("not a serialized array (bad magic)")
    with np.load(io.BytesIO(data[4:])) as z:
        return z["arr"]


def serialize_dataset(ds: DataSet) -> bytes:
    arrays = {"features": ds.features}
    if ds.labels is not None:
        arrays["labels"] = ds.labels
    if ds.features_mask is not None:
        arrays["features_mask"] = ds.features_mask
    if ds.labels_mask is not None:
        arrays["labels_mask"] = ds.labels_mask
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return _DATASET_MAGIC + buf.getvalue()


def deserialize_dataset(data: bytes) -> DataSet:
    if data[:4] != _DATASET_MAGIC:
        raise ValueError("not a serialized DataSet (bad magic)")
    with np.load(io.BytesIO(data[4:])) as z:
        return DataSet(
            z["features"],
            z["labels"] if "labels" in z.files else None,
            z["features_mask"] if "features_mask" in z.files else None,
            z["labels_mask"] if "labels_mask" in z.files else None)
