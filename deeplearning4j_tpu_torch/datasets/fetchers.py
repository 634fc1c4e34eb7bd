"""MNIST from local files: the port of the offline path of
``deeplearning4j_tpu/datasets/fetchers.py`` (MnistDataFetcher.java,
MnistManager.java, MnistDataSetIterator.java), numpy only.

The idx files are looked for under ``$DL4J_TORCH_DATA_DIR/mnist/`` and
``~/.deeplearning4j_tpu/mnist/``, or in the ``data_dir`` a caller names
(the committed ``tests/fixtures/real_mnist`` subset loads that way).
Nothing is downloaded. Without the files, the iterator falls back, with
a loud warning, to the reference's seeded synthetic stand-in (per-class
prototypes plus noise), whose arrays are the reference's to the bit;
``.synthetic`` says which one it holds.
"""

from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator

__all__ = ["MnistDataSetIterator", "read_idx"]


def _search_dirs():
    # read at call time: tests may set the knob after import
    return [env_str("DL4J_TORCH_DATA_DIR"),
            os.path.expanduser("~/.deeplearning4j_tpu")]


def _has_files(d, filenames):
    return all(os.path.exists(os.path.join(d, f))
               or os.path.exists(os.path.join(d, f + ".gz"))
               for f in filenames)


def _find(name, filenames):
    for base in _search_dirs():
        if base and _has_files(os.path.join(base, name), filenames):
            return os.path.join(base, name)
    return None


def read_idx(path):
    """Parse an idx file (magic, dims, big-endian payload), plain or
    ``.gz``."""
    real = path if os.path.exists(path) else path + ".gz"
    opener = gzip.open if real.endswith(".gz") else open
    with opener(real, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"Bad idx magic in {path}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32,
                 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(),
                             dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def _synthetic_images(n, h, w, c, n_classes, seed, proto_seed=1234):
    """Seeded per-class prototypes plus noise: learnable, fixed shapes.
    The prototypes come from ``proto_seed``, so the train and test splits
    (different ``seed``) share their class structure."""
    rng = np.random.RandomState(seed)
    protos = np.random.RandomState(proto_seed).rand(
        n_classes, h, w, c).astype(np.float32)
    labels = rng.randint(0, n_classes, n)
    noise = rng.rand(n, h, w, c).astype(np.float32)
    imgs = 0.7 * protos[labels] + 0.3 * noise
    return imgs, labels


class _InMemoryIterator(DataSetIterator):
    """Minibatches walked over in-memory ``features``/``labels``."""

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return len(self.features)

    def __next__(self):
        if self._pos >= len(self.features):
            raise StopIteration
        sl = slice(self._pos, self._pos + self._batch)
        self._pos += self._batch
        return DataSet(self.features[sl], self.labels[sl])


class MnistDataSetIterator(_InMemoryIterator):
    """MNIST 28x28x1, 10 classes: features in [0, 1], NHWC (or flat
    [N, 784] with ``flatten``), labels one-hot; ``binarize``, ``shuffle``
    and ``seed`` as MnistDataSetIterator's; ``num_examples`` keeps the
    first N."""

    H = W = 28
    N_CLASSES = 10

    def __init__(self, batch_size, train=True, *, binarize=False,
                 shuffle=False, seed=123, num_examples=None, flatten=False,
                 data_dir=None):
        self._batch = batch_size
        self.flatten = flatten
        prefix = "train" if train else "t10k"
        names = [f"{prefix}-images-idx3-ubyte", f"{prefix}-labels-idx1-ubyte"]
        if data_dir is not None:
            if not _has_files(data_dir, names):
                raise FileNotFoundError(
                    f"{data_dir} is missing {names} (idx files, optionally "
                    ".gz)")
            d = data_dir
        else:
            d = _find("mnist", names)
        if d is not None:
            imgs = read_idx(os.path.join(d, names[0])).astype(
                np.float32) / 255.0
            labels = read_idx(os.path.join(d, names[1])).astype(np.int64)
            imgs = imgs[..., None]   # NHWC
            self.synthetic = False
        else:
            warnings.warn(
                "MNIST: no local dataset found; substituting the seeded "
                "SYNTHETIC stand-in (per-class prototype patterns plus "
                "noise, NOT real MNIST; .synthetic is True). To use real "
                "data, put the idx files under $DL4J_TORCH_DATA_DIR/mnist/",
                UserWarning, stacklevel=2)
            n = num_examples or (60000 if train else 10000)
            imgs, labels = _synthetic_images(n, self.H, self.W, 1,
                                             self.N_CLASSES,
                                             seed=42 if train else 43)
            self.synthetic = True
        if num_examples is not None:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        if binarize:
            imgs = (imgs > 0.5).astype(np.float32)
        if shuffle:
            idx = np.random.RandomState(seed).permutation(len(imgs))
            imgs, labels = imgs[idx], labels[idx]
        self.features = imgs.reshape(len(imgs), -1) if flatten else imgs
        self.labels = np.eye(self.N_CLASSES, dtype=np.float32)[labels]
        self.label_ids = labels
        self._pos = 0
