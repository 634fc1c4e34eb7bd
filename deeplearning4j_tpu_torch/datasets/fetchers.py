"""The canned datasets from local files: the port of the offline path of
``deeplearning4j_tpu/datasets/fetchers.py`` (MnistDataFetcher.java,
MnistManager.java and the MNIST, Iris, CIFAR-10, LFW and Curves
DataSetIterators): numpy, and the native idx decoder
(``nativelib.idx_load``) for MNIST's files where the reference decodes
natively. The reference's ``nativelib.mnist_assemble`` also scales the
pixels in C, by a product that differs from ``u8 / 255`` in the last bit
of some pixels; the port keeps ``u8 / 255`` in numpy, the arithmetic its
MNIST test holds bit for bit.

Files are looked for under ``$DL4J_TORCH_DATA_DIR/<name>/`` and
``~/.deeplearning4j_tpu/<name>/`` (``mnist``, ``iris``,
``cifar-10-batches-py``, ``lfw``), or where a caller names them (the
committed ``tests/fixtures/real_mnist`` subset loads through
``data_dir``, an LFW tree through ``images_dir``). Nothing is
downloaded: the reference's gated ``ingest_*`` functions have no
counterpart here. Without the files, an iterator falls back, with a loud
warning, to the reference's seeded synthetic stand-in (per-class
prototypes plus noise, or Iris's three clusters), whose arrays are the
reference's to the bit; ``.synthetic`` says which one it holds.

:class:`DigitsDataSetIterator` reads the committed
``tests/fixtures/real_digits`` (real UCI handwritten digits, 8x8) and has
no stand-in; :class:`CurvesDataSetIterator` regenerates its curves from
a seed, as the reference does.
"""

from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator

__all__ = ["CifarDataSetIterator", "CurvesDataSetIterator",
           "DigitsDataSetIterator", "IrisDataSetIterator",
           "LFWDataSetIterator", "MnistDataSetIterator", "read_idx"]


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


def _find_dir(name):
    for base in _search_dirs():
        if base and os.path.isdir(os.path.join(base, name)):
            return os.path.join(base, name)
    return None


def _warn_synthetic(name, how_to_fix):
    """The loud warning of a synthetic substitution: nobody should train
    on the stand-in believing it is the real dataset."""
    warnings.warn(
        f"{name}: no local dataset found; substituting the seeded "
        f"SYNTHETIC stand-in (per-class prototype patterns plus noise, NOT "
        f"real {name} data; .synthetic is True). To use real data, "
        f"{how_to_fix}", UserWarning, stacklevel=3)


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


def _read_u8(path):
    """A u8 idx file (plain or ``.gz``) through the native decoder
    (``nativelib.idx_load``, ``native/src/idx.cpp``: MnistManager.java's
    part), or :func:`read_idx` where the library is unavailable or
    declines the file; the same array either way."""
    from deeplearning4j_tpu_torch import nativelib
    arr = nativelib.idx_load(path if os.path.exists(path) else path + ".gz")
    return read_idx(path) if arr is None else arr


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
            imgs = _read_u8(os.path.join(d, names[0])).astype(
                np.float32) / 255.0
            labels = _read_u8(os.path.join(d, names[1])).astype(np.int64)
            imgs = imgs[..., None]   # NHWC
            self.synthetic = False
        else:
            _warn_synthetic("MNIST", "put the idx files under "
                            "$DL4J_TORCH_DATA_DIR/mnist/")
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


def _repo_fixture(*parts):
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "fixtures", *parts)


class DigitsDataSetIterator(_InMemoryIterator):
    """Real handwritten digits from the committed fixture
    ``tests/fixtures/real_digits`` (UCI optical digits, 8x8x1, 10 classes,
    idx-encoded): features in [0, 1], NHWC (or flat with ``flatten``),
    labels one-hot. No synthetic fallback: accuracy checks on it always
    run on real pixels. ``shuffle`` permutes before ``num_examples``
    keeps the first N."""

    H = W = 8
    N_CLASSES = 10

    def __init__(self, batch_size, train=True, *, shuffle=False, seed=123,
                 num_examples=None, flatten=False):
        self._batch = batch_size
        d = _repo_fixture("real_digits")
        prefix = "train" if train else "t10k"
        imgs = read_idx(os.path.join(d, f"{prefix}-images-idx3-ubyte")
                        ).astype(np.float32) / 255.0
        labels = read_idx(os.path.join(d, f"{prefix}-labels-idx1-ubyte")
                          ).astype(np.int64)
        imgs = imgs[..., None]   # NHWC
        if shuffle:
            order = np.random.RandomState(seed).permutation(len(imgs))
            imgs, labels = imgs[order], labels[order]
        if num_examples is not None:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        self.features = imgs.reshape(len(imgs), -1) if flatten else imgs
        self.labels = np.eye(self.N_CLASSES, dtype=np.float32)[labels]
        self.label_ids = labels
        self.synthetic = False
        self._pos = 0


def _read_image(path):
    """An image file as a float array in [0, 1], (H, W, k), or None for a
    file of another kind (or a JPEG without PIL)."""
    low = path.lower()
    if low.endswith(".npy"):
        img = np.load(path)
    elif low.endswith(".png"):
        from deeplearning4j_tpu_torch.utils.pngio import decode_png
        with open(path, "rb") as f:
            img = decode_png(f.read())
    elif low.endswith((".jpg", ".jpeg")):
        # the real LFW tarball is .jpg
        try:
            from PIL import Image
        except ImportError:
            return None
        img = np.asarray(Image.open(path))
    else:
        return None
    img = np.asarray(img, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    return img[..., None] if img.ndim == 2 else img


class LFWDataSetIterator(_InMemoryIterator):
    """Labeled-faces image directories (LFWDataSetIterator.java): a tree
    ``<root>/<person>/<image>`` of ``.png`` (``utils/pngio``, 8-bit gray
    or RGB), ``.jpg`` (PIL, if installed) or ``.npy`` images, each
    brought to ``image_shape`` (channels converted, a centred square crop
    resized by nearest neighbour); labels one-hot over the sorted person
    names. ``images_dir`` names the root, else ``lfw`` is looked for under
    the data directories; without one, the seeded synthetic stand-in of
    ``n_people`` classes (64 images unless ``num_examples``)."""

    def __init__(self, batch_size, images_dir=None, *, num_examples=None,
                 image_shape=(32, 32, 1), n_people=8, seed=11):
        self._batch = batch_size
        h, w, c = image_shape
        d = images_dir or _find_dir("lfw")
        if d is not None:
            xs, names = [], []
            for person in sorted(os.listdir(d)):
                pdir = os.path.join(d, person)
                if not os.path.isdir(pdir):
                    continue
                for fn in sorted(os.listdir(pdir)):
                    img = _read_image(os.path.join(pdir, fn))
                    if img is None:
                        continue
                    xs.append(_center_crop_resize(_to_channels(img, c), h, w))
                    names.append(person)
            if not xs:
                raise ValueError(f"no .png/.npy images under {d}")
            people = sorted(set(names))
            y = np.array([people.index(n) for n in names])
            X = np.stack(xs)
            self.people = people
            self.synthetic = False
        else:
            _warn_synthetic("LFW", "put the person-per-directory tree under "
                            "$DL4J_TORCH_DATA_DIR/lfw/ or pass images_dir")
            X, y = _synthetic_images(num_examples or 64, h, w, c, n_people,
                                     seed)
            self.people = [f"person_{i}" for i in range(n_people)]
            self.synthetic = True
        if num_examples is not None:
            X, y = X[:num_examples], y[:num_examples]
        self.features = X
        self.labels = np.eye(len(self.people), dtype=np.float32)[y]
        self.label_ids = y
        self._pos = 0


def _to_channels(img, c):
    """An (H, W, k) image with ``c`` channels: alpha dropped, gray repeated
    to RGB, RGB reduced to luma, so a mixed directory stacks to one
    shape."""
    k = img.shape[-1]
    if k == c:      # an exact match (RGBA to RGBA too) passes as it is
        return img
    if k == 2:      # gray + alpha
        img, k = img[..., :1], 1
    elif k == 4:    # RGBA
        img, k = img[..., :3], 3
    if k == c:
        return img
    if c == 1:      # RGB → luma
        weights = np.array([0.299, 0.587, 0.114], np.float32)
        return (img @ weights)[..., None]
    if k == 1:      # gray → repeated channels
        return np.repeat(img, c, axis=-1)
    if k > c:
        return img[..., :c]
    raise ValueError(f"cannot convert {k}-channel image to {c} channels")


def _center_crop_resize(img, h, w):
    """A centred square crop resized to (h, w) by nearest neighbour."""
    ih, iw = img.shape[:2]
    side = min(ih, iw)
    top, left = (ih - side) // 2, (iw - side) // 2
    sq = img[top:top + side, left:left + side]
    ri = (np.arange(h) * side // h).astype(int)
    ci = (np.arange(w) * side // w).astype(int)
    return sq[ri][:, ci]


class CurvesDataSetIterator(_InMemoryIterator):
    """Curves (CurvesDataFetcher.java): 28x28 images of smooth random
    curves, the deep-autoencoder pretraining set, flat [N, 784] with the
    features as their own labels. The original set is itself generated;
    this regenerates it from ``seed`` as the reference does (a quadratic
    Bezier curve through three random control points an image, sampled
    at 256 points so strokes have no gaps)."""

    H = W = 28

    def __init__(self, batch_size, num_examples=1000, seed=3):
        self._batch = batch_size
        rng = np.random.RandomState(seed)
        n = num_examples
        t = np.linspace(0.0, 1.0, 256)
        p = rng.rand(n, 3, 2) * 0.8 + 0.1
        b = ((1 - t)[None, :, None] ** 2 * p[:, None, 0]
             + 2 * (1 - t)[None, :, None] * t[:, None] * p[:, None, 1]
             + t[None, :, None] ** 2 * p[:, None, 2])       # (n, T, 2)
        imgs = np.zeros((n, self.H, self.W), np.float32)
        xi = np.clip((b[..., 0] * self.W).astype(int), 0, self.W - 1)
        yi = np.clip((b[..., 1] * self.H).astype(int), 0, self.H - 1)
        for i in range(n):
            imgs[i, yi[i], xi[i]] = 1.0
        self.features = imgs.reshape(n, -1)
        self.labels = self.features           # the reconstruction target
        self.synthetic = True
        self._pos = 0


class IrisDataSetIterator(_InMemoryIterator):
    """Iris (IrisDataSetIterator.java): 150 x 4 features, 3 classes, from
    ``iris/iris.data`` (the UCI CSV) under the data directories, else a
    seeded stand-in of three Gaussian clusters."""

    def __init__(self, batch_size=150, num_examples=150, seed=6):
        d = _find("iris", ["iris.data"])
        if d is not None:
            rows = []
            names = {"Iris-setosa": 0, "Iris-versicolor": 1,
                     "Iris-virginica": 2}
            with open(os.path.join(d, "iris.data")) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) == 5:
                        rows.append([float(v) for v in parts[:4]]
                                    + [names[parts[4]]])
            arr = np.array(rows, dtype=np.float32)
            X, y = arr[:, :4], arr[:, 4].astype(int)
            self.synthetic = False
        else:
            _warn_synthetic("Iris", "put iris.data (the UCI CSV) under "
                            "$DL4J_TORCH_DATA_DIR/iris/")
            rng = np.random.RandomState(seed)
            centers = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3],
                                [6.6, 3.0, 5.6, 2.0]], dtype=np.float32)
            X = np.vstack([c + 0.35 * rng.randn(50, 4).astype(np.float32)
                           for c in centers])
            y = np.repeat(np.arange(3), 50)
            self.synthetic = True
        self.features = X[:num_examples]
        self.labels = np.eye(3, dtype=np.float32)[y[:num_examples]]
        self._batch = batch_size
        self._pos = 0


class CifarDataSetIterator(_InMemoryIterator):
    """CIFAR-10 32x32x3 NHWC in [0, 1], 10 classes
    (CifarDataSetIterator.java), from the python-pickle batches under
    ``cifar-10-batches-py`` in the data directories, else the seeded
    synthetic stand-in. The batches are pickles: point the data
    directory only at files this machine's owner put there."""

    H = W = 32
    N_CLASSES = 10

    def __init__(self, batch_size, num_examples=10000, train=True, seed=7):
        names = ["data_batch_1"] if train else ["test_batch"]
        d = _find("cifar-10-batches-py", names)
        if d is not None:
            import pickle
            files = [f"data_batch_{i}" for i in range(1, 6)] if train \
                else ["test_batch"]
            xs, ys = [], []
            for fn in files:
                p = os.path.join(d, fn)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        batch = pickle.load(f, encoding="bytes")
                    xs.append(batch[b"data"])
                    ys.extend(batch[b"labels"])
            X = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                 .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
            y = np.asarray(ys)
            self.synthetic = False
        else:
            _warn_synthetic("CIFAR-10", "untar cifar-10-python.tar.gz under "
                            "$DL4J_TORCH_DATA_DIR/")
            X, y = _synthetic_images(num_examples, self.H, self.W, 3,
                                     self.N_CLASSES, seed)
            self.synthetic = True
        self.features = X[:num_examples]
        self.labels = np.eye(self.N_CLASSES,
                             dtype=np.float32)[y[:num_examples]]
        self._batch = batch_size
        self._pos = 0
