"""The port's dataset iterators and PNG codec against the JAX package's,
on the CPU.

Every iterator is built by both packages from the same local files (or,
where none are found, as the same seeded synthetic stand-in), and its
arrays must be equal bitwise: both read the files with numpy and draw the
stand-ins from the same ``RandomState`` seeds. Files are written by the
tests into a temporary data directory; the reference is pointed at it
through its ``_search_dirs`` and the port through ``DL4J_TORCH_DATA_DIR``
(with ``HOME`` moved there too, so no file of the machine's is read).
The PNG decoder is held against the reference's on every scanline filter
(none, sub, up, average, Paeth) in gray, gray+alpha, RGB and RGBA, and
the encoder's files decode to the array they were written from.
"""

import pickle
import struct
import zlib

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.utils import pngio as jpng
from deeplearning4j_tpu_torch.datasets import fetchers as pf
from deeplearning4j_tpu_torch.utils import pngio as ppng


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("DL4J_TPU_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setattr(jf, "_search_dirs", lambda: [str(tmp_path)])
    return tmp_path


def _equal(got, want, fields=("features", "labels")):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.synthetic == want.synthetic
    assert got.total_examples() == want.total_examples()
    got.reset()
    want.reset()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("kw", [
    dict(batch_size=64), dict(batch_size=50, train=False),
    dict(batch_size=32, shuffle=True, seed=7, num_examples=100),
    dict(batch_size=16, flatten=True, num_examples=40)],
    ids=["train", "test", "shuffled", "flat"])
def test_digits_are_the_reference_s(kw):
    got, want = pf.DigitsDataSetIterator(**kw), jf.DigitsDataSetIterator(**kw)
    _equal(got, want, ("features", "labels", "label_ids"))
    assert not got.synthetic and got.features.max() <= 1.0


@pytest.mark.parametrize("name,make", [
    ("Iris", lambda m: m.IrisDataSetIterator(batch_size=32)),
    ("CIFAR-10", lambda m: m.CifarDataSetIterator(64, num_examples=100)),
    ("CIFAR-10", lambda m: m.CifarDataSetIterator(8, num_examples=20,
                                                  train=False, seed=9)),
    ("LFW", lambda m: m.LFWDataSetIterator(16, num_examples=40,
                                           image_shape=(12, 12, 3),
                                           n_people=5, seed=3)),
], ids=["iris", "cifar_train", "cifar_test", "lfw"])
def test_synthetic_stand_ins_are_the_reference_s(data_dir, name, make):
    with pytest.warns(UserWarning, match=f"{name}: .*SYNTHETIC"):
        got = make(pf)
    with pytest.warns(UserWarning):
        want = make(jf)
    assert got.synthetic
    _equal(got, want)


@pytest.mark.parametrize("n", [20, 3])
def test_curves_are_the_reference_s(n):
    got = pf.CurvesDataSetIterator(8, num_examples=n, seed=4)
    want = jf.CurvesDataSetIterator(8, num_examples=n, seed=4)
    _equal(got, want)
    assert got.features.shape == (n, 784) and got.features.max() == 1.0


def test_iris_reads_the_uci_file(data_dir):
    r = np.random.RandomState(0)
    names = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
    rows = [",".join(f"{v:.1f}" for v in 4 + 3 * r.rand(4))
            + f",{names[i % 3]}" for i in range(30)]
    (data_dir / "iris").mkdir()
    (data_dir / "iris" / "iris.data").write_text("\n".join(rows) + "\n\n")
    got = pf.IrisDataSetIterator(batch_size=8, num_examples=25)
    want = jf.IrisDataSetIterator(batch_size=8, num_examples=25)
    assert not got.synthetic and got.features.shape == (25, 4)
    _equal(got, want)


def test_cifar_reads_the_pickle_batches(data_dir):
    r = np.random.RandomState(1)
    d = data_dir / "cifar-10-batches-py"
    d.mkdir()
    for fn, n in [(f"data_batch_{i}", 6) for i in range(1, 6)] \
            + [("test_batch", 4)]:
        with open(d / fn, "wb") as f:
            pickle.dump({b"data": r.randint(0, 256, (n, 3072)).astype(
                np.uint8), b"labels": r.randint(0, 10, n).tolist()}, f)
    for train in (True, False):
        got = pf.CifarDataSetIterator(7, num_examples=20, train=train)
        want = jf.CifarDataSetIterator(7, num_examples=20, train=train)
        assert not got.synthetic
        assert got.features.shape == ((20 if train else 4), 32, 32, 3)
        _equal(got, want)


def test_lfw_reads_an_image_tree(tmp_path):
    r = np.random.RandomState(2)
    root = tmp_path / "faces"
    for i, person in enumerate(["bob", "alice", "carol"]):
        (root / person).mkdir(parents=True)
        gray = r.randint(0, 256, (20, 14)).astype(np.uint8)
        (root / person / "a.png").write_bytes(ppng.encode_png_gray(gray))
        (root / person / "b.png").write_bytes(
            _png(r.randint(0, 256, (9, 11, 3)).astype(np.uint8), i % 5))
        np.save(root / person / "c.npy", r.rand(16, 16, 4).astype(np.float32))
        (root / person / "notes.txt").write_text("skipped")
    (root / "stray.png").write_bytes(b"not a person directory")
    for shape in ((8, 8, 1), (10, 6, 3)):
        got = pf.LFWDataSetIterator(4, images_dir=str(root),
                                    image_shape=shape)
        want = jf.LFWDataSetIterator(4, images_dir=str(root),
                                     image_shape=shape)
        assert got.people == want.people == ["alice", "bob", "carol"]
        assert got.features.shape == (9,) + shape
        _equal(got, want, ("features", "labels", "label_ids"))


def _png(img, ftype):
    """An 8-bit PNG of ``img`` ((H, W) gray or (H, W, C)) with every
    scanline written under filter ``ftype`` (0 none, 1 sub, 2 up,
    3 average, 4 Paeth)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int32)
    raw = b""
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decode_is_the_reference_s(ftype, channels):
    r = np.random.RandomState(10 * ftype + channels)
    shape = (7, 9) if channels == 1 else (7, 9, channels)
    img = r.randint(0, 256, shape).astype(np.uint8)
    data = _png(img, ftype)
    got = ppng.decode_png(data)
    np.testing.assert_array_equal(got, jpng.decode_png(data))
    np.testing.assert_array_equal(got, img)


def test_png_gray_round_trip_and_errors():
    img = np.random.RandomState(5).randint(0, 256, (13, 6)).astype(np.uint8)
    data = ppng.encode_png_gray(img)
    assert data == jpng.encode_png_gray(img)
    np.testing.assert_array_equal(ppng.decode_png(data), img)
    with pytest.raises(ValueError, match="not a PNG"):
        ppng.decode_png(b"GIF89a" + data[6:])
    with pytest.raises(ValueError, match="bitdepth"):
        bad = bytearray(data)
        bad[24] = 16                   # IHDR bit depth
        ppng.decode_png(bytes(bad))
