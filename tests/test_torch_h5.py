"""The port's HDF5 reader (``deeplearning4j_tpu_torch/utils/h5.py``, a copy
of the reference's) against the reference's reader and h5py, on the same
h5py-written files: attributes, groups, nested paths, contiguous, compact
and chunked-deflate datasets, libver "latest" headers; and on corrupt
files (truncations, bit flips, not HDF5 at all), where both readers must
fail alike (the same exception type) or read the same arrays. Equality is
exact: the readers decode the same bytes.
"""

import json

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.utils import h5 as jh5
from deeplearning4j_tpu_torch.utils import h5 as ph5


def _write(path, libver=None):
    r = np.random.RandomState(0)
    data = {"model_weights/dense_1/dense_1_W": r.randn(12, 24)
            .astype(np.float32),
            "model_weights/dense_1/dense_1_b": r.randn(24),
            "model_weights/chunked_gz": r.randn(33, 47).astype(np.float32),
            "model_weights/ints": np.arange(10, dtype=np.int64),
            "a/b/x": np.arange(6, dtype=np.int32).reshape(2, 3)}
    kw = {} if libver is None else {"libver": libver}
    with h5py.File(path, "w", **kw) as f:
        f.attrs["model_config"] = json.dumps({"class_name": "Sequential"})
        f.attrs["count"] = 7
        f.attrs["ratio"] = 0.25
        g = f.create_group("model_weights")
        d1 = g.create_group("dense_1")
        d1.attrs["weight_names"] = np.array(["dense_1_W", "dense_1_b"],
                                            dtype=object)
        g.attrs["layer_names"] = np.array([b"dense_1"], dtype="S16")
        for name, arr in data.items():
            opts = dict(chunks=(8, 16), compression="gzip") \
                if name.endswith("chunked_gz") else {}
            f.create_dataset(name, data=arr, **opts)
    return data


def _attrs(group):
    out = {}
    for k in group.attrs:
        v = group.attrs[k]
        out[k] = [x.decode() if isinstance(x, bytes) else x for x in v] \
            if isinstance(v, np.ndarray) else \
            (v.decode() if isinstance(v, bytes) else v)
    return out


@pytest.mark.parametrize("libver", [None, "latest"])
def test_reader_matches_reference_and_h5py(tmp_path, libver):
    p = str(tmp_path / "m.h5")
    data = _write(p, libver)
    with ph5.H5File(p) as pf, jh5.H5File(p) as jf, h5py.File(p, "r") as hf:
        assert _attrs(pf) == _attrs(jf)
        assert json.loads(pf.attrs["model_config"]) == \
            json.loads(hf.attrs["model_config"])
        assert pf.attrs["count"] == hf.attrs["count"] == 7
        assert sorted(pf.keys()) == sorted(jf.keys()) == sorted(hf.keys())
        for group in ("model_weights", "model_weights/dense_1", "a/b"):
            assert sorted(pf[group].keys()) == sorted(hf[group].keys())
            assert _attrs(pf[group]) == _attrs(jf[group])
        assert list(pf["model_weights/dense_1"].attrs["weight_names"]) == \
            ["dense_1_W", "dense_1_b"]
        for name, arr in data.items():
            if libver == "latest" and name.endswith("chunked_gz"):
                # a v4 chunked layout: neither reader takes it (Keras
                # writes the earliest format), and both say so alike
                for f in (pf, jf):
                    with pytest.raises(ValueError, match="v4 chunked"):
                        np.asarray(f[name])
                continue
            got = np.asarray(pf[name])
            np.testing.assert_array_equal(got, np.asarray(jf[name]))
            np.testing.assert_array_equal(got, hf[name][()])
            np.testing.assert_array_equal(got, arr)
            assert got.dtype == hf[name].dtype
        assert "dense_1" in pf["model_weights"]
        assert "missing" not in pf["model_weights"]
        assert "dense_1_W/oops" not in pf["model_weights/dense_1"]
        with pytest.raises(KeyError):
            pf["a/zzz"]
        with pytest.raises(KeyError):
            pf["model_weights/dense_1"]["dense_1_W/oops"]


def _outcome(mod, path):
    """(exception type name, None) or (None, the arrays read)."""
    try:
        with mod.H5File(path) as f:
            return None, (np.asarray(f["grp"]["data"]),
                          list(f["grp"].attrs.get("names", [])))
    except Exception as e:        # an ordinary exception, never a hang
        assert not isinstance(e, (SystemExit, KeyboardInterrupt))
        return type(e).__name__, None


def _corrupt_cases(blob):
    r = np.random.RandomState(0)
    cases = {f"trunc{frac}": blob[:int(len(blob) * frac)]
             for frac in (0.1, 0.3, 0.5, 0.9, 0.99)}
    for i in range(24):
        mutated = bytearray(blob)
        for _ in range(r.randint(1, 8)):
            mutated[r.randint(0, len(mutated))] ^= 1 << r.randint(0, 8)
        cases[f"flip{i}"] = bytes(mutated)
    cases["empty"] = b""
    cases["header_only"] = b"\x89HDF\r\n\x1a\n" + b"\x00" * 16
    cases["not_hdf5"] = b"definitely not hdf5"
    return cases


def test_corrupt_files_fail_alike(tmp_path):
    src = tmp_path / "good.h5"
    with h5py.File(src, "w") as f:
        g = f.create_group("grp")
        g.attrs["names"] = np.array([b"a", b"b"])
        g.create_dataset("data", data=np.arange(64, dtype=np.float32))
    cases = _corrupt_cases(src.read_bytes())
    failed = 0
    for tag, blob in cases.items():
        p = tmp_path / f"{tag}.h5"
        p.write_bytes(blob)
        (perr, pval), (jerr, jval) = _outcome(ph5, str(p)), \
            _outcome(jh5, str(p))
        assert perr == jerr, tag
        if perr is None:
            np.testing.assert_array_equal(pval[0], jval[0])
            assert pval[1] == jval[1], tag
        else:
            failed += 1
    assert failed >= 8
    with pytest.raises(ph5.H5Error, match="not an HDF5 file"):
        ph5.H5File(str(tmp_path / "not_hdf5.h5"))
    # the good file still reads (no state shared between opens)
    assert _outcome(ph5, str(src))[1][0].shape == (64,)
