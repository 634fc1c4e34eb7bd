"""The port's native library (``deeplearning4j_tpu_torch/nativelib.py``)
against the reference's (``deeplearning4j_tpu/nativelib.py``), and the
port's coordinators against the reference's on the wire.

- the port builds the library with ``g++`` from ``native/src`` into its
  own ``_build/native`` (never ``native/build``, the reference's);
- ``csv_parse``, ``idx_load``, ``mnist_assemble`` and ``tlv_validate``
  give the reference's results on the same files and payloads, the
  declined inputs included (None);
- wire parity: each collective scenario of ``tests/test_native.py``
  (allreduce and barrier, rounds reusing a tag, broadcast, the parameter
  server, its errors before init) runs with a reference client against
  the port's Python and native coordinators, and with the port's Python
  and native clients against the reference's Python coordinator;
- the factories prefer the native implementation, say which one served
  (``kind``) and count a fallback; ``coordinator_main`` serves clients.
"""

import gzip
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import nativelib as ref_native
from deeplearning4j_tpu.parallel import coordinator as ref_coord
from deeplearning4j_tpu_torch import nativelib
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel import coordinator as port_coord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "real_mnist")
HOST = "127.0.0.1"


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert nativelib.ensure_built(), nativelib.build_error()
    assert ref_native.available()


def test_library_builds_into_the_port_package():
    lib = nativelib.LIB_PATH
    assert lib.is_file()
    assert lib.parent == nativelib._PKG / "_build" / "native"
    assert os.path.realpath(lib) != os.path.realpath(ref_native._LIB_PATH)
    built = lib.stat().st_mtime
    assert all((nativelib.SRC_DIR / s).stat().st_mtime <= built
               for s in nativelib.SOURCES)
    assert nativelib.available() and nativelib.build_error() is None


CSV_CASES = {
    "numeric": (b"1.5,2,3\n4,5.25,-6\n", {}),
    "precision": (b"0.1,0.2,1e-3\n", {}),
    "hex": (b"1,0x10\n", {}),
    "crlf_header": (b"header,x,y\r\n1,2,3\r\n4,5,6\r\n", {"skip_lines": 1}),
    "non_numeric": (b"1,2,cat\n", {}),
    "ragged": (b"1,2\n3\n", {}),
    "semicolon": (b"1;2\n3;4\n", {"delimiter": ";"}),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_parse_equals_reference(tmp_path, case):
    body, kw = CSV_CASES[case]
    p = tmp_path / "d.csv"
    p.write_bytes(body)
    got, want = nativelib.csv_parse(str(p), **kw), \
        ref_native.csv_parse(str(p), **kw)
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["train-images-idx3-ubyte",
                                  "train-labels-idx1-ubyte",
                                  "t10k-labels-idx1-ubyte"])
def test_idx_load_equals_reference(tmp_path, name):
    src = os.path.join(FIX, name)
    gz = tmp_path / (name + ".gz")
    with open(src, "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    for path in (src, str(gz)):
        got = nativelib.idx_load(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref_native.idx_load(path))


@pytest.mark.parametrize("shuffle,seed", [(False, 123), (True, 7)])
def test_mnist_assemble_equals_reference(shuffle, seed):
    args = (os.path.join(FIX, "train-images-idx3-ubyte"),
            os.path.join(FIX, "train-labels-idx1-ubyte"))
    got = nativelib.mnist_assemble(*args, shuffle=shuffle, seed=seed)
    want = ref_native.mnist_assemble(*args, shuffle=shuffle, seed=seed)
    assert got[0].shape == (320, 28, 28, 1) and got[1].shape == (320, 10)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_declined_idx_files_return_none_like_reference(tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00\x01\x02")
    evil = tmp_path / "evil-idx3-ubyte"
    evil.write_bytes(b"\x00\x00\x08\x04" + b"\xff\xff\xff\xff" * 4)
    big = tmp_path / "big-idx1-ubyte"
    big.write_bytes(b"\x00\x00\x08\x01" + b"\xff\xff\xff\xff")
    for p in (bad, evil, big):
        assert nativelib.idx_load(str(p)) is None
        assert ref_native.idx_load(str(p)) is None
    assert nativelib.mnist_assemble(str(bad), str(bad)) is None


def test_tlv_validate_equals_reference():
    from deeplearning4j_tpu.ui import codec
    good = codec.encode({"a": 1, "b": [1.0, "x"],
                         "c": np.zeros((2, 3), np.float32)})
    for payload in (good, b"XXXX\x01\x00\x00", good[:-3], good + b"zz"):
        assert nativelib.tlv_validate(payload) == \
            ref_native.tlv_validate(payload)
    assert nativelib.tlv_validate(good) == 0


# ---- wire parity --------------------------------------------------------
def _run_workers(n, fn):
    """fn(worker_id) on n threads; re-raises the first error."""
    errors, results = [], [None] * n

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    if errors:
        raise errors[0]
    return results


# (server, client) pairs: one package's endpoint against the other's
PAIRS = {
    "ref_client-port_py_server": (
        lambda n: port_coord.PyCoordinator(n, timeout=20.0),
        lambda port, w: ref_coord.PyCollectiveClient(HOST, port, w)),
    "ref_client-port_native_server": (
        lambda n: nativelib.NativeCoordinator(n),
        lambda port, w: ref_coord.PyCollectiveClient(HOST, port, w)),
    "port_py_client-ref_py_server": (
        lambda n: ref_coord.PyCoordinator(n, timeout=20.0),
        lambda port, w: port_coord.PyCollectiveClient(HOST, port, w)),
    "port_native_client-ref_py_server": (
        lambda n: ref_coord.PyCoordinator(n, timeout=20.0),
        lambda port, w: nativelib.NativeCollectiveClient(HOST, port, w)),
    "mixed_clients-port_py_server": (
        lambda n: port_coord.PyCoordinator(n, timeout=20.0),
        lambda port, w: (ref_native.NativeCollectiveClient(HOST, port, w)
                         if w % 2 else
                         port_coord.PyCollectiveClient(HOST, port, w))),
}


def _allreduce_and_barrier(make_server, make_client):
    with make_server(4) as coord:
        def worker(i):
            with make_client(coord.port, i) as c:
                c.barrier()
                out = c.allreduce(np.full(5, float(i + 1), np.float32))
                c.barrier()
                out2 = c.allreduce(np.full(3, 1.0, np.float32), tag="second")
                return out, out2
        for out, out2 in _run_workers(4, worker):
            np.testing.assert_array_equal(out, np.full(5, 10.0))
            np.testing.assert_array_equal(out2, np.full(3, 4.0))


def _rounds_reuse_a_tag(make_server, make_client):
    with make_server(2) as coord:
        def worker(i):
            with make_client(coord.port, i) as c:
                return [c.allreduce(np.asarray([float(r + i)], np.float32),
                                    tag="g") for r in range(3)]
        for outs in _run_workers(2, worker):
            np.testing.assert_array_equal(np.concatenate(outs),
                                          [1.0, 3.0, 5.0])


def _broadcast(make_server, make_client):
    payload = np.arange(4, dtype=np.float32)
    with make_server(3) as coord:
        def worker(i):
            with make_client(coord.port, i) as c:
                if i == 0:
                    return c.broadcast(payload.copy(), root=True)
                return c.broadcast(np.zeros(4, np.float32))
        for out in _run_workers(3, worker):
            np.testing.assert_array_equal(out, payload)


def _parameter_server(make_server, make_client):
    with make_server(3) as coord:
        def worker(i):
            with make_client(coord.port, i) as c:
                if i == 0:
                    c.ps_init(np.zeros(4, np.float32))
                c.barrier()
                c.ps_push(np.full(4, float(i + 1), np.float32))
                c.barrier()
                return c.ps_pull(4)
        for out in _run_workers(3, worker):
            np.testing.assert_array_equal(out, np.full(4, 6.0))


def _ps_errors_before_init(make_server, make_client):
    with make_server(1) as coord:
        with make_client(coord.port, 0) as c:
            with pytest.raises(RuntimeError):
                c.ps_pull(4)
            with pytest.raises(RuntimeError):
                c.ps_push(np.zeros(4, np.float32))


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _allreduce_and_barrier, _rounds_reuse_a_tag, _broadcast,
    _parameter_server, _ps_errors_before_init)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_wire_parity(pair, scenario):
    SCENARIOS[scenario](*PAIRS[pair])


# ---- the factories --------------------------------------------------------
def test_factories_prefer_native_and_say_so():
    with port_coord.start_coordinator(2) as coord:
        assert coord.kind == "native"
        assert isinstance(coord, nativelib.NativeCoordinator)

        def worker(i):
            with port_coord.connect(HOST, coord.port, i) as c:
                assert c.kind == "native"
                return c.allreduce(np.asarray([1.0], np.float32))
        for out in _run_workers(2, worker):
            np.testing.assert_array_equal(out, [2.0])


def test_python_forced_and_fallback_counted(monkeypatch):
    name = "collective.native_fallbacks_total"
    before = obs.metrics.value(name) or 0
    with port_coord.start_coordinator(1, prefer_native=False) as coord:
        assert coord.kind == "python"
        with port_coord.connect(HOST, coord.port, 0,
                                prefer_native=False) as c:
            assert c.kind == "python"
            c.barrier()
    assert (obs.metrics.value(name) or 0) == before   # asked for, not a fallback
    monkeypatch.setattr(nativelib, "available", lambda: False)
    with port_coord.start_coordinator(1) as coord:
        assert isinstance(coord, port_coord.PyCoordinator)
        with port_coord.connect(HOST, coord.port, 0) as c:
            assert isinstance(c, port_coord.PyCollectiveClient)
            c.barrier()
    assert obs.metrics.value(name) == before + 2


def test_elastic_request_routes_to_python():
    with port_coord.start_coordinator(1, elastic=True) as coord:
        assert coord.kind == "python" and coord.elastic


@pytest.mark.parametrize("native", [True, False])
def test_coordinator_main_serves_clients(native):
    args = [sys.executable, "-m",
            "deeplearning4j_tpu_torch.parallel.coordinator_main",
            "--port", "0", "--n-workers", "2"] + ([] if native
                                                  else ["--no-native"])
    proc = subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "coordinator listening on port" in line, line
        assert ("native" if native else "python") in line
        port = int(line.split("port ")[1].split()[0])

        def worker(i):
            with ref_coord.PyCollectiveClient(HOST, port, i) as c:
                return c.allreduce(np.full(2, i + 1.0, np.float32))
        for out in _run_workers(2, worker):
            np.testing.assert_array_equal(out, [3.0, 3.0])
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("kw", [{}, {"shuffle": True, "seed": 5,
                                     "num_examples": 100, "binarize": True}])
def test_mnist_iterator_decodes_through_the_native_reader(monkeypatch, kw):
    """MnistDataSetIterator decodes its idx files through ``idx_load``
    (the reference decodes natively too), scales ``u8 / 255`` in numpy
    (bit for bit the ``read_idx`` path it falls back to) and holds the
    reference's arrays: labels equal, pixels within one f32 step (the
    reference's ``mnist_assemble`` scales in C)."""
    from deeplearning4j_tpu.datasets.fetchers import \
        MnistDataSetIterator as JMnist
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        MnistDataSetIterator
    calls = []
    real = nativelib.idx_load

    def counted(path):
        calls.append(path)
        return real(path)
    monkeypatch.setattr(nativelib, "idx_load", counted)
    got = MnistDataSetIterator(64, data_dir=FIX, **kw)
    assert len(calls) == 2 and not got.synthetic
    want = JMnist(64, data_dir=FIX, **kw)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.label_ids, want.label_ids)
    np.testing.assert_allclose(got.features, want.features, rtol=0,
                               atol=6e-8)
    monkeypatch.setattr(nativelib, "idx_load", lambda path: None)
    plain = MnistDataSetIterator(64, data_dir=FIX, **kw)
    for name in ("features", "labels", "label_ids"):
        np.testing.assert_array_equal(getattr(plain, name),
                                      getattr(got, name))
