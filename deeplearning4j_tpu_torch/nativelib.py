"""ctypes bindings for the native runtime: the port of
``deeplearning4j_tpu/nativelib.py``.

The repository's C++ sources (``native/src/{csv,tlv,collective,idx}.cpp``)
play the part the reference library gives native code: the fast CSV and
idx (MNIST) readers, the stats-codec (TLV) validator, and the TCP
collective coordinator and client that stand in for Spark's driver and
Aeron's media driver. The port compiles those sources with ``g++`` (the
flags of ``native/Makefile``) into ``_build/native/libdl4jtpu.so`` inside
this package, a directory git ignores, and never into ``native/build/``,
which belongs to the JAX package's own ``make``.

The library is built on its first use, or by :func:`ensure_built`
(``python -m deeplearning4j_tpu_torch.nativelib``): each source in its own
``g++`` process, all started together, linked into a temporary file that
is renamed into place, under a file lock, so a concurrent loader never
sees a partial file. It is built anew when a source is newer than it.
Where it cannot be built or loaded, every entry point returns None (the
classes raise), and callers fall back to pure Python, as the reference's
do: ``parallel/coordinator.py`` speaks the same wire protocol.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["LIB_PATH", "NativeCollectiveClient", "NativeCoordinator",
           "available", "build_error", "csv_parse", "ensure_built",
           "get_lib", "idx_load", "mnist_assemble", "tlv_validate"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG.parent / "native" / "src"
SOURCES = ("csv.cpp", "tlv.cpp", "collective.cpp", "idx.cpp")
BUILD_DIR = _PKG / "_build" / "native"
LIB_PATH = BUILD_DIR / "libdl4jtpu.so"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False
_build_error = None


def _stale():
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((SRC_DIR / s).stat().st_mtime > built for s in SOURCES)


def _compile(timeout):
    """Compile every source (one ``g++`` each, in parallel) and link the
    library into place. Raises on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: cannot build the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cpp", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [cxx, *CXXFLAGS, "-c", str(SRC_DIR / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, proc in zip(SOURCES, procs):
            log, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {src} "
                                   f"(exit {proc.returncode}):\n{log}")
        out = os.path.join(tmp, "libdl4jtpu.so")
        link = subprocess.run([cxx, *CXXFLAGS, "-shared", *objs, "-o", out,
                               "-lz"], capture_output=True, text=True,
                              timeout=timeout)
        if link.returncode != 0:
            raise RuntimeError(f"linking the native library failed:\n"
                               f"{link.stdout}{link.stderr}")
        # a rename: a concurrent loader never sees a partial file
        os.replace(out, LIB_PATH)


def _build_if_stale(timeout=180):
    """Build the library when it is missing or older than a source,
    serialised across processes by a file lock. Records (and swallows)
    a failure: a library built earlier still loads."""
    global _build_error
    import fcntl
    try:
        if _stale():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".build.lock", "w") as lock_fh:
                fcntl.flock(lock_fh, fcntl.LOCK_EX)
                if _stale():   # another process may have built it meanwhile
                    _compile(timeout)
        _build_error = None
    except Exception as e:  # no toolchain, read-only checkout, no sources
        _build_error = f"{type(e).__name__}: {e}"


def build_error():
    """Why the last build failed, or None."""
    return _build_error


def ensure_built(timeout=180):
    """Build the library if it is missing or stale and load it; returns
    whether it is loaded. A library already loaded in this process stays
    (a rebuilt file cannot be loaded again)."""
    global _load_attempted
    with _lib_lock:
        if _lib is not None:
            return True
        _build_if_stale(timeout)
        _load_attempted = False
    return get_lib() is not None


def _bind(lib):
    P, F, I, L = ctypes.POINTER, ctypes.c_float, ctypes.c_int, ctypes.c_long
    i64 = ctypes.c_int64
    sigs = {
        "dl4j_csv_parse": (I, [ctypes.c_char_p, ctypes.c_char, L,
                               P(P(ctypes.c_double)), P(L), P(L)]),
        "dl4j_free": (None, [ctypes.c_void_p]),
        "dl4j_tlv_validate": (I, [ctypes.c_char_p, L]),
        "dl4j_coord_start": (ctypes.c_void_p, [I, I, P(I)]),
        "dl4j_coord_stop": (None, [ctypes.c_void_p]),
        "dl4j_client_connect": (ctypes.c_void_p, [ctypes.c_char_p, I, I]),
        "dl4j_client_close": (None, [ctypes.c_void_p]),
        "dl4j_barrier": (I, [ctypes.c_void_p, ctypes.c_char_p]),
        "dl4j_allreduce": (I, [ctypes.c_void_p, ctypes.c_char_p, P(F), L]),
        "dl4j_broadcast": (I, [ctypes.c_void_p, ctypes.c_char_p, P(F), L,
                               I]),
        "dl4j_ps_init": (I, [ctypes.c_void_p, P(F), L]),
        "dl4j_ps_push": (I, [ctypes.c_void_p, P(F), L]),
        "dl4j_ps_pull": (I, [ctypes.c_void_p, P(F), L]),
        "dl4j_idx_load_u8": (I, [ctypes.c_char_p, P(P(ctypes.c_uint8)),
                                 P(I), P(i64)]),
        "dl4j_free_u8": (None, [P(ctypes.c_uint8)]),
        "dl4j_free_f32": (None, [P(F)]),
        "dl4j_mnist_assemble": (I, [ctypes.c_char_p, ctypes.c_char_p, I, I,
                                    ctypes.c_uint64, P(P(F)), P(P(F)),
                                    P(i64), P(i64), P(i64)]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib():
    """The loaded native library, or None. Its first call builds it when
    it is missing or stale (a few seconds); a failed build or load is not
    retried until :func:`ensure_built`."""
    global _lib, _load_attempted
    with _lib_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        _build_if_stale()
        if not LIB_PATH.exists():
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
        except (OSError, AttributeError):
            return None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# CSV fast path
# ---------------------------------------------------------------------------
def csv_parse(path, delimiter=",", skip_lines=0):
    """Parse an all-numeric CSV into a float64 [rows, cols] array (the
    Python parser's precision), or None if the library is unavailable or
    the file is not purely numeric."""
    lib = get_lib()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.dl4j_csv_parse(os.fsencode(path), delimiter.encode()[:1],
                            skip_lines, ctypes.byref(data),
                            ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    try:
        out = np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.dl4j_free(data)
    return out


# ---------------------------------------------------------------------------
# idx (MNIST-format) fast path: MnistManager.java's part
# ---------------------------------------------------------------------------
def idx_load(path):
    """Load a u8 idx file (plain or .gz) as a numpy array, or None when
    the library is unavailable or the file is not u8 idx."""
    lib = get_lib()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_uint8)()
    ndim = ctypes.c_int()
    dims = (ctypes.c_int64 * 4)()
    rc = lib.dl4j_idx_load_u8(os.fsencode(path), ctypes.byref(data),
                              ctypes.byref(ndim), dims)
    if rc != 0:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    try:
        out = np.ctypeslib.as_array(
            data, shape=(int(np.prod(shape)),)).reshape(shape).copy()
    finally:
        lib.dl4j_free_u8(data)
    return out


def mnist_assemble(images_path, labels_path, n_classes=10, shuffle=False,
                   seed=123):
    """A native image/label pair made ready to train: ([N, rows, cols, 1]
    float32 in [0, 1], one-hot float32 labels, int64 class ids). None when
    the library is unavailable or declines the files (callers fall back
    to the Python reader)."""
    lib = get_lib()
    if lib is None:
        return None
    feats = ctypes.POINTER(ctypes.c_float)()
    labels = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.dl4j_mnist_assemble(
        os.fsencode(images_path), os.fsencode(labels_path), n_classes,
        1 if shuffle else 0, seed, ctypes.byref(feats), ctypes.byref(labels),
        ctypes.byref(n), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    try:
        X = np.ctypeslib.as_array(
            feats, shape=(n.value, rows.value, cols.value)).copy()[..., None]
        Y = np.ctypeslib.as_array(labels, shape=(n.value, n_classes)).copy()
    finally:
        lib.dl4j_free_f32(feats)
        lib.dl4j_free_f32(labels)
    return X, Y, np.argmax(Y, axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# TLV validation
# ---------------------------------------------------------------------------
def tlv_validate(payload: bytes):
    """0 = valid, >0 = error code; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    return lib.dl4j_tlv_validate(payload, len(payload))


# ---------------------------------------------------------------------------
# Collective coordinator / client
# ---------------------------------------------------------------------------
class NativeCoordinator:
    """In-process coordinator server (the Spark driver's and Aeron media
    driver's part)."""

    kind = "native"

    def __init__(self, n_workers, port=0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        out_port = ctypes.c_int()
        self._h = lib.dl4j_coord_start(port, n_workers, ctypes.byref(out_port))
        if not self._h:
            raise RuntimeError(f"could not start coordinator on port {port}")
        self.port = out_port.value
        self.n_workers = n_workers
        self._lib = lib
        self._stop_lock = threading.Lock()

    def stop(self):
        # a watchdog thread and the owner's finally block may race here:
        # a second dl4j_coord_stop would free the handle twice
        with self._stop_lock:
            h, self._h = self._h, None
        if h:
            self._lib.dl4j_coord_stop(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class NativeCollectiveClient:
    """Blocking collective client; one a worker thread or process."""

    kind = "native"

    def __init__(self, host, port, worker_id):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._h = lib.dl4j_client_connect(host.encode(), port, worker_id)
        if not self._h:
            raise RuntimeError(f"could not connect to coordinator {host}:{port}")
        self._lib = lib
        self.worker_id = worker_id

    def _buf(self, arr):
        # always a copy: the C calls write results in place, and the
        # Python client never changes its caller's buffer
        arr = np.array(arr, np.float32, order="C")
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def barrier(self, tag="barrier"):
        if self._lib.dl4j_barrier(self._h, tag.encode()) != 0:
            raise RuntimeError("barrier failed")

    def allreduce(self, arr, tag="allreduce"):
        """Sum across workers; returns the reduced float32 array."""
        arr, ptr = self._buf(arr)
        if self._lib.dl4j_allreduce(self._h, tag.encode(), ptr, arr.size) != 0:
            raise RuntimeError("allreduce failed")
        return arr

    def broadcast(self, arr, root=False, tag="broadcast"):
        arr, ptr = self._buf(arr)
        if self._lib.dl4j_broadcast(self._h, tag.encode(), ptr, arr.size,
                                    1 if root else 0) != 0:
            raise RuntimeError("broadcast failed")
        return arr

    def ps_init(self, params):
        arr, ptr = self._buf(params)
        if self._lib.dl4j_ps_init(self._h, ptr, arr.size) != 0:
            raise RuntimeError("ps_init failed")

    def ps_push(self, delta):
        arr, ptr = self._buf(delta)
        if self._lib.dl4j_ps_push(self._h, ptr, arr.size) != 0:
            raise RuntimeError("ps_push failed (init first?)")

    def ps_pull(self, n):
        out = np.empty(n, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.dl4j_ps_pull(self._h, ptr, n) != 0:
            raise RuntimeError("ps_pull failed (init first?)")
        return out

    def close(self):
        if self._h:
            self._lib.dl4j_client_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


if __name__ == "__main__":
    ok = ensure_built()
    print(f"native library {'built and loaded' if ok else 'UNAVAILABLE'}: "
          f"{LIB_PATH}" + ("" if ok else f" ({build_error()})"))
    raise SystemExit(0 if ok else 1)
