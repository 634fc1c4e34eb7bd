"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel family behind a plain C entry
point of the same name; the sources share ``csrc/*.cuh`` headers. It is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so``
inside the package (a directory git ignores), where the hash covers the
source, every header and the flags, so an edited source or header builds
anew and an unchanged one is reused. Nothing is built at import:
the first wrapper call on a CUDA tensor builds, or :func:`build_all`
builds every kernel at once, one ``nvcc`` process per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (argtypes of its C entry point of the same name)
KERNELS = {
    "flash_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "flash_attn_dq": (_P,) * 7 + (_I,) * 6 + (_F, _I, _P),
    "flash_attn_dkv": (_P,) * 8 + (_I,) * 6 + (_F, _I, _P),
    "lstm_cell_fwd": (_P,) * 10 + (_I,) * 5 + (_P,),
    "lstm_cell_bwd": (_P,) * 14 + (_I,) * 4 + (_P,),
}
# further C functions of a kernel's library: name -> {function: (argtypes,
# restype)}
HELPERS = {
    "lstm_cell_fwd": {"lstm_cell_fwd_scratch_ints": ((_I, _I),
                                                     ctypes.c_longlong)},
    "lstm_cell_bwd": {"lstm_cell_bwd_scratch_floats": ((_I, _I),
                                                       ctypes.c_longlong)},
}

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name):
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name):
    """Start ``nvcc`` for kernel ``name`` unless its library exists.
    Returns (final path, temp path, process) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name, started):
    """Wait for a build started by :func:`_start`; returns nvcc's output
    (its register and shared-memory report). Raises on failure."""
    out, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # a concurrent loader never sees a partial file
    return log


def build_all():
    """Build every kernel in :data:`KERNELS` in parallel. Returns
    {name: nvcc output, or "" when the library was already built}."""
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        return {name: _finish(name, s) if s else ""
                for name, s in started.items()}


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, building it first
    if needed; its entry point ``name`` has its argtypes and an int
    (cudaError_t) restype set, and so do its :data:`HELPERS`."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = KERNELS[name]
        fn.restype = ctypes.c_int
        for helper, (argtypes, restype) in HELPERS.get(name, {}).items():
            fn = getattr(lib, helper)
            fn.argtypes, fn.restype = argtypes, restype
        _libs[name] = lib
        return lib
