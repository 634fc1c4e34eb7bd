"""Runtime program watcher: the torch counterpart of
``deeplearning4j_tpu/testing/compilewatch.py``.

The reference watches XLA backend compiles. The port builds two kinds of
program, and this watcher records both:

- **captures**: the CUDA graphs the port captures on the card. Most are
  :class:`~deeplearning4j_tpu_torch.models._cuda_graph.StaticGraph`
  programs (the decode pool's, ``generate()``'s and ``beam_search()``'s,
  GloVe's and Word2Vec's chunks); the fused training loop's window
  graphs are captured by ``models/_layered.py`` with ``torch.cuda.graph``
  directly, so ``capture_count()`` never sees them. The watcher therefore
  sits at the torch seam, ``torch.cuda.CUDAGraph.capture_begin``, which
  every capture passes through;
- **builds** and **loads**: the kernel libraries ``ops/_build.py``
  compiles with ``nvcc`` (``_start`` returns a running build) and loads
  with ``ctypes`` (``load`` of a library not loaded yet), at first use or
  in ``build_all()``.

Every event records the in-repo fragment of its stack (innermost first)
and its **family**, the identity the gates and counts key on:

- a StaticGraph capture: the ``file:line`` that built the StaticGraph,
  which the watcher records by wrapping ``StaticGraph.__init__``, e.g.
  ``deeplearning4j_tpu_torch/serving/decode.py:350`` for the decode
  pool's programs, whose captures after ``warm_start()`` number
  ``len(graph_inventory())``;
- any other capture: its innermost in-repo frame, the ``with
  torch.cuda.graph(...)`` line (``models/_layered.py``'s window graph);
- a build or a load: ``build:<kernel>`` / ``load:<kernel>``.

Attribution is to the port's own program inventory (:func:`inventory`),
read from the source, not to siglint, which models ``jax.jit`` sites:
every ``StaticGraph(...)`` and ``torch.cuda.graph(...)`` call in the
package (``models/_cuda_graph.py``, the StaticGraph machinery itself,
aside), and a build and a load family for each kernel of
``ops/_build.KERNELS``. An event whose family is not in the inventory
(a capture in a script or a test) is recorded but attributed to nothing.

The gate is **steady state**: any capture, build or load recorded
inside a ``with compilewatch.steady():`` region (on any thread) is a
violation. After warm-up the program set is closed by construction: a
capture there is a recapture regression, a build there a kernel that
the warm-up never reached.

Enablement is the registered ``DL4J_TORCH_COMPILEWATCH`` knob (default
OFF), which the pytest plugin ``testing/pytest_watch.py`` honours.
``tests/conftest.py`` installs only the JAX package's watchers, so the
port's own tests and ``chip_smoke.py``'s phase ``watch`` install this
one explicitly.

Scope limits:

- events before ``install()`` are invisible, and a StaticGraph built
  before it is attributed as any other capture is, to the innermost
  in-repo frame of its first call;
- on the CPU nothing is captured or built (StaticGraph runs its function,
  kernels are never loaded), so the watcher records nothing there and
  its gates pass;
- a ``StaticGraph`` replay, a kernel launch and the native collective
  library's g++ build (``nativelib.py``) are not programs here.
"""

from __future__ import annotations

import ast
import os
import sys
import threading
import time
import weakref
from contextlib import contextmanager

__all__ = ["enabled", "install", "uninstall", "installed", "watch",
           "extend_watch_paths", "inventory", "snapshot", "events",
           "attributed", "counts_by_family", "counts_by_site", "steady",
           "violations", "reset", "report", "assert_clean"]

_state = threading.RLock()
_events: list = []             # [_Event]
_violations: list = []
_serial = [0]
_installed = False
_steady_depth = [0]
_current = threading.local()   # .program: the StaticGraph being captured
_sites = weakref.WeakKeyDictionary()   # StaticGraph -> (path, line) built
_originals: dict = {}          # (owner, name) -> the unwrapped attribute

_MAX_FRAMES = 25

# repo root: the parent of the deeplearning4j_tpu_torch package — only
# frames under it are recorded (the same anchoring as leakwatch)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG = os.path.join(_REPO_ROOT, "deeplearning4j_tpu_torch")
_MACHINERY = os.path.join(_PKG, "models", "_cuda_graph.py")

_watch_paths: list = []        # extra inventory roots (fixture dirs)
_inv_cache = [None]


def enabled():
    """Whether the registered ``DL4J_TORCH_COMPILEWATCH`` knob asks for
    the watcher (read at call time; default off)."""
    from deeplearning4j_tpu_torch.config import env_flag
    return env_flag("DL4J_TORCH_COMPILEWATCH")


def _rel(path):
    return os.path.relpath(path, _REPO_ROOT).replace(os.sep, "/")


def _thread_name(tid):
    """The thread's name WITHOUT ``threading.current_thread()``: on a
    thread that Python did not start (autograd's backward threads load
    the LSTM backward's library), that call makes a ``_DummyThread``,
    which leakwatch would then count as a thread this module left
    alive. A raw registry peek makes nothing."""
    th = threading._active.get(tid)
    return th.name if th is not None else f"tid-{tid}"


class _Event:
    __slots__ = ("serial", "kind", "family", "frames", "steady", "thread",
                 "t0")

    def __init__(self, serial, kind, family, frames, steady):
        self.serial = serial
        self.kind = kind           # "capture" | "build" | "load"
        self.family = family
        self.frames = frames       # [(abspath, lineno)] innermost-first
        self.steady = steady
        self.thread = _thread_name(threading.get_ident())
        self.t0 = time.monotonic()

    def describe(self):
        where = ", ".join(f"{_rel(p)}:{ln}" for p, ln in self.frames[:3]) \
            or "<out of repo>"
        tag = " [steady]" if self.steady else ""
        return (f"{self.kind} #{self.serial} of {self.family} from {where} "
                f"(thread {self.thread!r}){tag}")


def _repo_frames():
    """In-repo ``(abspath, lineno)`` frames of the current stack,
    innermost first, capped; this module and the StaticGraph machinery
    are left out."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < _MAX_FRAMES:
        name = f.f_code.co_filename
        if name != __file__ and not name.startswith("<"):
            ap = os.path.abspath(name)
            if ap.startswith(_REPO_ROOT + os.sep) and \
                    "site-packages" not in ap and ap != _MACHINERY:
                out.append((ap, f.f_lineno))
        f = f.f_back
    return out


def _capture_family(frames):
    """A StaticGraph's creation site, or the capture's innermost in-repo
    frame."""
    program = getattr(_current, "program", None)
    site = _sites.get(program) if program is not None else None
    if site is not None:
        path, line = site
        return f"{_rel(os.path.abspath(path))}:{line}"
    if frames:
        return f"{_rel(frames[0][0])}:{frames[0][1]}"
    return "<out of repo>"


def _record(kind, family=None):
    """Record one event; a capture's family is worked out here."""
    frames = _repo_frames()
    if family is None:
        family = _capture_family(frames)
    with _state:
        _serial[0] += 1
        _events.append(_Event(_serial[0], kind, family, frames,
                              _steady_depth[0] > 0))


# ---- the wrapped seams -----------------------------------------------------

def _wrap_capture_begin(fn):
    def capture_begin(self, *args, **kwargs):
        _record("capture")
        return fn(self, *args, **kwargs)
    capture_begin.__wrapped__ = fn
    return capture_begin


def _wrap_static_init(fn):
    def __init__(self, *args, **kwargs):
        caller = sys._getframe(1)
        _sites[self] = (caller.f_code.co_filename, caller.f_lineno)
        fn(self, *args, **kwargs)
    __init__.__wrapped__ = fn
    return __init__


def _wrap_static_capture(fn):
    def _capture(self):
        outer = getattr(_current, "program", None)
        _current.program = self
        try:
            return fn(self)
        finally:
            _current.program = outer
    _capture.__wrapped__ = fn
    return _capture


def _wrap_start(fn):
    def _start(name):
        started = fn(name)
        if started is not None:
            _record("build", f"build:{name}")
        return started
    _start.__wrapped__ = fn
    return _start


def _wrap_load(fn, libs):
    def load(name):
        fresh = name not in libs
        lib = fn(name)
        if fresh:
            _record("load", f"load:{name}")
        return lib
    load.__wrapped__ = fn
    return load


def installed():
    return _installed


def _patch(owner, name, wrapper):
    # None: the attribute was inherited (a Tensor method of TensorBase),
    # so uninstall() deletes the wrapper instead of pinning a copy
    _originals[(owner, name)] = vars(owner).get(name)
    setattr(owner, name, wrapper)


def install():
    """Wrap the capture, build and load seams and start recording.
    Idempotent."""
    global _installed
    with _state:
        if _installed:
            return
        import torch
        from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
        from deeplearning4j_tpu_torch.ops import _build
        graph_cls = getattr(torch.cuda, "CUDAGraph", None)
        if graph_cls is not None:
            _patch(graph_cls, "capture_begin",
                   _wrap_capture_begin(graph_cls.capture_begin))
        _patch(StaticGraph, "__init__",
               _wrap_static_init(StaticGraph.__init__))
        _patch(StaticGraph, "_capture",
               _wrap_static_capture(StaticGraph._capture))
        _patch(_build, "_start", _wrap_start(_build._start))
        _patch(_build, "load", _wrap_load(_build.load, _build._libs))
        _installed = True


def uninstall():
    """Restore the unwrapped seams and stop recording. Recorded events
    persist until :func:`reset`."""
    global _installed
    with _state:
        if not _installed:
            return
        for (owner, name), fn in _originals.items():
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        _originals.clear()
        _installed = False


@contextmanager
def watch():
    """``with compilewatch.watch():`` records for the block; on exit it
    restores ONLY if this block did the installing."""
    already = _installed
    install()
    try:
        yield sys.modules[__name__]
    finally:
        if not already:
            uninstall()


# ---- the program inventory -------------------------------------------------

def extend_watch_paths(*paths):
    """Add inventory roots beyond the package (fixture files or dirs in
    tests). Invalidates the cached inventory."""
    with _state:
        for p in paths:
            ap = os.path.abspath(p)
            if ap not in _watch_paths:
                _watch_paths.append(ap)
        _inv_cache[0] = None


def _sources(roots):
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, files in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d != "_build")
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def _program_calls(path):
    """``{(relpath, lineno): "<how> in <function>"}`` of every
    ``StaticGraph(...)`` and ``torch.cuda.graph(...)`` call in ``path``."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if "StaticGraph(" not in text and "cuda.graph(" not in text:
        return {}
    out = {}

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.Call):
                fn = child.func
                name = getattr(fn, "id", getattr(fn, "attr", None))
                base = getattr(getattr(fn, "value", None), "attr", None)
                how = ("StaticGraph" if name == "StaticGraph" else
                       "torch.cuda.graph" if name == "graph"
                       and base == "cuda" else None)
                if how is not None:
                    out[(_rel(path), child.lineno)] = \
                        f"{how} in {'.'.join(scope) or '<module>'}"
            visit(child, scope)
    visit(ast.parse(text, path), [])
    return out


def inventory():
    """``{family: description}`` of every program the port can build:
    each capture site (``relpath:lineno``) and a build and a load family
    for each kernel."""
    with _state:
        cached = _inv_cache[0]
        if cached is not None:
            return dict(cached)
        roots = [_PKG] + list(_watch_paths)
    inv = {}
    for path in _sources(roots):
        if os.path.abspath(path) == _MACHINERY:
            continue
        for (rel, line), what in _program_calls(path).items():
            inv[f"{rel}:{line}"] = f"capture: {what}"
    from deeplearning4j_tpu_torch.ops._build import KERNELS
    for name in KERNELS:
        inv[f"build:{name}"] = f"nvcc build of csrc/{name}.cu"
        inv[f"load:{name}"] = f"load of the {name} library"
    with _state:
        _inv_cache[0] = inv
    return dict(inv)


# ---- query surfaces --------------------------------------------------------

def snapshot():
    """An opaque marker: pass to the query and gate functions to scope
    them to events recorded AFTER this point."""
    with _state:
        return _serial[0]


def events(since=0):
    with _state:
        return [e for e in _events if e.serial > since]


def attributed(since=0):
    """``[(event, family, description)]`` of every event since the
    marker whose family is in :func:`inventory`."""
    inv = inventory()
    return [(e, e.family, inv[e.family]) for e in events(since)
            if e.family in inv]


def counts_by_family(since=0):
    """``{family: count}`` of the attributed events since the marker."""
    out = {}
    for _ev, family, _what in attributed(since):
        out[family] = out.get(family, 0) + 1
    return out


def counts_by_site(since=0):
    """``{(relpath, lineno): count}`` of the attributed captures since
    the marker, keyed by capture site."""
    out = {}
    for ev, family, _what in attributed(since):
        if ev.kind == "capture":
            rel, line = family.rsplit(":", 1)
            key = (rel, int(line))
            out[key] = out.get(key, 0) + 1
    return out


@contextmanager
def steady():
    """Declare a steady-state region: the program set is closed, so ANY
    capture, build or load recorded inside (on any thread, attributed or
    not) is a violation surfaced by :func:`assert_clean`."""
    with _state:
        _steady_depth[0] += 1
    try:
        yield
    finally:
        with _state:
            _steady_depth[0] -= 1


def violations():
    with _state:
        return list(_violations)


def reset():
    """Drop recorded events and violations (the inventory cache stays:
    the source does not change within a process)."""
    with _state:
        _events.clear()
        _violations.clear()


def _gate_failures(since):
    return [(ev, f"steady-state {ev.kind}") for ev in events(since)
            if ev.steady]


def report(since=0):
    bad = _gate_failures(since)
    if not bad:
        return "compilewatch: no stray captures or builds"
    out = [f"compilewatch: {len(bad)} stray program event(s)"]
    for ev, why in bad:
        out.append(f"  - {ev.describe()}: {why}")
    out.append("the program set is closed after warm-up: capture each "
               "program once and replay it (StaticGraph), key new "
               "signatures into the warm-up, and build every kernel before "
               "the steady loop")
    return "\n".join(out)


def assert_clean(since=0):
    """Raise ``AssertionError`` for every steady-region event since the
    marker, and record each in :func:`violations`."""
    bad = _gate_failures(since)
    if bad:
        msg = report(since)
        with _state:
            for ev, why in bad:
                _violations.append({"why": why, "family": ev.family,
                                    "site": ev.frames[0] if ev.frames
                                    else None})
        raise AssertionError(msg)
