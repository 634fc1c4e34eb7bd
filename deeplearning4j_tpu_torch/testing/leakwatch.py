"""Runtime resource-leak watcher: the port of
``deeplearning4j_tpu/testing/leakwatch.py`` (the dynamic twin of
graftlint G022-G024, as lockwatch is of G014).

``install()`` wraps the four constructor families the static leaklint
pack inventories (``threading.Thread``, ``socket.socket``, which
``socket.create_connection`` routes through, ``builtins.open`` and
``tempfile.TemporaryDirectory``) with watched factories that register
every resource **created from in-repo code**, keyed by its *creation
site* (``file:line`` of the first frame outside leakwatch and the
stdlib constructor machinery). That identity is how the static pack
records its acquisition inventory
(``tools/graftlint/resources.py::resource_inventory_for_paths``), so a
test can assert the runtime-observed sites are a SUBSET of the static
inventory.

A registered resource is **live** while its kind-specific probe says so
(a started thread that ``is_alive()``, a file that is not ``closed``, a
socket whose ``fileno() != -1``, a temp dir that still exists); it
leaves the books when released OR when the interpreter collects it.
``snapshot()`` + ``assert_clean(since=...)`` is the per-test gate:
everything created after the snapshot must be dead by the end of the
test, or the gate raises with each leak's kind, creation site and age,
and records it in ``violations()``.

Enablement is the registered ``DL4J_TORCH_LEAKWATCH`` knob (default OFF:
the wrapper costs a dict update per construction), which the pytest
plugin ``testing/pytest_watch.py`` honours. ``tests/conftest.py``
installs only the JAX package's watchers, so the port's own tests and
``chip_smoke.py``'s phase ``watch`` install this one explicitly.
The four kinds are the reference's: nothing CUDA-specific (streams,
graphs, kernel libraries) is watched here.

Deliberate scope limits (each covered by the static side where
possible):

- resources created BEFORE ``install()`` (import-time singletons) are
  invisible;
- only creation sites under the repo root are registered: torch's own
  threads and files, pytest's capture files and stdlib machinery would
  otherwise drown every report (frames under ``site-packages``, torch's
  included, never register);
- a resource whose last reference dies is unregistered even if it was
  never explicitly released (refcount close is not a teardown path, but
  it is not observable here); the static G022/G024 rules cover that
  class;
- daemon threads are reported exactly like non-daemon ones: "process
  exit reaps it" is not a teardown path. By-design process-lifetime
  daemons belong on the ``allow`` list of the gate that sees them.
"""

from __future__ import annotations

import builtins
import collections
import os
import socket as _socket_mod
import sys
import tempfile as _tempfile_mod
import threading
import time
import weakref
from contextlib import contextmanager

__all__ = ["enabled", "install", "uninstall", "installed", "watch",
           "snapshot", "live", "observed_sites", "violations", "reset",
           "report", "assert_clean"]

# RLock, not Lock: a GC pass triggered by an allocation made while the
# state lock is held must not deadlock same-thread re-entry
_state = threading.RLock()
_records: dict = {}            # serial -> _Record
# serials whose referent was collected, appended LOCK-FREE by the
# weakref callback (_Record._gone) and drained under _state by the next
# registration/reader. A GC callback fires at ARBITRARY allocation
# points — including while ANOTHER watcher's bookkeeping lock is held
# by this very thread (lockwatch's _note_edges guards its edge table
# with a raw non-reentrant lock); acquiring any watched lock from the
# callback can therefore self-deadlock the process. deque.append is
# GIL-atomic: no lock, no deadlock.
_dead: collections.deque = collections.deque()
_observed: list = []           # (site, kind) of EVERY registration
_violations: list = []
_serial = [0]
_installed = False
_active = False
_orig = {}                     # name -> original constructor

# repo root: the parent of the deeplearning4j_tpu_torch package — only
# resources born from files under it are registered
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_SKIP_FILES = (__file__, threading.__file__, _socket_mod.__file__,
               _tempfile_mod.__file__)


def enabled():
    """Whether the registered ``DL4J_TORCH_LEAKWATCH`` knob asks for the
    watcher (read at call time; default off)."""
    from deeplearning4j_tpu_torch.config import env_flag
    return env_flag("DL4J_TORCH_LEAKWATCH")


def _site_label():
    """``file:line`` of the first frame outside leakwatch and the stdlib
    constructor modules — the shared identity with the static
    inventory. Returns None for out-of-repo creation sites (not
    registered)."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name not in _SKIP_FILES:
            ap = os.path.abspath(name)
            # separator-anchored prefix (a sibling <repo>-backup is
            # NOT repo code) and no vendored trees (an in-repo venv's
            # site-packages would drown the gate in third-party noise)
            if not ap.startswith(_REPO_ROOT + os.sep) or \
                    "site-packages" in ap:
                return None
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return None


class _Record:
    __slots__ = ("serial", "kind", "site", "ref", "probe", "t0")

    def __init__(self, serial, kind, site, obj, probe):
        self.serial = serial
        self.kind = kind
        self.site = site
        self.probe = probe
        self.t0 = time.monotonic()
        self.ref = weakref.ref(obj, self._gone)

    def _gone(self, _ref):
        # no lock here, EVER — see the _dead contract above. The record
        # stays in _records as a tombstone until the next drain; is_live
        # already answers False for a collected referent, so the gates
        # stay correct in between.
        _dead.append(self.serial)

    def is_live(self):
        obj = self.ref()
        if obj is None:
            return False
        try:
            return bool(self.probe(obj))
        except Exception:
            return False

    def describe(self):
        age = time.monotonic() - self.t0
        return f"{self.kind} created at {self.site} ({age:.1f}s old)"


def _drain_dead():
    """Drop records whose referent the GC collected (caller holds
    ``_state``). popleft survives a racing callback append: the deque is
    only ever consumed here, under the lock."""
    while _dead:
        try:
            _records.pop(_dead.popleft(), None)
        except IndexError:   # raced an empty check — nothing left
            break


def _register(kind, obj, probe):
    site = _site_label()
    if site is None:
        return
    with _state:
        if not _active:
            return
        _drain_dead()
        _serial[0] += 1
        rec = _Record(_serial[0], kind, site, obj, probe)
        _records[rec.serial] = rec
        _observed.append((site, kind))


# ---- kind-specific liveness probes ----------------------------------------

def _thread_live(t):
    return t.is_alive()


def _file_live(fh):
    return not getattr(fh, "closed", False)


def _socket_live(s):
    return s.fileno() != -1


def _tempdir_live(d):
    return os.path.isdir(d.name)


# ---- watched factories ----------------------------------------------------
# threading.Thread and tempfile.TemporaryDirectory are CLASSES whose
# subclass relationships matter downstream (socketserver spawns
# threading.Thread, concurrent.futures subclasses it) — wrap with
# subclasses so isinstance stays true. socket.socket likewise.
# builtins.open is a function — a plain wrapper suffices.

def _make_thread_cls(base):
    class WatchedThread(base):
        def __init__(self, *a, **kw):
            base.__init__(self, *a, **kw)
            _register("thread", self, _thread_live)
    WatchedThread.__name__ = base.__name__
    WatchedThread.__qualname__ = base.__qualname__
    return WatchedThread


def _make_socket_cls(base):
    class WatchedSocket(base):
        def __init__(self, *a, **kw):
            base.__init__(self, *a, **kw)
            _register("socket", self, _socket_live)
    WatchedSocket.__name__ = base.__name__
    WatchedSocket.__qualname__ = base.__qualname__
    return WatchedSocket


def _make_tempdir_cls(base):
    class WatchedTemporaryDirectory(base):
        def __init__(self, *a, **kw):
            base.__init__(self, *a, **kw)
            _register("temp dir", self, _tempdir_live)
    WatchedTemporaryDirectory.__name__ = base.__name__
    WatchedTemporaryDirectory.__qualname__ = base.__qualname__
    return WatchedTemporaryDirectory


def _open_wrapper(*a, **kw):
    fh = _orig["open"](*a, **kw)
    _register("file", fh, _file_live)
    return fh


def installed():
    return _installed


def install():
    """Patch the four constructor families with watched twins.
    Idempotent. Resources created before this call stay raw (and
    silent)."""
    global _installed, _active
    if _installed:
        _active = True
        return
    _orig["Thread"] = threading.Thread
    _orig["socket"] = _socket_mod.socket
    _orig["open"] = builtins.open
    _orig["TemporaryDirectory"] = _tempfile_mod.TemporaryDirectory
    threading.Thread = _make_thread_cls(_orig["Thread"])
    _socket_mod.socket = _make_socket_cls(_orig["socket"])
    builtins.open = _open_wrapper
    _tempfile_mod.TemporaryDirectory = _make_tempdir_cls(
        _orig["TemporaryDirectory"])
    _installed = True
    _active = True


def uninstall():
    """Restore the original constructors. Already-registered resources
    keep their records (their probes still work); new constructions go
    unwatched."""
    global _installed, _active
    if not _installed:
        return
    threading.Thread = _orig["Thread"]
    _socket_mod.socket = _orig["socket"]
    builtins.open = _orig["open"]
    _tempfile_mod.TemporaryDirectory = _orig["TemporaryDirectory"]
    _installed = False
    _active = False


@contextmanager
def watch():
    """``with leakwatch.watch():`` installs for the block; on exit it
    restores ONLY if this block did the installing (an install around a
    whole run survives nested use). Records persist until
    :func:`reset`."""
    already = _installed
    install()
    try:
        yield sys.modules[__name__]
    finally:
        if not already:
            uninstall()


def snapshot():
    """An opaque marker: pass to :func:`live`/:func:`assert_clean` to
    scope the check to resources created AFTER this point (the per-test
    gate's shape)."""
    with _state:
        return _serial[0]


def live(since=0, allow=()):
    """Records of still-live resources created after ``since``,
    excluding creation sites containing any ``allow`` substring."""
    with _state:
        _drain_dead()
        recs = [r for r in _records.values() if r.serial > since]
    out = []
    for r in recs:
        if any(a in r.site for a in allow):
            continue
        if r.is_live():
            out.append(r)
    return sorted(out, key=lambda r: r.serial)


def observed_sites():
    """Every registered creation ``(site, kind)`` pair — comparable 1:1
    with the static inventory of
    ``tools.graftlint.resources.resource_inventory_for_paths`` (the
    runtime ⊆ static subset fixture)."""
    with _state:
        return list(_observed)


def violations():
    with _state:
        return list(_violations)


def reset():
    """Drop recorded observations and violations (live-resource records
    are untouched — forgetting one would hide a real leak from a later
    gate)."""
    with _state:
        _observed.clear()
        _violations.clear()


def report(since=0, allow=()):
    leaks = live(since, allow)
    if not leaks:
        return "leakwatch: no leaked resources"
    out = [f"leakwatch: {len(leaks)} leaked resource(s)"]
    for r in leaks:
        out.append(f"  - {r.describe()}")
    out.append("every acquisition needs a reachable release on every "
               "path: with/try-finally locally, a stop()/close() teardown "
               "for stored resources (docs/ROBUSTNESS.md, graftlint "
               "G022-G024)")
    return "\n".join(out)


def assert_clean(since=0, allow=()):
    """Raise ``AssertionError`` listing every still-live resource created
    after ``since``, and record each in :func:`violations`, so a
    swallowed per-test failure still shows at a later gate."""
    leaks = live(since, allow)
    if leaks:
        msg = report(since, allow)
        with _state:
            for r in leaks:
                _violations.append({"kind": r.kind, "site": r.site})
        raise AssertionError(msg)
