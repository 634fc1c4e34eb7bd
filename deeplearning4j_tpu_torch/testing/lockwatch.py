"""TSAN-lite runtime lock-order validator: the port of
``deeplearning4j_tpu/testing/lockwatch.py`` (the dynamic twin of
graftlint G014).

``install()`` replaces ``threading.Lock`` / ``threading.RLock`` with
watched factories (``threading.Condition``, ``Event``, ``Semaphore`` and
``queue.Queue`` inherit the wrapping automatically: they construct their
locks through those module globals at call time). Every watched lock
records, per OS thread, the set of locks currently held and, on each
blocking acquisition, the ordered pair *(held -> acquired)* into a global
edge set together with the acquisition stack. Observing both ``A -> B``
and ``B -> A`` is a **lock-order inversion** (the schedule-dependent
ABBA deadlock no unit test reproduces) and is reported as a violation
carrying BOTH acquisition stacks (this side and the previously recorded
one), TSAN style.

Lock identity is the lock's **creation site** (``file:line`` of the
frame that called the constructor, stdlib ``threading.py`` frames
skipped), which is how the static analyzer keys its lock nodes
(``tools/graftlint/concurrency.py`` records the creation site of every
``self._lock = threading.Lock()``), so a test can assert the runtime
edges it observed are a SUBSET of the static lock-order graph.

Enablement is the registered ``DL4J_TORCH_LOCKWATCH`` knob (default OFF:
the wrapper costs a dict update per acquire), which the pytest plugin
``testing/pytest_watch.py`` honours. ``tests/conftest.py`` installs only
the JAX package's watchers, so the port's own tests and
``chip_smoke.py``'s phase ``watch`` install this one explicitly
(``install()``, or ``with lockwatch.watch():``) when they use it.

Deliberate scope limits (mirrors of the static rule's false-negative
table):

- locks created BEFORE ``install()`` are invisible. That includes the
  port's module-level locks bound at import, such as
  ``models/_cuda_graph.py``'s ``_LOCK`` and ``ops/_build.py``'s
  ``_lock``; locks created later (instance locks of servers, batchers,
  routers, storages, and the per-device ``RLock`` that every CUDA-graph
  replay and capture takes, made at a device's first program) ARE
  watched;
- same-creation-site pairs (two instances born on one line, e.g. every
  metric's ``self._lock``) are not ordered against each other: without a
  stable instance identity an instance-address order cannot be checked;
- try-acquires (``acquire(False)`` / ``acquire(timeout=...)``) keep the
  held-set bookkeeping but record no edges: a bounded acquire cannot
  deadlock forever, and Condition's internal probing would pollute the
  graph;
- ``Condition.wait``'s release/re-acquire updates the held set but
  records no edge on the re-acquire (the wait protocol forces that
  order; it is not a programmer choice to validate).
"""

from __future__ import annotations

import sys
import threading
import traceback
import warnings
from contextlib import contextmanager
from threading import get_ident

__all__ = ["enabled", "install", "uninstall", "installed", "watch",
           "violations", "edges", "reset", "report", "assert_clean"]

_state = threading.Lock()          # created before install(): always raw
_held: dict = {}                   # tid -> [[label, lock id, depth], ...]
_edges: dict = {}                  # (label_a, label_b) -> edge info dict
_violations: list = []
_reported: set = set()
_installed = False
_active = False
_orig_lock = None
_orig_rlock = None

# frames to skip when attributing a lock's creation site: THIS module and
# the stdlib threading machinery. Exact paths, not name suffixes — a
# suffix match also swallowed frames of files merely *named* like these
# (tests/test_lockwatch.py), collapsing their locks onto one foreign label
_SKIP_FILES = (__file__, threading.__file__)


def enabled():
    """Whether the registered ``DL4J_TORCH_LOCKWATCH`` knob asks for the
    validator (read at call time; default off)."""
    from deeplearning4j_tpu_torch.config import env_flag
    return env_flag("DL4J_TORCH_LOCKWATCH")


def _site_label():
    """``file:line`` of the first frame outside lockwatch/threading — the
    lock's creation site, the identity shared with the static graph."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name not in _SKIP_FILES:
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _stack():
    out = []
    for line in traceback.format_stack():
        if f'"{__file__}"' in line.split(",")[0]:
            continue   # wrapper frames: noise in every report
        out.append(line)
    return "".join(out[-12:])


def _thread_name(tid):
    """Thread name WITHOUT threading.current_thread(): during thread
    bootstrap (Event.set before _active registration) current_thread()
    constructs a _DummyThread, whose __init__ creates a watched Event —
    re-entering the bookkeeping under _state and self-deadlocking. A raw
    registry peek cannot allocate anything."""
    th = threading._active.get(tid)
    return th.name if th is not None else f"tid-{tid}"


def _note_edges(lock):
    """Record ordering edges (and detect inversions) for an imminent
    UNBOUNDED blocking acquire — called BEFORE blocking on the inner
    lock: a schedule that actually lands the ABBA deadlock still reports
    the inversion (warning + violations list) instead of hanging with
    zero diagnostics. Reentrant re-acquires record nothing."""
    tid = get_ident()
    label = lock._lw_label
    tname = _thread_name(tid)
    with _state:
        if not _active:
            return
        held = _held.get(tid, ())
        if any(entry[1] == id(lock) for entry in held):
            return               # reentrant: no ordering claim
        inversions = []
        seen = set()
        for entry in held:
            prior = entry[0]
            if prior == label or prior in seen:
                continue         # same-site pair: no instance order to check
            seen.add(prior)
            pair = (prior, label)
            rev = _edges.get((label, prior))
            if rev is not None and pair not in _reported:
                _reported.add(pair)
                _reported.add((label, prior))
                _violations.append({
                    "locks": pair,
                    "stack": _stack(),
                    "thread": tname,
                    "prior_stack": rev["stack"],
                    "prior_thread": rev["thread"],
                })
                inversions.append((pair, rev["thread"]))
            if pair not in _edges:
                _edges[pair] = {"stack": _stack(), "thread": tname}
    # warn OUTSIDE _state: warning filters may run arbitrary code, and
    # arbitrary code under the bookkeeping lock is how validators deadlock
    for pair, prior_thread in inversions:
        warnings.warn(
            f"lockwatch: lock-order inversion between {pair[0]} and "
            f"{pair[1]} (thread {tname!r} vs {prior_thread!r}) — see "
            "lockwatch.report()", RuntimeWarning, stacklevel=3)


def _note_held(lock):
    """Held-set bookkeeping for a SUCCESSFUL acquire (reentrancy-aware)."""
    tid = get_ident()
    with _state:
        held = _held.setdefault(tid, [])
        for entry in held:
            if entry[1] == id(lock):
                entry[2] += 1
                return
        held.append([lock._lw_label, id(lock), 1])


def _note_release(lock, full=False):
    tid = get_ident()
    with _state:
        held = _held.get(tid, ())
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] == id(lock):
                held[i][2] = 0 if full else held[i][2] - 1
                if held[i][2] <= 0:
                    del held[i]
                return
        # not held by this thread: a plain Lock released by a DIFFERENT
        # thread than its acquirer (legal lock-as-signal handoff). Purge
        # the acquirer's stale entry — leaving it would poison every
        # later edge that thread records
        for other in _held.values():
            for i in range(len(other) - 1, -1, -1):
                if other[i][1] == id(lock):
                    del other[i]
                    return


class _WatchedLock:
    """Proxy over a raw ``_thread`` lock with held-set bookkeeping. Only
    the lock protocol is exposed — ``Condition`` over a plain Lock uses
    its own acquire/release fallbacks, which route through here."""

    _lw_reentrant = False

    def __init__(self, label):
        self._lw_inner = (_orig_rlock if self._lw_reentrant
                          else _orig_lock)()
        self._lw_label = label

    def acquire(self, blocking=True, timeout=-1):
        # truthiness, not identity: acquire(1) is the legacy blocking idiom
        if blocking and timeout == -1:
            # record edges BEFORE blocking: if this acquire IS the deadlock,
            # the inversion report (warning + violations) still lands
            _note_edges(self)
        ok = self._lw_inner.acquire(blocking, timeout)
        if ok:
            _note_held(self)
        return ok

    def release(self):
        _note_release(self)
        self._lw_inner.release()

    def locked(self):
        locked = getattr(self._lw_inner, "locked", None)
        return locked() if locked is not None else False

    def _at_fork_reinit(self):
        # os.register_at_fork handlers (concurrent.futures) call this on
        # whatever threading.Lock() handed them
        self._lw_inner._at_fork_reinit()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<lockwatch {type(self).__name__} {self._lw_label}>"


class _WatchedRLock(_WatchedLock):
    """RLock proxy: adds the protocol ``Condition.wait`` drives."""

    _lw_reentrant = True

    def _is_owned(self):
        return self._lw_inner._is_owned()

    def _release_save(self):
        # Condition.wait fully releases (all recursion levels)
        _note_release(self, full=True)
        return self._lw_inner._release_save()

    def _acquire_restore(self, state):
        self._lw_inner._acquire_restore(state)
        # the wait protocol forces this re-acquire; order is not a choice,
        # so bookkeeping only — no edges
        _note_held(self)


def _lock_factory():
    return _WatchedLock(_site_label())


def _rlock_factory():
    return _WatchedRLock(_site_label())


def installed():
    return _installed


def install():
    """Patch ``threading.Lock``/``RLock`` with watched factories.
    Idempotent. Locks created before this call stay raw (and silent)."""
    global _installed, _active, _orig_lock, _orig_rlock
    if _installed:
        _active = True
        return
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True
    _active = True


def uninstall():
    """Restore the original constructors. Watched locks already handed
    out keep working (bookkeeping continues; edge recording stops)."""
    global _installed, _active
    if not _installed:
        return
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock
    _installed = False
    _active = False


@contextmanager
def watch():
    """``with lockwatch.watch():`` installs for the block; on exit it
    restores ONLY if this block did the installing (an install around a
    whole run survives nested use). Recorded edges and violations
    persist until :func:`reset`."""
    already = _installed
    install()
    try:
        yield sys.modules[__name__]
    finally:
        if not already:
            uninstall()


def violations():
    with _state:
        return list(_violations)


def edges():
    """Observed lock-order edges: ``{(site_a, site_b): info}`` where each
    site is the ``file:line`` creation label — comparable 1:1 with the
    static graph's ``LockNode.created_path``/``created_line``."""
    with _state:
        return dict(_edges)


def reset():
    """Drop recorded edges and violations (held-set bookkeeping for live
    locks is untouched — forgetting a held lock would corrupt release
    accounting)."""
    with _state:
        _edges.clear()
        _violations.clear()
        _reported.clear()


def report():
    """Human-readable violation report: both acquisition stacks per
    inversion, TSAN style."""
    vs = violations()
    if not vs:
        return "lockwatch: no lock-order violations observed"
    out = [f"lockwatch: {len(vs)} lock-order inversion(s)"]
    for i, v in enumerate(vs):
        a, b = v["locks"]   # this side acquired b while holding a
        out.append(f"\n== inversion {i + 1}: locks {a} and {b} are taken "
                   f"in both orders\n-- this acquisition (thread "
                   f"{v['thread']!r}, order {a} -> {b}):\n{v['stack']}"
                   f"-- prior acquisition (thread {v['prior_thread']!r}, "
                   f"order {b} -> {a}):\n{v['prior_stack']}")
    return "\n".join(out)


def assert_clean():
    """Raise ``AssertionError`` with the full two-stack report if any
    inversion was recorded."""
    if violations():
        raise AssertionError(report())
