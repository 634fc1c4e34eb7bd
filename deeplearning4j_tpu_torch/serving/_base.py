"""Queue and lifecycle core of the two serving front ends.

One bounded request deque, one lock, one owner-thread contract; the
subclass loop (the batcher's ``batcher.py``, the continuous decoder's
``decode.py``) decides what to do with popped requests, while capacity,
backpressure, the deadline sweep and the typed drain live here.

Thread contract: ``_enqueue`` is called from any client thread; the
subclass ``_loop`` body runs on ONE daemon thread spawned under the lock
by the same critical section that checked ``_stopping``, so a concurrent
``stop()`` can never be undone by a racing submit. ``stop()`` fails the
queue typed, then joins; loop-owned subclass state is touched only
through ``_after_stop(joined)``, which says whether the join landed.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_float, env_int, env_str
from deeplearning4j_tpu_torch.errors import (ServeDeadlineError,
                                             ServeQueueFullError,
                                             ServeStoppedError)
from deeplearning4j_tpu_torch.testing import faults

__all__ = ["ServingFrontEnd", "int_ladder", "resolve_deadline"]


def int_ladder(knob, default):
    """Parse a comma-separated-int ladder knob (sorted, deduplicated,
    each at least 1); malformed values warn and fall back to
    ``default``."""
    raw = env_str(knob)
    try:
        vs = sorted({max(1, int(p)) for p in raw.split(",") if p.strip()})
    except ValueError:
        warnings.warn(f"{knob}={raw!r} is not a comma-separated int "
                      f"list; using {default}")
        vs = []
    return tuple(vs) if vs else default


_QUEUE_DEPTH = obs.gauge("serve.queue_depth",
                         "Requests waiting in the serving queue")
_REQUESTS = obs.counter("serve.requests_total",
                        "Requests accepted by the serving tier")
_REJECTED = obs.counter(
    "serve.rejected_total",
    "Requests refused with ServeQueueFullError (backpressure)")

OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                     0.875, 1.0)

_REQ_SECONDS = obs.histogram(
    "serve.request_seconds",
    "End-to-end request latency: submit() to result")
_OCCUPANCY = obs.histogram(
    "serve.batch_occupancy",
    "Real-request fraction of each dispatched batch (1.0 = no padding "
    "rows)", buckets=OCCUPANCY_BUCKETS)
_DISCONNECTS = obs.counter(
    "serve.disconnects_total",
    "Requests whose caller disappeared (cancelled future) mid-flight")
_DEADLINE_EXPIRED = obs.counter(
    "serve.deadline_expired_total",
    "Requests swept with ServeDeadlineError before dispatch: their "
    "deadline expired while they were still queued")


def resolve_deadline(deadline_s):
    """Absolute monotonic deadline for a submit: an explicit per-request
    budget (seconds) wins; else the ``DL4J_TORCH_SERVE_DEADLINE_S``
    default (0 = no deadline → ``None``)."""
    if deadline_s is None:
        deadline_s = env_float("DL4J_TORCH_SERVE_DEADLINE_S", minimum=0.0)
        if not deadline_s:
            return None
    return time.monotonic() + float(deadline_s)


class ServingFrontEnd:
    """Bounded request queue + single owner-thread lifecycle."""

    _thread_name = "dl4j-torch-serve"

    def __init__(self, queue_cap=None):
        self._lock = threading.Lock()
        self._more = threading.Condition(self._lock)
        self._pending = deque()
        self._cap = queue_cap if queue_cap is not None \
            else env_int("DL4J_TORCH_SERVE_QUEUE", minimum=1)
        self._stopping = False
        self._draining = False
        self._died = False    # hard crash (kill-replica): no resurrection
        self._thread = None
        # accepted-but-unresolved request count: incremented by _enqueue,
        # decremented by a future done-callback, which covers every
        # resolution path (completion, typed drain, disconnect, deadline
        # sweep). drain() and load() read it.
        self._open = 0
        # qualifier of the kill-replica / slow-replica fault sites; set by
        # a router that fronts several replicas, None for a lone server
        self.replica_id = None

    # ---- subclass surface ----------------------------------------------
    def _loop(self):
        """The owner-thread body (dispatch loop)."""
        raise NotImplementedError

    def _after_stop(self, joined):
        """Called by ``stop()`` after the join attempt; ``joined`` is
        False when the loop thread outlived the timeout, and loop-owned
        state must then be left alone."""

    # ---- queue ---------------------------------------------------------
    def _enqueue(self, r):
        """Admit request ``r`` (an object with ``future`` and
        ``deadline`` attrs) under the capacity/stopping/draining
        contract and make sure the loop thread runs. Returns
        ``r.future``."""
        overflow = faults.fire("queue-overflow") is not None
        with self._lock:
            if self._stopping or self._draining or self._died:
                raise ServeStoppedError(
                    "serving front end is draining" if self._draining
                    else "serving loop died (replica crash)" if self._died
                    else "serving front end is stopped")
            if overflow or len(self._pending) >= self._cap:
                _REJECTED.inc()
                raise ServeQueueFullError(
                    f"serving queue at capacity ({self._cap}); retry "
                    f"later (DL4J_TORCH_SERVE_QUEUE)")
            self._pending.append(r)
            self._open += 1
            _REQUESTS.inc()
            _QUEUE_DEPTH.set(len(self._pending))
            self._more.notify()
            self._ensure_thread_locked()
        # registered outside the lock: an already-resolved future runs
        # its callback synchronously, and _dec_open takes the same lock
        r.future.add_done_callback(self._dec_open)
        return r.future

    def _pop_pending(self):
        """The oldest queued request, or None."""
        with self._lock:
            if not self._pending:
                return None
            r = self._pending.popleft()
            _QUEUE_DEPTH.set(len(self._pending))
            return r

    def _dec_open(self, _future):
        with self._lock:
            self._open -= 1

    def _sweep_expired(self, reqs):
        """The pre-dispatch deadline sweep: fail every request in
        ``reqs`` whose deadline has passed (typed, with the non-positive
        time left in the message) and return the live ones. An expired
        request is never batched, so it costs no device work. Runs
        outside the queue lock (resolving a future fires done-callbacks
        that take it)."""
        now = time.monotonic()
        live = []
        for r in reqs:
            dl = r.deadline
            if faults.fire("expire-deadline") is not None:
                dl = now
            if dl is not None and now >= dl:
                _DEADLINE_EXPIRED.inc()
                if not r.future.done():
                    r.future.set_exception(ServeDeadlineError(
                        f"request deadline expired before dispatch "
                        f"(time left {dl - now:.4f}s <= 0); swept from "
                        f"the queue, no device work done"))
            else:
                live.append(r)
        return live

    # ---- health surface -------------------------------------------------
    def load(self):
        """Requests accepted (queued or dispatching) whose futures have
        not resolved yet: the balancing signal for a router."""
        with self._lock:
            return self._open

    def healthy(self):
        """Accepting work (not stopped or draining) and the loop thread,
        if one was ever spawned, still alive."""
        with self._lock:
            if self._stopping or self._draining or self._died:
                return False
            return self._thread is None or self._thread.is_alive()

    def _replica_fault(self):
        """The ``kill-replica`` / ``slow-replica`` fault sites, fired once
        per dispatch with this replica's id as qualifier. Returns True
        when the loop must die now, without failing its futures (a hard
        crash)."""
        if faults.fire("kill-replica", qual=self.replica_id) is not None:
            with self._lock:
                # a dead replica stays dead: a racing submit must not
                # respawn the loop thread
                self._died = True
            return True
        spec = faults.fire("slow-replica", qual=self.replica_id)
        if spec is not None:
            time.sleep(spec.param_float(0.5))
        return False

    # ---- lifecycle -----------------------------------------------------
    def _ensure_thread_locked(self):
        # caller holds the lock; _stopping was checked in the same
        # critical section, so a racing stop() cannot be undone
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name=self._thread_name, daemon=True)
            self._thread.start()

    def start(self):
        """Explicitly (re)start the loop thread: the only call that
        clears a previous ``stop()`` or ``drain()``."""
        with self._lock:
            self._stopping = False
            self._draining = False
            self._died = False
            self._ensure_thread_locked()
        return self

    def drain(self, timeout=30.0):
        """Graceful drain: from the first moment new submits fail typed
        (``ServeStoppedError``) while every accepted request runs to
        completion; then the loop thread is stopped and joined. Returns
        True when all accepted work finished inside ``timeout``."""
        with self._lock:
            self._draining = True
            self._more.notify_all()
        deadline = time.monotonic() + timeout
        drained = False
        while time.monotonic() < deadline:
            with self._lock:
                drained = self._open == 0
            if drained:
                break
            time.sleep(0.005)
        self.stop(timeout=max(1.0, deadline - time.monotonic()))
        return drained

    def stop(self, timeout=10.0):
        """Queued requests fail typed immediately; the loop exits at its
        next boundary and joins (a warning names a loop that outlives
        ``timeout``)."""
        with self._lock:
            self._stopping = True
            dropped = list(self._pending)
            self._pending.clear()
            _QUEUE_DEPTH.set(0)
            self._more.notify_all()
            t = self._thread
        for r in dropped:
            if not r.future.done():
                r.future.set_exception(
                    ServeStoppedError("serving stopped before this "
                                      "request was dispatched"))
        joined = True
        if t is not None:
            t.join(timeout)
            joined = not t.is_alive()
        if not joined:
            warnings.warn(
                f"{self._thread_name}: loop thread still running "
                f"{timeout}s after stop(); in-flight state left to it")
        self._after_stop(joined)
        return self
