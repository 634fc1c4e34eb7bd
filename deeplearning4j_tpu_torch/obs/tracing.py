"""Host-side trace spans exported as Chrome trace-event JSON.

``with span("serve.dispatch"):`` records a complete ("ph": "X") event
with microsecond monotonic timestamps and the OS thread id, so spans of
different threads land on separate tracks when the file is opened in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``, beside a
``torch.profiler`` capture of the device.

Enablement is ``DL4J_TORCH_TRACE_DIR``: empty (the default) makes
``span()`` return a shared no-op context manager; set, events accumulate
in a bounded in-process buffer and :func:`flush` rewrites
``<dir>/trace_<pid>.json`` with the full buffer (an atexit hook catches
runs that never flush). Overflow of the buffer (``_MAX_EVENTS``) drops
new events and counts them in ``trace.dropped_events_total``.

Nothing here touches torch; every value recorded is host data, so a span
never forces a device sync.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

from deeplearning4j_tpu_torch.config import env_str

__all__ = ["add_span", "span", "enabled", "trace_dir", "flush",
           "reset_trace", "event_count"]

_MAX_EVENTS = 200_000

_EVENTS = []
_EVENTS_LOCK = threading.Lock()
_SEEN_TIDS = set()          # tids that already emitted thread metadata
_PID = os.getpid()


def trace_dir():
    """The span output directory (``DL4J_TORCH_TRACE_DIR``; empty =
    off), read at call time."""
    return env_str("DL4J_TORCH_TRACE_DIR")


def enabled():
    return bool(trace_dir())


def _now_us():
    # monotonic microseconds; Perfetto needs only a consistent epoch
    return time.perf_counter_ns() // 1_000


def _append(event, tname):
    tid = event["tid"]
    with _EVENTS_LOCK:
        if len(_EVENTS) >= _MAX_EVENTS:
            from deeplearning4j_tpu_torch.obs import metrics
            metrics.counter(
                "trace.dropped_events_total",
                "Span events dropped because the trace buffer is full").inc()
            return
        if tid not in _SEEN_TIDS:
            _SEEN_TIDS.add(tid)
            _EVENTS.append({"ph": "M", "name": "thread_name", "pid": _PID,
                            "tid": tid, "args": {"name": tname}})
        _EVENTS.append(event)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        th = threading.current_thread()
        event = {"ph": "X", "name": self.name, "cat": self.name.split(".")[0],
                 "ts": self._t0, "dur": t1 - self._t0,
                 "pid": _PID, "tid": th.native_id}
        if self.args:
            event["args"] = self.args
        _append(event, th.name)
        return False


def span(name, **args):
    """Context manager recording its body as one complete trace event
    (no-op singleton when tracing is off). ``args`` become the event's
    ``args`` payload: keep them small, JSON-able host values."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, args)


def add_span(name, start, duration, **args):
    """Record an externally timed span: ``start`` is a
    ``time.perf_counter()`` reading and ``duration`` seconds (the clock
    ``span`` reads), for code that times a stretch itself."""
    if not enabled():
        return
    th = threading.current_thread()
    event = {"ph": "X", "name": name, "cat": name.split(".")[0],
             "ts": int(start * 1e6), "dur": int(duration * 1e6),
             "pid": _PID, "tid": th.native_id}
    if args:
        event["args"] = args
    _append(event, th.name)


def event_count():
    with _EVENTS_LOCK:
        return len(_EVENTS)


def reset_trace():
    """Drop every buffered event."""
    with _EVENTS_LOCK:
        _EVENTS.clear()
        _SEEN_TIDS.clear()


def flush(path=None):
    """Rewrite the trace file with the full buffer. Returns the path
    written, or None when tracing is off and no explicit ``path`` was
    given."""
    if path is None:
        d = trace_dir()
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace_{_PID}.json")
    with _EVENTS_LOCK:
        events = list(_EVENTS)
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)   # readers never see a half-written trace
    return path


@atexit.register
def _flush_at_exit():
    # a run that never flushed still gets its spans
    if enabled() and event_count():
        try:
            flush()
        except OSError:
            pass
