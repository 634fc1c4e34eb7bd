"""Trace spans: Chrome trace-event JSON, profiler ranges and device time.

``with span("serve.dispatch"):`` records its body as one complete
("ph": "X") event with the OS thread id, so spans of different threads
land on separate tracks when the file is opened in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``.

When a span records. While ``DL4J_TORCH_TRACE_DIR`` is set, and while a
``torch.profiler`` profile is recording (torch's own flag, read only
once torch is loaded). Otherwise ``span()`` returns a shared no-op
object: it reads no clock, creates no CUDA event and allocates nothing.
A span open when a profile starts or stops is dropped whole: no Chrome
event, no histogram observation, and no range in a profile it did not
start in (the profiler itself ends a range still open at its stop).

Where it goes.

- With ``DL4J_TORCH_TRACE_DIR`` set, events accumulate in a bounded
  in-process buffer and :func:`flush` rewrites ``<dir>/trace_<pid>.json``
  with the full buffer (an atexit hook catches runs that never flush).
  Overflow of the buffer (``_MAX_EVENTS``) drops new events and counts
  them in ``trace.dropped_events_total``. An event's ``args`` carry
  ``parent``, the enclosing span on its thread, where it has one.
- While a profile records, each span also opens a profiler range that
  the profiler keeps as an ordinary host op (not a user annotation, so
  the profile gains no device-typed copy of it): the profile's host
  events name the program's phases.
- ``span(name, device=dev)`` on a CUDA device records a CUDA event pair
  on the current stream at enter and exit. The pair is resolved without
  a synchronize, once its end has completed, by
  :func:`resolve_device_spans` (which a reader of the histograms calls
  first), or at a span exit once ``_MAX_PENDING`` pairs wait. The
  elapsed time goes into the histogram ``<name>.device_seconds``. On
  another device the span records host time only. A device span must
  not open inside a CUDA graph capture: an event recorded there times
  nothing.

One clock. Chrome timestamps are microseconds on the clock the profiler
reports (Unix epoch): the monotonic clock plus one offset taken at
import, so a span file and a profile of the same process line up.

This module imports no torch; it reaches torch through ``sys.modules``
once the program has loaded it.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time

from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.obs import metrics

__all__ = ["add_span", "span", "enabled", "recording", "trace_dir", "flush",
           "reset_trace", "event_count", "resolve_device_spans"]

_MAX_EVENTS = 200_000

_EVENTS = []
_EVENTS_LOCK = threading.Lock()
_SEEN_TIDS = set()          # tids that already emitted thread metadata
_PID = os.getpid()
# the profiler's clock (Unix-epoch ns) less the monotonic one
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

_OPEN = threading.local()   # .names: the recording spans open on a thread

_PENDING = collections.deque()   # (start, end, histogram), oldest first
_PENDING_LOCK = threading.Lock()
_MAX_PENDING = 256          # a span exit resolves once this many wait


def trace_dir():
    """The span output directory (``DL4J_TORCH_TRACE_DIR``; empty =
    off), read at call time."""
    return env_str("DL4J_TORCH_TRACE_DIR")


def enabled():
    """Whether spans go to the Chrome trace file."""
    return bool(trace_dir())


def _profiling():
    """Whether a ``torch.profiler`` profile is recording."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def recording():
    """Whether ``span()`` records: the trace file is on or a profile
    records."""
    return enabled() or _profiling()


def _to_us(perf_ns):
    return (perf_ns + _EPOCH_NS) // 1_000


def _append(event, tname):
    tid = event["tid"]
    with _EVENTS_LOCK:
        if len(_EVENTS) >= _MAX_EVENTS:
            metrics.counter(
                "trace.dropped_events_total",
                "Span events dropped because the trace buffer is full").inc()
            return
        if tid not in _SEEN_TIDS:
            _SEEN_TIDS.add(tid)
            _EVENTS.append({"ph": "M", "name": "thread_name", "pid": _PID,
                            "tid": tid, "args": {"name": tname}})
        _EVENTS.append(event)


def _event(name, ts_us, dur_us, args):
    th = threading.current_thread()
    event = {"ph": "X", "name": name, "cat": name.split(".")[0],
             "ts": ts_us, "dur": dur_us, "pid": _PID, "tid": th.native_id}
    if args:
        event["args"] = args
    _append(event, th.name)


def _cuda_index(device):
    """The CUDA device index a device span times on, or None."""
    torch = sys.modules["torch"]
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _record(event, index):
    event.record(sys.modules["torch"].cuda.current_stream(index))


def resolve_device_spans():
    """Record the device time of every pending span whose end event has
    completed into its ``<name>.device_seconds`` histogram, oldest first,
    stopping at the first still running. Never waits for the device."""
    done = []
    with _PENDING_LOCK:
        while _PENDING and _PENDING[0][1].query():
            start, end, hist = _PENDING.popleft()
            done.append((hist, start.elapsed_time(end) / 1e3))
    for hist, seconds in done:
        hist.record(seconds)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "index", "_t0", "_prof", "_range",
                 "_pair", "_parent")

    def __init__(self, name, args, index):
        self.name = name
        self.args = args
        self.index = index

    def __enter__(self):
        names = getattr(_OPEN, "names", None)
        if names is None:
            names = _OPEN.names = []
        self._parent = names[-1] if names else None
        names.append(self.name)
        self._prof = _profiling()
        self._range = None
        if self._prof:
            torch = sys.modules["torch"]
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._pair = None
        if self.index is not None:
            Event = sys.modules["torch"].cuda.Event
            self._pair = (Event(enable_timing=True),
                          Event(enable_timing=True))
            _record(self._pair[0], self.index)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._pair is not None:
            _record(self._pair[1], self.index)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _OPEN.names.pop()
        if _profiling() != self._prof:   # a profile started or stopped
            return False
        if self._pair is not None:
            hist = metrics.histogram(
                self.name + ".device_seconds",
                f"Device time of the {self.name} span on its stream")
            with _PENDING_LOCK:
                _PENDING.append((*self._pair, hist))
                full = len(_PENDING) >= _MAX_PENDING
            if full:
                resolve_device_spans()
        if enabled():
            args = self.args
            if self._parent is not None:
                args = dict(args, parent=self._parent)
            _event(self.name, _to_us(self._t0), (t1 - self._t0) // 1_000,
                   args)
        return False


def span(name, *, device=None, **args):
    """Context manager recording its body as one span (the shared no-op
    object while nothing records). ``device``: the device the body runs
    on; on a CUDA device the span also times the body on its current
    stream, into ``<name>.device_seconds``. ``args`` become the Chrome
    event's ``args`` payload: keep them small, JSON-able host values."""
    if not recording():
        return _NULL_SPAN
    index = None if device is None else _cuda_index(device)
    return _Span(name, args, index)


def add_span(name, start, duration, **args):
    """Record an externally timed span in the trace file: ``start`` is a
    ``time.perf_counter()`` reading and ``duration`` seconds, for code
    that times a stretch itself."""
    if not enabled():
        return
    _event(name, _to_us(int(start * 1e9)), int(duration * 1e6), args)


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
