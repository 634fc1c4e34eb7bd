"""Typed, thread-safe metric registry: the one place request latencies,
queue depths and dispatch times live.

Every subsystem records into named metrics here, and these read them
back out: :func:`metrics_snapshot` (the full registry as a JSON-able
dict), :func:`value` (one metric), :func:`prometheus_text` (Prometheus
text exposition, the serving ingress's ``/metrics``) and
:func:`metrics_summary` (the compact count/mean/p50/p99/max digest of
each histogram that a benchmark line can embed).

Metric kinds: :class:`Counter` (monotonic), :class:`Gauge` (last value),
:class:`Histogram` (fixed bucket bounds, cumulative at export, with a
``time()`` context-manager Timer reading the monotonic clock). Names are
dotted (``serve.request_seconds``).

Recording helpers accept host scalars only (python numbers). A caller
that hands a device tensor to ``record()`` forces the device sync itself
and owns that decision; nothing in this module touches torch.

``DL4J_TORCH_METRICS=0`` turns every record into an early-out. The knob
is read at call time. Metric objects are always registered, so a
disabled run still exports a complete (all-zero) catalogue.
"""

from __future__ import annotations

import threading
import time

from deeplearning4j_tpu_torch.config import env_flag

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "timer", "enabled", "value", "metrics_snapshot", "metrics_summary",
           "prometheus_text", "reset_metrics", "TIME_BUCKETS"]

# default bucket bounds (seconds) for duration histograms
TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_REGISTRY = {}          # name -> metric, insertion-ordered
_REGISTRY_LOCK = threading.Lock()


def enabled():
    """Whether recording is on (``DL4J_TORCH_METRICS``, default on)."""
    return env_flag("DL4J_TORCH_METRICS")


class _Metric:
    kind = "metric"

    def __init__(self, name, doc):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()

    def reset(self):
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (events, requests, rows)."""

    kind = "counter"

    def __init__(self, name, doc):
        super().__init__(name, doc)
        self._value = 0

    def inc(self, n=1):
        if not enabled():
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Last observed value (queue depth)."""

    kind = "gauge"

    def __init__(self, name, doc):
        super().__init__(name, doc)
        self._value = 0

    def set(self, v):
        if not enabled():
            return
        # a single assignment is atomic under the interpreter lock; a
        # reader seeing the previous value is correct for a gauge
        self._value = v

    @property
    def value(self):
        return self._value

    def reset(self):
        self._value = 0

    def snapshot(self):
        return self._value


class Histogram(_Metric):
    """Fixed-bound bucket histogram with count/sum/min/max, plus a
    ``time()`` context-manager Timer over the monotonic clock. Bounds are
    upper edges; one overflow bucket (+Inf) is implicit."""

    kind = "histogram"

    def __init__(self, name, doc, buckets=TIME_BUCKETS):
        super().__init__(name, doc)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def record(self, v):
        """Record one host scalar observation."""
        if not enabled():
            return
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def time(self):
        """Context manager recording the wall-clock (monotonic) duration
        of its body into this histogram."""
        return _Timer(self)

    @property
    def count(self):
        with self._lock:
            return self._count

    def quantile(self, q):
        """Bucket-interpolated quantile estimate for ``q`` in [0, 1]
        (Prometheus ``histogram_quantile`` style); None when empty. The
        overflow bucket reports the observed max."""
        with self._lock:
            total = self._count
            if not total:
                return None
            rank = q * total
            seen = 0
            for i, c in enumerate(self._counts):
                if not c:
                    continue
                if seen + c >= rank:
                    if i >= len(self.buckets):
                        return self._max
                    lo = self.buckets[i - 1] if i else 0.0
                    hi = self.buckets[i]
                    frac = (rank - seen) / c
                    # the interpolation must not report beyond observation
                    return min(lo + (hi - lo) * frac, self._max)
                seen += c
            return self._max

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def snapshot(self):
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "buckets": [[b, c] for b, c in
                                zip(self.buckets + ("+Inf",), self._counts)]}

    def summary(self):
        """Compact digest: count/mean/p50/p99/max."""
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
        if not count:
            return {"count": 0}
        return {"count": count,
                "mean": total / count,
                "p50": self.quantile(0.5),
                "p99": self.quantile(0.99),
                "max": mx}


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.record(time.perf_counter() - self._t0)
        return False


def _get_or_create(cls, name, doc, **kw):
    with _REGISTRY_LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = cls(name, doc, **kw)
            _REGISTRY[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} is already registered as a {m.kind}, "
                f"not a {cls.kind}")
        return m


def counter(name, doc=""):
    """Get-or-create the named :class:`Counter`."""
    return _get_or_create(Counter, name, doc)


def gauge(name, doc=""):
    """Get-or-create the named :class:`Gauge`."""
    return _get_or_create(Gauge, name, doc)


def histogram(name, doc="", buckets=TIME_BUCKETS):
    """Get-or-create the named :class:`Histogram` (bounds fixed at first
    creation)."""
    return _get_or_create(Histogram, name, doc, buckets=buckets)


def timer(name, doc=""):
    """Context manager timing its body into histogram ``name``."""
    return histogram(name, doc).time()


def value(name):
    """Current value of a registered metric: number for counter/gauge,
    observation count for a histogram; KeyError for an unknown name."""
    m = _REGISTRY[name]
    return m.count if isinstance(m, Histogram) else m.value


def reset_metrics():
    """Zero every registered metric (registrations stay)."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    for m in metrics:
        m.reset()


def metrics_snapshot():
    """The whole registry as one JSON-able dict, grouped by kind."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    out = {"enabled": enabled(),
           "counters": {}, "gauges": {}, "histograms": {}}
    for m in metrics:
        out[m.kind + "s"][m.name] = m.snapshot()
    return out


def metrics_summary():
    """Counter and gauge values plus each histogram's digest
    (count/mean/p50/p99/max); metrics still at zero are left out."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    out = {}
    for m in metrics:
        if isinstance(m, Histogram):
            s = m.summary()
            if s["count"]:
                out[m.name] = {k: (round(v, 6) if isinstance(v, float) else v)
                               for k, v in s.items()}
        elif m.value:
            out[m.name] = m.value
    return out


def _prom_name(name):
    return "dl4j_torch_" + name.replace(".", "_").replace("-", "_")


def prometheus_text():
    """Prometheus text exposition (version 0.0.4) of the registry: the
    body of the serving ingress's ``/metrics``."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    lines = []
    for m in metrics:
        pname = _prom_name(m.name)
        if m.doc:
            lines.append(f"# HELP {pname} {m.doc}")
        lines.append(f"# TYPE {pname} {m.kind}")
        if isinstance(m, Histogram):
            snap = m.snapshot()
            cum = 0
            for b, c in snap["buckets"]:
                cum += c
                le = "+Inf" if b == "+Inf" else repr(float(b))
                lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{pname}_sum {snap['sum']}")
            lines.append(f"{pname}_count {snap['count']}")
        else:
            lines.append(f"{pname} {m.snapshot()}")
    return "\n".join(lines) + "\n"
