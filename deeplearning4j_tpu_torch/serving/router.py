"""Health-checked router over serving replicas: balancing, shedding,
failover.

One :class:`ReplicaRouter` fronts N replicas, ``InferenceServer`` or
``ContinuousLM`` front ends: anything with ``submit()``, ``load()``,
``healthy()`` and ``evict_pending()`` (``serving/_base.py``). Replicas
over one model share its parameters, never copies of them. On the card
each ``ContinuousLM`` replica holds its own slot pool, and the captured
graphs bound to it, since a graph binds storage: ``warm_start`` captures
every replica's whole inventory before traffic, so serving, a failover
included, captures nothing (``models/_cuda_graph.capture_count``).

Three jobs, all driven by one heartbeat thread
(``DL4J_TORCH_ROUTER_HEARTBEAT_S``):

- balancing: each submit goes to the healthy replica with the smallest
  ``load()``, its accepted and unresolved requests (queued and
  admitted), so a replica stuck on a slow dispatch stops drawing work;
- the SLO shed gate: the heartbeat keeps a rolling p99 of
  ``serve.request_seconds`` (the histogram's bucket counts since the
  last beat); while it exceeds ``DL4J_TORCH_SERVE_SLO_MS``, new submits
  fail at once with ``ServeQueueFullError`` (429 and Retry-After at the
  ingress, ``serve.shed_total``), which keeps the p99 of admitted work
  bounded;
- failover: when a replica stops reporting ``healthy()`` (the
  ``kill-replica`` fault, a crashed loop thread), its queued requests
  that were not admitted yet are evicted and dispatched to the
  survivors: the caller's future resolves from another replica and no
  request is lost. Requests the dead replica had admitted may have
  produced tokens, so they are not run again (at-most-once): their
  futures fail with ``ServeReplicaDeadError`` (retryable, 502 at the
  ingress) and the caller decides whether to resubmit.
  ``serve.replica_failovers_total`` counts dead-replica events;
  ``router.replicas_healthy`` is the live-replica gauge.

Lock discipline: one router lock guards the health table, the
outstanding-request map and the rolling p99; futures are never resolved
and replica methods never called while holding it (a replica takes its
own lock, and resolving a future runs its callbacks at once).
"""

from __future__ import annotations

import threading
import warnings
from concurrent.futures import Future

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_float
from deeplearning4j_tpu_torch.errors import (ServeQueueFullError,
                                             ServeReplicaDeadError,
                                             ServeStoppedError)
from deeplearning4j_tpu_torch.serving._base import _REQ_SECONDS

__all__ = ["ReplicaRouter"]

_SHED = obs.counter(
    "serve.shed_total",
    "Requests refused at the router because the rolling p99 of "
    "serve.request_seconds exceeded DL4J_TORCH_SERVE_SLO_MS (429 at the "
    "ingress, Retry-After set)")
_FAILOVERS = obs.counter(
    "serve.replica_failovers_total",
    "Dead-replica failovers: the heartbeat found a replica unhealthy and "
    "moved its requests that were not admitted yet to the survivors")
_REPLICAS_HEALTHY = obs.gauge(
    "router.replicas_healthy",
    "Replicas passing the router's heartbeat health check")

# a shed decision needs at least this many completions in the heartbeat
# window: a p99 of one or two samples would flap the gate
_SLO_MIN_SAMPLES = 5


class _Outstanding:
    """One routed request: the caller's future and what a re-dispatch
    needs if its replica dies before admitting it."""

    __slots__ = ("client", "args", "kwargs", "replica_idx")

    def __init__(self, client, args, kwargs, replica_idx):
        self.client = client
        self.args = args
        self.kwargs = kwargs
        self.replica_idx = replica_idx


class ReplicaRouter:
    """Balancer by load and health checker over serving replicas.

    ``replicas`` are front ends of one kind (failover re-dispatches with
    the original arguments, so their ``submit()`` signatures must
    match). :meth:`submit` forwards ``*args, **kwargs`` to the chosen
    replica's ``submit`` and returns a future that outlives that
    replica's death while the request was not admitted yet."""

    def __init__(self, replicas, *, heartbeat_s=None, slo_ms=None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self._replicas = list(replicas)
        for i, rep in enumerate(self._replicas):
            rep.replica_id = i
        self._hb_s = heartbeat_s if heartbeat_s is not None \
            else env_float("DL4J_TORCH_ROUTER_HEARTBEAT_S", minimum=0.01)
        self._slo_ms = slo_ms if slo_ms is not None \
            else env_float("DL4J_TORCH_SERVE_SLO_MS", minimum=0.0)
        self._lock = threading.Lock()
        self._healthy = [True] * len(self._replicas)
        self._outstanding = {}        # replica future -> _Outstanding
        self._p99 = None              # rolling window p99 (seconds)
        self._hist_prev = None        # request_seconds bucket counts
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._stopping = False
        _REPLICAS_HEALTHY.set(len(self._replicas))

    # ---- client surface ------------------------------------------------
    @property
    def replicas(self):
        return tuple(self._replicas)

    def submit(self, *args, **kwargs):
        """Route one request to the healthy replica with the least load;
        returns a ``concurrent.futures.Future``. Raises
        ``ServeQueueFullError`` when the shed gate is closed or no
        healthy replica has queue room, ``ServeStoppedError`` when no
        replica accepts work, and a replica's own validation error
        (``ValueError``) at once."""
        self._shed_gate()
        self._ensure_heartbeat()
        client = Future()
        exc = self._dispatch(client, args, kwargs, exclude=())
        if exc is not None:
            raise exc
        return client

    def healthy_count(self):
        """Replicas passing the health check as of the last heartbeat."""
        with self._lock:
            return sum(self._healthy)

    def healthy(self):
        """At least one healthy replica and not stopping: the ingress's
        ``/readyz``."""
        with self._lock:
            return not self._stopping and any(self._healthy)

    def load(self):
        """Accepted and unresolved requests across the replicas."""
        return sum(rep.load() for rep in self._replicas)

    def rolling_p99(self):
        """The shed gate's rolling p99 of ``serve.request_seconds``
        (seconds; None until a window with enough completions closed)."""
        with self._lock:
            return self._p99

    def warm_start(self, *args, **kwargs):
        """``warm_start`` of every replica (on the card each captures its
        own inventory over its own pool); the replicas' results."""
        return [rep.warm_start(*args, **kwargs) for rep in self._replicas]

    # ---- dispatch ------------------------------------------------------
    def _pick_order(self, exclude):
        with self._lock:
            idxs = [i for i in range(len(self._replicas))
                    if self._healthy[i] and i not in exclude]
        # load() takes each replica's own lock: outside the router's
        return sorted(idxs, key=lambda i: self._replicas[i].load())

    def _dispatch(self, client, args, kwargs, exclude):
        """Try the replicas in order of load; register the outstanding
        record and return None on success, else return the typed error
        (a first dispatch raises it, a failover fails the future with
        it). A validation error (``ValueError``) propagates at once: the
        request is malformed for every replica."""
        last = None
        for i in self._pick_order(exclude):
            rep = self._replicas[i]
            try:
                f = rep.submit(*args, **kwargs)
            except ServeQueueFullError as e:
                last = e
                continue
            except ServeStoppedError as e:
                last = e
                with self._lock:
                    self._healthy[i] = False
                continue
            with self._lock:
                self._outstanding[f] = _Outstanding(client, args, kwargs, i)
            f.add_done_callback(self._on_replica_done)
            return None
        return last if last is not None else ServeStoppedError(
            "no healthy replica is accepting work")

    def _on_replica_done(self, f):
        with self._lock:
            rec = self._outstanding.pop(f, None)
        if rec is None or rec.client.done():
            return   # failed over already, or resolved elsewhere
        if f.cancelled():
            rec.client.cancel()
        elif f.exception() is not None:
            rec.client.set_exception(f.exception())
        else:
            rec.client.set_result(f.result())

    # ---- SLO shed gate -------------------------------------------------
    def _shed_gate(self):
        if not self._slo_ms:
            return
        with self._lock:
            p99 = self._p99
        if p99 is not None and p99 * 1000.0 > self._slo_ms:
            _SHED.inc()
            raise ServeQueueFullError(
                f"SLO shed: rolling p99 {p99 * 1000.0:.1f}ms over the last "
                f"heartbeat window exceeds DL4J_TORCH_SERVE_SLO_MS="
                f"{self._slo_ms:g}ms; retry after backing off")

    def _update_p99(self):
        snap = _REQ_SECONDS.snapshot()
        counts = [c for _, c in snap["buckets"]]
        with self._lock:
            prev, self._hist_prev = self._hist_prev, counts
        if prev is None or len(prev) != len(counts):
            return
        delta = [c - p for c, p in zip(counts, prev)]
        if sum(delta) < _SLO_MIN_SAMPLES:
            # too few completions this window to estimate a tail: open
            # the gate rather than shed on noise
            with self._lock:
                self._p99 = None
            return
        p99 = _delta_quantile(delta, 0.99, _REQ_SECONDS.buckets,
                              snap["max"])
        with self._lock:
            self._p99 = p99

    # ---- heartbeat / failover ------------------------------------------
    def _ensure_heartbeat(self):
        with self._lock:
            if self._stopping:
                raise ServeStoppedError("router is stopped")
            if self._hb_thread is None or not self._hb_thread.is_alive():
                self._hb_stop.clear()
                self._hb_thread = threading.Thread(
                    target=self._heartbeat_loop,
                    name="dl4j-torch-serve-router", daemon=True)
                self._hb_thread.start()

    def _heartbeat_loop(self):
        while not self._hb_stop.wait(self._hb_s):   # stop() lands here
            self.check()

    def check(self):
        """One heartbeat: refresh each replica's health (failing over a
        replica that died since the last beat), the healthy gauge and the
        rolling p99. The heartbeat thread calls it every
        ``DL4J_TORCH_ROUTER_HEARTBEAT_S``; a caller that parks the heartbeat
        (a long ``heartbeat_s``) calls it for a beat at a point of its
        choosing."""
        for i, rep in enumerate(self._replicas):
            ok = rep.healthy()
            with self._lock:
                was = self._healthy[i]
                self._healthy[i] = ok
            if ok:
                continue
            # fail over on the transition down, and keep sweeping an
            # unhealthy replica that still holds routed work: a submit
            # that raced the health flip must not be stranded
            if was or self._has_outstanding(i):
                self._failover(i, first=was)
        with self._lock:
            n = sum(self._healthy)
        _REPLICAS_HEALTHY.set(n)
        self._update_p99()

    def _has_outstanding(self, i):
        with self._lock:
            return any(rec.replica_idx == i
                       for rec in self._outstanding.values())

    def _failover(self, i, first=True):
        rep = self._replicas[i]
        if first:
            _FAILOVERS.inc()
        # requests not admitted yet: the dead loop can no longer pop
        # them, so they move to the survivors and nothing is lost
        moved = 0
        for r in rep.evict_pending():
            with self._lock:
                rec = self._outstanding.pop(r.future, None)
            if rec is None or rec.client.done():
                continue   # submitted around the router, or resolved
            exc = self._dispatch(rec.client, rec.args, rec.kwargs,
                                 exclude=(i,))
            if exc is not None:
                rec.client.set_exception(exc)
            else:
                moved += 1
            r.future.cancel()   # the dead replica's copy is now inert
        # what is still outstanding on i was admitted (or died between pop
        # and admit): it may have produced tokens, so at-most-once forbids
        # running it again; it fails typed and retryable
        with self._lock:
            dead = [(f, rec) for f, rec in self._outstanding.items()
                    if rec.replica_idx == i]
            for f, _ in dead:
                del self._outstanding[f]
        for f, rec in dead:
            if not rec.client.done():
                rec.client.set_exception(ServeReplicaDeadError(
                    f"replica {i} died with this request admitted; it may "
                    f"have partly run, so it is not run again "
                    f"(at-most-once); resubmitting it as a new request is "
                    f"safe"))
            # the dead loop never resolves its side: cancelling it brings
            # the replica's open-request count to zero (drain())
            f.cancel()
        if first and (moved or dead):
            warnings.warn(
                f"serving replica {i} failed over: {moved} queued "
                f"request(s) moved to survivors, {len(dead)} admitted "
                f"request(s) failed retryable", RuntimeWarning)

    # ---- lifecycle -----------------------------------------------------
    def _stop_heartbeat(self, timeout):
        with self._lock:
            t = self._hb_thread
            self._hb_thread = None
        self._hb_stop.set()
        if t is not None and t.is_alive():
            t.join(timeout)

    def drain(self, timeout=30.0):
        """Graceful drain: the heartbeat stops (no failover fires against
        replicas that drain on purpose), then every replica drains at
        once: new submits fail typed while admitted work completes.
        True when every replica drained within ``timeout``."""
        with self._lock:
            self._stopping = True
        self._stop_heartbeat(timeout=5.0)
        results = [False] * len(self._replicas)

        def _drain_one(i, rep):
            results[i] = rep.drain(timeout=timeout)

        ts = [threading.Thread(target=_drain_one, args=(i, rep),
                               name=f"dl4j-torch-router-drain-{i}",
                               daemon=True)
              for i, rep in enumerate(self._replicas)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout + 5.0)
        return all(results) and not any(t.is_alive() for t in ts)

    def stop(self, timeout=10.0):
        """Hard stop: the heartbeat, then every replica's ``stop()``
        (their queued work fails typed)."""
        with self._lock:
            self._stopping = True
        self._stop_heartbeat(timeout=5.0)
        for rep in self._replicas:
            rep.stop(timeout=timeout)
        return self


def _delta_quantile(delta, q, bounds, observed_max):
    """Quantile ``q`` of a window's bucket-count deltas, interpolated in
    its bucket as ``Histogram.quantile`` does for all-time counts.
    ``delta`` has one entry a bound plus the overflow bucket, which
    reports the all-time observed max: conservative for a window, the
    right bias for a shed gate."""
    total = sum(delta)
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    for i, c in enumerate(delta):
        if not c:
            continue
        if seen + c >= rank:
            if i >= len(bounds):
                return observed_max
            lo = bounds[i - 1] if i else 0.0
            hi = bounds[i]
            est = lo + (hi - lo) * ((rank - seen) / c)
            return est if observed_max is None else min(est, observed_max)
        seen += c
    return observed_max
