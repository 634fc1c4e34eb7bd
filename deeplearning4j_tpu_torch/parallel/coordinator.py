"""Host-side collective coordinator: the port of
``deeplearning4j_tpu/parallel/coordinator.py``, the pure-Python twin of
the native module (``native/src/collective.cpp``, bound by
``nativelib.py``).

It speaks the native module's wire protocol exactly (magic 'DLCV', an
op byte, a tag, a float32 payload; ops 1-9), so native and Python
endpoints of either package interoperate. ``start_coordinator`` and
``connect`` prefer the native implementation and fall back to this one
when the native library cannot be built or loaded, as the reference's
do; each server and client says which one it is (``kind``: ``"native"``
or ``"python"``), and every fallback counts in
``collective.native_fallbacks_total``.

Roles: barrier, allreduce and broadcast are the Spark driver's
broadcast/aggregate control plane across hosts (the training master's);
ps_init, ps_push and ps_pull are the Aeron parameter server's
asynchronous mode (the parameter-server wrapper's). Everything here is
host code on float32 numpy payloads: a device tensor is copied to the
host by its caller.

Fault model (``docs/ROBUSTNESS.md``): every collective round carries a
deadline (``DL4J_TORCH_COLLECTIVE_TIMEOUT``): a round that cannot
complete fails on every waiter with a typed error instead of hanging
the survivors; a participant whose connection dies while a round is
still open fails the round at once (``PeerDeadError``) without waiting
out the deadline. Clients connect with retry and exponential backoff
and read every response under a deadline, so a dead coordinator raises
instead of blocking forever. Under ``DL4J_TORCH_ELASTIC`` the Python
coordinator also serves re-form waves (``OP_REFORM``): the survivors
and joiners of a world agree on a new membership epoch, contiguous
ranks and a world size.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch import nativelib, obs
from deeplearning4j_tpu_torch.config import env_flag, env_float, env_int
from deeplearning4j_tpu_torch.errors import (CollectiveError,
                                             CollectiveTimeoutError,
                                             PeerDeadError, WorldChangedError)
from deeplearning4j_tpu_torch.testing import faults

MAGIC = 0x444C4356

_REQ_HDR = struct.Struct("<IBIH")   # magic, op, worker, tag_len
_LEN = struct.Struct("<Q")
_RESP_HDR = struct.Struct("<BQ")    # status, payload_len

OP_JOIN, OP_BARRIER, OP_ALLREDUCE, OP_BCAST_SEND, OP_BCAST_RECV = 1, 2, 3, 4, 5
OP_PS_PUSH, OP_PS_PULL, OP_PS_INIT = 6, 7, 8
OP_REFORM = 9

# the worker id a participant with no prior rank sends in OP_REFORM (a
# scale-up joiner): sorts after every survivor, so survivors keep their
# relative rank order across a re-form
JOINER_ID = 0xFFFFFFFF

# wire status codes (native collective.cpp treats any nonzero as failure;
# the Python twin additionally distinguishes the failure kind)
STATUS_OK, STATUS_FAIL, STATUS_ROUND_FAILED = 0, 1, 2
STATUS_TIMEOUT, STATUS_PEER_DEAD, STATUS_WORLD_CHANGED = 3, 4, 5

_STATUS_ERRORS = {STATUS_ROUND_FAILED: CollectiveError,
                  STATUS_TIMEOUT: CollectiveTimeoutError,
                  STATUS_PEER_DEAD: PeerDeadError,
                  STATUS_WORLD_CHANGED: WorldChangedError}

# coordinator-side collective observability (docs/OBSERVABILITY.md): one
# record per ROUND at its terminal transition (complete or failed), so
# failed/timed-out rounds land in the same latency histogram as healthy
# ones and carry their own status counters
_OBS_ROUND_SECONDS = obs.histogram(
    "collective.round_seconds",
    "Collective round latency, first arrival to completion or failure "
    "(timed-out and failed rounds included)")
_OBS_ROUNDS = obs.counter("collective.rounds_total",
                          "Collective rounds that reached a terminal state")
_OBS_TIMEOUTS = obs.counter(
    "collective.timeouts_total",
    "Collective rounds failed by the per-round deadline")
_OBS_DEAD_PEERS = obs.counter(
    "collective.dead_peers_total",
    "Rounds failed because a joined participant's connection died")
_OBS_CONNECT_RETRIES = obs.counter(
    "collective.connect_retries_total",
    "Collective client connect attempts that failed and were retried")
_OBS_NATIVE_FALLBACKS = obs.counter(
    "collective.native_fallbacks_total",
    "Coordinators and clients that asked for the native implementation "
    "and got the Python twin (the native library unavailable)")

# elastic-membership observability (docs/ROBUSTNESS.md §7): the re-form
# wave is coordinator-owned, so its latency histogram and the join/leave
# event counters are recorded HERE, at wave commit — the one place that
# sees both the old membership and the new one
_OBS_REFORM_SECONDS = obs.histogram(
    "elastic.reform_seconds",
    "Elastic re-form wave latency, first OP_REFORM arrival to commit "
    "(failed waves included — their latency IS the deadline)")
_OBS_JOIN_EVENTS = obs.counter(
    "elastic.events_total.join",
    "Participants that entered the world at a re-form commit (scale-up "
    "joiners plus the initial wave's members)")
_OBS_LEAVE_EVENTS = obs.counter(
    "elastic.events_total.leave",
    "Participants that left the world at a re-form commit (dead peers, "
    "expelled stragglers, and members that missed the wave)")
_OBS_WORLD_SIZE = obs.gauge(
    "elastic.world_size",
    "World size committed by the most recent elastic re-form wave")


def _read_full(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _retry_connect(factory, retries, what):
    """Run ``factory`` with ``retries`` extra attempts and exponential
    backoff — collective workers race the coordinator process at startup,
    and one refused TCP handshake must not kill a whole training job."""
    delay = 0.05
    for attempt in range(retries + 1):
        try:
            return factory()
        except (OSError, RuntimeError):
            if attempt >= retries:
                raise
            _OBS_CONNECT_RETRIES.inc()
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
    raise RuntimeError(f"unreachable: {what}")   # pragma: no cover


class _Entry:
    def __init__(self):
        self.acc = None
        self.arrived = 0
        self.delivered = 0
        self.complete = threading.Event()
        self.error = None   # set on failure: whole round fails
        self.status = STATUS_ROUND_FAILED   # wire status when error is set
        self.t0 = time.perf_counter()   # round latency epoch (first arrival)
        self.recorded = False           # latency recorded exactly once
        self.wids = set()   # worker ids that arrived (expulsion inventory)
        self.expel = False  # elastic: timeout expels the non-arrived ids


class _Reform:
    """One open elastic re-form wave (state machine in
    docs/ROBUSTNESS.md §7): OP_REFORM arrivals accumulate until the wave
    SETTLES (no new arrival for a fraction of the deadline) or the
    deadline expires, then the closer thread commits the new membership
    epoch — every arrival learns its new rank and the agreed world size
    from the coordinator, instead of each survivor guessing."""

    def __init__(self, now):
        self.arrivals = []            # (sock, old worker id) in wire order
        self.assigned = {}            # sock -> new rank (set at commit)
        self.complete = threading.Event()
        self.error = None
        self.status = STATUS_ROUND_FAILED
        self.t0 = now                 # wave latency epoch (first arrival)
        self.last = now               # most recent arrival (settle clock)
        self.epoch = 0                # committed membership epoch
        self.n = 0                    # committed world size
        self.drivers = 0              # arrivals that carry the driver tag


class PyCoordinator:
    """Pure-Python coordinator server (one thread a connection).

    ``timeout`` is the per-round deadline in seconds (default: the
    ``DL4J_TORCH_COLLECTIVE_TIMEOUT`` knob): a barrier/allreduce/broadcast
    round not completed within it fails on every waiter with a typed
    timeout status. A joined worker whose connection drops while rounds
    are still open fails those rounds (and all subsequent ones, until a
    worker re-JOINs under the same id) immediately with a peer-death
    status — detection relies on the OS closing the dead process's
    sockets; a silent network partition is covered by the deadline.

    Wave reuse: ANY disconnect of a joined worker (graceful close
    included) marks its id departed, and rounds started while an id is
    departed fail fast. Recovery is a FRESH WAVE: every client (survivors
    included) reconnects, which re-JOINs all ids and resets every
    per-client round counter. A replacement joining alongside surviving
    old clients is NOT enough — the survivors' round tags (``tag#r``)
    would never match the newcomer's (``tag#0``), so mixed-wave rounds
    only ever fail by deadline. Connect every client first, then do
    rounds.
    """

    kind = "python"

    def __init__(self, n_workers, port=0, timeout=None, elastic=None,
                 min_workers=None, reform_timeout=None):
        self.n_workers = n_workers
        self.timeout = env_float("DL4J_TORCH_COLLECTIVE_TIMEOUT",
                                 minimum=0.001) if timeout is None else timeout
        # elastic membership (docs/ROBUSTNESS.md §7): off by default —
        # the classic fixed-world wave contract above stays byte-for-byte
        # identical unless the caller (or DL4J_TORCH_ELASTIC) opts in
        self.elastic = env_flag("DL4J_TORCH_ELASTIC") if elastic is None \
            else bool(elastic)
        self.min_workers = env_int("DL4J_TORCH_ELASTIC_MIN_WORKERS",
                                   minimum=1) if min_workers is None \
            else max(1, int(min_workers))
        self.reform_timeout = env_float(
            "DL4J_TORCH_REFORM_TIMEOUT", minimum=0.001) \
            if reform_timeout is None else reform_timeout
        self.epoch = 0            # membership epoch (bumped per re-form)
        self._entries = {}
        self._lock = threading.Lock()
        self._ps_params = None
        self._stopping = False
        self._conns = set()
        self._peers = {}   # conn -> worker id (recorded at JOIN)
        self._peer_conns = {}   # worker id -> its CURRENT conn (last JOIN)
        self._dead = set()  # worker ids whose connection died
        self._join_epoch = {}   # conn -> epoch it JOINed/re-formed under
        self._reform = None     # the open _Reform wave, if any
        self._reform_thread = None   # its closer thread (joined in stop())
        coord = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with coord._lock:
                    coord._conns.add(self.request)
                try:
                    while True:
                        coord._serve_one(self.request)
                except (ConnectionError, OSError):
                    pass
                finally:
                    coord._on_disconnect(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        # a short poll: stop() returns within it, not the default 0.5 s
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._thread.start()

    def _entry(self, tag):
        with self._lock:
            e = self._entries.get(tag)
            if e is None:
                e = _Entry()
                self._entries[tag] = e
            return e

    def _finish(self, tag, e):
        with self._lock:
            e.delivered += 1
            # n_workers is read under the lock: a re-form commit may
            # change it concurrently with a round's delivery accounting
            if e.delivered >= self.n_workers:
                self._entries.pop(tag, None)

    @staticmethod
    def _round_done(e, status=STATUS_OK):
        """Record a round's terminal transition exactly once: latency into
        the round histogram (failures included — a timed-out round's
        latency IS the deadline, and its absence would bias the
        distribution), plus the per-status failure counters. Callers hold
        the coordinator lock; metric locks never nest back into it."""
        if e.recorded:
            return
        e.recorded = True
        dur = time.perf_counter() - e.t0
        _OBS_ROUND_SECONDS.record(dur)
        _OBS_ROUNDS.inc()
        if status == STATUS_TIMEOUT:
            _OBS_TIMEOUTS.inc()
        elif status == STATUS_PEER_DEAD:
            _OBS_DEAD_PEERS.inc()
        obs.add_span("collective.round", e.t0, dur, status=status)

    def _fail_entry(self, tag, e, status, message):
        """Fail a round (caller holds the lock): every current waiter of
        the entry sees the error instead of the result. The entry is
        popped EAGERLY — a failed round's participant may never arrive to
        drive delivered up to n_workers, and a leaked entry would both
        hold its acc buffer forever and hand its stale error to a future
        client that reuses the tag (a replacement worker's per-client
        round counters restart at 0). A straggler arriving after the pop
        starts a fresh entry and fails by deadline/dead-peer instead."""
        if e.error is None:
            e.error = message
            e.status = status
        self._round_done(e, status)
        e.complete.set()
        self._entries.pop(tag, None)

    def _on_disconnect(self, conn):
        """A connection closed: if its worker had JOINed and we are not
        shutting down, mark it dead and fail every still-open round — the
        expected participant set can no longer complete them."""
        with self._lock:
            self._conns.discard(conn)
            self._join_epoch.pop(conn, None)
            wid = self._peers.pop(conn, None)
            if self._stopping or wid is None:
                return
            if self._peer_conns.get(wid) is not conn:
                # a STALE connection of an id that already re-JOINed on a
                # fresh one (the old wave's socket lingering until GC/late
                # close): marking the id dead here would poison the
                # re-formed wave — the exact leak-vs-re-form hazard the
                # teardown contract exists for (docs/ROBUSTNESS.md §6)
                return
            self._peer_conns.pop(wid, None)
            self._dead.add(wid)
            for tag, e in list(self._entries.items()):
                if not e.complete.is_set():
                    self._fail_entry(
                        tag, e, STATUS_PEER_DEAD,
                        f"peer death: worker {wid} disconnected while round "
                        f"{tag!r} was open ({e.arrived}/{self.n_workers} "
                        "arrived); failing the round for all survivors")

    def _dead_check(self, tag, e):
        """Fail an open round at arrival time when known-dead peers make
        completion impossible (caller holds the lock)."""
        if self._dead and not e.complete.is_set():
            self._fail_entry(
                tag, e, STATUS_PEER_DEAD,
                f"peer death: worker(s) {sorted(self._dead)} are gone, so "
                f"round {tag!r} can never gather {self.n_workers} "
                "participants")

    def _await_round(self, tag, e):
        """Deadline-bounded wait for a round; on expiry the whole round is
        failed so every other waiter wakes with the same typed error."""
        if not e.complete.wait(self.timeout):
            with self._lock:
                # re-check under the lock: the round may have completed in
                # the instant after the wait expired — a completed round
                # must never be retroactively failed for anyone
                if not e.complete.is_set():
                    self._fail_entry(
                        tag, e, STATUS_TIMEOUT,
                        f"collective round {tag!r} timed out after "
                        f"{self.timeout:g}s with {e.arrived}/{self.n_workers} "
                        "participants")
                    if self.elastic and e.expel:
                        self._expel_laggards(e)

    def _expel_laggards(self, e):
        """Elastic only (caller holds the lock): a joined worker that
        never arrived in a round that just blew its deadline is a
        straggler — treat it as DEPARTED so the survivors re-form around
        it instead of retrying the round with it forever. Its connection
        is shut down (its own late request then fails with
        ``ConnectionError``, telling it it was expelled) and its id is
        marked dead, exactly as if the OS had closed its socket."""
        for wid in sorted(set(self._peer_conns) - e.wids):
            conn = self._peer_conns.pop(wid, None)
            self._dead.add(wid)
            if conn is None:
                continue
            self._peers.pop(conn, None)
            self._join_epoch.pop(conn, None)
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _world_guard(self, sock):
        """Elastic only: the stale-wave check every round op runs at
        arrival. Returns a failure message when this connection's rounds
        can never complete again — a re-form wave is open (the epoch is
        closing) or the epoch already moved on without it — else None."""
        if not self.elastic:
            return None
        with self._lock:
            if self._reform is not None:
                return (f"world changed: a re-form wave is open under "
                        f"membership epoch {self.epoch}; tear down and "
                        "re-join it (OP_REFORM on a fresh connection)")
            joined = self._join_epoch.get(sock, self.epoch)
            if joined != self.epoch:
                return (f"world changed: this connection joined under "
                        f"membership epoch {joined} but the world re-formed "
                        f"at epoch {self.epoch}; tear down and re-join "
                        "(OP_REFORM on a fresh connection)")
        return None

    def _stop_requested(self):
        # read under the lock: stop() sets the flag under it, and handler
        # threads consult it after every round wait (the lock pairs the
        # write with its readers)
        with self._lock:
            return self._stopping

    @staticmethod
    def _respond(sock, status, payload=b""):
        sock.sendall(_RESP_HDR.pack(status, len(payload)) + payload)

    def _serve_one(self, sock):
        magic, op, worker, tag_len = _REQ_HDR.unpack(_read_full(sock, _REQ_HDR.size))
        if magic != MAGIC:
            raise ConnectionError("bad magic")
        tag = _read_full(sock, tag_len).decode() if tag_len else ""
        (plen,) = _LEN.unpack(_read_full(sock, _LEN.size))
        payload = np.frombuffer(_read_full(sock, plen), np.float32) if plen else \
            np.zeros(0, np.float32)

        if op == OP_JOIN:
            with self._lock:
                self._peers[sock] = worker
                # a rejoin under a departed id clears its mark; full rounds
                # become possible again once EVERY id has rejoined (fresh
                # wave — see the class docstring's wave-reuse contract).
                # The id's CURRENT conn is recorded so a superseded
                # connection's late disconnect cannot re-mark it dead.
                self._peer_conns[worker] = sock
                self._dead.discard(worker)
                self._join_epoch[sock] = self.epoch
                # snapshot under the lock: a re-form commit rewrites
                # n_workers from the closer thread
                world = self.n_workers
            self._respond(sock, 0, np.float32(world).tobytes())
        elif op == OP_REFORM:
            self._serve_reform(sock, worker, tag)
        elif op in (OP_BARRIER, OP_ALLREDUCE):
            stale = self._world_guard(sock)
            if stale is not None:
                self._respond(sock, STATUS_WORLD_CHANGED, stale.encode())
                return
            e = self._entry(tag)
            with self._lock:
                e.wids.add(worker)
                e.expel = True
                if e.error is None and e.acc is not None \
                        and len(payload) != len(e.acc):
                    # participants disagree on buffer length: fail the WHOLE
                    # round (a zero-padded partial sum would silently corrupt
                    # the longer participant's result)
                    self._fail_entry(
                        tag, e, STATUS_ROUND_FAILED,
                        f"allreduce size mismatch on tag {tag!r}: "
                        f"got {len(payload)} floats, round started "
                        f"with {len(e.acc)}")
                self._dead_check(tag, e)
                failed = e.error is not None
                if not failed:
                    if e.acc is None:
                        e.acc = payload.astype(np.float32).copy()
                    else:
                        e.acc += payload
                    e.arrived += 1
                    if e.arrived >= self.n_workers:
                        self._round_done(e)
                        e.complete.set()
            if not failed:
                self._await_round(tag, e)
                if self._stop_requested():
                    raise ConnectionError("coordinator stopping")
            if e.error is not None:
                self._finish(tag, e)
                self._respond(sock, e.status, e.error.encode())
                return
            result = b"" if op == OP_BARRIER else e.acc.tobytes()
            self._finish(tag, e)
            self._respond(sock, 0, result)
        elif op == OP_BCAST_SEND:
            stale = self._world_guard(sock)
            if stale is not None:
                self._respond(sock, STATUS_WORLD_CHANGED, stale.encode())
                return
            e = self._entry(tag)
            with self._lock:
                e.acc = payload.copy()
                self._round_done(e)
                e.complete.set()
            self._finish(tag, e)
            self._respond(sock, 0)
        elif op == OP_BCAST_RECV:
            stale = self._world_guard(sock)
            if stale is not None:
                self._respond(sock, STATUS_WORLD_CHANGED, stale.encode())
                return
            e = self._entry(tag)
            with self._lock:
                self._dead_check(tag, e)
            self._await_round(tag, e)
            if self._stop_requested():
                raise ConnectionError("coordinator stopping")
            if e.error is not None:
                self._finish(tag, e)
                self._respond(sock, e.status, e.error.encode())
                return
            result = e.acc.tobytes()
            self._finish(tag, e)
            self._respond(sock, 0, result)
        elif op == OP_PS_INIT:
            with self._lock:
                self._ps_params = payload.copy()
            self._respond(sock, 0)
        elif op == OP_PS_PUSH:
            with self._lock:
                if self._ps_params is None:
                    self._respond(sock, STATUS_FAIL,
                                  b"ps_push before ps_init: the server "
                                  b"holds no parameter buffer yet")
                    return
                if len(self._ps_params) != len(payload):
                    self._respond(
                        sock, STATUS_FAIL,
                        f"ps_push size mismatch: got {len(payload)} floats, "
                        f"server buffer holds {len(self._ps_params)} "
                        "(all workers must push the full flat parameter "
                        "delta)".encode())
                    return
                self._ps_params = self._ps_params + payload
            self._respond(sock, 0)
        elif op == OP_PS_PULL:
            with self._lock:
                params = None if self._ps_params is None else self._ps_params.tobytes()
            if params is None:
                self._respond(sock, STATUS_FAIL,
                              b"ps_pull before ps_init: the server holds "
                              b"no parameter buffer yet")
            else:
                self._respond(sock, 0, params)
        else:
            raise ConnectionError(f"unknown op {op}")

    # ------------------------------------------------------------------
    # elastic re-form (docs/ROBUSTNESS.md §7): OP_REFORM arrivals gather
    # into ONE wave; a closer thread commits it when arrivals settle (or
    # the deadline expires), bumping the membership epoch, reassigning
    # contiguous ranks, and setting n_workers to the agreed world size
    # ------------------------------------------------------------------
    def _serve_reform(self, sock, worker, tag=""):
        if not self.elastic:
            self._respond(sock, STATUS_FAIL,
                          b"re-form requires an elastic coordinator "
                          b"(elastic=True or DL4J_TORCH_ELASTIC=1)")
            return
        now = time.perf_counter()
        with self._lock:
            if self._stopping:
                raise ConnectionError("coordinator stopping")
            r = self._reform
            if r is None:
                r = self._reform = _Reform(now)
                # the epoch is now CLOSING: wake every open round so its
                # participants tear down and join this wave instead of
                # waiting out a deadline that can never be met (this is
                # how a running world learns a scale-up joiner arrived)
                for tag, e in list(self._entries.items()):
                    if not e.complete.is_set():
                        self._fail_entry(
                            tag, e, STATUS_WORLD_CHANGED,
                            f"world changed: a re-form wave opened while "
                            f"round {tag!r} was in flight; tear down and "
                            "re-join the wave")
                self._reform_thread = threading.Thread(
                    target=self._close_reform, args=(r,), daemon=True)
                self._reform_thread.start()
            r.arrivals.append((sock, worker))
            if tag == "driver":
                r.drivers += 1
            r.last = now
        # bounded wait: the closer commits or fails the wave within
        # reform_timeout; the slack covers the commit bookkeeping itself
        r.complete.wait(self.reform_timeout + 2.0)
        with self._lock:
            if r.error is None and r.complete.is_set() \
                    and sock in r.assigned:
                payload = np.asarray(
                    [r.epoch, r.assigned[sock], r.n], np.float32).tobytes()
                status, body = STATUS_OK, payload
            elif r.error is not None:
                status, body = r.status, r.error.encode()
            else:   # closer wedged past deadline + slack: fail loudly
                status, body = STATUS_TIMEOUT, (
                    f"re-form wave never closed within "
                    f"{self.reform_timeout + 2.0:g}s").encode()
        self._respond(sock, status, body)

    def _close_reform(self, r):
        """Closer thread for ONE wave: commits when arrivals settle,
        fails at the deadline when the wave is under min_workers. Every
        wait is bounded and the loop consults _stopping."""
        settle = min(max(self.reform_timeout / 20.0, 0.05), 2.0)
        while True:
            time.sleep(0.02)
            now = time.perf_counter()
            with self._lock:
                if self._stopping:
                    r.error = "re-form abandoned: coordinator stopping"
                    r.status = STATUS_ROUND_FAILED
                    self._reform = None
                    r.complete.set()
                    return
                expired = now - r.t0 >= self.reform_timeout
                settled = r.arrivals and now - r.last >= settle
                if not (expired or settled):
                    continue
                if len(r.arrivals) < self.min_workers or not r.drivers:
                    # a wave without the training rank is a useless world:
                    # members would complete rounds among themselves while
                    # the late driver forces yet another epoch — hold the
                    # commit for the driver (or the deadline)
                    if not expired:
                        continue   # settled but short: wait for stragglers
                    r.error = (
                        f"elastic re-form wave failed: "
                        f"{len(r.arrivals)} participant(s), "
                        f"{r.drivers} driver(s) arrived within "
                        f"{self.reform_timeout:g}s (needs >= "
                        f"{self.min_workers} participants incl. a driver)")
                    r.status = STATUS_TIMEOUT
                    _OBS_REFORM_SECONDS.record(now - r.t0)
                    self._reform = None
                    r.complete.set()
                    return
            # commit outside the decision's lock scope: _commit_reform
            # re-acquires and re-checks (an arrival landing in the gap is
            # simply included in the committed wave)
            self._commit_reform(r, now)
            return

    def _commit_reform(self, r, now):
        """Commit a wave: bump the epoch, assign contiguous ranks
        ordered by old worker id (JOINER_ID newcomers sort last,
        survivors keep their relative order), install the new
        membership, and fail any round the old epoch left open."""
        with self._lock:
            if self._reform is not r or r.complete.is_set():
                return   # superseded (stop()) in the lock gap
            prev = set(self._peer_conns) | set(self._dead)
            self.epoch += 1
            order = sorted(range(len(r.arrivals)),
                           key=lambda i: (r.arrivals[i][1], i))
            self._peers = {}
            self._peer_conns = {}
            self._dead = set()
            arrived = []
            for rank, i in enumerate(order):
                sock, old = r.arrivals[i]
                r.assigned[sock] = rank
                self._peers[sock] = rank
                self._peer_conns[rank] = sock
                self._join_epoch[sock] = self.epoch
                arrived.append(old)
            r.epoch = self.epoch
            r.n = len(order)
            self.n_workers = r.n
            for tag, e in list(self._entries.items()):
                if not e.complete.is_set():
                    self._fail_entry(
                        tag, e, STATUS_WORLD_CHANGED,
                        f"world changed: membership epoch {self.epoch} "
                        f"committed while round {tag!r} was open")
            _OBS_REFORM_SECONDS.record(now - r.t0)
            _OBS_JOIN_EVENTS.inc(
                sum(1 for w in arrived if w == JOINER_ID or w not in prev))
            _OBS_LEAVE_EVENTS.inc(len(prev - set(arrived)))
            _OBS_WORLD_SIZE.set(r.n)
            self._reform = None
            r.complete.set()

    def stop(self):
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            conns = list(self._conns)
            # wake every handler blocked on a collective; they see _stopping
            # and drop their connections instead of waiting forever
            for e in self._entries.values():
                e.complete.set()
            if self._reform is not None:
                # reform waiters wake too; the closer thread sees
                # _stopping on its next tick and exits
                self._reform.error = "re-form abandoned: coordinator stopping"
                self._reform.status = STATUS_ROUND_FAILED
                self._reform.complete.set()
                self._reform = None
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.shutdown()
        self._server.server_close()
        # serve_forever returned after shutdown(); join so a stopped
        # coordinator leaves no accept thread racing a re-formed wave's
        # fresh bind (the teardown contract)
        self._thread.join(timeout=5)
        if self._reform_thread is not None:
            # the closer consults _stopping every tick, so this join is
            # bounded in practice; the timeout bounds it by contract
            self._reform_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class PyCollectiveClient:
    """Pure-Python client for the coordinator protocol.

    Connects with retry + exponential backoff (``DL4J_TORCH_CONNECT_RETRIES``
    attempts of ``DL4J_TORCH_CONNECT_TIMEOUT`` seconds each) and reads every
    response under a deadline slightly beyond the coordinator's own round
    deadline, so a dead coordinator raises ``CollectiveTimeoutError``
    instead of blocking its caller forever. Per-round failures arrive as
    typed errors: ``CollectiveTimeoutError`` (round missed the deadline),
    ``PeerDeadError`` (a participant died), ``CollectiveError`` (the round
    itself is invalid, e.g. an allreduce size mismatch)."""

    kind = "python"

    def __init__(self, host, port, worker_id, timeout=None,
                 connect_timeout=None, connect_retries=None):
        self.timeout = env_float("DL4J_TORCH_COLLECTIVE_TIMEOUT",
                                 minimum=0.001) if timeout is None else timeout
        ct = env_float("DL4J_TORCH_CONNECT_TIMEOUT", minimum=0.001) \
            if connect_timeout is None else connect_timeout
        retries = env_int("DL4J_TORCH_CONNECT_RETRIES", minimum=0) \
            if connect_retries is None else connect_retries
        self._sock = _retry_connect(
            lambda: socket.create_connection((host, port), timeout=ct),
            retries, f"connect to coordinator {host}:{port}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # a response may legitimately take a full server-side round
        # deadline to arrive; only BEYOND that is the coordinator dead
        self._sock.settimeout(self.timeout + 2.0)
        self.worker_id = worker_id
        self._rounds = {}
        self._lock = threading.Lock()
        try:
            self._request(OP_JOIN, "", b"")
        except Exception:
            self.close()   # don't leak the socket of a failed handshake
            raise

    def _round_tag(self, tag):
        r = self._rounds.get(tag, 0)
        self._rounds[tag] = r + 1
        return f"{tag}#{r}"

    def _request(self, op, tag, payload, read_deadline=None):
        spec = faults.fire("drop-conn", qual=self.worker_id)
        if spec is not None:
            # simulated worker death: the coordinator sees the closed
            # connection and fails open rounds for the survivors
            self._sock.close()
            raise ConnectionError(
                f"fault injected: worker {self.worker_id} dropped its "
                f"connection before request op {op}")
        deadline = self.timeout + 2.0 if read_deadline is None \
            else read_deadline
        with self._lock:
            tb = tag.encode()
            if read_deadline is not None:
                # a re-form reply may legitimately take the (longer)
                # re-form deadline to arrive; restore the per-round
                # deadline afterwards
                self._sock.settimeout(read_deadline)
            try:
                self._sock.sendall(
                    _REQ_HDR.pack(MAGIC, op, self.worker_id, len(tb))
                    + tb + _LEN.pack(len(payload)) + payload)
                try:
                    status, rlen = _RESP_HDR.unpack(
                        _read_full(self._sock, _RESP_HDR.size))
                    body = _read_full(self._sock, rlen) if rlen else b""
                except socket.timeout:
                    # poison the connection: a late reply would otherwise
                    # sit in the kernel buffer and desynchronize the
                    # framing, handing a retried request the PREVIOUS
                    # operation's response
                    self._sock.close()
                    raise CollectiveTimeoutError(
                        f"no response from coordinator within "
                        f"{deadline:g}s (op {op}, tag {tag!r}): "
                        "coordinator dead or partitioned; connection closed "
                        "— reconnect to retry") from None
            finally:
                if read_deadline is not None:
                    try:
                        self._sock.settimeout(self.timeout + 2.0)
                    except OSError:
                        pass   # poisoned above: already closed
        if status != 0:
            detail = body.decode(errors="replace") if body else f"status {status}"
            raise _STATUS_ERRORS.get(status, RuntimeError)(
                f"coordinator op {op} failed: {detail}")
        return body

    def barrier(self, tag="barrier"):
        self._request(OP_BARRIER, self._round_tag(tag), b"")

    def reform(self, reform_timeout=None, driver=False):
        """Join the coordinator's elastic re-form wave on THIS connection
        and block (bounded by the re-form deadline) until it commits.
        Returns ``(epoch, rank, world)`` — the committed membership
        epoch, this participant's NEW contiguous rank, and the agreed
        world size. Call it on a FRESH connection (the wave contract:
        every participant reconnects); the per-client round counters are
        reset so the new wave's rounds start at ``#0``. ``driver=True``
        marks the training rank: a wave only ever commits when it holds
        at least one driver, so members can never form a driver-less
        world that spins rounds among themselves. A wave that cannot
        gather ``min_workers`` (driver included) raises
        ``CollectiveTimeoutError``; a non-elastic coordinator fails the
        request."""
        rt = env_float("DL4J_TORCH_REFORM_TIMEOUT", minimum=0.001) \
            if reform_timeout is None else reform_timeout
        body = self._request(OP_REFORM, "driver" if driver else "", b"",
                             read_deadline=rt + 4.0)
        vals = np.frombuffer(body, np.float32)
        if vals.size != 3:
            raise RuntimeError(
                f"re-form reply malformed: expected 3 floats "
                f"(epoch, rank, world), got {vals.size}")
        epoch, rank, world = (int(v) for v in vals)
        with self._lock:
            self._rounds.clear()
            self.worker_id = rank
        return epoch, rank, world

    def allreduce(self, arr, tag="allreduce"):
        arr = np.ascontiguousarray(arr, np.float32)
        body = self._request(OP_ALLREDUCE, self._round_tag(tag), arr.tobytes())
        out = np.frombuffer(body, np.float32)
        if out.size != arr.size:
            raise RuntimeError(
                f"allreduce size mismatch: sent {arr.size}, got {out.size} "
                "(participants disagree on buffer length)")
        return out.reshape(arr.shape).copy()

    def broadcast(self, arr, root=False, tag="broadcast"):
        arr = np.ascontiguousarray(arr, np.float32)
        t = self._round_tag(tag)
        if root:
            self._request(OP_BCAST_SEND, t, arr.tobytes())
            return arr
        body = self._request(OP_BCAST_RECV, t, b"")
        out = np.frombuffer(body, np.float32)
        if out.size != arr.size:
            raise RuntimeError(
                f"broadcast size mismatch: expected {arr.size}, got {out.size}")
        return out.reshape(arr.shape).copy()

    def ps_init(self, params):
        self._request(OP_PS_INIT, "",
                      np.ascontiguousarray(params, np.float32).tobytes())

    def ps_push(self, delta):
        self._request(OP_PS_PUSH, "",
                      np.ascontiguousarray(delta, np.float32).tobytes())

    def ps_pull(self, n):
        body = self._request(OP_PS_PULL, "", b"")
        out = np.frombuffer(body, np.float32)
        if out.size != n:
            raise RuntimeError(f"ps_pull size mismatch: {out.size} != {n}")
        return out.copy()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_coordinator(n_workers, port=0, prefer_native=True, timeout=None,
                      elastic=None, min_workers=None, reform_timeout=None):
    """Coordinator server: the native one (``NativeCoordinator``) when
    ``prefer_native`` and the library is available, else the Python
    twin (a fallback counted in ``collective.native_fallbacks_total``).
    The native server has no per-round deadline; the Python twin honours
    ``timeout`` / ``DL4J_TORCH_COLLECTIVE_TIMEOUT``. Elastic membership
    (``OP_REFORM``) exists only in the Python twin, so an elastic request
    always goes there."""
    use_elastic = env_flag("DL4J_TORCH_ELASTIC") if elastic is None \
        else bool(elastic)
    if prefer_native and not use_elastic:
        if nativelib.available():
            return nativelib.NativeCoordinator(n_workers, port)
        _OBS_NATIVE_FALLBACKS.inc()
    return PyCoordinator(n_workers, port, timeout=timeout,
                         elastic=use_elastic, min_workers=min_workers,
                         reform_timeout=reform_timeout)


def connect(host, port, worker_id, prefer_native=True, timeout=None,
            connect_retries=None):
    """Collective client: native when ``prefer_native`` and the library
    is available, else Python (the same protocol; the fallback counted).

    Both get connect retry with exponential backoff
    (``DL4J_TORCH_CONNECT_RETRIES``): the native client raises
    ``RuntimeError`` on a refused handshake, the Python one ``OSError``;
    only the Python twin honours the per-request deadline."""
    if prefer_native:
        if nativelib.available():
            retries = env_int("DL4J_TORCH_CONNECT_RETRIES", minimum=0) \
                if connect_retries is None else connect_retries
            return _retry_connect(
                lambda: nativelib.NativeCollectiveClient(host, port,
                                                         worker_id),
                retries, f"native connect to {host}:{port}")
        _OBS_NATIVE_FALLBACKS.inc()
    return PyCollectiveClient(host, port, worker_id, timeout=timeout,
                              connect_retries=connect_retries)
