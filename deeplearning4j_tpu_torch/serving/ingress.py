"""HTTP ingress of the serving tier: deadlines, typed statuses, drain.

The front ends and :class:`~deeplearning4j_tpu_torch.serving.router.ReplicaRouter`
speak futures and typed ``ServingError``s; this module is the one place
where those become wire semantics, on ``utils/http_base.py``'s
background ``ThreadingHTTPServer`` (loopback by default, an ephemeral
port with ``port=0``).

Endpoints:

- ``POST /v1/generate``: JSON ``{"prompt": [ints], "n_new": N, ...}``
  against a ``ContinuousLM``-like backend (alone or behind a router).
  ``"stream": true`` answers in NDJSON: one ``{"tokens": [...]}`` line
  a decoded chunk as it lands (the ``on_tokens`` seam), then a final
  ``{"done": ...}`` line;
- ``POST /v1/infer``: JSON ``{"x": [[...]]}`` against an
  ``InferenceServer``-like backend; answers ``{"y": [...]}``;
- ``GET /healthz``: liveness (200 while the listener runs);
- ``GET /readyz``: readiness, 503 from the moment :meth:`drain` begins
  (before the listener closes, so a load balancer stops sending while
  admitted work finishes) or while the backend reports unhealthy;
- ``GET /metrics``: Prometheus text of the obs registry.

Deadlines: an ``X-Deadline-Ms`` header becomes the request's
``deadline_s`` (else ``DL4J_TORCH_SERVE_DEADLINE_S``); a request still
queued past it is swept with ``ServeDeadlineError`` before any device
work and answered 504 here.

Status mapping: each ``ServingError`` class declares its ``http_status``
and ``retryable`` (``errors.py``), so one except clause maps the family:
queue full or shed 429 with ``Retry-After``, stopped or draining 503,
deadline 504, replica death 502; a malformed body or request 400. Every
error body is ``{"error": <class>, "message": ..., "retryable": bool}``.

Handler threads never touch a device tensor: a backend's futures resolve
to host arrays, and ``on_tokens`` hands over host arrays. Every wait is
bounded: by the request's deadline plus slack, else ``_RESULT_CAP_S``;
the streaming loop polls a bounded ``Queue.get`` that the future's done
callback always wakes. A client that goes away mid-stream
(``BrokenPipeError``) cancels its future, which the scheduler treats as
a disconnect.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import queue
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.errors import ServingError
from deeplearning4j_tpu_torch.utils.http_base import (BackgroundHTTPServer,
                                                      QuietJSONHandler)

__all__ = ["ServingIngress"]

# cap on a result or stream wait when the request carries no deadline: a
# handler thread always comes back
_RESULT_CAP_S = 300.0

_HTTP_REQUESTS = obs.counter(
    "ingress.http_requests_total",
    "HTTP requests the serving ingress handled (all endpoints)")
_HTTP_ERRORS = obs.counter(
    "ingress.http_errors_total",
    "HTTP responses with status >= 400 (shed, drain, deadline, 4xx)")

_STREAM_END = object()   # queue sentinel: the request's future resolved


class _Handler(QuietJSONHandler):
    ingress = None   # the ServingIngress, set on a subclass per listener

    def _json(self, obj, status=200, headers=()):
        super()._json(obj, status, headers)
        _HTTP_REQUESTS.inc()
        if status >= 400:
            _HTTP_ERRORS.inc()

    def _text(self, text, content_type="text/plain; version=0.0.4"):
        self._send(text.encode(), content_type)
        _HTTP_REQUESTS.inc()

    def do_GET(self):
        try:
            self.ingress._handle_get(self)
        except BrokenPipeError:
            pass

    def do_POST(self):
        try:
            self.ingress._handle_post(self)
        except BrokenPipeError:
            pass


class ServingIngress:
    """HTTP front door over one serving backend (a front end or a router).

    ``backend`` needs ``submit(...)`` returning a future; ``/readyz`` also
    asks its ``healthy()`` where it has one. ``start()`` binds
    (``port=0`` takes an ephemeral port: read ``self.port`` back) and
    serves on daemon threads; ``drain()`` turns ``/readyz`` to 503
    first, then drains the backend, then closes the listener; ``stop()``
    closes it at once."""

    def __init__(self, backend, *, host="127.0.0.1", port=0):
        self.backend = backend
        self.host = host
        self.port = port
        # guards the listener and the ready flag: handler threads read
        # readiness while drain()/stop() write it
        self._lock = threading.Lock()
        self._server = None
        self._ready = False

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        handler = type("IngressHandler", (_Handler,), {"ingress": self})
        with self._lock:
            self._server = BackgroundHTTPServer(
                handler, self.port, self.host,
                name="dl4j-torch-serve-ingress").start()
            self.port = self._server.port
            self._ready = True
        return self

    def ready(self):
        """The ``/readyz`` predicate: started and not draining, and the
        backend, where it has ``healthy()``, reports a live replica."""
        with self._lock:
            if not self._ready:
                return False
        probe = getattr(self.backend, "healthy", None)
        return True if probe is None else bool(probe())

    def drain(self, timeout=30.0):
        """Graceful shutdown: ``/readyz`` answers 503 at once while the
        listener stays open, the backend drains (admitted work completes,
        new submits fail typed), and only then does the listener close.
        Returns the backend's drained verdict."""
        with self._lock:
            self._ready = False
        drain = getattr(self.backend, "drain", None)
        drained = drain(timeout=timeout) if drain is not None else True
        self._close_listener()
        return drained

    def stop(self):
        """Close the listener now; the backend is left to its own
        ``stop()`` (the ingress does not own it)."""
        with self._lock:
            self._ready = False
        self._close_listener()
        return self

    def _close_listener(self):
        with self._lock:
            server, self._server = self._server, None
        if server is not None:
            server.stop()

    # ---- GET -----------------------------------------------------------
    def _handle_get(self, h):
        path = h.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/healthz":
            h._json({"status": "ok"})
        elif path == "/readyz":
            if self.ready():
                h._json({"status": "ready"})
            else:
                h._json({"status": "draining"}, status=503)
        elif path == "/metrics":
            h._text(obs.prometheus_text())
        else:
            h._json({"error": "not found", "path": path}, status=404)

    # ---- POST ----------------------------------------------------------
    def _handle_post(self, h):
        path = h.path.split("?", 1)[0].rstrip("/")
        if path not in ("/v1/generate", "/v1/infer"):
            h._json({"error": "not found", "path": path}, status=404)
            return
        try:
            body = json.loads(h._read_body() or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, TypeError) as e:
            h._json({"error": "BadRequest", "message": f"bad JSON body: {e}",
                     "retryable": False}, status=400)
            return
        try:
            deadline_s = self._header_deadline(h)
            if path == "/v1/generate":
                self._generate(h, body, deadline_s)
            else:
                self._infer(h, body, deadline_s)
        except ServingError as e:
            self._serving_error(h, e)
        except (ValueError, TypeError, KeyError) as e:
            h._json({"error": "BadRequest", "message": str(e),
                     "retryable": False}, status=400)

    @staticmethod
    def _header_deadline(h):
        raw = h.headers.get("X-Deadline-Ms")
        if raw is None:
            return None
        try:
            ms = float(raw)
        except ValueError:
            raise ValueError(f"X-Deadline-Ms must be a number, got {raw!r}")
        if ms <= 0:
            raise ValueError("X-Deadline-Ms must be > 0")
        return ms / 1000.0

    @staticmethod
    def _serving_error(h, e):
        """The one ServingError-to-wire mapping: the status and the
        retryable bit are declared on the error's class."""
        headers = (("Retry-After", "1"),) if e.http_status == 429 else ()
        h._json({"error": type(e).__name__, "message": str(e),
                 "retryable": e.retryable}, status=e.http_status,
                headers=headers)

    @staticmethod
    def _wait_cap(deadline_s):
        """A result wait's bound: the request's deadline plus slack for
        the dispatch, else the cap."""
        return min(deadline_s + 30.0, _RESULT_CAP_S) \
            if deadline_s is not None else _RESULT_CAP_S

    def _finish(self, h, fut, deadline_s, to_body):
        """Wait for ``fut`` within the bound and answer: its result as
        ``to_body(result)``, a typed error by its declared status, a
        cancellation 503 and a timeout 504."""
        try:
            y = fut.result(timeout=self._wait_cap(deadline_s))
        except ServingError as e:
            self._serving_error(h, e)
            return
        except cf.CancelledError:
            h._json({"error": "Cancelled",
                     "message": "request cancelled mid-flight",
                     "retryable": True}, status=503)
            return
        except cf.TimeoutError:
            fut.cancel()
            h._json({"error": "GatewayTimeout",
                     "message": "result did not arrive within the wait "
                                "cap; request abandoned",
                     "retryable": False}, status=504)
            return
        h._json(to_body(y))

    def _infer(self, h, body, deadline_s):
        if "x" not in body:
            raise ValueError("missing required field 'x'")
        fut = self.backend.submit(np.asarray(body["x"]),
                                  deadline_s=deadline_s)
        self._finish(h, fut, deadline_s,
                     lambda y: {"y": np.asarray(y).tolist()})

    def _generate(self, h, body, deadline_s):
        if "prompt" not in body:
            raise ValueError("missing required field 'prompt'")
        kw = {"temperature": float(body.get("temperature", 0.0)),
              "seed": int(body.get("seed", 0)),
              "deadline_s": deadline_s}
        if body.get("top_k") is not None:
            kw["top_k"] = int(body["top_k"])
        if body.get("top_p") is not None:
            kw["top_p"] = float(body["top_p"])
        prompt = np.asarray(body["prompt"], np.int32)
        n_new = int(body.get("n_new", 16))
        if not body.get("stream"):
            fut = self.backend.submit(prompt, n_new, **kw)
            self._finish(h, fut, deadline_s,
                         lambda y: {"tokens": np.asarray(y).tolist()})
            return
        self._generate_stream(h, prompt, n_new, kw, deadline_s)

    def _generate_stream(self, h, prompt, n_new, kw, deadline_s):
        """NDJSON streaming: decoded chunks are written as they land.
        ``on_tokens`` runs on the scheduler thread, so it only enqueues;
        the handler thread writes and owns the disconnect (a broken pipe
        cancels the future)."""
        chunks = queue.Queue()

        def on_tokens(toks):
            chunks.put(np.asarray(toks).tolist())

        fut = self.backend.submit(prompt, n_new, on_tokens=on_tokens, **kw)
        fut.add_done_callback(lambda _f: chunks.put(_STREAM_END))
        # the 200 means admitted; a late failure arrives as the final
        # NDJSON line
        h.send_response(200)
        h.send_header("Content-Type", "application/x-ndjson")
        h.end_headers()
        _HTTP_REQUESTS.inc()
        sent = 0
        deadline = time.monotonic() + self._wait_cap(deadline_s)
        try:
            while time.monotonic() < deadline:
                try:
                    item = chunks.get(timeout=0.25)   # the done callback
                except queue.Empty:                   # always puts
                    continue                          # _STREAM_END
                if item is _STREAM_END:
                    break
                sent += len(item)
                h.wfile.write(json.dumps({"tokens": item}).encode() + b"\n")
                h.wfile.flush()
            else:
                fut.cancel()   # the wait cap ran out: typed line below
        except BrokenPipeError:
            fut.cancel()       # the client went away
            return
        self._stream_final(h, fut, sent)

    @staticmethod
    def _stream_final(h, fut, sent):
        try:
            y = fut.result(timeout=1.0) if fut.done() else None
            final = {"done": True, "streamed": sent} if y is None else \
                {"done": True, "streamed": sent,
                 "tokens": np.asarray(y).tolist()}
        except ServingError as e:
            _HTTP_ERRORS.inc()
            final = {"done": False, "error": type(e).__name__,
                     "message": str(e), "retryable": e.retryable,
                     "status": e.http_status}
        except (cf.CancelledError, cf.TimeoutError):
            _HTTP_ERRORS.inc()
            final = {"done": False, "error": "Cancelled",
                     "message": "stream abandoned", "retryable": True,
                     "status": 503}
        try:
            h.wfile.write(json.dumps(final).encode() + b"\n")
            h.wfile.flush()
        except BrokenPipeError:
            pass
