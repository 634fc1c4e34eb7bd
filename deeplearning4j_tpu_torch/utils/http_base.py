"""Background HTTP server scaffolding: a ``ThreadingHTTPServer`` bound to
loopback by default (an unauthenticated endpoint is exposed only on
request), served from a daemon thread that ``stop()`` joins, and a
handler base with quiet, length-framed responses. The serving ingress
(``serving/ingress.py``) and the streaming inference endpoint
(``streaming/routes.py``) are built on it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["BackgroundHTTPServer", "QuietJSONHandler"]


class QuietJSONHandler(BaseHTTPRequestHandler):
    """Request handler base: no access log on stderr, length-framed
    response helpers."""

    def log_message(self, *args):
        pass

    def _send(self, data: bytes, content_type: str, status: int = 200,
              headers=()):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, status: int = 200, headers=()):
        self._send(json.dumps(obj).encode(), "application/json", status,
                   headers)

    def _bytes(self, data: bytes, content_type="application/octet-stream",
               status: int = 200):
        self._send(data, content_type, status)

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))


class BackgroundHTTPServer:
    """Owns a ThreadingHTTPServer and its daemon serving thread.

    ``handler_cls`` handles the requests; ``self.port`` is the bound port
    (resolved when ``port=0``)."""

    def __init__(self, handler_cls, port: int = 0, host: str = "127.0.0.1",
                 name: str = "dl4j-torch-http"):
        self._httpd = ThreadingHTTPServer((host, port), handler_cls)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=name, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        # shutdown() blocks for ever if serve_forever never ran (only its
        # exit sets the is-shut-down event), so a stop before start skips
        # it; the join hands back a server whose thread is gone
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5)
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
