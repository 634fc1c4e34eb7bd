"""Minimal TCP topic broker: the port of
``deeplearning4j_tpu/streaming/broker.py``, the Kafka stand-in of the
streaming routes.

One broker thread owns named topics; publishers push byte messages,
subscribers receive every message on their topic from the moment they
subscribe (fan-out). Framing: ``u8 op | u16 topic_len | topic | u64 len |
payload``; op 1 publishes, 2 subscribes. A subscriber connection then
receives ``u64 len | payload`` frames until it closes. It plays the part
of the embedded Kafka and Zookeeper pair of the reference's tests
(``dl4j-streaming/.../embedded/EmbeddedKafkaCluster.java``): in process,
addressed by port, many clients. The wire is the reference's, so a
client of either package talks to a broker of the other.
"""

from __future__ import annotations

import queue
import socket
import socketserver
import struct
import threading
from typing import Optional

_OP_PUB, _OP_SUB = 1, 2
_HDR = struct.Struct("<BH")
_LEN = struct.Struct("<Q")
_MAX_MSG = 1 << 31


def _read_full(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _read_frame_bytes(sock, n):
    """Like _read_full but a timeout AFTER partial consumption raises
    ConnectionError: the byte stream is mid-frame and can't be re-synced."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if buf:
                raise ConnectionError(
                    "timeout mid-frame: stream desynchronized") from None
            raise
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class MessageBroker:
    """Topic fan-out broker (EmbeddedKafkaCluster role)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._subs: dict[str, list[queue.Queue]] = {}
        self._lock = threading.Lock()
        broker = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    op, tlen = _HDR.unpack(_read_full(sock, _HDR.size))
                    topic = _read_full(sock, tlen).decode()
                    if op == _OP_PUB:
                        while True:
                            (n,) = _LEN.unpack(_read_full(sock, _LEN.size))
                            if n > _MAX_MSG:
                                raise ConnectionError("oversized message")
                            msg = _read_full(sock, n)
                            broker._fanout(topic, msg)
                    elif op == _OP_SUB:
                        q: queue.Queue = queue.Queue()
                        broker._subscribe(topic, q)
                        sock.sendall(b"\x01")   # subscription-registered ack
                        try:
                            while True:
                                # blocking by design: stop() fans a None
                                # sentinel into every subscriber queue, and
                                # the handler is a daemon thread of the
                                # broker's own server
                                msg = q.get()
                                if msg is None:      # broker stopping
                                    return
                                sock.sendall(_LEN.pack(len(msg)) + msg)
                        finally:
                            broker._unsubscribe(topic, q)
                    else:
                        raise ConnectionError(f"unknown op {op}")
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _subscribe(self, topic, q):
        with self._lock:
            self._subs.setdefault(topic, []).append(q)

    def _unsubscribe(self, topic, q):
        with self._lock:
            subs = self._subs.get(topic, [])
            if q in subs:
                subs.remove(q)

    def _fanout(self, topic, msg):
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for q in subs:
            q.put(msg)

    def stop(self):
        with self._lock:
            for subs in self._subs.values():
                for q in subs:
                    q.put(None)
        self._server.shutdown()
        self._server.server_close()
        # serve_forever returned after shutdown(); join so a stopped
        # broker leaves no accept thread behind
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class TopicPublisher:
    """``NDArrayPublisher`` role: push byte messages to a broker topic."""

    def __init__(self, host, port, topic: str, connect_timeout: float = 10.0):
        # bounded connect: a dead broker must raise here, not hang the
        # publisher thread forever (sends remain blocking-by-backpressure)
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        tb = topic.encode()
        self._sock.sendall(_HDR.pack(_OP_PUB, len(tb)) + tb)

    def publish(self, payload: bytes):
        self._sock.sendall(_LEN.pack(len(payload)) + payload)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TopicConsumer:
    """``NDArrayConsumer`` role: receive byte messages from a broker topic.

    The constructor blocks until the broker acknowledges the subscription,
    so messages published immediately afterwards are never lost."""

    def __init__(self, host, port, topic: str, timeout: Optional[float] = None,
                 connect_timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        tb = topic.encode()
        self._sock.sendall(_HDR.pack(_OP_SUB, len(tb)) + tb)
        self._sock.settimeout(10.0 if timeout is None else max(timeout, 10.0))
        _read_full(self._sock, 1)    # wait for the registration ack
        self._sock.settimeout(timeout)

    def poll(self) -> bytes:
        """Block (up to the constructor timeout) for the next message.

        A timeout BETWEEN frames raises ``socket.timeout`` and the stream
        stays usable; a timeout MID-frame (or an oversized length word)
        raises ``ConnectionError`` — the framing is no longer trustworthy
        and the consumer must be recreated."""
        hdr = _read_frame_bytes(self._sock, _LEN.size)
        (n,) = _LEN.unpack(hdr)
        if n > _MAX_MSG:
            raise ConnectionError(f"oversized/corrupt frame length {n}")
        try:
            return _read_frame_bytes(self._sock, n)
        except socket.timeout:
            raise ConnectionError(
                "timeout mid-frame: stream desynchronized") from None

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
