"""Per-device bucketed feeding queue (``parallelism/MagicQueue.java:21-29``):
the port of ``deeplearning4j_tpu/datasets/magic_queue.py``, which uses no
JAX and is carried over as it is.

DL4J feeds multi-GPU training through one queue-like object that keeps a
blocking queue per device and deals incoming DataSets round-robin across
them, so each worker thread polls only its own device's bucket. It suits
host-side pipelines that stage batches per device (a worker process a
card).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

__all__ = ["MagicQueue"]


class MagicQueue:
    """Round-robin fan-out over ``n_devices`` blocking buckets.

    ``add`` distributes producer-side; ``poll(device)`` /
    ``take(device)`` consume one device's bucket (MagicQueue's
    device-affinity contract). ``size()`` is the total across buckets."""

    def __init__(self, n_devices: int, capacity_per_device: int = 8):
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        self.n_devices = n_devices
        self._buckets = [queue.Queue(maxsize=capacity_per_device)
                         for _ in range(n_devices)]
        self._next = 0
        self._lock = threading.Lock()

    def add(self, ds, block: bool = True, timeout: Optional[float] = None):
        """Enqueue to the next bucket (round-robin, MagicQueue.add).

        The rotation slot is consumed only on a SUCCESSFUL put: a Full on a
        non-blocking add leaves the pointer so the retry targets the same
        device and fairness is preserved under backpressure."""
        with self._lock:
            i = self._next
        self._buckets[i].put(ds, block=block, timeout=timeout)
        with self._lock:
            if self._next == i:   # only this slot's success rotates it
                self._next = (i + 1) % self.n_devices
        return i

    def add_for(self, device: int, ds, block: bool = True,
                timeout: Optional[float] = None):
        """Enqueue to a specific device's bucket."""
        self._buckets[device].put(ds, block=block, timeout=timeout)

    def poll(self, device: int, timeout: Optional[float] = None):
        """Next item for ``device``, or None on timeout (MagicQueue.poll)."""
        try:
            return self._buckets[device].get(
                timeout=timeout if timeout is not None else 0.001)
        except queue.Empty:
            return None

    def take(self, device: int):
        """Blocking take for ``device`` — MagicQueue.take parity. Callers
        that need liveness use ``poll(timeout)``; this form exists for the
        reference's blocking contract."""
        return self._buckets[device].get()

    def size(self, device: Optional[int] = None) -> int:
        if device is not None:
            return self._buckets[device].qsize()
        return sum(b.qsize() for b in self._buckets)

    def __len__(self):
        return self.size()
