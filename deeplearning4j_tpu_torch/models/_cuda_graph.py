"""Functions over static tensors, captured once as CUDA graphs and
replayed: the port's form of the reference's compiled inference programs
(one jitted program per blessed signature becomes one captured graph).

A :class:`StaticGraph` wraps a zero-argument function that reads and
writes tensors allocated outside it (its inputs are copied into them
before a call, its results read from them after). On the card the first
call runs the function eagerly on a side stream (it is that call's real
work, and it does the lazy set-up a capture must not see: cuBLAS handles
and workspaces, allocator growth), then captures it; every later call
replays the graph. On the CPU every call runs the function. A failed
capture or replay raises: there is no eager fallback on the card, and
the device, never an error, chooses the eager route.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["StaticGraph", "capture_count", "captures_graphs"]

_LOCK = threading.Lock()
_CAPTURES = 0


def captures_graphs(device):
    """Whether programs on ``device`` run as captured CUDA graphs (the
    card) or as direct calls of the same function (the CPU)."""
    return torch.device(device).type == "cuda"


def capture_count():
    """Graphs captured by this process so far (every StaticGraph)."""
    return _CAPTURES


class StaticGraph:
    """``fn()`` over static tensors, captured on its first call on the
    card and replayed after. ``pool`` is a graph memory pool handle that
    graphs replayed one after another on one stream may share
    (``torch.cuda.graph_pool_handle()``); ``None`` gives the graph its
    own."""

    def __init__(self, fn, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None

    def __call__(self):
        """Run the function (CPU), or replay its graph, capturing it
        first (card). Returns whether this call captured."""
        if not captures_graphs(self.device):
            with torch.no_grad():
                self.fn()
            return False
        if self.graph is not None:
            self.graph.replay()
            return False
        global _CAPTURES
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            self.fn()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            self.fn()
        self.graph = graph
        with _LOCK:
            _CAPTURES += 1
        return True
