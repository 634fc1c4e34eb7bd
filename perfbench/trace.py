"""The device trace of a traced run: ``torch.profiler`` over a marked
window, reduced to device intervals, busy and idle time, and time by
kernel name.

The window is the span of a ``perfbench.window`` range recorded from the
benchmark's own code; device events (kernels, copies, memsets) are
clipped to it. A few spin kernels open every profile and are left out:
the profiler can drop a region's first device events.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import torch

WINDOW = "perfbench.window"
_SPIN = 100


class Trace:
    """Device and host events of one traced window, times in seconds."""

    def __init__(self, device, host, window):
        lo, hi = window
        self.window = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.host = host
        self.window_s = hi - lo

    def busy_intervals(self):
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, match):
        """Summed device time of the events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def top_ops(self, k=10):
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:160]] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """Idle device time summed by what the host was doing in the middle
        of each gap: the innermost host event (an op or a CUDA runtime
        call) spanning it, or none recorded."""
        lo, hi = self.window
        edges, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                edges.append((t, s))
            t = max(t, e)
        if hi > t:
            edges.append((t, hi))
        by = defaultdict(float)
        host = sorted(self.host, key=lambda x: x[1])
        live, i = [], 0   # a heap of (end, start, name) of open host events
        for s, e in sorted(edges, key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(live, (host[i][2], host[i][1], host[i][0]))
                i += 1
            while live and live[0][0] < mid:
                heapq.heappop(live)
            name = min(live, key=lambda h: h[0] - h[1])[2][:160] if live \
                else "host: no recorded op"
            by[name] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]


def _device_type(e):
    return str(e.device_type()).rsplit(".", 1)[-1]


def prime():
    """Start and stop one empty profile: a process's first start sets up
    the profiler's tracing, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


class Recorder:
    """A profile the caller starts and stops, and the window inside it
    that the caller opens and closes; ``result()`` reduces it to a
    :class:`Trace`. Start and stop it on the thread that launches the
    device work, or while no other thread launches any: one start from
    the main thread among a serving thread's graph replays hung a run.
    On a CPU device (the tests) it records host events alone."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self._cuda = device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._cuda else []))
        self._mark = None

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def start(self):
        self._prof.start()
        if self._cuda:
            for _ in range(_SPIN):
                torch.cuda._sleep(1000)
        self._sync()

    def open(self):
        self._mark = torch.autograd.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def close(self):
        self._sync()
        self._mark.__exit__(None, None, None)

    def stop(self):
        self._prof.stop()

    def result(self):
        """The window's events, read from the profiler's raw results (one
        pass; the parsed event tree of a serving window holds a million
        kernels)."""
        device, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name, on_cuda = e.name(), _device_type(e) == "CUDA"
            s = e.start_ns() / 1e9
            t = s + e.duration_ns() / 1e9
            if name == WINDOW:
                if not on_cuda:
                    window = (s, t)
            elif on_cuda:
                if "spin_kernel" not in name:
                    device.append((name, s, t))
            else:
                host.append((name, s, t))
        if window is None:
            raise RuntimeError("the profile holds no perfbench.window range")
        return Trace(device, host, window)
