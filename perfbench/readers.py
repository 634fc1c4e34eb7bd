"""Arithmetic the per-layer metric readers share: kernel classes by
name, a kernel family's share of its roofline, the device's idle share.
Each returns None where the trace holds nothing to read."""

from __future__ import annotations

import re

from perfbench import counts

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|s16816|s1688|wgmma|cublas",
                  re.IGNORECASE)
COPY = re.compile(r"^(Memcpy|Memset)", re.IGNORECASE)


def is_flash(name):
    return "flash_" in name


def is_elementwise(name):
    """A kernel that is neither a GEMM nor a flash kernel (copies and
    memsets are not kernels)."""
    return not (GEMM.search(name) or is_flash(name) or COPY.search(name))


def per_step_ms(m, match):
    if m.trace is None:
        return None
    t = m.trace.kernel_seconds(match)
    return t / m.steps_traced * 1e3 if t > 0 else None


def roofline_share(m, kernels, work):
    """Least time of the step's flash calls (``work(n, T, hd, causal)``
    gives their operations and bytes) over the device time of the kernels
    whose names hold one of ``kernels``, in %."""
    if m.trace is None:
        return None
    spent = m.trace.kernel_seconds(lambda n: any(k in n for k in kernels))
    if spent <= 0:
        return None
    least = sum(counts.least_seconds(*work(*call))
                for call in m.flash_calls) * m.steps_traced
    return least / spent * 100


def idle_share(m):
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return (1 - m.trace.busy_s / m.trace.window_s) * 100


def occupancy(m):
    n = m.counters.get("serve.batch_occupancy.count", 0)
    return m.counters["serve.batch_occupancy.sum"] / n * 100 if n else None
