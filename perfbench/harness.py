"""Run one cell once: find its configuration, traffic and metric readers
by name, drive it, and build the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own that this module finds by the name in
``BENCHMARK.json``: ``perfbench/configs/<config>.json`` (with a
``family``, ``perfbench/families/<family>.py``),
``perfbench/workloads/<cell>.json`` (with a ``driver``,
``perfbench/drivers/<driver>.py``) and ``perfbench/metrics/<metric>.py``
(a ``read(measure)`` returning the metric, or None where it finds
nothing to read).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import check, trace


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def load_cell(root, name, overrides=None):
    """(benchmark, cell entry, configuration, traffic) of cell ``name``;
    ``overrides`` replace keys of its traffic: ``perfbench/sweep.py``'s
    rates, kept to measure the knee again when the program moves it."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cell = _named(bench["workloads"], name, "workload")
    cfg = _load_json(root / _named(bench["configs"], cell["config"],
                                   "configuration")["file"])
    tr = _load_json(root / "perfbench" / "workloads" / f"{name}.json")
    tr.update(overrides or {})
    return bench, cell, cfg, tr


def cell_metrics(bench, name, kind):
    """The ``end_to_end`` or ``per_layer`` entries cell ``name`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(root, name):
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Job:
    """What a driver reads (the cell, the seed, the device) and fills in
    (end-to-end values, the measure the readers take, the numbers
    compared)."""

    def __init__(self, cfg, traffic, seed, seconds, trace_on, device,
                 t_start):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device = torch.device(device)
        self.t_start = t_start
        self.family = importlib.import_module(
            f"perfbench.families.{cfg['family']}")
        self.e2e, self.numbers, self.notes = {}, {}, {}
        self.measure = SimpleNamespace(cfg=cfg, traffic=traffic, trace=None,
                                       counters={}, tails={})
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.setup_s = None
        self.fault = lambda target: None   # tests break the timed path here

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self):
        self.sync()
        self.setup_s = time.monotonic() - self.t_start

    def recorder(self):
        return trace.Recorder(self.device)

    def read_memory_peak(self):
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(root, name, seed, seconds, trace_on, device, t_start,
             fault=None, chips=1, overrides=None):
    """Drive cell ``name`` once; returns (result dict, the job)."""
    bench, cell, cfg, tr = load_cell(root, name, overrides)
    job = Job(cfg, tr, seed, seconds, trace_on, device, t_start)
    if fault is not None:
        job.fault = fault
    importlib.import_module(f"perfbench.drivers.{tr['driver']}").run(job)
    job.e2e["setup_s"] = job.setup_s
    ok, rows = check.verdict(job.numbers, tr["limits"])

    metrics = {}
    if not trace_on:
        for m in cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": float(job.e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, name, "per_layer"):
            value = reader(root, m["name"])(job.measure)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    dev = job.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else dev.type,
              "count": chips, "memory_peak_bytes": int(job.memory_peak)}
    result = {"correct": ok and job.failed == 0,
              "attempted": int(job.attempted), "failed": int(job.failed),
              "metrics": metrics, "device": device}
    t = job.measure.trace
    if t is not None:
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, job
