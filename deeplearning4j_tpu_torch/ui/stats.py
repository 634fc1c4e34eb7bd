"""StatsListener: per-iteration training telemetry: the port of
``deeplearning4j_tpu/ui/stats.py``
(``ui/stats/BaseStatsListener.java:43,273``).

Collects the score, iteration timing, memory (the host's RSS and the
card's allocator), per-layer parameter and gradient summaries (mean,
stdev, mean magnitude, histogram; ``BaseStatsListener.java:444-496``),
learning rates, and a first static report of hardware, software and
model. ``StatsUpdateConfiguration`` sets how often and what.

The reports are the reference's, key for key, with two exceptions in the
static report: a card is listed as ``cuda:<device name>`` where the
reference writes ``platform:device_kind``, and ``software`` names
``torch`` and its CUDA version where the reference names ``jax``.

Parameters and gradients live on the model's device. A report copies all
of its tensors to the host in one transfer (``_host_trees``) and
summarises them there in float64, as the reference does with
``np.asarray``, which a CUDA tensor refuses. Every read is gated by
``reporting_frequency``. After a fused group the listener runs once for
each of the group's updates, after the group, with the group's final
parameters and last gradients, as in the reference. Under a ZeRO plan
of level 2 or 3 the model keeps no whole gradients (``_last_gradients``
is None), so the reports carry none; at level 3 the parameter summaries
are of this rank's shards.
"""

from __future__ import annotations

import os
import platform
import sys
import time
import uuid

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.storage import Persistable

TYPE_ID = "StatsListener"
STATIC_TYPE_ID = "StatsListener"


class StatsUpdateConfiguration:
    """Which stats to collect, how often (StatsUpdateConfiguration.java)."""

    def __init__(self, reporting_frequency=1, collect_score=True,
                 collect_timing=True, collect_memory=True,
                 collect_learning_rates=True, collect_histograms=True,
                 num_histogram_bins=20, collect_mean=True, collect_stdev=True,
                 collect_mean_magnitudes=True, collect_params=True,
                 collect_gradients=True, collect_updates=False,
                 collect_activations=False):
        self.reporting_frequency = max(1, reporting_frequency)
        self.collect_score = collect_score
        self.collect_timing = collect_timing
        self.collect_memory = collect_memory
        self.collect_learning_rates = collect_learning_rates
        self.collect_histograms = collect_histograms
        self.num_histogram_bins = num_histogram_bins
        self.collect_mean = collect_mean
        self.collect_stdev = collect_stdev
        self.collect_mean_magnitudes = collect_mean_magnitudes
        self.collect_params = collect_params
        self.collect_gradients = collect_gradients
        self.collect_updates = collect_updates
        self.collect_activations = collect_activations


def _summary(arr, cfg):
    """Mean, stdev, mean magnitude and histogram of one host array, in
    float64 (the reference's function)."""
    a = np.asarray(arr, np.float64).ravel()
    out = {}
    if a.size == 0:
        return out
    if cfg.collect_mean:
        out["mean"] = float(a.mean())
    if cfg.collect_stdev:
        out["stdev"] = float(a.std())
    if cfg.collect_mean_magnitudes:
        out["meanmag"] = float(np.abs(a).mean())
    if cfg.collect_histograms:
        counts, edges = np.histogram(a, bins=cfg.num_histogram_bins)
        out["histogram"] = {
            "min": float(edges[0]), "max": float(edges[-1]),
            "counts": counts.astype(np.float32)}
    return out


def _host_trees(*trees):
    """Each ``[(name, {key: tensor})]`` tree with its tensors replaced by
    float64 host arrays, all of them fetched in ONE device-to-host copy:
    the leaves are flattened into one buffer on their device (float32,
    which holds bf16/f16/f32 exactly, or float64 when a leaf is), copied,
    and split on the host."""
    leaves = [v for tree in trees for _, d in tree for v in d.values()]
    if not leaves:
        return trees
    wide = any(v.dtype == torch.float64 for v in leaves)
    dt = torch.float64 if wide else torch.float32
    with torch.no_grad():
        flat = torch.cat([v.detach().reshape(-1).to(dt) for v in leaves])
    host = flat.cpu().numpy().astype(np.float64)
    out, pos = [], 0
    for tree in trees:
        new = []
        for name, d in tree:
            nd = {}
            for k, v in d.items():
                n = v.numel()
                nd[k] = host[pos:pos + n].reshape(tuple(v.shape))
                pos += n
            new.append((name, nd))
        out.append(new)
    return tuple(out)


def _named_params(model):
    """[(layer_name, {param_name: tensor})] for either model kind."""
    if hasattr(model, "params_map"):  # ComputationGraph
        names = model.layer_names
        plist = [model.params_map[n] for n in names]
    else:
        names = [f"{i}_{type(l).__name__}" for i, l in enumerate(model.layers)]
        plist = model.params_list
    return list(zip(names, plist))


def _named_grads(model):
    """The last update's gradients by layer name. Both models keep them as
    a list in layer order (a graph's in topological order, where the
    reference keys them by name): the last step's after a fused group
    (``models/_layered.py`` ``_fused_dispatch``), None at ZeRO levels
    2-3."""
    grads = model._last_gradients
    if grads is None:
        return []
    return list(zip([n for n, _ in _named_params(model)], grads))


def _cuda_device(model):
    """The model's CUDA device, or None when it is not on a card."""
    dev = getattr(model, "device", None)
    if dev is None:
        return None
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def _host_memory():
    """This process's resident set and the host's memory, in bytes, from
    ``/proc`` (Linux) or ``resource`` (the peak resident set elsewhere)."""
    out = {}
    rss = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0
                    break
    except OSError:
        rss = None
    if rss is None:
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # kilobytes on Linux, bytes on macOS
        rss = float(peak if sys.platform == "darwin" else peak * 1024)
    out["host_rss_bytes"] = rss
    pages, page = os.sysconf("SC_PHYS_PAGES"), os.sysconf("SC_PAGE_SIZE")
    out["host_total_bytes"] = float(pages * page)
    return out


def _device_memory(dev):
    """The card's allocated and total bytes under the reference's keys
    (``device{i}_bytes_in_use``, ``device{i}_bytes_limit``). No fallback:
    a card that cannot be read raises."""
    i = dev.index
    in_use = torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]
    _, total = torch.cuda.mem_get_info(dev)
    return {f"device{i}_bytes_in_use": float(in_use),
            f"device{i}_bytes_limit": float(total)}


def _devices(model):
    """The static report's device list: every visible card as
    ``cuda:<name>`` for a model on a card, else the reference's CPU entry."""
    if _cuda_device(model) is not None:
        return [f"cuda:{torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())]
    return ["cpu:cpu"]


class StatsListener(IterationListener):
    """Collect per-iteration stats and route them to a StatsStorageRouter
    (BaseStatsListener.iterationDone:273)."""

    def __init__(self, router, update_config=None, session_id=None,
                 worker_id="single"):
        self.router = router
        self.cfg = update_config or StatsUpdateConfiguration()
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:12]}"
        self.worker_id = worker_id
        self._init_sent = False
        self._last_report_time = None
        self._count = 0

    # --- initial static report (hardware/software/model) ---
    def _send_init(self, model):
        try:
            model_config = model.conf.to_json()
        except (AttributeError, TypeError, ValueError):
            model_config = "{}"
        named = _named_params(model)
        n_params = sum(int(v.numel()) for _, p in named for v in p.values())
        content = {
            "hardware": {"devices": _devices(model),
                         "host": platform.node(),
                         "cpus": float(os.cpu_count() or 1)},
            "software": {"python": sys.version.split()[0],
                         "torch": torch.__version__,
                         "cuda": str(torch.version.cuda),
                         "os": platform.platform()},
            "model": {"config": model_config,
                      "n_params": n_params,
                      "model_type": type(model).__name__,
                      "layer_names": [n for n, _ in named]},
        }
        self.router.put_static_info(Persistable(
            self.session_id, STATIC_TYPE_ID, self.worker_id,
            int(time.time() * 1000), content))
        self._init_sent = True

    def iteration_done(self, model, iteration):
        if not self._init_sent:
            self._send_init(model)
        self._count += 1
        if (self._count - 1) % self.cfg.reporting_frequency != 0:
            return
        now = time.perf_counter()
        content = {"iteration": iteration}
        cfg = self.cfg
        if cfg.collect_score and model.score_ is not None:
            content["score"] = float(model.score_)
        if cfg.collect_timing:
            if self._last_report_time is not None:
                dt = now - self._last_report_time
                content["duration_ms"] = dt * 1000.0 / cfg.reporting_frequency
                batch = getattr(model, "_last_batch_size", None)
                if batch and dt > 0:
                    content["examples_per_sec"] = (
                        batch * cfg.reporting_frequency / dt)
                    content["minibatches_per_sec"] = \
                        cfg.reporting_frequency / dt
            self._last_report_time = now
        if cfg.collect_memory:
            content["memory"] = self._memory_stats(model)
        if cfg.collect_learning_rates:
            content["learning_rates"] = self._learning_rates(model)
        params = _named_params(model) if cfg.collect_params else []
        grads = _named_grads(model) if cfg.collect_gradients else []
        params, grads = _host_trees(params, grads)
        if cfg.collect_params:
            content["params"] = {
                name: {k: _summary(v, cfg) for k, v in p.items()}
                for name, p in params if p}
        if cfg.collect_gradients:
            content["gradients"] = {
                name: {k: _summary(v, cfg) for k, v in g.items()}
                for name, g in grads if g}
        self.router.put_update(Persistable(
            self.session_id, TYPE_ID, self.worker_id,
            int(time.time() * 1000), content))

    @staticmethod
    def _memory_stats(model):
        out = _host_memory()
        dev = _cuda_device(model)
        if dev is not None:
            out.update(_device_memory(dev))
        return out

    @staticmethod
    def _learning_rates(model):
        out = {}
        names = [n for n, _ in _named_params(model)]
        for name, layer in zip(names, model.layers):
            lr = getattr(layer, "learning_rate", None)
            if lr is not None:
                out[name] = float(lr)
        return out
