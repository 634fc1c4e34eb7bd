"""The autotuner's decision cache, and how ``fit()`` wraps its iterator
for the fused loop: the port of ``deeplearning4j_tpu/tuning/autotuner.py``.

Decisions (a fused K, ContinuousLM's slot width, its rung ladders) are
kept per (model, backend) in memory and, with
``DL4J_TORCH_TUNE_CACHE_DIR`` set, in one JSON file per (model, backend)
committed through ``utils/atomic_io.py``'s tmp+fsync+rename protocol: a
restarted process reads the file and never probes again. A missing,
corrupt or mismatched file is an empty decision set (worst case one
re-probe), never a failure. The backend key names the device: ``cpu``,
or ``cuda`` and the card's name, so a decision taken on one card is not
adopted on another.

The reference's first-compile fusion autotuner (probe each K of a ladder
with zero-weight timed dispatches, keep the winner per bucket shape,
re-chunk in-flight groups) is not ported yet (ROADMAP.md, queue 1):
asking for it (``DL4J_TORCH_FUSE_AUTOTUNE=1`` with
``DL4J_TORCH_FUSE_STEPS`` unset) raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings

from deeplearning4j_tpu_torch.config import env_flag, env_is_set, env_str
from deeplearning4j_tpu_torch.datasets.async_iterator import default_fuse
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed

__all__ = ["autotune_active", "backend_key", "fuse_wrap_config",
           "lookup_decision", "model_key", "record_decision"]

_CACHE_VERSION = 1

_LOCK = threading.Lock()
_MEM: dict[tuple, dict] = {}      # (model_key, backend) -> {repr(bucket): k}
_PROV: dict[tuple, dict] = {}     # same slots -> {repr(bucket): per_step_s}
_LOADED: set[tuple] = set()       # (model_key, backend) disk already read

# pure value fields of a config: they do not move step time
_VALUE_FIELDS = frozenset((
    "seed", "learning_rate", "lr_schedule", "warmup_steps", "total_steps",
    "weight_decay", "beta1", "beta2", "eps", "label_smoothing", "z_loss",
    "ema_decay", "grad_clip_norm"))


def _reset_for_tests():
    """Drop the in-memory decisions (not the files): a process restart."""
    with _LOCK:
        _MEM.clear()
        _PROV.clear()
        _LOADED.clear()


def autotune_active():
    """The tuner engages only when asked AND no explicit K is set: an
    operator's ``DL4J_TORCH_FUSE_STEPS`` always wins."""
    return env_flag("DL4J_TORCH_FUSE_AUTOTUNE") and \
        not env_is_set("DL4J_TORCH_FUSE_STEPS")


def backend_key(device):
    """The backend part of a decision's key: ``cpu``, or ``cuda`` and the
    card's name (``cuda-NVIDIA-H100-80GB-HBM3``)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    name = torch.cuda.get_device_name(dev)
    return "cuda-" + "".join(ch if ch.isalnum() else "-" for ch in name)


def model_key(model):
    """Stable hash of what determines a step's cost profile: the model's
    class, its compute dtype, and its layers' types and parameter shapes
    or, for a model without a ``layers`` list (the TransformerLM), the
    architecture fields of its config. Seeds and values are left out:
    they do not move step time."""
    cached = getattr(model, "_tune_model_key", None)
    if cached is not None:
        return cached
    parts = [type(model).__name__,
             str(getattr(model.conf, "compute_dtype", None) or "float32")]
    layers = getattr(model, "layers", None)
    if layers is None:
        parts.append(_conf_cost_fields(model.conf))
    else:
        for layer in layers:
            shapes = tuple(sorted((k, tuple(v))
                                  for k, v in layer.param_shapes().items()))
            parts.append((type(layer).__name__, shapes))
    key = hashlib.sha1(repr(parts).encode()).hexdigest()
    model._tune_model_key = key
    return key


def _conf_cost_fields(conf):
    """The architecture slice of a config dataclass: every field but the
    pure value fields, so two architecturally identical servers share
    their persisted decisions."""
    if dataclasses.is_dataclass(conf):
        return tuple(sorted(
            (f.name, repr(getattr(conf, f.name)))
            for f in dataclasses.fields(conf)
            if f.name not in _VALUE_FIELDS))
    return repr(conf)


def _cache_path(mk, backend):
    root = env_str("DL4J_TORCH_TUNE_CACHE_DIR")
    if not root:
        return None
    return os.path.join(os.path.expanduser(root),
                        f"fusetune_{mk[:16]}_{backend}.json")


def _load_locked(mk, backend):
    """The decisions of (model, backend), read from disk once; the caller
    holds ``_LOCK``."""
    slot = (mk, backend)
    mem = _MEM.setdefault(slot, {})
    if slot in _LOADED:
        return mem
    _LOADED.add(slot)
    path = _cache_path(mk, backend)
    if path and os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.loads(fh.read())
            if (doc.get("version") == _CACHE_VERSION
                    and doc.get("model") == mk
                    and doc.get("backend") == backend):
                for bkey, entry in doc.get("decisions", {}).items():
                    k = entry["k"]
                    # rung ladders persist as int sequences beside the
                    # scalar K and slot decisions
                    mem[bkey] = (tuple(max(1, int(x)) for x in k)
                                 if isinstance(k, (list, tuple))
                                 else max(1, int(k)))
                    if isinstance(entry.get("per_step_s"), dict):
                        _PROV.setdefault(slot, {})[bkey] = entry["per_step_s"]
        except (OSError, ValueError, KeyError, TypeError) as exc:
            warnings.warn(f"ignoring unreadable tune cache {path!r}: "
                          f"{exc!r} (the probe will re-run)")
    return mem


def lookup_decision(mk, backend, bucket_key):
    """The decision for ``bucket_key``, or None while undecided."""
    with _LOCK:
        return _load_locked(mk, backend).get(repr(bucket_key))


def record_decision(mk, backend, bucket_key, k, per_step_s):
    """Publish a decision (an int, or an int sequence for a rung ladder)
    in memory and, with ``DL4J_TORCH_TUNE_CACHE_DIR`` set, on disk; the
    file is rewritten whole with every bucket's decision and probe
    times."""
    from deeplearning4j_tpu_torch.utils import atomic_io
    with _LOCK:
        mem = _load_locked(mk, backend)
        mem[repr(bucket_key)] = (tuple(int(x) for x in k)
                                 if isinstance(k, (list, tuple)) else int(k))
        prov = _PROV.setdefault((mk, backend), {})
        prov[repr(bucket_key)] = {str(ck): round(t, 9)
                                  for ck, t in per_step_s.items()}
        path = _cache_path(mk, backend)
        if path is None:
            return
        doc = {"version": _CACHE_VERSION, "model": mk, "backend": backend,
               "decisions": {b: ({"k": kk, "per_step_s": prov[b]}
                                 if b in prov else {"k": kk})
                             for b, kk in mem.items()}}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_io.write_bytes_atomic(
                path, json.dumps(doc, sort_keys=True).encode())
        except OSError as exc:
            warnings.warn(f"could not persist tune decision to {path!r}: "
                          f"{exc!r} (the in-memory decision stands)")


def fuse_wrap_config(model):
    """``(fuse, k_resolver, bucket_pad, autotune_armed)`` for a model's
    ``fit()``: a model that may not fuse (``fuse_allowed``) gets the plain
    per-batch contract; otherwise groups of ``DL4J_TORCH_FUSE_STEPS`` and
    bucket padding, so that even a per-batch run (K 1) trains every
    maskless batch through the example-weight path."""
    if not fuse_allowed(model.conf, model.layers):
        return 1, None, False, False
    if autotune_active():
        raise NotImplementedError(
            "DL4J_TORCH_FUSE_AUTOTUNE: the fusion autotuner (probe and "
            "chunk planner) is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1, \"The fused loop's remaining "
            "pieces\"); set DL4J_TORCH_FUSE_STEPS instead")
    return default_fuse(), None, True, False
