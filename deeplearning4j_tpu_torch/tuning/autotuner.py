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

The fusion autotuner picks the fused loop's K per shape bucket, once:
with ``DL4J_TORCH_FUSE_AUTOTUNE=1`` and ``DL4J_TORCH_FUSE_STEPS`` unset,
``fit()`` arms it (:func:`fuse_wrap_config`): the prefetch worker groups
an undecided bucket at the probe size (the largest
``DL4J_TORCH_FUSE_PROBE_KS`` entry, :func:`bucket_resolver`), and the
first full group that reaches ``fit_fused`` is probed (:func:`_probe`):
each candidate K is dispatched as a ZERO-WEIGHT group, once to warm up
and twice timed. Zero example weights make every step a select-reverted
identity update, so parameters, updater and layer state, iteration and
draw counter are untouched. The lowest per-step time wins, in-flight
probe-size groups are re-chunked to it (:func:`_chunk`), and the worker
groups by it from its next group on.

One difference from the reference: there K shapes the compiled scan, so
the losers' programs leave its cache. Here K does not change what is
captured (each window is one graph whatever K is); K sets the group
size only: the staged host-to-device copies, one guard read and one
bookkeeping pass a group. A probe therefore captures nothing a timed fit
would not, and a bucket holds one window graph whatever was probed.

Thread contract: :func:`bucket_resolver`'s closure runs on the prefetch
worker and touches no device (the backend key is taken at arm time on
the consumer thread); probing runs on the consumer thread inside
``fit_fused``. The decision state is lock-guarded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings

import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_flag, env_is_set, env_str
from deeplearning4j_tpu_torch.datasets.async_iterator import default_fuse
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed

__all__ = ["autotune_active", "backend_key", "bucket_resolver",
           "candidate_ladder", "fuse_wrap_config", "lookup_decision",
           "model_key", "plan_fused", "probe_group_steps",
           "record_decision", "stacked_bucket_key"]

_OBS_PROBES = obs.counter(
    "fuse.autotune_probes_total",
    "Candidate fused-K probe measurements the autotuner ran (zero on a "
    "tune-cache hit: the persisted decision is reused)")
_OBS_SELECTED_K = obs.gauge(
    "fuse.selected_k",
    "Most recently resolved fused-loop K (autotuner decision or cache hit)")

_DEFAULT_LADDER = (1, 4, 8, 16)
_PROBE_REPS = 2          # timed repetitions per candidate (min taken)
_CACHE_VERSION = 1

_LOCK = threading.Lock()
_MEM: dict[tuple, dict] = {}      # (model_key, backend) -> {repr(bucket): k}
_PROV: dict[tuple, dict] = {}     # same slots -> {repr(bucket): per_step_s}
_LOADED: set[tuple] = set()       # (model_key, backend) disk already read
# undecided buckets' sub-probe-size dispatch counts: the "never engaged"
# warning waits for _UNPROBED_WARN_AT sightings, so the one or two
# partial groups a stream emits before its first full one stay quiet
_UNPROBED_SEEN: dict[tuple, int] = {}
_UNPROBED_WARN_AT = 3

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
        _UNPROBED_SEEN.clear()


def autotune_active():
    """The tuner engages only when asked AND no explicit K is set: an
    operator's ``DL4J_TORCH_FUSE_STEPS`` always wins."""
    return env_flag("DL4J_TORCH_FUSE_AUTOTUNE") and \
        not env_is_set("DL4J_TORCH_FUSE_STEPS")


def candidate_ladder():
    """The K candidates to probe, parsed from ``DL4J_TORCH_FUSE_PROBE_KS``
    (sorted, deduplicated, each at least 1); a malformed value warns and
    falls back to the default ladder."""
    raw = env_str("DL4J_TORCH_FUSE_PROBE_KS")
    try:
        ks = sorted({max(1, int(p)) for p in raw.split(",") if p.strip()})
    except ValueError:
        warnings.warn(f"DL4J_TORCH_FUSE_PROBE_KS={raw!r} is not a comma-"
                      f"separated int list; using {_DEFAULT_LADDER}")
        ks = []
    return tuple(ks) if ks else _DEFAULT_LADDER


def probe_group_steps():
    """The group size of an UNDECIDED bucket: the largest candidate, so
    that the first full group holds enough steps to probe every rung."""
    return candidate_ladder()[-1]


def backend_key(device):
    """The backend part of a decision's key: ``cpu``, or ``cuda`` and the
    card's name (``cuda-NVIDIA-H100-80GB-HBM3``)."""
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


def stacked_bucket_key(stacked):
    """The bucket key of a stacked group, the prefetch worker's
    ``AsyncDataSetIterator._shapes_of`` of one full batch of it: a
    ``StackedDataSet`` keys as ``("ds", features, labels)``, a
    ``StackedMultiDataSet`` as ``("mds", (features...), (labels...))``,
    batch dimension included."""
    def shape(a):
        return tuple(int(d) for d in a.shape[1:])
    if isinstance(stacked.features, (list, tuple)):
        return ("mds", tuple(shape(x) for x in stacked.features),
                tuple(shape(y) for y in stacked.labels))
    return ("ds", shape(stacked.features), shape(stacked.labels))


def bucket_resolver(model):
    """The worker-side K resolver for ``AsyncDataSetIterator``: a decided
    bucket's K, the probe group size while undecided. The model key and
    the backend are taken here, on the consumer thread; the closure
    touches no device."""
    mk = model_key(model)
    backend = backend_key(model.device)
    probe_k = probe_group_steps()

    def resolve(bucket_key):
        k = lookup_decision(mk, backend, bucket_key)
        return k if k is not None else probe_k

    return resolve


def fuse_wrap_config(model):
    """``(fuse, k_resolver, bucket_pad, autotune_armed)`` for a model's
    ``fit()``: a model that may not fuse (``fuse_allowed``) gets the plain
    per-batch contract; with the tuner active, groups of the probe size
    and the bucket resolver; otherwise groups of
    ``DL4J_TORCH_FUSE_STEPS``. Bucket padding is on for every model that
    may fuse, so that even a per-batch run (K 1) trains every maskless
    batch through the example-weight path."""
    if not fuse_allowed(model.conf, model.layers):
        return 1, None, False, False
    if autotune_active():
        return probe_group_steps(), bucket_resolver(model), True, True
    return default_fuse(), None, True, False


# ---------------------------------------------------------------------------
# probe and chunk planning (consumer thread, inside fit_fused)
# ---------------------------------------------------------------------------
def _probe(model, xs, ys, ews, guard, mk, backend, bucket_key):
    """Time every candidate K on zero-weight slices of this real group and
    record the winner (the lowest per-step wall time; the larger K on a
    tie). Runs once per (model, bucket, backend), the disk cache
    included."""
    total = int(ews.shape[0])
    ladder = [k for k in candidate_ladder() if k <= total] or [total]
    per_step = {}
    for k in ladder:
        cxs, cys = [a[:k] for a in xs], [a[:k] for a in ys]
        cews = torch.zeros_like(ews[:k])   # identity steps: state untouched
        model._fused_probe_dispatch(cxs, cys, cews, guard)   # warm-up
        best = min(model._fused_probe_dispatch(cxs, cys, cews, guard)
                   for _ in range(_PROBE_REPS))
        per_step[k] = best / k
        _OBS_PROBES.inc()
    winner = min(ladder, key=lambda k: (per_step[k], -k))
    record_decision(mk, backend, bucket_key, winner, per_step)
    return winner


def _chunk(xs, ys, ews, n_real, k):
    """Re-chunk an in-flight probe-size group (lists of [K, B, ...]
    streams) to the decided ``k``: full [k, B, ...] slices, the remainder
    padded with zero-weight copies of its last step. All-padding chunks
    are left out: their steps would revert to nothing. Returns ``[(xs,
    ys, ews, real steps), ...]``."""
    total = int(ews.shape[0])
    chunks = []
    i = 0
    while i < max(1, n_real):
        stop = i + k
        if stop <= total:
            cxs, cys = [a[i:stop] for a in xs], [a[i:stop] for a in ys]
            cews = ews[i:stop]
        else:
            pad = stop - total

            def rep(a):
                return torch.cat([a[i:], a[-1:].repeat(
                    (pad,) + (1,) * (a.ndim - 1))])
            cxs, cys = [rep(a) for a in xs], [rep(a) for a in ys]
            cews = torch.cat([ews[i:], torch.zeros(
                (pad,) + tuple(ews.shape[1:]), dtype=ews.dtype,
                device=ews.device)])
        chunks.append((cxs, cys, cews, max(0, min(k, n_real - i))))
        i = stop
    return chunks


def plan_fused(model, xs, ys, ews, n_real, guard, bucket_key=None):
    """The dispatch plan of one stacked group under an ARMED tuner:
    ``[(xs, ys, ews, real steps), ...]``, each chunk at the bucket's
    decided K. An undecided bucket is probed (once) on its first group of
    the probe size; a smaller group (an adaptive partial) passes through
    unchanged, and so does a group no larger than the decision.
    ``bucket_key`` defaults to the multi-stream key of ``xs``/``ys``."""
    mk = model_key(model)
    backend = backend_key(model.device)
    if bucket_key is None:
        bucket_key = ("mds", tuple(tuple(int(d) for d in x.shape[1:])
                                   for x in xs),
                      tuple(tuple(int(d) for d in y.shape[1:]) for y in ys))
    k = lookup_decision(mk, backend, bucket_key)
    have = int(ews.shape[0])
    if k is None:
        if have < probe_group_steps():
            # nothing to tune in a partial group; but if no group of this
            # bucket ever reaches the probe size (a byte-capped or
            # thrashing stream), say once that the tuner never engaged
            slot = (mk, backend, repr(bucket_key))
            with _LOCK:
                n = _UNPROBED_SEEN.get(slot, 0) + 1
                _UNPROBED_SEEN[slot] = n
            if n == _UNPROBED_WARN_AT:
                warnings.warn(
                    f"fuse autotuner: bucket {bucket_key} dispatched a "
                    f"{have}-step group below the probe size "
                    f"({probe_group_steps()}); if no full-size group ever "
                    "forms (DL4J_TORCH_TRANSFER_STAGE_BYTES cap, or a "
                    "thrashing stream) this bucket stays untuned: shrink "
                    "DL4J_TORCH_FUSE_PROBE_KS or raise the byte cap")
            return [(xs, ys, ews, n_real)]
        k = _probe(model, xs, ys, ews, guard, mk, backend, bucket_key)
    _OBS_SELECTED_K.set(k)
    if k >= have:
        return [(xs, ys, ews, n_real)]
    return _chunk(xs, ys, ews, n_real, k)
