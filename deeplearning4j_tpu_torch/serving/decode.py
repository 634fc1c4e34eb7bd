"""Continuous-batching generation: a persistent KV slot pool, one step.

``TransformerLM.generate`` runs one whole-sequence program per request:
every caller pays full-batch decode alone. ``ContinuousLM`` serves many
requests from one pool instead: the model's decode chunk advances
``slots`` independent sequences by ``DL4J_TORCH_SERVE_CHUNK`` tokens per
dispatch over a persistent ``[slots, kv_heads, max_len, hd]`` KV cache
(in the compute dtype), and an active-row mask with per-row positions
lets the scheduler admit a new request into a freed row mid-decode.

Every program is bound to the pool's static tensors and, on the card,
captured once as a CUDA graph and replayed (``models/_cuda_graph.py``,
one graph memory pool shared by all of a pool's graphs). The fixed
inventory, all captured by :meth:`ContinuousLM.warm_start`:

- one decode chunk per KV window rung (``DL4J_TORCH_SERVE_KV_LADDER``;
  paged attention: a chunk reads the first W positions of the pool as a
  strided view, W the smallest rung covering the pool's largest active
  position, picked on the host from its position mirrors) and sampler
  variant (``greedy``, ``sample``, ``filter``: the host knows every
  admitted request's sampler and picks the variant where the reference
  branches on the device);
- one prefill program per prompt-window rung
  (``DL4J_TORCH_SERVE_PREFILL_LADDER``; chunked prefill: a window of
  prompt tokens per dispatch, interleaved with decode chunks) and
  variant (``compute``, or ``inject`` for a prefix-cache hit);
- one admit program, which writes a request's fields into its slot from
  one staging record (one host-to-device copy an admission).

That is ``3 * len(kv_ladder) + 2 * len(prefill_ladder) + 1`` graphs where
the reference compiles ``len(kv_ladder) + len(prefill_ladder) + 1``
programs. Prefill windows are memoised by prompt-prefix hash in a
byte-bounded LRU page cache (``DL4J_TORCH_SERVE_PREFIX_CACHE_MB``).
Completion is length-driven from the host's position mirrors (a row
advances exactly ``chunk`` positions a dispatch), so the scheduler never
reads the card to decide what to do next; the ``out`` rows are fetched
once per chunk that completes requests.

The slot width resolves on first use: an explicit value wins, then a
persisted decision of the autotuner's cache (``tuning/autotuner.py``),
then, with ``DL4J_TORCH_SERVE_AUTOTUNE`` set, a probe of
``DL4J_TORCH_SERVE_SLOTS_LADDER`` on the first full queue, else a width
derived from ``DL4J_TORCH_MEM_BUDGET``. Sampling: temperature 0 is greedy
(the same tokens as ``generate(temperature=0)``); a sampled row's noise
is a pure function of (pool base seed, request seed, position), so its
tokens do not depend on how admits interleave with decode chunks.

On the card every scheduler thread, like the caller's, launches on the
device's default stream, so several servers over one model (the replicas
behind a ``ReplicaRouter``) run their programs one after another on the
card and overlap on the host only: graphs captured from one model share
the cuBLAS workspaces bound at capture, and two of them replayed at once
on two streams compute wrong rows (``models/_cuda_graph.py``).

Fault sites (``DL4J_TORCH_FAULT_SPEC``): ``slow-request`` sleeps the loop
before decode dispatch N, ``client-disconnect`` cancels a request's
future right before its result lands, ``kill-replica`` ends the loop
without cleanup (with ``queue-overflow`` and ``expire-deadline`` from
``_base.py``).
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import (env_flag, env_float, env_int,
                                             env_str)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.errors import ServeStoppedError
from deeplearning4j_tpu_torch.models._cuda_graph import (StaticGraph,
                                                         captures_graphs)
from deeplearning4j_tpu_torch.models.transformer import (_ADMIT_FIELDS,
                                                         _PREFILL_FIELDS,
                                                         DECODE_MODES,
                                                         admit_record,
                                                         prefill_record)
from deeplearning4j_tpu_torch.serving._base import (_DISCONNECTS, _OCCUPANCY,
                                                    _REQ_SECONDS,
                                                    ServingFrontEnd,
                                                    int_ladder,
                                                    resolve_deadline)
from deeplearning4j_tpu_torch.testing import faults

__all__ = ["ContinuousLM", "slots_ladder", "kv_ladder", "prefill_ladder"]

_LOG = logging.getLogger(__name__)

# bounds of the memory-derived default slot width
_MIN_DEFAULT_SLOTS = 1
_MAX_DEFAULT_SLOTS = 64
_PROBE_REPS = 2          # timed reps per ladder rung (min taken)
# dispatch-poll rounds the scheduler waits for the queue to reach the
# ladder's widest rung before probing a queue that is not full
_PROBE_PATIENCE = 3
# pinned host staging records in flight before one is reused
_STAGE_RING = 32

_TOKENS = obs.counter("serve.tokens_total",
                      "Generated tokens delivered to completed requests")
_STEPS = obs.counter(
    "serve.decode_steps_total",
    "Decode steps advanced across all KV slots (chunk x dispatches)")
_SLOTS_G = obs.gauge("serve.slots",
                     "Resolved continuous-batching KV slot width")
_ACTIVE_G = obs.gauge("serve.active_slots",
                      "KV slots currently decoding a request")
_PROBES = obs.counter(
    "serve.autotune_probes_total",
    "Decode-width ladder probe measurements (zero on a tune-cache hit)")
_KV_WINDOW_G = obs.gauge(
    "serve.kv_window",
    "KV attention-window rung of the last decode chunk (the smallest "
    "ladder rung covering the pool's largest active position)")
_PREFILL_SECONDS = obs.histogram(
    "serve.prefill_seconds",
    "Admission-to-activation wall time of chunked-prefill requests "
    "(decode chunks interleaved between prefill windows included)")
_TTFT_SECONDS = obs.histogram(
    "serve.ttft_seconds",
    "Submit-to-first-token latency, recorded when the chunk holding a "
    "request's first sampled token has been dispatched (dispatch clock: "
    "it can lead the card's completion by the chunk in flight)")
_PREFILL_WINDOWS = obs.counter(
    "serve.prefill_windows_total",
    "Chunked-prefill window dispatches (compute + prefix inject)")
_PREFIX_HITS = obs.counter(
    "serve.prefix_hits_total",
    "Prefill windows served by injecting prefix-cache KV pages")
_PREFIX_MISSES = obs.counter(
    "serve.prefix_misses_total",
    "Prefill windows computed with the prefix cache enabled")
_PREFIX_EVICT = obs.counter(
    "serve.prefix_evictions_total",
    "Prefix-cache page entries evicted (LRU) past the "
    "DL4J_TORCH_SERVE_PREFIX_CACHE_MB budget")
_PREFIX_BYTES_G = obs.gauge(
    "serve.prefix_cache_bytes",
    "Bytes of KV pages held by the prompt-prefix cache")


def slots_ladder():
    """The ``DL4J_TORCH_SERVE_SLOTS_LADDER`` candidates (sorted,
    deduplicated, warn-and-fall-back on malformed values)."""
    return int_ladder("DL4J_TORCH_SERVE_SLOTS_LADDER", (2, 4, 8))


def kv_ladder(max_len, chunk, override=None):
    """The paged-attention KV window rungs for a model: sorted, each at
    least ``chunk`` (a dispatch advances a row ``chunk`` positions) and
    below ``max_len``, which is always the top rung.

    ``override`` (or the ``DL4J_TORCH_SERVE_KV_LADDER`` knob when None):
    empty derives 32, 64, ..., max_len; ``"off"`` keeps the single
    ``max_len`` rung (the un-paged program); an int sequence (argument) or
    comma list (knob) is clamped the same way."""
    if override is None:
        override = env_str("DL4J_TORCH_SERVE_KV_LADDER").strip()
    if isinstance(override, str):
        if override.lower() == "off":
            return (max_len,)
        rungs = int_ladder("DL4J_TORCH_SERVE_KV_LADDER", ()) if override \
            else ()
    else:
        rungs = tuple(int(r) for r in override)
    if not rungs:
        rungs, r = [], 32
        while r < max_len:
            rungs.append(r)
            r *= 2
    rungs = sorted({r for r in rungs if chunk <= r < max_len})
    return tuple(rungs) + (max_len,)


def prefill_ladder(max_len, override=None):
    """The chunked-prefill prompt-window rungs: 16, 64, 256, ... capped
    at ``max_len``. ``"off"`` (or an empty sequence) disables chunked
    prefill: prompts teacher-force through the decode chunk."""
    if override is None:
        override = env_str("DL4J_TORCH_SERVE_PREFILL_LADDER").strip()
    if isinstance(override, str):
        if override.lower() == "off":
            return ()
        if override:
            rungs = int_ladder("DL4J_TORCH_SERVE_PREFILL_LADDER", ())
        else:
            rungs, r = [], 16
            while r <= max_len:
                rungs.append(r)
                r *= 4
            rungs = rungs or [max_len]
    else:
        rungs = tuple(int(r) for r in override)
    return tuple(sorted({min(int(r), max_len) for r in rungs if r >= 1}))


# ContinuousLM's parameters shadow the ladder helpers (an override and
# its helper share the knob's name): aliases for use inside __init__
_kv_ladder_fn = kv_ladder
_prefill_ladder_fn = prefill_ladder


def _prefix_key(prompt, end):
    """Prefix-cache key: the hash of the prompt's first ``end`` tokens
    (windows start at fixed offsets, so two prompts sharing a prefix
    share the key of every full window inside it)."""
    return hashlib.sha1(np.ascontiguousarray(
        prompt[:end]).tobytes()).hexdigest()


def _params_token(lm):
    """What the prefix cache's pages were computed from: the parameter
    tree's identity and each leaf's in-place version counter, so pages
    of replaced or trained parameters are never injected."""
    return id(lm.params), tuple(p._version for p in lm.parameters())


class _PrefixKVCache:
    """Byte-bounded LRU of prefilled KV pages, keyed by prompt-prefix
    hash. Owned by the scheduler thread; every insert evicts the least
    recently used entries until the budget holds. ``pin`` is the
    :func:`_params_token` the pages belong to (``clear`` when it
    changes)."""

    def __init__(self, cap_bytes):
        self.cap = int(cap_bytes)
        self.pin = None
        self._map = OrderedDict()   # key -> (kpages, vpages, start, n, W)
        self._bytes = 0

    def __len__(self):
        return len(self._map)

    def get(self, key, start, n, W):
        e = self._map.get(key)
        if e is None or e[2:] != (start, n, W):
            return None
        self._map.move_to_end(key)
        return e[0], e[1]

    def put(self, key, kpages, vpages, start, n, W):
        nbytes = _nbytes(kpages) + _nbytes(vpages)
        if key in self._map or nbytes > self.cap:
            return
        self._map[key] = (kpages, vpages, start, n, W)
        self._bytes += nbytes
        while self._bytes > self.cap and self._map:
            _, old = self._map.popitem(last=False)   # LRU eviction
            self._bytes -= _nbytes(old[0]) + _nbytes(old[1])
            _PREFIX_EVICT.inc()
        _PREFIX_BYTES_G.set(self._bytes)

    def clear(self):
        self._map.clear()
        self._bytes = 0
        _PREFIX_BYTES_G.set(0)


def _nbytes(t):
    return t.numel() * t.element_size()


class _GenRequest:
    __slots__ = ("prompt", "n_new", "temp", "top_k", "top_p", "seed",
                 "future", "t0", "deadline", "on_tokens", "emitted")

    def __init__(self, prompt, n_new, temp, top_k, top_p, seed,
                 deadline=None, on_tokens=None):
        self.prompt = prompt
        self.n_new = n_new
        self.temp = temp
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.future = Future()
        self.t0 = time.monotonic()
        self.deadline = deadline     # absolute monotonic, None = none
        self.on_tokens = on_tokens   # streaming callback
        self.emitted = 0             # sampled tokens already streamed


class _Stage:
    """An int64 staging record: a device buffer the programs read, filled
    by one host-to-device copy a use. On the card the copy leaves a ring
    of pinned host buffers, each reused only once its last copy is done
    (an event), so a burst of admissions never waits for the card."""

    def __init__(self, n, device):
        self.dev = torch.zeros(n, dtype=torch.int64, device=device)
        self.ring = None
        if captures_graphs(device):
            self.ring = [(torch.zeros(n, dtype=torch.int64).pin_memory(),
                          torch.cuda.Event()) for _ in range(_STAGE_RING)]
            self.used = [False] * _STAGE_RING
            self.i = 0

    def load(self, rec):
        if self.ring is None:
            self.dev.copy_(torch.from_numpy(rec))
            return
        host, done = self.ring[self.i]
        if self.used[self.i]:
            done.synchronize()
        self.used[self.i] = True
        self.i = (self.i + 1) % _STAGE_RING
        host.numpy()[:] = rec
        self.dev.copy_(host, non_blocking=True)
        done.record()


class _SlotPool:
    """The decode state of one slot width, allocated once, and the
    programs bound to it: ``graphs`` maps a program signature to its
    :class:`StaticGraph` (captured on the card, direct calls on the CPU),
    all sharing one graph memory pool. Resetting the state happens in
    place, so the graphs stay bound to live storage; a new width is a new
    pool, and dropping a pool drops its graphs with it."""

    def __init__(self, lm, slots, seed):
        c = lm.conf
        dev = lm.device
        self.lm = lm
        self.slots = slots
        self.seed = seed
        self.state = lm._init_decode_state(slots, seed)
        self.graphs = {}
        self.params = lm.params
        self.mempool = (torch.cuda.graph_pool_handle()
                        if captures_graphs(dev) else None)
        self.admit_stage = _Stage(_ADMIT_FIELDS + c.max_len, dev)
        self._prefill = {}   # window rung -> (stage, ik, iv, pk, pv)

    def run(self, sig, fn):
        """Dispatch the program ``sig``: ``fn``, a closure over this
        pool's static tensors, captured on its first dispatch on the card.
        Parameters assigned anew since the graphs were captured make them
        stale: they are dropped and captured again."""
        if self.params is not self.lm.params:
            self.graphs.clear()
            self.params = self.lm.params
        g = self.graphs.get(sig)
        if g is None:
            g = self.graphs[sig] = StaticGraph(fn, self.lm.device,
                                               self.mempool)
        g()

    def reset(self):
        self.lm._reset_decode_state(self.state, self.seed)

    def prefill_buffers(self, W):
        """The rung's staging record, inject pages and computed pages."""
        bufs = self._prefill.get(W)
        if bufs is None:
            c = self.lm.conf
            shape = (c.n_layers, c.kv_heads, W, c.d_model // c.n_heads)
            dt, dev = self.lm._cache_dtype(), self.lm.device
            bufs = self._prefill[W] = (
                _Stage(_PREFILL_FIELDS + W, dev),
                *(torch.zeros(shape, dtype=dt, device=dev)
                  for _ in range(4)))
        return bufs

    def admit(self, rec):
        lm = self.lm
        self.admit_stage.load(rec)
        fn = lm._admit_fn(self.slots)
        self.run(lm._admit_signature(self.slots),
                 lambda: fn(self.state, self.admit_stage.dev))

    def decode(self, chunk, window, mode):
        lm = self.lm
        _, step = lm._decode_fns(self.slots, chunk, window, mode)
        self.run(lm._decode_signature(self.slots, chunk, window, mode),
                 lambda: step(lm.params, self.state))

    def prefill(self, W, inject, rec, pages=None):
        """One prefill window; returns the static computed pages (compute
        variant) for the caller to copy into the prefix cache."""
        lm = self.lm
        stage, ik, iv, pk, pv = self.prefill_buffers(W)
        stage.load(rec)
        if inject:
            ik.copy_(pages[0])
            iv.copy_(pages[1])
        fn = lm._prefill_fn(self.slots, W, inject)
        self.run(lm._prefill_signature(self.slots, W, inject),
                 lambda: fn(lm.params, self.state, stage.dev, ik, iv, pk,
                            pv))
        return pk, pv

    def out_rows(self):
        return self.state["out"].cpu().numpy()


class ContinuousLM(ServingFrontEnd):
    """Continuous-batching generation scheduler over one TransformerLM.

    ``submit(prompt, n_new)`` from any thread returns a Future of the
    full ``[P + n_new]`` token row; ONE scheduler thread owns the slot
    pool. Admission happens at chunk boundaries into freed KV slots. The
    server serves on ``device`` (None means the card) and refuses a model
    that lives elsewhere."""

    _thread_name = "dl4j-torch-serve-decode"

    def __init__(self, lm, *, slots=None, chunk=None, queue_cap=None,
                 seed=0, kv_ladder=None, prefill_ladder=None,
                 prefix_cache_mb=None, device=None):
        lm._check_decodable()
        dev = resolve_device(device)
        if lm.device != dev:
            raise ValueError(f"model lives on {lm.device}, the server "
                             f"on {dev}")
        super().__init__(queue_cap=queue_cap)
        if lm.params is None:
            lm.init()
        self.lm = lm
        self.device = dev
        self._slots_arg = None if slots is None else int(slots)
        self._chunk = chunk if chunk is not None \
            else env_int("DL4J_TORCH_SERVE_CHUNK", minimum=1)
        self._wait = max(env_float("DL4J_TORCH_SERVE_WAIT", minimum=0.0),
                         0.001)
        self._seed = seed
        # paged-attention / chunked-prefill rung ladders (argument > knob
        # > derived default; "off" = the un-paged behaviour)
        self._kv_ladder = _kv_ladder_fn(lm.conf.max_len, self._chunk,
                                        kv_ladder)
        self._prefill_ladder = _prefill_ladder_fn(lm.conf.max_len,
                                                  prefill_ladder)
        # pinned ladders overwrite a persisted rung decision; derived ones
        # adopt it (_sync_ladders)
        self._kv_explicit = kv_ladder is not None \
            or bool(env_str("DL4J_TORCH_SERVE_KV_LADDER").strip())
        self._prefill_explicit = prefill_ladder is not None \
            or bool(env_str("DL4J_TORCH_SERVE_PREFILL_LADDER").strip())
        mb = env_int("DL4J_TORCH_SERVE_PREFIX_CACHE_MB", minimum=0) \
            if prefix_cache_mb is None else int(prefix_cache_mb)
        self._prefix = _PrefixKVCache(mb << 20) \
            if mb and self._prefill_ladder else None
        # resolved on the first dispatch (autotune seam)
        self._slots = None
        self._probe_polls = 0
        self._pool = None
        # host mirrors of the device counters: slot -> [request, pos, tgt];
        # pos advances by exactly chunk per dispatch for active rows, so
        # completion needs no device read
        self._slot_req = {}
        # slots mid-prefill (admitted inactive): slot -> [request, plan,
        # next window index, admit time]
        self._prefilling = {}
        self._free = []

    # ---- client surface ------------------------------------------------
    def submit(self, prompt, n_new, *, temperature=0.0, top_k=None,
               top_p=None, seed=0, deadline_s=None, on_tokens=None):
        """Enqueue one generation request: ``prompt`` is a 1-D int token
        array; the Future resolves to ``[P + n_new]`` int32 (prompt
        included, the ``generate`` contract). ``top_k``/``top_p`` are
        per-request sampler parameters riding the slot state. Typed
        backpressure past ``DL4J_TORCH_SERVE_QUEUE`` pending requests.

        ``deadline_s`` is the request's deadline budget (seconds; default
        ``DL4J_TORCH_SERVE_DEADLINE_S``): still queued past it, the
        request fails with ``ServeDeadlineError`` before admission, with
        no device work. ``on_tokens`` streams: it is called from the
        scheduler thread with each newly sampled span (1-D int array) as
        chunks complete (one extra ``out`` fetch per chunk with
        streamers); a raising callback counts as a client disconnect."""
        c = self.lm.conf
        prompt = np.asarray(prompt).reshape(-1)
        if not np.issubdtype(prompt.dtype, np.integer) and prompt.size:
            raise ValueError("prompt must hold integer token ids")
        prompt = prompt.astype(np.int32)
        n_new = int(n_new)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.min() < 0 or prompt.max() >= c.vocab_size:
            raise ValueError(f"token ids must lie in [0, {c.vocab_size})")
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if prompt.size + n_new > c.max_len:
            raise ValueError(f"P+n_new={prompt.size + n_new} exceeds "
                             f"max_len={c.max_len}")
        if top_k is not None and not 1 <= int(top_k) <= c.vocab_size:
            raise ValueError(f"top_k must be in [1, {c.vocab_size}]")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if on_tokens is not None and not callable(on_tokens):
            raise ValueError("on_tokens must be callable")
        r = _GenRequest(prompt, n_new, float(temperature),
                        c.vocab_size if top_k is None else int(top_k),
                        1.0 if top_p is None else float(top_p), int(seed),
                        resolve_deadline(deadline_s), on_tokens)
        return self._enqueue(r)

    def generate(self, prompt, n_new, *, temperature=0.0, top_k=None,
                 top_p=None, seed=0, timeout=120.0):
        """Synchronous ``submit``: the ``[P + n_new]`` token row."""
        return self.submit(prompt, n_new, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           seed=seed).result(timeout)

    def graph_inventory(self):
        """The sorted program signatures bound to the current slot pool
        (captured graphs on the card)."""
        pool = self._pool
        return sorted(pool.graphs) if pool is not None else []

    # ---- lifecycle -----------------------------------------------------
    def _loop(self):
        if captures_graphs(self.device):
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            self._decode_loop()

    def warm_start(self, slots=None):
        """Resolve the slot width and capture the whole program inventory
        before the first submit: the admit program, every decode chunk
        (each KV window rung in each sampler variant) and every prefill
        program (each prompt-window rung, compute and inject), each run
        once as a no-op dispatch (all rows inactive, zero valid tokens).
        The state is then reset in place, so the graphs stay bound to it.
        Refused while the scheduler thread runs: it owns the pool."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError(
                    "warm_start() must run before serving starts: the "
                    "scheduler thread owns the slot pool once submits "
                    "flow (stop() first)")
        s = self._resolve_slots(force=True) if slots is None else int(slots)
        self._bind_slots(s)
        pool = self._pool
        c = self.lm.conf
        with torch.no_grad():
            pool.admit(self._release_record(0))
            for w in self._kv_ladder:
                for mode in DECODE_MODES:
                    pool.decode(self._chunk, w, mode)
            for w in self._prefill_ladder:
                rec = prefill_record(0, (), 0, 0, False, w)
                pool.prefill(w, False, rec)
                shape = (c.n_layers, c.kv_heads, w, c.d_model // c.n_heads)
                zeros = torch.zeros(shape, dtype=self.lm._cache_dtype(),
                                    device=self.device)
                pool.prefill(w, True, rec, (zeros, zeros))
            # the warm dispatches scribbled slot 0's position; start from
            # a blank pool, in place
            pool.reset()
        return s

    def _after_stop(self, joined):
        """The scheduler has exited: fail in-flight requests typed and
        release the pool (its state, graphs and staging) and the prefix
        pages, so a stopped server holds no device memory; a restart
        binds a fresh pool at full capacity. When the join timed out the
        thread still owns the table: leave it alone."""
        if not joined:
            return
        for rec in list(self._slot_req.values()) \
                + list(self._prefilling.values()):
            if not rec[0].future.done():
                rec[0].future.set_exception(
                    ServeStoppedError("serving stopped before this "
                                      "generation completed"))
        self._slot_req.clear()
        self._prefilling.clear()
        self._slots = None
        self._pool = None
        self._free = []
        if self._prefix is not None:
            self._prefix.clear()
        _ACTIVE_G.set(0)

    # ---- slot-width resolution (decode-width autotuner) ----------------
    def _tune_keys(self):
        from deeplearning4j_tpu_torch.tuning import autotuner
        return autotuner.model_key(self.lm), \
            autotuner.backend_key(self.device)

    def _resolve_slots(self, force=False):
        """The slot width: explicit argument or knob > persisted decision
        > ladder probe (armed, on the first full queue) > memory-derived
        default. None defers (queue not full, patience left)."""
        if self._slots_arg is not None:
            return self._slots_arg
        explicit = env_int("DL4J_TORCH_SERVE_SLOTS", minimum=1)
        if explicit:
            return explicit
        from deeplearning4j_tpu_torch.tuning import autotuner
        mk, backend = self._tune_keys()
        bucket_key = ("serve_slots", self._chunk, self.lm.conf.max_len)
        hit = autotuner.lookup_decision(mk, backend, bucket_key)
        if hit is not None:
            return hit
        if not env_flag("DL4J_TORCH_SERVE_AUTOTUNE"):
            return self._default_slots()
        ladder = slots_ladder()
        if not force:
            with self._lock:
                depth = len(self._pending)
            if depth < ladder[-1] and self._probe_polls < _PROBE_PATIENCE:
                self._probe_polls += 1
                return None
        return self._probe_slots(mk, backend, bucket_key, ladder)

    def _default_slots(self):
        """The slot width derived from memory: one slot's KV bytes
        (``2 * layers * kv_heads * max_len * head_dim * cache dtype
        size``) into half the ``DL4J_TORCH_MEM_BUDGET`` left after the
        parameters (the other half is headroom for activations), clamped
        to [1, 64]; the derivation is logged."""
        c = self.lm.conf
        hd = c.d_model // c.n_heads
        dsize = torch.empty((), dtype=self.lm._cache_dtype()).element_size()
        kv_slot = 2 * c.n_layers * c.kv_heads * c.max_len * hd * dsize
        params_b = sum(_nbytes(p) for p in self.lm.parameters())
        budget = env_int("DL4J_TORCH_MEM_BUDGET", minimum=1)
        avail = max(budget // 2 - params_b, 0)
        slots = min(max(avail // kv_slot, _MIN_DEFAULT_SLOTS),
                    _MAX_DEFAULT_SLOTS)
        _LOG.info(
            "serve slots default derived from memory: budget=%d B, "
            "params=%d B, kv_cache/slot=%d B -> %d slots (clamped to "
            "[%d, %d])", budget, params_b, kv_slot, slots,
            _MIN_DEFAULT_SLOTS, _MAX_DEFAULT_SLOTS)
        return slots

    def _probe_slots(self, mk, backend, bucket_key, ladder):
        """Time one all-slots-active chunk per ladder width on a scratch
        pool (first dispatch warm, then the min of timed reps), pick the
        best per-token width, drop the losers' programs, and persist the
        decision."""
        from deeplearning4j_tpu_torch.tuning import autotuner
        lm = self.lm
        top = self._kv_ladder[-1]   # probe at the max_len rung: the
        per_tok = {}                # conservative steady-state cost
        for s in ladder:
            pool = _SlotPool(lm, s, self._seed)
            pool.state["active"].fill_(True)
            pool.state["nnew"].fill_(lm.conf.max_len - 1)
            with torch.no_grad():
                pool.decode(self._chunk, top, "greedy")     # warm
                pool.state["pos"].cpu()
                best = None
                for _ in range(_PROBE_REPS):
                    pool.state["pos"].zero_()
                    t0 = time.perf_counter()
                    pool.decode(self._chunk, top, "greedy")
                    pool.state["pos"].cpu()   # the dispatch has finished
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
            per_tok[s] = best / (s * self._chunk)
            _PROBES.inc()
        winner = min(ladder, key=lambda s: (per_tok[s], -s))
        for s in ladder:
            if s != winner:   # the losers' programs leave the cache
                lm._jit_decode.pop(lm._decode_signature(
                    s, self._chunk, top, "greedy"), None)
                lm._jit_decode.pop(lm._admit_signature(s), None)
        autotuner.record_decision(mk, backend, bucket_key, winner, per_tok)
        return winner

    def _sync_ladders(self):
        """Persist the rung ladders beside the slot decision and, where no
        ladder is pinned, adopt a persisted one, so a restarted server
        re-arms the same program inventory. Recording is gated on
        ``DL4J_TORCH_SERVE_AUTOTUNE`` (an unarmed server never writes the
        shared cache); adoption reads what an armed run left."""
        from deeplearning4j_tpu_torch.tuning import autotuner
        mk, backend = self._tune_keys()
        c = self.lm.conf
        armed = env_flag("DL4J_TORCH_SERVE_AUTOTUNE")
        for name, attr, explicit in (
                ("serve_kv_ladder", "_kv_ladder", self._kv_explicit),
                ("serve_prefill_ladder", "_prefill_ladder",
                 self._prefill_explicit)):
            bkey = (name, self._chunk, c.max_len)
            hit = autotuner.lookup_decision(mk, backend, bkey)
            cur = getattr(self, attr)
            if hit is not None and not explicit:
                setattr(self, attr, tuple(hit))
            elif armed and (hit is None or tuple(hit) != tuple(cur)):
                autotuner.record_decision(mk, backend, bkey, cur, {})

    def _bind_slots(self, s):
        if self._slots == s and self._pool is not None:
            return
        self._sync_ladders()
        self._slots = s
        self._pool = _SlotPool(self.lm, s, self._seed)
        self._slot_req = {}
        self._prefilling = {}
        self._free = list(range(s))
        _SLOTS_G.set(s)

    # ---- scheduler (single owner thread) -------------------------------
    def _release_record(self, slot):
        c = self.lm.conf
        return admit_record(c, slot, (), 1, 0, 0.0, c.vocab_size, 1.0,
                            False, 0)

    def _admit(self, slot, r):
        """Write request ``r`` into cache row ``slot`` (one admit program
        for every slot). A prompt whose span to prefill (P - 1) fills at
        least the smallest prefill rung is admitted inactive and handed
        to the prefill pump; the final window leaves ``pos`` at
        ``plen - 1`` and sets the row live. Shorter prompts teacher-force
        through the shared decode chunk."""
        c = self.lm.conf
        span = r.prompt.size - 1
        use_prefill = bool(self._prefill_ladder) \
            and span >= self._prefill_ladder[0]
        self._pool.admit(admit_record(
            c, slot, r.prompt, r.prompt.size, r.n_new, r.temp, r.top_k,
            r.top_p, not use_prefill, r.seed))
        if use_prefill:
            self._prefilling[slot] = [r, self._plan_prefill(span), 0,
                                      time.monotonic()]
        else:
            # complete once pos >= plen + n_new - 1 (the last needed sample
            # falls out of position plen + n_new - 2)
            self._slot_req[slot] = [r, 0, r.prompt.size + r.n_new - 1]

    def _plan_prefill(self, span):
        """Prefill windows for a ``span``-token prompt prefix: full windows
        at the largest rung, one tail window at the smallest rung
        covering the rest. Boundaries depend only on the offset, so two
        prompts sharing a prefix share every full window's key.
        Returns [(start, rung, n_valid), ...]."""
        top = self._prefill_ladder[-1]
        plan, s = [], 0
        while span - s > 0:
            rem = span - s
            if rem >= top:
                plan.append((s, top, top))
                s += top
            else:
                rung = min(r for r in self._prefill_ladder if r >= rem)
                plan.append((s, rung, rem))
                s = span
        return plan

    def _pump_prefill(self):
        """Dispatch ONE prefill window (FIFO over mid-prefill slots) per
        scheduler iteration, so long prompts interleave with decode
        chunks. On a prefix-cache hit the window's pages are injected
        (the inject program); on a miss the computed pages are kept for
        the next prompt sharing the prefix."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        rec = self._prefilling[slot]
        r, plan, idx, t0 = rec
        start, W, n = plan[idx]
        final = idx == len(plan) - 1
        cache = self._prefix
        if cache is not None:
            token = _params_token(self.lm)
            if cache.pin != token:
                cache.clear()   # pages of other parameters never inject
                cache.pin = token
        key = entry = None
        if cache is not None:
            key = _prefix_key(r.prompt, start + n)
            entry = cache.get(key, start, n, W)
        stage = prefill_record(slot, r.prompt[start:start + n], start, n,
                               final, W)
        if entry is not None:
            _PREFIX_HITS.inc()
        elif cache is not None:
            _PREFIX_MISSES.inc()
        kp, vp = self._pool.prefill(W, entry is not None, stage, entry)
        _PREFILL_WINDOWS.inc()
        if cache is not None and entry is None:
            cache.put(key, kp.clone(), vp.clone(), start, n, W)
        if final:
            del self._prefilling[slot]
            span = r.prompt.size - 1
            self._slot_req[slot] = [r, span, r.prompt.size + r.n_new - 1]
            _PREFILL_SECONDS.record(time.monotonic() - t0)
        else:
            rec[2] = idx + 1

    def _select_rung(self):
        """Smallest KV window rung covering every active row through the
        next chunk, from the host's position mirrors."""
        need = max(rec[1] for rec in self._slot_req.values()) + self._chunk
        for r in self._kv_ladder:
            if r >= need:
                return r
        return self._kv_ladder[-1]

    def _select_mode(self):
        """The decode chunk's sampler variant: ``greedy`` when no active
        row samples; else ``filter`` when an admitted request (active or
        mid-prefill, the rows whose state the reference's device-side
        test sees) filters; else ``sample``."""
        if all(rec[0].temp <= 0.0 for rec in self._slot_req.values()):
            return "greedy"
        V = self.lm.conf.vocab_size
        for rec in list(self._slot_req.values()) \
                + list(self._prefilling.values()):
            if rec[0].top_k < V or rec[0].top_p < 1.0:
                return "filter"
        return "sample"

    def _release(self, slot):
        self._pool.admit(self._release_record(slot))
        self._free.append(slot)

    def _fill_free_slots(self):
        while self._free:
            r = self._pop_pending()
            if r is None:
                return
            # pre-admission deadline sweep: an expired request fails typed
            # here and never touches a slot
            if not self._sweep_expired([r]):
                continue
            self._admit(self._free.pop(), r)

    def _decode_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
                if not self._pending and not self._slot_req \
                        and not self._prefilling:
                    self._more.wait(self._wait)   # bounded idle poll
                    continue
            if self._pool is None:
                s = self._resolve_slots()
                if s is None:        # autotune waiting for a full queue
                    time.sleep(self._wait)
                    continue
                self._bind_slots(s)
            self._fill_free_slots()
            self._pump_prefill()
            if not self._slot_req:
                continue
            if self._replica_fault():
                return   # kill-replica: hard crash, no cleanup
            spec = faults.fire("slow-request")
            if spec is not None:
                time.sleep(spec.param_float(0.05))
            rung = self._select_rung()
            self._pool.decode(self._chunk, rung, self._select_mode())
            _KV_WINDOW_G.set(rung)
            _STEPS.inc(self._chunk * len(self._slot_req))
            _OCCUPANCY.record(len(self._slot_req) / self._slots)
            _ACTIVE_G.set(len(self._slot_req))
            done, now = [], None
            for slot, rec in self._slot_req.items():
                old = rec[1]
                rec[1] += self._chunk
                plen = rec[0].prompt.size
                if old < plen <= rec[1]:   # the first sampled token's chunk
                    if now is None:
                        now = time.monotonic()
                    _TTFT_SECONDS.record(now - rec[0].t0)
                if rec[1] >= rec[2]:
                    done.append(slot)
            self._stream_emit()
            if done:
                self._complete(done)

    def _stream_emit(self):
        """Incremental delivery to streaming requests: one ``out`` fetch
        per chunk with streamers whose sampled count advanced. A raising
        callback is a client disconnect: the future is cancelled and
        ``_complete`` discards the row."""
        pend = []
        for slot, rec in self._slot_req.items():
            r = rec[0]
            if r.on_tokens is None or r.future.cancelled():
                continue
            have = min(max(rec[1] - (r.prompt.size - 1), 0), r.n_new)
            if have > r.emitted:
                pend.append((slot, r, have))
        if not pend:
            return
        out_host = self._pool.out_rows()
        for slot, r, have in pend:
            try:
                r.on_tokens(out_host[slot, r.emitted:have].astype(np.int32))
            except Exception:
                r.future.cancel()   # a dead stream consumer == disconnect
            r.emitted = have

    def _complete(self, done):
        """Fetch ``out`` ONCE for this chunk's completions, resolve their
        futures, then refill each freed row from the queue or park it
        inactive."""
        out_host = self._pool.out_rows()
        now = time.monotonic()
        for slot in done:
            r, _, _ = self._slot_req.pop(slot)
            if faults.fire("client-disconnect") is not None:
                r.future.cancel()
            if r.future.cancelled():
                _DISCONNECTS.inc()
            else:
                toks = np.concatenate(
                    [r.prompt, out_host[slot, :r.n_new].astype(np.int32)])
                r.future.set_result(toks)
                _TOKENS.inc(r.n_new)
                _REQ_SECONDS.record(now - r.t0)
        for slot in done:
            r = self._pop_pending()
            if r is not None and self._sweep_expired([r]):
                self._admit(slot, r)   # the freed row reused mid-decode
            else:
                self._release(slot)
        _ACTIVE_G.set(len(self._slot_req))
