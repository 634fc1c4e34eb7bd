"""Registry of every ``DL4J_TORCH_*`` environment knob the port reads.

Each knob is declared here once, with its type, default and a one-line
doc that names its ``DL4J_TPU_*`` counterpart in the JAX package. The
port reads its own names only, so a setting meant for the JAX package
can never steer the port.

Contracts shared by every knob (the same as the JAX registry's):

- values are read from ``os.environ`` at call time, never cached at
  import, so tests and tools may set a knob after importing the package;
- a malformed value warns and falls back to the declared default;
- reading an undeclared name raises ``KeyError``: that is a programming
  error, not a user error.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

__all__ = ["Knob", "KNOBS", "env_flag", "env_int", "env_float", "env_is_set",
           "env_str"]


@dataclass(frozen=True)
class Knob:
    name: str       # full env var name, DL4J_TORCH_* (one DL4J_TPU_*)
    kind: str       # "flag" | "int" | "float" | "str"
    default: object
    doc: str        # one line


KNOBS: dict[str, Knob] = {}


def _declare(name, kind, default, doc):
    if name in KNOBS:
        raise ValueError(f"duplicate knob declaration {name!r}")
    KNOBS[name] = Knob(name, kind, default, doc)


# keep alphabetical
_declare("DL4J_TORCH_CKPT_EVERY", "int", 0,
         "Default periodic-checkpoint cadence (parameter updates between "
         "training checkpoints) of fit(checkpoint_dir=...); 0 disables "
         "unless fit's checkpoint_every argument sets one. Counterpart: "
         "DL4J_TPU_CKPT_EVERY.")
_declare("DL4J_TORCH_CKPT_KEEP", "int", 3,
         "Rolling retention of training checkpoints: the newest K are kept "
         "in a directory. Counterpart: DL4J_TPU_CKPT_KEEP.")
_declare("DL4J_TORCH_CKPT_VERIFY", "flag", True,
         "Check each payload's CRC-32 against the archive's manifest when "
         "a checkpoint is restored; 0 skips that pass (a structurally "
         "damaged archive still raises CheckpointCorruptError). "
         "Counterpart: DL4J_TPU_CKPT_VERIFY.")
_declare("DL4J_TORCH_COLLECTIVE_TIMEOUT", "float", 300.0,
         "Per-round deadline (seconds) of the coordinator's collectives "
         "(parallel/coordinator.py): a round not completed within it "
         "fails on every waiter with CollectiveTimeoutError instead of "
         "hanging. Counterpart: DL4J_TPU_COLLECTIVE_TIMEOUT.")
_declare("DL4J_TORCH_CONNECT_RETRIES", "int", 3,
         "Extra connection attempts (exponential backoff) a collective "
         "client makes before giving up on the coordinator. Counterpart: "
         "DL4J_TPU_CONNECT_RETRIES.")
_declare("DL4J_TORCH_CONNECT_TIMEOUT", "float", 10.0,
         "Per-attempt TCP connect timeout (seconds) of a collective "
         "client; retried DL4J_TORCH_CONNECT_RETRIES times. Counterpart: "
         "DL4J_TPU_CONNECT_TIMEOUT.")
_declare("DL4J_TORCH_DATA_DIR", "str", "",
         "Root of the offline dataset files (e.g. <root>/mnist/ with the "
         "idx files), searched before ~/.deeplearning4j_tpu. "
         "Counterpart: DL4J_TPU_DATA_DIR.")
_declare("DL4J_TORCH_DP_SHARD", "int", None,
         "ZeRO level of the data-parallel trainers (parallel/"
         "sharding_core.py): 0 replicated, 1 updater state sharded 1/N, 2 "
         "+ gradients reduce-scattered, 3 + parameters sharded between "
         "steps; unset defers to DL4J_TORCH_DP_SHARD_UPDATER. "
         "Counterpart: DL4J_TPU_DP_SHARD.")
_declare("DL4J_TORCH_DP_SHARD_UPDATER", "flag", True,
         "Legacy ZeRO-1 switch, the default of DL4J_TORCH_DP_SHARD while "
         "that is unset: on is level 1, off level 0. Counterpart: "
         "DL4J_TPU_DP_SHARD_UPDATER.")
_declare("DL4J_TORCH_ELASTIC", "flag", False,
         "Elastic membership: the coordinator accepts re-form waves "
         "(OP_REFORM) and expels a straggler that misses a round's "
         "deadline, and the parameter-server wrapper hands a dead "
         "trainer's queued batches to the survivors instead of failing "
         "the fit. Counterpart: DL4J_TPU_ELASTIC.")
_declare("DL4J_TORCH_ELASTIC_MIN_WORKERS", "int", 1,
         "Least world size an elastic re-form wave may commit at: a wave "
         "that cannot gather this many participants within "
         "DL4J_TORCH_REFORM_TIMEOUT fails every arrival with "
         "CollectiveTimeoutError. Counterpart: "
         "DL4J_TPU_ELASTIC_MIN_WORKERS.")
_declare("DL4J_TORCH_FAULT_SPEC", "str", "",
         "Deterministic fault-injection plan (testing/faults.py), e.g. "
         "'queue-overflow@0,slow-request@1:0.2'; empty disables every "
         "injection point. Counterpart: DL4J_TPU_FAULT_SPEC.")
_declare("DL4J_TORCH_FLASH_BWD", "str", "auto",
         "Flash-attention backward route: 'scan' differentiates the plain "
         "forward recurrence (blockwise attention; dense attention with a "
         "window) by autograd, on CPU tensors only (on the card it "
         "raises); any other value ('auto') takes the dQ and dK/dV CUDA "
         "kernels for a CUDA tensor and their plain twin for a CPU "
         "tensor. Counterpart: DL4J_TPU_FLASH_BWD.")
_declare("DL4J_TORCH_FUSE_ADAPT", "flag", True,
         "Adaptive fused-loop grouping: only the trailing group of a shape "
         "bucket is padded to its full K; a mid-stream rebucket flush emits "
         "the partial group at the next power of 2 (per batch at length "
         "1), and a bucket that thrashes halves its K toward 1; 0 pads "
         "every short group to K. Counterpart: DL4J_TPU_FUSE_ADAPT.")
_declare("DL4J_TORCH_FUSE_AUTOTUNE", "flag", False,
         "Fusion autotuner: with DL4J_TORCH_FUSE_STEPS unset, fit() groups "
         "an undecided shape bucket at the probe size, times zero-weight "
         "groups at each DL4J_TORCH_FUSE_PROBE_KS rung once and keeps the "
         "fastest per-step K (persisted under DL4J_TORCH_TUNE_CACHE_DIR). "
         "Counterpart: DL4J_TPU_FUSE_AUTOTUNE.")
_declare("DL4J_TORCH_FUSE_PROBE_KS", "str", "1,4,8,16",
         "Fused-K candidates the fusion autotuner probes (comma-separated "
         "ints; the largest is the probe group size). Counterpart: "
         "DL4J_TPU_FUSE_PROBE_KS.")
_declare("DL4J_TORCH_FUSE_STEPS", "int", 8,
         "Fused-loop group size K for MultiLayerNetwork.fit(iterator): the "
         "prefetch worker stacks up to K same-shape batches into one "
         "StackedDataSet that fit_fused trains in one pass (on the card, "
         "a replayed CUDA graph a tBPTT window); 1 keeps the per-batch "
         "loop. Counterpart: DL4J_TPU_FUSE_STEPS.")
_declare("DL4J_TORCH_FUSE_TBPTT", "flag", True,
         "Let tBPTT models take the fused loop (each window's train step "
         "one captured CUDA graph on the card); 0 keeps them on the "
         "per-batch host window loop. Counterpart: DL4J_TPU_FUSE_TBPTT.")
_declare("DL4J_TORCH_LM_ATTN", "str", "auto",
         "TransformerLM block attention route when block_size is set: "
         "'scan' takes the plain blockwise recurrence (CPU tensors only: "
         "on the card it raises); any other value "
         "('auto') goes through ops.flash_attention (the CUDA kernel for "
         "a CUDA tensor, its plain twin for a CPU tensor). Counterpart: "
         "DL4J_TPU_LM_ATTN.")
_declare("DL4J_TORCH_MEM_BUDGET", "int", 17179869184,
         "Per-device memory budget in bytes (default 16 GiB, the "
         "reference's default, not the card's 80 GB) that ContinuousLM "
         "derives its default slot width from: half of it, less the "
         "parameters, over one slot's KV bytes. Counterpart: "
         "DL4J_TPU_MEM_BUDGET.")
_declare("DL4J_TORCH_LSTM_KERNEL", "str", "auto",
         "LSTM time-step route: 'builtin' differentiates the plain "
         "recurrence (LSTM._scan_builtin) by autograd, on CPU tensors only "
         "(on the card it raises); any other value ('auto') takes "
         "ops.lstm_cell (the CUDA kernels for a CUDA tensor, their plain "
         "twins for a CPU tensor) wherever the layer has sigmoid gates "
         "and a tanh cell. Counterpart: DL4J_TPU_LSTM_KERNEL.")
_declare("DL4J_TORCH_METRICS", "flag", True,
         "Record into the obs metric registry; 0 turns every record into "
         "a no-op. Counterpart: DL4J_TPU_METRICS.")
_declare("DL4J_TORCH_MODEL_CACHE", "str", "~/.dl4j_torch/trainedmodels",
         "Root of the pretrained-model weight cache that TrainedModelHelper "
         "looks in (modelimport/trained_models.py; local files only). "
         "Counterpart: DL4J_TPU_MODEL_CACHE.")
_declare("DL4J_TORCH_NANGUARD", "flag", True,
         "Non-finite guard in MultiLayerNetwork's train step: a step whose "
         "loss or gradients are not finite is reverted on the device "
         "(params, updater state, tBPTT carries, iteration) and counted. "
         "Counterpart: DL4J_TPU_NANGUARD.")
_declare("DL4J_TORCH_NANGUARD_CKPT", "str", "dl4j_tpu_diverged.zip",
         "Path the non-finite guard writes the model (its last good "
         "parameters) to before raising TrainingDivergedError. "
         "Counterpart: DL4J_TPU_NANGUARD_CKPT.")
_declare("DL4J_TORCH_NANGUARD_PATIENCE", "int", 3,
         "Consecutive dispatches (a step, or a fused group) holding a "
         "reverted non-finite step that the guard tolerates before it "
         "writes the model and raises TrainingDivergedError. Counterpart: "
         "DL4J_TPU_NANGUARD_PATIENCE.")
_declare("DL4J_TORCH_REFORM_TIMEOUT", "float", 30.0,
         "Deadline (seconds) of one elastic re-form wave: each OP_REFORM "
         "arrival waits at most this long; at expiry the wave commits "
         "with whoever arrived (if at least DL4J_TORCH_ELASTIC_MIN_WORKERS, "
         "a driver among them) or fails every arrival with "
         "CollectiveTimeoutError. Counterpart: DL4J_TPU_REFORM_TIMEOUT.")
_declare("DL4J_TORCH_ROUTER_HEARTBEAT_S", "float", 0.25,
         "Heartbeat interval (seconds) of ReplicaRouter: each beat checks "
         "every replica's health, sets router.replicas_healthy and the "
         "rolling p99 of the SLO gate, and fails a dead replica over. "
         "Counterpart: DL4J_TPU_ROUTER_HEARTBEAT_S.")
_declare("DL4J_TORCH_SERVE_AUTOTUNE", "flag", False,
         "Decode-width autotuner of ContinuousLM: with "
         "DL4J_TORCH_SERVE_SLOTS unset and no persisted decision, probe "
         "DL4J_TORCH_SERVE_SLOTS_LADDER on the first full queue and "
         "persist the winner (and the rung ladders) under "
         "DL4J_TORCH_TUNE_CACHE_DIR. Counterpart: DL4J_TPU_SERVE_AUTOTUNE.")
_declare("DL4J_TORCH_SERVE_BUCKETS", "str", "8",
         "Batch-size bucket ladder (comma-separated ints) the serving "
         "batcher pads request batches into. Counterpart: "
         "DL4J_TPU_SERVE_BUCKETS.")
_declare("DL4J_TORCH_SERVE_CHUNK", "int", 8,
         "Decode steps per ContinuousLM dispatch: each dispatch (one "
         "replayed CUDA graph on the card) advances every active KV slot "
         "by this many tokens; requests are admitted at chunk boundaries. "
         "Counterpart: DL4J_TPU_SERVE_CHUNK.")
_declare("DL4J_TORCH_SERVE_DEADLINE_S", "float", 0.0,
         "Default per-request deadline budget (seconds) for submits that "
         "carry none; a request still queued past it is swept with "
         "ServeDeadlineError before dispatch. 0 disables. Counterpart: "
         "DL4J_TPU_SERVE_DEADLINE_S.")
_declare("DL4J_TORCH_SERVE_GEN_CACHE", "int", 8,
         "Bound on TransformerLM's cache of generate()/beam_search() "
         "programs (one captured CUDA graph each on the card, keyed by "
         "_gen_signature): the oldest is evicted first once it holds "
         "this many. Counterpart: DL4J_TPU_SERVE_GEN_CACHE.")
_declare("DL4J_TORCH_SERVE_KV_LADDER", "str", "",
         "KV attention-window rungs of ContinuousLM's paged decode: each "
         "chunk attends over the first W positions of the slot pool, W "
         "the smallest rung covering the pool's largest active position. "
         "Empty derives 32, 64, ... up to max_len; 'off' keeps the one "
         "max_len rung; comma-separated ints are clamped to [chunk, "
         "max_len]. Counterpart: DL4J_TPU_SERVE_KV_LADDER.")
_declare("DL4J_TORCH_SERVE_PREFILL_LADDER", "str", "",
         "Prompt-window rungs of ContinuousLM's chunked prefill: a "
         "prompt is ingested a whole window per dispatch. Empty derives "
         "16, 64, 256, ... up to max_len; 'off' disables chunked prefill "
         "(prompts teacher-force through the decode chunk). Counterpart: "
         "DL4J_TPU_SERVE_PREFILL_LADDER.")
_declare("DL4J_TORCH_SERVE_PREFIX_CACHE_MB", "int", 64,
         "Byte budget (MiB) of ContinuousLM's prompt-prefix KV page cache "
         "(least recently used pages evicted past it); 0 disables prefix "
         "sharing. Counterpart: DL4J_TPU_SERVE_PREFIX_CACHE_MB.")
_declare("DL4J_TORCH_SERVE_QUEUE", "int", 256,
         "Serving request-queue capacity: a submit past this depth fails "
         "fast with ServeQueueFullError. Counterpart: "
         "DL4J_TPU_SERVE_QUEUE.")
_declare("DL4J_TORCH_SERVE_SLOTS", "int", None,
         "Slot count of ContinuousLM's persistent KV pool [slots, "
         "kv_heads, max_len, head_dim]; unset takes the persisted or "
         "probed decision, else the width derived from "
         "DL4J_TORCH_MEM_BUDGET. Counterpart: DL4J_TPU_SERVE_SLOTS.")
_declare("DL4J_TORCH_SERVE_SLOTS_LADDER", "str", "2,4,8",
         "Slot widths the decode-width autotuner probes "
         "(comma-separated ints). Counterpart: "
         "DL4J_TPU_SERVE_SLOTS_LADDER.")
_declare("DL4J_TORCH_SERVE_SLO_MS", "float", 0.0,
         "Latency SLO (milliseconds) of ReplicaRouter's shed gate: while "
         "the rolling p99 of serve.request_seconds over a heartbeat "
         "window exceeds it, new submits fail at once with "
         "ServeQueueFullError (429 at the ingress); 0 disables shedding. "
         "Counterpart: DL4J_TPU_SERVE_SLO_MS.")
_declare("DL4J_TORCH_SERVE_WAIT", "float", 0.002,
         "Batcher linger (seconds): how long the batch loop waits for "
         "more same-shape requests before dispatching a partial (padded) "
         "batch; ContinuousLM's idle poll interval. Counterpart: "
         "DL4J_TPU_SERVE_WAIT.")
_declare("DL4J_TORCH_TRANSFER_STAGE", "int", 8,
         "Super-batch staging factor of fit(iterator)'s prefetch: up to "
         "this many equal-shape maskless batches travel to the device in "
         "one copy; 1 disables. Counterpart: DL4J_TPU_TRANSFER_STAGE.")
_declare("DL4J_TORCH_TRANSFER_STAGE_BYTES", "int", 256 * 1024 * 1024,
         "Byte cap on one staged or stacked transfer (and about twice this "
         "on queued batches). Counterpart: DL4J_TPU_TRANSFER_STAGE_BYTES.")
_declare("DL4J_TORCH_TRACE_DIR", "str", "",
         "Directory for Chrome trace-event span files (obs/tracing.py, "
         "one trace_<pid>.json per process); empty disables span "
         "recording. Counterpart: DL4J_TPU_TRACE_DIR.")
_declare("DL4J_TORCH_TUNE_CACHE_DIR", "str", "~/.dl4j_torch/tune",
         "Directory the autotuner's decisions persist in (one JSON file a "
         "model and backend, committed by atomic_io's tmp+fsync+rename); "
         "empty keeps decisions in memory only. Counterpart: "
         "DL4J_TPU_TUNE_CACHE_DIR.")
_declare("DL4J_TORCH_W2V_BATCH", "int", None,
         "Word2Vec pair-batch size of the benchmark harnesses; unset "
         "takes each harness's default. Counterpart: DL4J_TPU_W2V_BATCH.")
_declare("DL4J_TORCH_W2V_DTYPE", "str", "float32",
         "Word2Vec lookup-table storage dtype, float32 or bfloat16; the "
         "update's arithmetic stays f32. Counterpart: DL4J_TPU_W2V_DTYPE.")
_declare("DL4J_TORCH_W2V_SCATTER", "str", "sorted",
         "Word2Vec scatter strategy: 'sorted' (a sort and a segment sum, "
         "then one write a unique row: the same bits on every run), "
         "'fused' (one index_add_ of all rows) or 'two' (one index_add_ "
         "a table); on the card the last two add with atomics, so their "
         "f32 sums are not reproducible. Read when a step is built; "
         "nlp.lookup.set_scatter_impl switches it. Counterpart: "
         "DL4J_TPU_W2V_SCATTER.")
_declare("DL4J_TPU_DISABLE_HELPERS", "flag", False,
         "Disable every accelerated layer helper (nn/helpers.py: the flash "
         "route of SelfAttentionLayer, the im2col route of small convs, "
         "the LSTM helper); the layers take their built-in paths. The one "
         "knob that keeps the reference's name, so a script that sets it "
         "for the JAX package sets it here too.")


def _warn(name, raw, kind, default):
    warnings.warn(f"{name}={raw!r} is not a valid {kind}; "
                  f"using the default ({default!r})")


_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))


def env_flag(name):
    """Boolean knob: 1/true/yes/on or 0/false/no/off (any case); a set
    but empty variable counts as unset; anything else warns and falls
    back to the default."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return knob.default
    low = raw.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    _warn(name, raw, "flag", knob.default)
    return knob.default


def env_int(name, *, minimum=None):
    """Integer knob; ``minimum`` clamps the parsed value."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    try:
        v = int(raw)
    except ValueError:
        _warn(name, raw, "int", knob.default)
        return knob.default
    return v if minimum is None else max(minimum, v)


def env_is_set(name):
    """Whether a declared knob is set (non-empty) in the environment: the
    operator chose a value, as opposed to the default applying."""
    KNOBS[name]   # undeclared names raise, as for every reader
    return bool(os.environ.get(name, "").strip())


def env_float(name, *, minimum=None):
    """Float knob; ``minimum`` clamps the parsed value."""
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    try:
        v = float(raw)
    except ValueError:
        _warn(name, raw, "float", knob.default)
        return knob.default
    return v if minimum is None else max(minimum, v)


def env_str(name):
    """String knob: the raw value, or the declared default when unset."""
    knob = KNOBS[name]
    return os.environ.get(name, knob.default)
