"""TrainingCheckpoint, the whole state an exact resume needs: the port of
``deeplearning4j_tpu/utils/training_checkpoint.py``.

A model archive (``model_serializer.write_model``) holds parameters,
updater and layer state, the iteration and epoch counters and the
dropout draw counter: enough to deploy a model, not to continue a run,
which also needs the non-finite guard's counters and the position in the
data stream. A TrainingCheckpoint is the same archive plus one entry,
``trainingState.json``::

    {"version": 1,
     "dropout_draws": n,         # the draw counter (as in the metadata)
     "nan": {"skipped": n,       # the device's skipped-step counter
             "seen": n,          # its last value read on the host
             "bad_consec": n},   # consecutive dispatches with a bad step
     "cursor": {"epoch": e,      # epochs completed within this fit
                "batch": b},     # real batches consumed in this epoch
     "world": {"size": n,        # elastic runs only: the world size,
               "epoch": e,       # the membership epoch and the width
               "width": w}}      # this state was committed under

The cursor counts real batches, which also fixes the fused-group offset:
groups form again in the same way from any batch index that starts a
group (fit checkpoints only between groups), so a resumed run is bitwise
the uninterrupted one. The reference keeps its PRNG key under ``rng``;
the port's dropout stream is the draw counter (``dropout_draws``), which
the reference ignores (their random streams cannot agree anyway). A
checkpoint an earlier version of this package wrote holds a
``torch_rng`` generator state instead: it still loads, its generator
state is ignored and the counter starts at the checkpoint's iteration.

A ``TransformerLM``, an ``MoETransformerLM`` or a ``ViT`` (the
reference's pytree branch) keeps its parameters, optimizer state,
iteration and dropout generator. Applied to an existing model, the
checkpoint is copied into the tensors the model already holds (``model_serializer.load_transformer_lm_``), so CUDA
graphs captured over them, such as ``ContinuousLM``'s programs, answer
from the restored weights without a new capture.

Checkpoints are ``ckpt_<iteration>.zip`` in a directory with rolling
retention (``DL4J_TORCH_CKPT_KEEP`` newest kept); each write goes through
the atomic commit (``utils/atomic_io.py``), and :func:`latest_checkpoint`
returns the newest archive that passes its check, falling back past torn
or corrupt ones.
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile

import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_int
from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.utils import atomic_io, model_serializer

__all__ = ["TRAIN_STATE_NAME", "apply_training_checkpoint",
           "checkpoint_files", "latest_checkpoint", "resume_latest",
           "save_training_checkpoint"]

_OBS_COMMIT_SECONDS = obs.histogram(
    "checkpoint.commit_seconds",
    "Wall-clock of one TrainingCheckpoint commit (serialize, atomic write "
    "and retention sweep)")
_OBS_COMMITS = obs.counter("checkpoint.commits_total",
                           "TrainingCheckpoints committed")

TRAIN_STATE_NAME = "trainingState.json"
_PREFIX = "ckpt_"
_VERSION = 1


def _training_state(net, cursor):
    state = {"version": _VERSION, "cursor": dict(cursor or {})}
    if model_serializer.is_pytree_model(net):
        if net._rng is not None:
            state["torch_rng"] = net._rng.get_state().tolist()
            state["torch_rng_device"] = net.device.type
    else:
        state["dropout_draws"] = net.dropout_draws
    skipped = getattr(net, "_nan_skipped", None)
    state["nan"] = {
        # the caller flushes the guard's pending read first (fit does), so
        # seen and bad_consec agree with the counter; an LM has no guard
        "skipped": 0 if skipped is None else int(skipped),
        "seen": int(getattr(net, "_nan_seen", 0)),
        "bad_consec": int(getattr(net, "_nan_bad_consec", 0)),
    }
    # elastic runs (parallel/elastic.py) stamp the world the state was
    # committed under; a restore sets it again and never acts on it
    world = getattr(net, "_world_info", None)
    if world:
        state["world"] = dict(world)
    return state


def save_training_checkpoint(net, directory, *, cursor=None, keep=None):
    """Commit ``ckpt_<iteration>.zip`` in ``directory`` atomically and keep
    the newest ``keep`` (default ``DL4J_TORCH_CKPT_KEEP``)."""
    with _OBS_COMMIT_SECONDS.time():
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{_PREFIX}{int(net.iteration)}.zip")
        extra = {TRAIN_STATE_NAME: json.dumps(_training_state(net, cursor))}
        model_serializer.write_model(net, path, extra_entries=extra)
        plan = model_serializer.writer_plan(net)
        if plan is not None and plan.rank != 0:
            return path   # rank 0 wrote the archive and keeps the directory
        keep = env_int("DL4J_TORCH_CKPT_KEEP", minimum=1) if keep is None \
            else keep
        stale = [name for _, name in checkpoint_files(directory)[:-keep]]
        # leftovers of crashed commits are garbage once this one landed
        stale += [name for name in os.listdir(directory)
                  if name.startswith(_PREFIX) and name.endswith(".zip.tmp")]
        for name in stale:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
    _OBS_COMMITS.inc()
    return path


def checkpoint_files(directory):
    """The committed ``(iteration, file name)`` pairs, ascending. Neither
    ``*.zip.tmp`` leftovers nor names without a number qualify."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not (name.startswith(_PREFIX) and name.endswith(".zip")):
            continue
        suffix = name[len(_PREFIX):-len(".zip")]
        if suffix.isdigit():
            out.append((int(suffix), name))
    return sorted(out)


def latest_checkpoint(directory):
    """The path of the newest checkpoint in ``directory`` that passes its
    CRC check, or None. Newer torn or corrupt archives are skipped with a
    warning."""
    for _, name in reversed(checkpoint_files(directory)):
        path = os.path.join(directory, name)
        try:
            atomic_io.open_zip_verified(path).close()
            return path
        except CheckpointCorruptError as e:
            warnings.warn(f"training checkpoint {path!r} failed its check "
                          f"({e}); falling back to the previous one",
                          RuntimeWarning)
    return None


def resume_latest(net, directory):
    """Restore the newest loadable TrainingCheckpoint of ``directory`` into
    ``net`` and return its cursor, falling back past corrupt archives with
    a warning; None when the directory holds no checkpoint."""
    for _, name in reversed(checkpoint_files(directory)):
        path = os.path.join(directory, name)
        try:
            return apply_training_checkpoint(net, path)
        except CheckpointCorruptError as e:
            warnings.warn(f"training checkpoint {path!r} failed its check "
                          f"({e}); falling back to the previous one",
                          RuntimeWarning)
    return None


def _read_training_state(path):
    # a plain read: the restore just before verified the archive
    try:
        with zipfile.ZipFile(path, "r") as z:
            if TRAIN_STATE_NAME not in z.namelist():
                return {}
            return json.loads(z.read(TRAIN_STATE_NAME).decode())
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unreadable training state: {e!r}") from e


def _apply_lm(net, path):
    """The pytree branch: the archive goes into ``net``'s own tensors, in
    place; the training state's generator, if any, wins over the
    archive's."""
    state = _read_training_state(path)
    model_serializer.load_transformer_lm_(net, path)
    if "torch_rng" in state and state.get(
            "torch_rng_device", net.device.type) == net.device.type:
        net.set_rng_state(state["torch_rng"])
    _apply_world(net, state)
    return state.get("cursor", {})


def _apply_world(net, state):
    if "world" in state:
        net._world_info = dict(state["world"])


def apply_training_checkpoint(net, path):
    """Load a TrainingCheckpoint into an existing MultiLayerNetwork,
    ComputationGraph or pytree-family model (TransformerLM,
    MoETransformerLM, ViT) in place, on its device, and return
    the data cursor ({} for a plain model archive). Parameters, layer and
    updater state, counters, generator and guard state are all replaced,
    so the continuation is bitwise the uninterrupted run. A failure
    leaves ``net`` as it was. A model under a sharding plan takes the
    whole state and is placed under its plan again: the re-shard (a
    collective: every rank of the plan restores)."""
    plan = getattr(net, "_shard_plan", None)
    if plan is None:
        return _apply(net, path)
    net._leave_plan()
    try:
        return _apply(net, path)
    finally:
        net._enter_plan(plan)


def _apply(net, path):
    if model_serializer.is_pytree_model(net):
        return _apply_lm(net, path)
    restored = model_serializer.restore_model(path, device=net.device)
    if type(restored).__name__ != type(net).__name__:
        raise ValueError(f"checkpoint {path!r} holds a "
                         f"{type(restored).__name__}, cannot resume a "
                         f"{type(net).__name__} from it")
    state = _read_training_state(path)
    net.params_list = restored.params_list
    net.states_list = restored.states_list
    net.updater_states = restored.updater_states
    net.iteration = restored.iteration
    net.epoch_count = restored.epoch_count
    net.set_dropout_draws(state.get("dropout_draws",
                                    restored.dropout_draws))
    nan = state.get("nan")
    if nan is not None:
        net._nan_skipped = torch.tensor(int(nan.get("skipped", 0)),
                                        dtype=torch.int32, device=net.device)
        net._nan_pending = None
        net._nan_seen = int(nan.get("seen", 0))
        net._nan_bad_consec = int(nan.get("bad_consec", 0))
    _apply_world(net, state)
    # the device mirrors refresh from the restored counters
    net._iter_dev = None
    net._iter_dev_py = None
    net._score = None
    return state.get("cursor", {})
