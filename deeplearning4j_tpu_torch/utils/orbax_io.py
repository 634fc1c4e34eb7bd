"""Per-rank shard checkpoints: the port of
``deeplearning4j_tpu/utils/orbax_io.py``. No orbax is involved: the name
is kept so that a reader finds the counterpart.

The zip archive (``utils/model_serializer.py``) is the parity format:
the whole trees in one file, gathered to rank 0 under a plan. At scale
every rank writes its own shards instead, and a restore reads onto the
restoring plan's width and level without any rank building the whole
state. A step is a directory::

    step_N/
      framework_config.json   rank 0: the model's configuration JSON
      plan.json               rank 0: level, width, counters, and each
                              tree's leaf specs (whole shape, dtype, shard
                              axis at rest, byte offset and length)
      <tree>.whole.bin        rank 0: the tree's leaves held whole at rest
      <tree>.rank<r>.bin      rank r: its shards of the tree's sharded
                              leaves, each moved to put its shard axis
                              first, one after another: the rank's row of
                              the sharding core's [N, C] buckets
      manifest.json           the CRC-32 of every payload

The trees are the model's at-rest trees (``_plan_trees``): parameters,
layer state and updater state of a ``MultiLayerNetwork`` or a
``ComputationGraph``, parameters and optimizer state of a
``TransformerLM``, each leaf placed as the plan's level says
(``parallel/sharding_core.py``).

Durability (the reference's protocol): the step is written into
``step_N.tmp``; after a barrier rank 0 writes the CRC manifest and
commits by renaming it to ``step_N`` (``utils/atomic_io.py``), and a
second barrier makes the commit visible to every rank before the save
returns. A crash mid-save leaves an uncommitted ``*.tmp`` that readers
ignore. :func:`latest_step` and :func:`verified_steps` parse step names
strictly; swaps parked by a crash are healed before any listing;
``CheckpointManager.restore_latest`` falls back past a damaged step with
a warning.

Every rank of the plan calls :func:`save_checkpoint` and
:func:`restore_checkpoint` (the barriers are collectives); without a
plan, or at width 1, they are one process's calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings

import torch

from deeplearning4j_tpu_torch.config import env_int
from deeplearning4j_tpu_torch.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.utils import atomic_io

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "verified_steps", "CheckpointManager", "CheckpointManagerLike"]

_CONFIG_NAME = "framework_config.json"
_PLAN_NAME = "plan.json"
_VERSION = 1


def _plan(net):
    """The model's plan when it spans more than one rank, else None."""
    dp = getattr(net, "_dp", None)
    if dp is None:
        raise TypeError(f"don't know how to checkpoint {type(net).__name__}")
    return dp()


def _trees(net):
    """(attr, leaves, at-rest axes) of each tree the model holds."""
    plan = _plan(net)
    out = []
    for attr, _spec in net._plan_trees:
        if getattr(net, attr, None) is None:
            continue
        leaves = net._plan_leaves(attr)
        axes = [None] * len(leaves) if plan is None \
            else net._dp_rest[attr]
        out.append((attr, leaves, axes))
    return out


def _counters(net):
    out = {"iteration": int(net.iteration)}
    if hasattr(net, "epoch_count"):
        out["epoch_count"] = int(net.epoch_count)
    if hasattr(net, "dropout_draws"):
        out["dropout_draws"] = int(net.dropout_draws)
    return out


def _config_json(net):
    conf = getattr(net, "conf", None)
    if conf is None:
        return None
    if hasattr(conf, "to_json"):
        return conf.to_json()
    try:   # the TransformerConfig dataclass
        return json.dumps(dataclasses.asdict(conf))
    except TypeError:
        return None


def _bytes(t):
    """A tensor's bytes in its own dtype (bf16 too)."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _dtype(name):
    return getattr(torch, name.split(".")[-1])


def _step_path(directory, step):
    directory = os.path.abspath(directory)
    return os.path.join(directory, f"step_{step}") if step is not None \
        else directory


def _barrier(plan):
    if plan is not None:
        plan.barrier()


def save_checkpoint(net, directory, step=None):
    """Write ``net``'s state under ``directory`` (in ``step_<step>`` when
    ``step`` is given): each rank its own shards, rank 0 the whole
    leaves, the configuration and the plan. Crash-consistent: the state
    lands in ``<path>.tmp`` and rank 0 commits it (manifest, fsync,
    rename) once every rank has written; a kill at any point leaves the
    previous checkpoint as it was. Returns the path."""
    plan = _plan(net)
    rank = 0 if plan is None else plan.rank
    path = _step_path(directory, step)
    tmp = path + ".tmp"
    if rank == 0:
        atomic_io.recover_dir(path)   # heal a crashed overwrite swap
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)   # a crashed save's leftover
        os.makedirs(tmp)
    # the cleanup happens before any rank writes into tmp
    _barrier(plan)
    spec = {"version": _VERSION, "model": type(net).__name__,
            "level": 0 if plan is None else plan.level,
            "width": 1 if plan is None else plan.n,
            "counters": _counters(net), "trees": {}}
    for attr, leaves, axes in _trees(net):
        whole, mine, specs = [], [], []
        w_off = r_off = 0
        for t, a in zip(leaves, axes):
            shape = list(t.shape)
            if a is None:
                # only rank 0 copies a whole leaf to the host; the others
                # need its length for the spec
                nbytes = t.numel() * t.element_size()
                specs.append({"shape": shape, "dtype": str(t.dtype),
                              "axis": None, "offset": w_off,
                              "nbytes": nbytes})
                w_off += nbytes
                if rank == 0:
                    whole.append(_bytes(t))
            else:
                data = _bytes(t.movedim(a, 0))
                shape[a] *= spec["width"]
                specs.append({"shape": shape, "dtype": str(t.dtype),
                              "axis": a, "offset": r_off,
                              "nbytes": len(data)})
                r_off += len(data)
                mine.append(data)
        spec["trees"][attr] = specs
        if mine:
            atomic_io.write_file(os.path.join(tmp, f"{attr}.rank{rank}.bin"),
                                 b"".join(mine))
        if rank == 0 and whole:
            atomic_io.write_file(os.path.join(tmp, f"{attr}.whole.bin"),
                                 b"".join(whole))
    # every rank's shards are in tmp before rank 0 commits it
    _barrier(plan)
    if rank == 0:
        atomic_io.write_file(os.path.join(tmp, _PLAN_NAME), json.dumps(spec))
        cj = _config_json(net)
        if cj is not None:
            atomic_io.write_file(os.path.join(tmp, _CONFIG_NAME), cj)
        try:
            atomic_io.commit_dir_atomic(tmp, path)
        finally:
            # the commit happens before any rank returns (a failed one
            # too: every rank leaves with the same directory)
            _barrier(plan)
    else:
        _barrier(plan)
    return path


class _Reader:
    """Byte ranges of one step's files, each file opened once."""

    def __init__(self, path):
        self.path = path
        self._files = {}

    def read(self, name, offset, nbytes):
        f = self._files.get(name)
        if f is None:
            p = os.path.join(self.path, name)
            if not os.path.isfile(p):
                raise CheckpointCorruptError(
                    f"checkpoint {self.path!r}: payload {name!r} missing")
            f = self._files[name] = open(p, "rb")
        f.seek(offset)
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise CheckpointCorruptError(
                f"checkpoint {self.path!r}: payload {name!r} is short")
        return data

    def close(self):
        for f in self._files.values():
            f.close()


def _tensor(data, dtype, shape):
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def _read_leaf(reader, attr, s, width, rank, n, axis):
    """Leaf ``s`` of tree ``attr`` as the restoring rank keeps it: its
    shard along ``axis`` of ``n`` (``rank``'s), or the whole leaf
    (``axis`` None). Only the bytes that part needs are read where the
    file's shard axis is the same or the part is whole; otherwise each
    file chunk is read and cut."""
    dtype, shape, a = _dtype(s["dtype"]), list(s["shape"]), s["axis"]
    if a is None:
        whole = _tensor(reader.read(f"{attr}.whole.bin", s["offset"],
                                    s["nbytes"]), dtype, shape)
        if axis is None:
            return whole
        c = shape[axis] // n
        return whole.narrow(axis, rank * c, c).contiguous()
    moved = [shape[a]] + [d for i, d in enumerate(shape) if i != a]
    row = s["nbytes"] // (moved[0] // width)   # bytes a row of the chunk
    c_old = moved[0] // width
    lo, hi = (0, moved[0]) if axis is None else \
        (rank * (shape[axis] // n), (rank + 1) * (shape[axis] // n))
    if axis is not None and axis != a:
        lo, hi = 0, moved[0]   # another axis: every chunk, cut below
    parts = []
    for j in range(lo // c_old, (hi - 1) // c_old + 1):
        r0, r1 = max(lo, j * c_old), min(hi, (j + 1) * c_old)
        parts.append(reader.read(f"{attr}.rank{j}.bin",
                                 s["offset"] + (r0 - j * c_old) * row,
                                 (r1 - r0) * row))
    t = _tensor(b"".join(parts), dtype, [hi - lo] + moved[1:])
    t = t.movedim(0, a).contiguous()
    if axis is not None and axis != a:
        c = shape[axis] // n
        t = t.narrow(axis, rank * c, c).contiguous()
    return t


def restore_checkpoint(net, directory, step=None):
    """Restore ``net``'s state in place, placed under the plan it holds
    now (its width and level may differ from the saving plan's): each
    rank reads the byte ranges of its own shards and the whole leaves
    its level keeps whole. The net must be built with the saved
    configuration. The step's CRC manifest is verified first (a directory
    without one is accepted as written before manifests); damage raises
    ``CheckpointCorruptError``."""
    path = _step_path(directory, step)
    atomic_io.recover_dir(path)   # heal a crashed overwrite swap
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    atomic_io.verify_dir_manifest(path, missing_ok=True)
    try:
        with open(os.path.join(path, _PLAN_NAME), "rb") as fh:
            spec = json.loads(fh.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unreadable {_PLAN_NAME}: {e!r}") from e
    plan = _plan(net)
    rank, n = (0, 1) if plan is None else (plan.rank, plan.n)
    width = int(spec["width"])
    reader = _Reader(path)
    try:
        new = {}
        for attr, leaves, axes in _trees(net):
            specs = spec["trees"].get(attr)
            if specs is None or len(specs) != len(leaves):
                raise ValueError(
                    f"checkpoint {path!r} holds another {attr} tree than "
                    f"this {type(net).__name__}: restore into a model "
                    "built with the saved configuration")
            out = []
            for t, a, s in zip(leaves, axes, specs):
                got = _read_leaf(reader, attr, s, width, rank, n, a)
                if got.dtype != t.dtype or tuple(got.shape) != tuple(
                        t.shape):
                    raise ValueError(
                        f"checkpoint {path!r}: a {attr} leaf is "
                        f"{tuple(got.shape)} {got.dtype}, this model's "
                        f"is {tuple(t.shape)} {t.dtype}")
                out.append(got.to(t.device).requires_grad_(t.requires_grad))
            new[attr] = out
    finally:
        reader.close()
    for attr, leaves in new.items():
        net._set_plan_leaves(attr, leaves)
    counters = spec.get("counters", {})
    net.iteration = int(counters.get("iteration", net.iteration))
    if "epoch_count" in counters:
        net.epoch_count = int(counters["epoch_count"])
    if "dropout_draws" in counters and hasattr(net, "set_dropout_draws"):
        net.set_dropout_draws(int(counters["dropout_draws"]))
    # the device mirrors refresh from the restored counters
    if hasattr(net, "_iter_dev"):
        net._iter_dev = None
        net._iter_dev_py = None
    return net


def _recover_swaps(directory):
    """Heal crashed overwrite swaps across ``directory``: a ``step_N.old``
    whose ``step_N`` is missing is the previous checkpoint parked by a
    kill; roll each back before any listing, restore or prune (best
    effort: a read-only mount leaves it)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name.startswith("step_") and name.endswith(".old"):
            try:
                atomic_io.recover_dir(os.path.join(directory,
                                                   name[:-len(".old")]))
            except OSError:
                pass


def _step_dirs(directory):
    """The committed ``(step, name)`` pairs, ascending: ``step_<digits>``
    only; ``step_N.tmp``, ``step_N.old`` and other names never qualify."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        suffix = name[len("step_"):]
        if suffix.isdigit() and os.path.isdir(os.path.join(directory, name)):
            out.append((int(suffix), name))
    return sorted(out)


def latest_step(directory):
    """The highest committed step under ``directory``, or None."""
    _recover_swaps(directory)
    steps = _step_dirs(directory)
    return steps[-1][0] if steps else None


def verified_steps(directory):
    """The committed steps whose CRC manifests verify, ascending (a step
    without a manifest counts as unverified here)."""
    _recover_swaps(directory)
    out = []
    for step, name in _step_dirs(directory):
        try:
            atomic_io.verify_dir_manifest(os.path.join(directory, name))
        except CheckpointCorruptError:
            continue
        out.append(step)
    return out


class CheckpointManagerLike:
    """Rolling retention of shard checkpoints: keep the newest ``keep``
    steps (``DL4J_TORCH_CKPT_KEEP`` when None)."""

    def __init__(self, directory, keep=None):
        self.directory = os.path.abspath(directory)
        self.keep = env_int("DL4J_TORCH_CKPT_KEEP", minimum=1) \
            if keep is None else keep

    def save(self, net, step):
        path = save_checkpoint(net, self.directory, step=step)
        plan = _plan(net)
        if plan is None or plan.rank == 0:
            self._prune()
        _barrier(plan)
        return path

    def restore_latest(self, net):
        """Restore the newest verified step, falling back with a warning
        past damaged ones; returns ``(net, step)``. A step whose manifest
        verifies but whose restore fails raises: that is a model that
        does not match the checkpoint, not damage. Raises
        ``FileNotFoundError`` without any step, ``CheckpointCorruptError``
        when none is loadable."""
        _recover_swaps(self.directory)
        steps = _step_dirs(self.directory)
        if not steps:
            raise FileNotFoundError(
                f"no step_N checkpoints under {self.directory}")
        for step, name in reversed(steps):
            path = os.path.join(self.directory, name)
            if os.path.isfile(os.path.join(path, atomic_io.MANIFEST_NAME)):
                try:
                    atomic_io.verify_dir_manifest(path)
                except CheckpointCorruptError as e:
                    warnings.warn(
                        f"checkpoint step_{step} under {self.directory} "
                        f"is corrupt ({e}); falling back to the previous "
                        "verified step", RuntimeWarning)
                    continue
                return restore_checkpoint(net, self.directory,
                                          step=step), step
            try:   # a step without a manifest: try it, skip on failure
                return restore_checkpoint(net, self.directory,
                                          step=step), step
            except Exception as e:
                warnings.warn(
                    f"checkpoint step_{step} under {self.directory} has no "
                    f"manifest and is not loadable ({e!r}); falling back "
                    "to the previous step", RuntimeWarning)
        raise CheckpointCorruptError(
            f"every step_N checkpoint under {self.directory} failed "
            "verification or restore; nothing loadable remains")

    def _prune(self):
        _recover_swaps(self.directory)
        for _step, name in _step_dirs(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
        # leftovers of crashed saves are garbage once a newer step landed
        for name in os.listdir(self.directory):
            if name.startswith("step_") and (name.endswith(".tmp")
                                             or name.endswith(".old")):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)


# the name the checkpoint subsystem documents; the *Like alias is the
# reference's older one
CheckpointManager = CheckpointManagerLike
