"""Joining a data-parallel world: one process a rank, in a
``torch.distributed`` process group. The port of
``deeplearning4j_tpu/parallel/multihost.py``.

The reference runs one controller per host over a device mesh and lets
XLA place the collectives; here every rank is a process of its own, and
the group is the mesh. :func:`initialize` joins it (NCCL for a CUDA
device, gloo for the CPU or when asked for); :func:`rank_device` is the
card a rank trains on, ``cuda:(local_rank % device_count)``, so ranks
may share one card (gloo only: NCCL refuses two ranks on one device).
:func:`take_rows` is ``global_put``'s role: every rank reads the whole
global batch and keeps its own rows.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["initialize", "is_multiprocess", "local_rank", "process_count",
           "process_index", "rank_device", "shutdown", "take_rows"]


def local_rank(default=None):
    """This process's index on its host: ``LOCAL_RANK`` (torchrun), else
    ``default``, else the global rank."""
    raw = os.environ.get("LOCAL_RANK")
    if raw is not None and raw.strip():
        return int(raw)
    if default is not None:
        return int(default)
    return process_index()


def rank_device(device=None, rank=None):
    """The device a rank trains on. ``device=None`` means the card:
    ``cuda:(local rank % device count)``, raising without CUDA; an
    explicit device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)   # raises without CUDA
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def initialize(coordinator_address, num_processes, process_id, *,
               device=None, backend=None):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``; ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` / ``file://`` URL). The backend is NCCL for a CUDA device
    and gloo for the CPU; ``backend="gloo"`` runs gloo over CUDA tensors
    (ranks sharing one card). Returns the rank's device. Joining twice is
    a no-op that returns the device again."""
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {dev}")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)
    return dev


def shutdown():
    """Leave the process group (no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess(group=None):
    """Whether ``group`` (the default group when None) spans more than
    one process."""
    return dist.is_initialized() and dist.get_world_size(group) > 1


def take_rows(arr, rank, n, axis=0):
    """Rank ``rank``'s rows of a global batch split ``n`` ways along
    ``axis`` (a numpy array or a tensor; a view where one exists). The
    axis must divide by ``n``: padding is the caller's
    (``ParallelWrapper`` repeats the last row)."""
    if arr is None or n == 1:
        return arr
    size = arr.shape[axis]
    if size % n:
        raise ValueError(f"batch axis {axis} of size {size} does not "
                         f"divide over {n} ranks")
    b = size // n
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(rank * b, (rank + 1) * b)
    return arr[tuple(idx)]
