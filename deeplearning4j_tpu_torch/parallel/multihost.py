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

:func:`reform` is what elastic training (``parallel/elastic.py``) does
where the reference re-plans a mesh inside one process: it destroys the
process group this process holds and starts a new one among the ranks a
committed re-form wave assigned, over a rendezvous store of that wave's
own (:func:`choose_backend` picks and names the backend).
:func:`is_peer_error` tells a collective that failed because a peer is
gone from any other failure.

:func:`exchange` is the point-to-point transfer the model-parallel
strategies use where the reference uses ``ppermute`` (the pipeline's
activations and gradients, the ring's K/V blocks). Gloo's ``send`` and
``recv`` hand the tensor's raw pointer to its TCP transport, so a CUDA
tensor under gloo (ranks sharing one card) goes through a pinned host
buffer there, and only there: bytes only, the compute stays on the card.
:data:`staging` counts those staged transfers and their host seconds.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["choose_backend", "exchange", "initialize", "is_multiprocess",
           "is_peer_error", "local_rank", "process_count", "process_index",
           "rank_device", "reform", "shutdown", "staging", "take_rows"]

# what :func:`exchange` staged through host memory: transfers (sends and
# receives), their bytes, and the host seconds of the exchanges that
# staged (copies and the wait together)
staging = {"transfers": 0, "bytes": 0, "seconds": 0.0}

# gloo raises a dead peer or a collective past the group's timeout as a
# plain RuntimeError from its TCP transport: the source path, then one of
# these (e.g. "[.../gloo/transport/tcp/pair.cc:553] Connection closed by
# peer [127.0.0.1]:45224", "[.../gloo/transport/tcp/unbound_buffer.cc:78]
# Timed out waiting 3000ms for recv operation to complete")
_GLOO_TRANSPORT = "gloo/transport/"
_GLOO_PEER_PHRASES = ("connection closed by peer", "connection reset by peer",
                      "broken pipe", "timed out waiting")


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


def choose_backend(device, world_size):
    """(backend, reason) for a group of ``world_size`` ranks on this
    host, each on ``device``: gloo for the CPU; gloo when the ranks
    outnumber this host's cards, so two of them share one (NCCL refuses
    that); NCCL otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"device {device}"
    cards = torch.cuda.device_count()
    if int(world_size) > cards:
        return "gloo", (f"{world_size} ranks share {cards} card(s); NCCL "
                        "takes one rank a device")
    return "nccl", f"{world_size} rank(s) on {cards} card(s)"


def reform(store_path, world_size, rank, *, device=None, timeout=None):
    """Leave the process group this process holds (if any) and join a
    new one of ``world_size`` ranks as ``rank``, meeting over a
    ``FileStore`` at ``store_path``. The path must be the new membership's
    own (one per re-form wave): a rank never meets a store of an earlier
    wave. ``device`` as :func:`rank_device` takes it (None: the card).
    The backend is :func:`choose_backend`'s pick, and the choice is
    printed. ``timeout`` (seconds) bounds every collective of
    the group, so a dead peer raises instead of hanging. Returns
    ``(device, backend)``."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, reason = choose_backend(dev, world_size)
    shutdown()
    print(f"process group: rank {rank} of {world_size} on {dev} over "
          f"{backend} ({reason})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(store_path)), exist_ok=True)
    store = dist.FileStore(store_path, int(world_size))
    kw = {"device_id": dev} if backend == "nccl" else {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
        store.set_timeout(kw["timeout"])
    dist.init_process_group(backend, store=store,
                            world_size=int(world_size), rank=int(rank), **kw)
    return dev, backend


def exchange(sends=(), recvs=(), group=None):
    """Post every ``(tensor, global rank)`` of ``sends`` and ``recvs``
    at once (``isend``/``irecv``, so a ring of ranks that each send and
    receive does not block) and wait for all of them; a received tensor
    is written in place. Under gloo a CUDA tensor travels through a
    pinned host copy (:data:`staging`); any other tensor, and every
    tensor under NCCL, is handed over as it is."""
    sends, recvs = list(sends), list(recvs)
    if not sends and not recvs:
        return
    staged = dist.get_backend(group) == "gloo" and any(
        t.is_cuda for t, _ in sends + recvs)
    t0 = time.perf_counter()

    def host(t):
        if not (staged and t.is_cuda):
            return t
        staging["transfers"] += 1
        staging["bytes"] += t.numel() * t.element_size()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out = []
    reqs = []
    for t, src in recvs:
        h = host(t)
        out.append((t, h))
        reqs.append(dist.irecv(h, src, group=group))
    for t, dst in sends:
        h = host(t)
        if h is not t:
            h.copy_(t)
        reqs.append(dist.isend(h.contiguous(), dst, group=group))
    for r in reqs:
        r.wait()
    for t, h in out:
        if h is not t:
            t.copy_(h)
    if staged:
        staging["seconds"] += time.perf_counter() - t0


def is_peer_error(exc):
    """Whether ``exc`` is a collective failing because a peer is gone:
    one of ``torch.distributed``'s own errors (NCCL's and the stores'),
    or gloo's transport saying that a peer closed its connection or that
    a wait ran past the group's timeout. Any other error, a CUDA launch
    that timed out included, is not."""
    dist_error = getattr(dist, "DistError", None)
    if dist_error is not None and isinstance(exc, dist_error):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    text = str(exc)
    return _GLOO_TRANSPORT in text and any(
        p in text.lower() for p in _GLOO_PEER_PHRASES)


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
