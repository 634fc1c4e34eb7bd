"""Elastic training: survive peer death and scale-up mid-run. The port of
``deeplearning4j_tpu/parallel/elastic.py`` onto ``torch.distributed``.

The reference's driver is one process over a device mesh: re-forming a
width re-plans that mesh in place. Here every trainer rank is a process
of its own running :class:`ElasticTrainer`, and a width is a process
group among the trainer processes, so re-forming it means tearing the
group down and starting a new one among the survivors. The state machine
is the reference's:

1. **detect**: every participant of a wave heartbeats a one-float
   allreduce at the coordinator (``HEARTBEAT_TAG``); the trainers of the
   group once per dispatch, through ``ParallelWrapper.fit``'s
   ``on_group``. A dead peer or a straggler surfaces as ``PeerDeadError``
   or ``CollectiveTimeoutError``, a membership change as
   ``WorldChangedError``, all deadline-bounded. A peer that died between
   a heartbeat and the next step leaves the survivors inside a gloo
   collective: the group's timeout (the round deadline) bounds it, and
   gloo's connection errors count as ``PeerDeadError``
   (``multihost.is_peer_error``);
2. **checkpoint**: the group commits a ``TrainingCheckpoint`` every
   ``checkpoint_every`` updates (every dispatch by default), rank 0
   writing, with the world it was committed under stamped into
   ``trainingState.json``. A dead rank's shards die with its process and
   a gather over a broken group cannot complete, so the survivors resume
   from the newest checkpoint the whole group committed: the last good
   group boundary that was checkpointed;
3. **tear down + re-form**: the failed wave's connection is closed and
   its process group destroyed; every survivor reconnects and sends
   ``OP_REFORM``; the coordinator commits the wave at a new membership
   epoch with contiguous ranks and the agreed world size. One census
   round follows (each trainer marks its new rank), so every trainer
   learns which ranks of the world train;
4. **re-shard + continue**: the width is ``elastic_width(world, live
   trainers)``; the first ``width`` trainers start a new process group
   (``multihost.reform``, over a rendezvous ``FileStore`` of the wave's
   own under the checkpoint directory) and resume through
   ``ParallelWrapper.fit(resume_from=...)``, the placement a cross-width
   resume takes (``sharding_core.place``). A trainer past the width
   heartbeats as a member until the next wave or the end.

Scale-up is the same cycle: a joining trainer (``worker_id=None``)
opens a wave, the running world's next heartbeat fails with
``WorldChangedError``, and everyone re-forms at the larger width. A
joiner asks the wave as a non-driver, so no wave commits without a
trainer of the running world, and it resumes from the run's newest
checkpoint like every survivor.

Roles: :class:`ElasticTrainer` is a trainer process;
:class:`ElasticMember` is a participant that only heartbeats, a thread
(the agent of another host; in the tests and ``chip_smoke.py``, a thread
that the ``kill-peer`` and ``slow-peer`` fault sites kill or slow down).
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.config import env_float, env_int
from deeplearning4j_tpu_torch.errors import (CheckpointCorruptError,
                                             CollectiveTimeoutError,
                                             PeerDeadError, WorldChangedError)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.coordinator import JOINER_ID, connect
from deeplearning4j_tpu_torch.parallel.sharding_core import (ShardingCore,
                                                             build_mesh,
                                                             elastic_width)
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils.training_checkpoint import (
    checkpoint_files, latest_checkpoint)

__all__ = ["ElasticMember", "ElasticTrainer", "HEARTBEAT_TAG"]

# every participant of a wave allreduces this tag once per group
# dispatch; the payload is one float: 0.0 while training, 1.0 from each
# trainer of the group when the fit completed (others leave on a nonzero
# sum)
HEARTBEAT_TAG = "elastic-hb"

# once after each committed wave, every participant allreduces a vector
# of the world's size: each trainer puts 1.0 at its new rank, a member
# nothing, so the trainers learn which ranks of the world train
CENSUS_TAG = "elastic-census"

# the exit code of a trainer process the kill-peer site takes down
KILLED_EXIT = 86

# the recoverable failures: a dead peer, a blown round deadline, a
# membership change. ConnectionError covers expulsion (the coordinator
# shut this participant's socket down) and the coordinator's death.
_RECOVERABLE = (PeerDeadError, CollectiveTimeoutError, WorldChangedError,
                ConnectionError)


def _reform_timeout(value):
    return env_float("DL4J_TORCH_REFORM_TIMEOUT", minimum=0.001) \
        if value is None else value


def _close(client):
    if client is None:
        return
    try:
        client._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    client.close()


class ElasticMember:
    """A participant that only heartbeats: joins re-form waves and the
    census after each, in a thread of its own.

    The loop re-joins after every recoverable failure and ends when (a)
    the trainers' heartbeat announces completion, (b) the coordinator
    expelled it (its socket is dead: a straggler past the round deadline
    is departed, it does not retry forever), (c) the ``kill-peer`` site
    took it down, or (d) :meth:`stop` was called. Fault sites take the
    member's initial worker id as qualifier: ``kill-peer[wid]@N`` leaves
    before heartbeat N, ``slow-peer[wid]@N:seconds`` sleeps before it."""

    def __init__(self, host, port, worker_id=None, *, timeout=None,
                 reform_timeout=None, pace=0.005):
        self.host = host
        self.port = port
        self.initial_id = JOINER_ID if worker_id is None else int(worker_id)
        self.timeout = timeout
        self.reform_timeout = _reform_timeout(reform_timeout)
        self._pace = pace
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._client = None
        self.rank = None
        self.world = None
        self.epoch = None
        self.killed = False     # the kill-peer site took this member down
        self.expelled = None    # the ConnectionError that ended the loop
        self.error = None       # an unexpected failure (join() raises it)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"elastic-member-{self.initial_id}")

    def start(self):
        self._thread.start()
        return self

    def _set_client(self, client):
        with self._lock:
            self._client = client

    def _close_client(self):
        with self._lock:
            client, self._client = self._client, None
        _close(client)

    def _rejoin(self):
        wid = self.initial_id if self.rank is None else self.rank
        client = connect(self.host, self.port, wid, prefer_native=False,
                         timeout=self.timeout)
        try:
            self.epoch, self.rank, self.world = \
                client.reform(self.reform_timeout)
            client.allreduce(np.zeros(self.world, np.float32),
                             tag=CENSUS_TAG)
        except BaseException:
            client.close()
            raise
        self._set_client(client)

    def _run(self):
        try:
            while not self._stop.is_set():
                with self._lock:
                    client = self._client
                if client is None:
                    try:
                        self._rejoin()
                    except (CollectiveTimeoutError, PeerDeadError,
                            WorldChangedError):
                        # a wave or its census failed (no trainer yet, or
                        # one died in between): each try is bounded by
                        # the deadlines, so retrying until stop() is too
                        continue
                    except (ConnectionError, OSError) as e:
                        self.expelled = e   # coordinator gone or refused
                        return
                    continue
                if faults.fire("kill-peer", qual=self.initial_id) \
                        is not None:
                    # a hard death mid-fit: the socket closes, the
                    # coordinator marks the id departed, the rest re-form
                    self.killed = True
                    return
                spec = faults.fire("slow-peer", qual=self.initial_id)
                if spec is not None:
                    # past the round deadline: the coordinator must expel
                    # this member, not wait for it forever
                    time.sleep(spec.param_float(1.0))
                try:
                    out = client.allreduce(np.zeros(1, np.float32),
                                           tag=HEARTBEAT_TAG)
                    if float(out[0]) > 0.5:
                        return   # the trainers announced completion
                except (PeerDeadError, CollectiveTimeoutError,
                        WorldChangedError):
                    self._close_client()   # re-join at the loop's top
                except (ConnectionError, OSError) as e:
                    # the socket is dead: expelled as a straggler, or the
                    # coordinator is gone; either way this member left
                    self.expelled = e
                    return
                # a short pace, so that a world whose trainers are still
                # committing a checkpoint idles instead of spinning
                if self._pace:
                    time.sleep(self._pace)
        except Exception as e:   # join() raises it
            with self._lock:
                self.error = e
        finally:
            self._close_client()

    def stop(self, timeout=10.0):
        """Bounded teardown: wake the loop (shutting the socket down
        unblocks a heartbeat in flight) and join the thread."""
        self._stop.set()
        self._close_client()
        self._thread.join(timeout=timeout)

    def join(self, timeout=None):
        self._thread.join(timeout=timeout)
        with self._lock:
            error = self.error
        if error is not None:
            raise error
        return self


class ElasticTrainer:
    """One trainer process of an elastic run: checkpoint, re-form,
    re-shard and continue around ``ParallelWrapper.fit`` (the module
    docstring has the state machine).

    ``worker_id`` is this trainer's id in the first wave (the trainers
    of a run take distinct ids; None joins a running world).
    ``dp_shard`` is the ZeRO level, ``device`` this rank's device (the
    model's; ``multihost.choose_backend`` picks each group's backend),
    ``timeout`` the round deadline (also every process group's
    collective timeout), ``max_width`` a cap on the width. ``reform_log`` holds one entry a committed wave: ``{"epoch",
    "world", "width", "seconds", "checkpoint"}`` as in the reference
    (``checkpoint``: the path the wave resumed from, None for a run's
    first), plus ``trainers`` (the live trainers), ``rank`` (this
    trainer's rank in the group, None past the width), ``backend``,
    ``group_seconds`` (starting the process group) and ``beats`` (the
    host clock at each of the wave's dispatch heartbeats, whose
    differences are the wave's time a dispatch)."""

    def __init__(self, model, host, port, *, worker_id=0, dp_shard=None,
                 timeout=None, reform_timeout=None, prefetch_buffer=2,
                 max_width=None, device=None):
        self.model = model
        self.host = host
        self.port = port
        self.dp_shard = dp_shard
        self.timeout = env_float("DL4J_TORCH_COLLECTIVE_TIMEOUT",
                                 minimum=0.001) if timeout is None \
            else timeout
        self.reform_timeout = _reform_timeout(reform_timeout)
        self.prefetch_buffer = prefetch_buffer
        self.max_width = max_width
        self.device = multihost.rank_device(
            device if device is not None else getattr(model, "device",
                                                      None))
        self.initial_id = JOINER_ID if worker_id is None else int(worker_id)
        self.reform_log = []
        self.group_rank = None   # this trainer's rank in the last group
        self._rank = None if worker_id is None else int(worker_id)
        self._lock = threading.Lock()   # the client's hand-off vs close()
        self._client = None
        self._in_group = False
        self._beats = []

    # ---- wave membership ----------------------------------------------
    def _teardown_client(self):
        """The failed wave's connection closes before the next wave
        forms: a lingering socket's late disconnect must never poison
        the re-formed world."""
        with self._lock:
            client, self._client = self._client, None
        if client is not None:
            client.close()

    def _teardown_group(self):
        """Leave the process group (a peer may be dead: no collective)."""
        if self._in_group:
            self.model._drop_plan()
            multihost.shutdown()
            self._in_group = False

    def _live_client(self):
        with self._lock:
            return self._client

    def _join_wave(self):
        """Join the next wave and its census: (epoch, rank, world,
        seconds, the world's trainer ranks)."""
        self._teardown_client()
        t0 = time.perf_counter()
        wid = JOINER_ID if self._rank is None else self._rank
        client = connect(self.host, self.port, wid, prefer_native=False,
                         timeout=self.timeout)
        try:
            # a joiner is no driver: a wave commits only with a trainer
            # of the running world, whose state everyone resumes from
            epoch, rank, world = client.reform(
                self.reform_timeout, driver=self._rank is not None)
            mark = np.zeros(world, np.float32)
            mark[rank] = 1.0
            census = client.allreduce(mark, tag=CENSUS_TAG)
        except BaseException:
            client.close()
            raise
        with self._lock:
            self._client = client
        self._rank = rank
        trainers = [int(r) for r in np.flatnonzero(census > 0.5)]
        return epoch, rank, world, time.perf_counter() - t0, trainers

    def _beat(self, payload=0.0):
        """One heartbeat round; the sum of the payloads."""
        out = self._live_client().allreduce(
            np.full(1, payload, np.float32), tag=HEARTBEAT_TAG)
        return float(out[0])

    def _heartbeat(self, ep, batches):
        """``on_group``: the fault sites, then one heartbeat."""
        self._beats.append(time.perf_counter())
        if faults.fire("kill-peer", qual=self.initial_id) is not None:
            # a hard death mid-fit: the OS closes the coordinator socket
            # and the group's pairs, the survivors re-form without us
            os._exit(KILLED_EXIT)
        spec = faults.fire("slow-peer", qual=self.initial_id)
        if spec is not None:
            time.sleep(spec.param_float(1.0))
        self._beat()

    def _idle(self):
        """Past the width: heartbeat as a member until the trainers
        announce the end (True) or the wave fails (raises)."""
        while True:
            if faults.fire("kill-peer", qual=self.initial_id) is not None:
                os._exit(KILLED_EXIT)
            if self._beat() > 0.5:
                return True
            time.sleep(0.005)

    def _announce_done(self):
        """Tell the members the fit completed (the heartbeat sum goes
        nonzero). Bounded: a wave that changes mid-announce gets a few
        re-joins, then the members' own deadlines take over."""
        for _ in range(3):
            try:
                self._beat(1.0)
                return
            except _RECOVERABLE:
                try:
                    self._join_wave()
                except (*_RECOVERABLE, OSError):
                    return

    def _form_group(self, store_dir, epoch, rank, width):
        t0 = time.perf_counter()
        store = os.path.join(store_dir, f"rdzv_{self.port}_{epoch}")
        _, backend = multihost.reform(store, width, rank,
                                      device=self.device,
                                      timeout=self.timeout)
        self._in_group = True
        return backend, time.perf_counter() - t0

    # ---- the fit loop -------------------------------------------------
    def fit(self, data_factory, *, epochs=1, checkpoint_dir=None,
            checkpoint_every=None, resume_from=None, max_reforms=None):
        """Elastic fit over ``data_factory()`` streams.

        ``data_factory`` returns a fresh iterator over an epoch's global
        batches; each wave fast-forwards it to the checkpoint's cursor,
        which is how the remaining batches go to the new width.
        ``checkpoint_dir`` (the run's own) is mandatory: it holds the
        checkpoints the survivors resume from and the waves' rendezvous
        stores. ``checkpoint_every`` defaults to every dispatch.
        ``max_reforms`` bounds the recovery cycles (default: the world
        less ``DL4J_TORCH_ELASTIC_MIN_WORKERS``, plus 8 for scale-ups);
        past it the last failure is raised, never a single-process run.
        Every trainer returns holding the run's final state: one that sat
        past the width at the end restores it from the final checkpoint
        its group committed.
        """
        net = self.model
        if getattr(net, "params_list", None) is None:
            net.init()
        every, ck_dir, keep = net._resolve_ckpt_args(
            checkpoint_every, checkpoint_dir, resume_from)
        if not ck_dir:
            raise ValueError(
                "elastic fit needs a checkpoint_dir (or resume_from): "
                "recovery resumes the survivors from the committed "
                "TrainingCheckpoint")
        every = every or 1
        store_dir = os.path.join(ck_dir, "rendezvous")
        # the first wave of the run starts from resume_from (or the model
        # as it is); a joiner, and every later wave, from the run's newest
        # checkpoint
        resume = ck_dir if self._rank is None else resume_from
        reforms = 0
        while True:
            world = 1
            try:
                epoch_m, rank, world, wave_s, trainers = self._join_wave()
                done = self._wave(net, epochs, data_factory, ck_dir, every,
                                  keep, store_dir, resume, epoch_m, rank,
                                  world, wave_s, trainers)
            except Exception as e:
                self._teardown_client()
                self._teardown_group()
                if not isinstance(e, _RECOVERABLE):
                    if not multihost.is_peer_error(e):
                        raise   # not a peer's fault: no re-form
                    e = PeerDeadError(f"a process-group peer is gone: {e}")
                reforms += 1
                limit = max_reforms if max_reforms is not None else (
                    max(0, world - env_int("DL4J_TORCH_ELASTIC_MIN_WORKERS",
                                           minimum=1)) + 8)
                if reforms > limit:
                    raise CollectiveTimeoutError(
                        f"elastic fit gave up after {reforms} re-form "
                        f"cycles (limit {limit}); last failure: {e}") from e
                resume = ck_dir
                continue
            break
        if not done:
            # this trainer's group finished the run: tell the others
            self._announce_done()
        self._teardown_client()
        if self._in_group:
            # every trainer of the group ends holding the whole state
            net._leave_plan()
        elif net._resume_fit_checkpoint(ck_dir) is None:
            # past the width at the end (its model holds an earlier
            # group's shards, or the initial state): the group committed
            # the final state before it announced the end
            raise CheckpointCorruptError(
                f"elastic fit ended with no loadable checkpoint in "
                f"{ck_dir!r} to take the final state from")
        return self

    def _wave(self, net, epochs, data_factory, ck_dir, every, keep,
              store_dir, resume, epoch_m, rank, world, wave_s, trainers):
        """One committed wave: train in its group, or heartbeat past the
        width. True when another trainer announced the end."""
        from deeplearning4j_tpu_torch.parallel.parallel_wrapper import \
            ParallelWrapper
        cap = len(trainers) if self.max_width is None \
            else min(len(trainers), self.max_width)
        width = elastic_width(world, cap)
        me = trainers.index(rank)
        # every checkpoint this wave commits records the agreed world
        net._world_info = {"size": int(world), "epoch": int(epoch_m),
                           "width": int(width)}
        entry = {"epoch": int(epoch_m), "world": int(world),
                 "width": int(width), "seconds": wave_s,
                 "checkpoint": latest_checkpoint(ck_dir) if resume
                 else None, "trainers": len(trainers),
                 "rank": me if me < width else None, "backend": None,
                 "group_seconds": None, "beats": []}
        self._beats = entry["beats"]
        self.reform_log.append(entry)
        if me >= width:
            self.group_rank = None
            return self._idle()
        self.group_rank = me
        entry["backend"], entry["group_seconds"] = self._form_group(
            store_dir, epoch_m, me, width)
        core = ShardingCore(build_mesh(width), level=self.dp_shard)
        self._beat()
        if resume is None and latest_checkpoint(ck_dir) is None:
            # a state to come back to before the first periodic
            # checkpoint: the run's starting point
            net._enter_plan(core)
            net._save_fit_checkpoint(ck_dir, 0, 0, keep)
        pw = ParallelWrapper(net, mesh=core.mesh, dp_shard=core.level,
                             prefetch_buffer=self.prefetch_buffer,
                             device=self.device)
        pw.fit(data_factory(), epochs=epochs, checkpoint_every=every,
               checkpoint_dir=ck_dir, resume_from=resume,
               on_group=self._heartbeat)
        # the final state committed, for the trainers past the width: the
        # last heartbeat came after the last periodic commit, so every
        # rank lists the same files
        files = checkpoint_files(ck_dir)
        if not files or files[-1][0] != net.iteration:
            net._save_fit_checkpoint(ck_dir, epochs, 0, keep)
        return False

    def close(self):
        """Close the connection and leave the process group."""
        self._teardown_client()
        if self._in_group:
            multihost.shutdown()
            self._in_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
