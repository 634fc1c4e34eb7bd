"""Asynchronous data parallelism through the parameter server: the port
of ``deeplearning4j_tpu/parallel/param_server_wrapper.py``.

The reference library's ``ParameterServerParallelWrapper.java:39-45``
embeds an Aeron ``MediaDriver`` and a ``ParameterServerNode`` in the
process and runs N trainer threads that push gradients to it and fetch
parameters from it through ``ParameterServerClient``. Here the media
driver is the collective coordinator (native, or its Python twin in
``coordinator.py``), the server's state is the coordinator's parameter
buffer, and each trainer pushes its parameter delta after every step and
pulls the global parameters every ``pull_frequency`` steps: Hogwild
asynchrony as the reference has it (no updater averaging; the replicas
drift between pulls). The replicas live on the wrapped model's device
and share torch's default stream; every push and pull crosses the host
as float32.

Under ``DL4J_TORCH_ELASTIC`` a trainer whose connection dies departs
instead of failing the fit, and its queued batches go to the survivors
(``docs/ROBUSTNESS.md`` §7).
"""

from __future__ import annotations

import contextlib
import queue
import threading

from deeplearning4j_tpu_torch.config import env_flag
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       MultiDataSet)
from deeplearning4j_tpu_torch.errors import CollectiveError, PeerDeadError
from deeplearning4j_tpu_torch.parallel.coordinator import (
    _OBS_LEAVE_EVENTS, connect, start_coordinator)


def _fit_one(model, item):
    """One ``fit_batch`` on a DataSet or (a graph's) MultiDataSet; returns
    the score (a device scalar on the card)."""
    if isinstance(item, MultiDataSet):
        return model.fit_batch(item)   # ComputationGraph's signature
    if isinstance(item, DataSet):
        return model.fit_batch(item.features, item.labels,
                               item.features_mask, item.labels_mask)
    raise TypeError(f"cannot fit {type(item).__name__}")


def _clone_model(model):
    """A fresh replica of the same configuration on the model's device
    (``Trainer.run``'s clone)."""
    return type(model)(model.conf, device=model.device).init()


class ParameterServerParallelWrapper:
    """N trainer threads + embedded parameter server
    (ParameterServerParallelWrapper.java: MediaDriver :159-161, client wiring
    :215-218, Trainer :288)."""

    def __init__(self, model, *, workers=2, prefetch_buffer=8,
                 pull_frequency=1, prefer_native=True):
        self.model = model
        self.workers = workers
        self.prefetch_buffer = max(2, prefetch_buffer)
        self.pull_frequency = max(1, pull_frequency)
        self.prefer_native = prefer_native
        self.coordinator_kind = None   # "native" or "python", per fit

    def fit(self, iterator, *, epochs=1):
        net = self.model
        if net.params_list is None:
            net.init()
        params0 = net.params()
        n_params = params0.size
        # the elastic contract: a trainer whose client
        # dies DEPARTS instead of failing the whole fit — its queued
        # batches are reassigned to the survivors, and batches stranded in
        # its queue after the feed are consumed inline at the end, so the
        # run still trains on every batch exactly once
        elastic = env_flag("DL4J_TORCH_ELASTIC")

        with contextlib.ExitStack() as stack:
            coord = stack.enter_context(start_coordinator(
                self.workers, prefer_native=self.prefer_native))
            self.coordinator_kind = coord.kind
            init_client = connect("127.0.0.1", coord.port, 0,
                                  prefer_native=self.prefer_native)
            # every exit path — including a raising feed — closes the
            # CURRENT worker-0 client (late binding is the point:
            # _tail_client may have replaced the original by exit time)
            stack.callback(lambda: init_client.close())
            init_client.ps_init(params0)

            queues = [queue.Queue(maxsize=self.prefetch_buffer)
                      for _ in range(self.workers)]
            errors = []
            # set when the feeder is done or dying: trainers blocked on an
            # empty queue re-check it instead of waiting forever on a feed
            # that will never come
            feeder_gone = threading.Event()
            # departure bookkeeping, shared by trainer threads (writers)
            # and the feeder (reader): one lock covers both structures
            state_lock = threading.Lock()
            departed = {}   # worker id -> the error that took it out
            reassign = []   # drained batches awaiting a surviving worker

            def trainer(worker_id, replica):
                client = None
                try:
                    client = (init_client if worker_id == 0 else
                              connect("127.0.0.1", coord.port, worker_id,
                                      prefer_native=self.prefer_native))
                    step = 0
                    while True:
                        try:
                            item = queues[worker_id].get(timeout=0.5)
                        except queue.Empty:
                            if feeder_gone.is_set():
                                break
                            continue
                        if item is None:
                            break
                        before = replica.params()
                        _fit_one(replica, item)
                        after = replica.params()
                        client.ps_push(after - before)
                        step += 1
                        if step % self.pull_frequency == 0:
                            replica.set_params(client.ps_pull(n_params))
                    if worker_id != 0:
                        client.close()
                except (CollectiveError, ConnectionError) as e:
                    if not elastic:
                        errors.append(e)
                    else:
                        # elastic: this trainer departs; batches already
                        # queued for it go straight back to the survivors
                        drained = []
                        while True:
                            try:
                                x = queues[worker_id].get_nowait()
                            except queue.Empty:
                                break
                            if x is not None:
                                drained.append(x)
                        with state_lock:
                            departed[worker_id] = e
                            reassign.extend(drained)
                        _OBS_LEAVE_EVENTS.inc()
                    if client is not None and worker_id != 0:
                        client.close()
                except Exception as e:  # surfaced after join
                    errors.append(e)

            # replicas cloned HERE, not in the trainer threads: each clone
            # re-creates and consumes the same seed's keys, which must
            # stay sequential (create -> consume per replica) — concurrent
            # clones interleave identical key bits across threads
            replicas = []
            for _ in range(self.workers):
                replica = _clone_model(net)
                replica.set_params(params0.copy())
                replicas.append(replica)
            threads = [threading.Thread(target=trainer,
                                        args=(i, replicas[i]), daemon=True)
                       for i in range(self.workers)]
            for t in threads:
                t.start()

            # round-robin dispatch over the LIVE workers
            # (ParallelWrapper.fit:148-156 feed pattern); put with timeout
            # so a dead trainer's full queue cannot block the feeder
            # forever — its captured error (or departure) surfaces instead
            pos = 0

            def dispatch(item):
                nonlocal pos
                while True:
                    if errors:
                        raise errors[0]
                    with state_lock:
                        live = [i for i in range(self.workers)
                                if i not in departed]
                        first = next(iter(departed.values()), None)
                    if not live:
                        raise PeerDeadError(
                            "all parameter-server trainers departed; "
                            f"first failure: {first}") from first
                    q = queues[live[pos % len(live)]]
                    pos += 1
                    try:
                        q.put(item, timeout=1.0)
                        return
                    except queue.Full:
                        continue

            def drain_reassign():
                with state_lock:
                    out, reassign[:] = list(reassign), []
                return out

            # a plain generator is exhausted after one pass — materialize it
            # so epochs > 1 actually re-feed the data
            if epochs > 1 and not isinstance(iterator, DataSetIterator):
                iterator = list(iterator)
            try:
                for _ in range(epochs):
                    for ds in iterator:
                        dispatch(ds)
                        for item in drain_reassign():
                            dispatch(item)
                items = drain_reassign()
                while items:
                    for item in items:
                        dispatch(item)
                    items = drain_reassign()
                for wid in range(self.workers):
                    while True:
                        if errors:
                            raise errors[0]
                        with state_lock:
                            gone = wid in departed
                        if gone:   # a departed trainer reads no sentinel
                            break
                        try:
                            queues[wid].put(None, timeout=1.0)
                            break
                        except queue.Full:
                            continue
            finally:
                # liveness: whether we fed everything or died mid-feed,
                # trainers must never block forever on an empty queue
                feeder_gone.set()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]

            if elastic:
                # batches stranded by departures: whatever the departing
                # trainer could not drain itself (a feeder put that raced
                # its death) plus anything still in the reassign list —
                # consumed inline so every batch trains exactly once
                leftovers = drain_reassign()
                for q in queues:
                    try:
                        while True:
                            x = q.get_nowait()
                            if x is not None:
                                leftovers.append(x)
                    except queue.Empty:
                        pass
                if leftovers:
                    init_client = self._tail_client(init_client, coord,
                                                    n_params)
                    replica = _clone_model(net)
                    replica.set_params(init_client.ps_pull(n_params))
                    for item in leftovers:
                        before = replica.params()
                        _fit_one(replica, item)
                        after = replica.params()
                        init_client.ps_push(after - before)

            init_client = self._tail_client(init_client, coord, n_params)
            net.set_params(init_client.ps_pull(n_params))
        return self

    def _tail_client(self, client, coord, n_params):
        """A client known to reach the parameter server: worker 0's
        departure may have poisoned the init client's socket, but the ps
        buffer lives in the coordinator — a fresh connection recovers it."""
        try:
            client.ps_pull(n_params)
            return client
        except (CollectiveError, ConnectionError, OSError):
            client.close()
            return connect("127.0.0.1", coord.port, 0,
                           prefer_native=self.prefer_native)
