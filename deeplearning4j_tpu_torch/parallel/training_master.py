"""Cluster-style synchronous data parallelism, the Spark TrainingMaster
stack: the port of ``deeplearning4j_tpu/parallel/training_master.py``.

The reference library's ``api/TrainingMaster.java`` SPI,
``impl/paramavg/ParameterAveragingTrainingMaster.java:75`` (split,
repartition, broadcast (configuration, parameters, updater state), each
worker fits ``batch_size_per_worker x averaging_frequency`` minibatches,
the parameter and updater-state sums are aggregated, divided and set on
the master), the ``SparkDl4jMultiLayer``/``SparkComputationGraph`` front
ends, and the Export data path (``BatchAndExportDataSetsFunction``:
batches saved to disk, each worker streams its own files).

Spark's broadcast and aggregate are the collective coordinator's
(``parallel/coordinator.py``, native or its Python twin): the master
broadcasts metadata and parameters as float32 payloads, the workers
allreduce their sums back. Every round crosses the host: a replica's
parameters on the card are copied to the host (``params()``), and what
comes back is set on the replica's own device. Workers are threads (the
reference's ``local[N]``) sharing the master's device and torch's
default stream, or OS processes started from
``deeplearning4j_tpu_torch.parallel.worker`` (one a host on a cluster,
each with its own CUDA context), which read their Export files and run
on the device the master's network is on.

The Export files keep the reference's ``.npz`` layout, so a file either
package writes the other reads.

Parity gate (``TestCompareParameterAveragingSparkVsSingleMachine.java:44``):
one worker with ``averaging_frequency=1`` ends with parameters equal, bit
for bit, to plain ``fit_batch`` over the same batches.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       MultiDataSet,
                                                       MultiDataSetIterator)
from deeplearning4j_tpu_torch.models._layered import host
from deeplearning4j_tpu_torch.parallel.coordinator import (connect,
                                                           start_coordinator)
from deeplearning4j_tpu_torch.parallel.param_server_wrapper import _fit_one
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["DistributedComputationGraph", "DistributedMultiLayerNetwork",
           "ParameterAveragingTrainingMaster", "TrainingHook",
           "TrainingMaster", "load_dataset", "run_worker_loop",
           "save_dataset"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _encode_json_payload(obj) -> np.ndarray:
    """JSON as a float32 array of its bytes (the channel carries float32)."""
    raw = json.dumps(obj).encode("utf-8")
    return np.frombuffer(raw, np.uint8).astype(np.float32)


def _decode_json_payload(arr) -> dict:
    raw = np.asarray(arr, np.float32).astype(np.uint8).tobytes()
    return json.loads(raw.decode("utf-8"))


def _broadcast_blob(client, arr=None, root=False, tag="blob"):
    """Broadcast of a variable length: the length first, then the payload
    (a broadcast's receivers must know its element count)."""
    if root:
        arr = np.ascontiguousarray(arr, np.float32)
        client.broadcast(np.asarray([arr.size], np.float32), root=True,
                         tag=tag + "_len")
        client.broadcast(arr, root=True, tag=tag)
        return arr
    n = int(client.broadcast(np.zeros(1, np.float32), tag=tag + "_len")[0])
    return client.broadcast(np.zeros(n, np.float32), tag=tag)


def save_dataset(ds, path):
    """One Export-mode batch file (``BatchAndExportDataSetsFunction``'s),
    of a DataSet or a MultiDataSet, in the reference's ``.npz`` layout."""
    if isinstance(ds, MultiDataSet):
        arrays = {"mds": np.asarray([1])}
        for i, f in enumerate(ds.features):
            arrays[f"f{i}"] = host(f)
        for i, l in enumerate(ds.labels):
            arrays[f"l{i}"] = host(l)
        for i, m in enumerate(ds.features_masks or []):
            if m is not None:
                arrays[f"fm{i}"] = host(m)
        for i, m in enumerate(ds.labels_masks or []):
            if m is not None:
                arrays[f"lm{i}"] = host(m)
        np.savez(path, **arrays)
        return
    arrays = {"features": host(ds.features)}
    for key in ("labels", "features_mask", "labels_mask"):
        a = getattr(ds, key)
        if a is not None:
            arrays[key] = host(a)
    np.savez(path, **arrays)


def load_dataset(path):
    """A batch file of :func:`save_dataset` (of either package)."""
    with np.load(path) as z:
        if "mds" in z.files:
            nf = len([k for k in z.files if k.startswith("f") and k[1:].isdigit()])
            nl = len([k for k in z.files if k.startswith("l") and k[1:].isdigit()])
            feats = [z[f"f{i}"] for i in range(nf)]
            labs = [z[f"l{i}"] for i in range(nl)]
            fms = [z[f"fm{i}"] if f"fm{i}" in z.files else None for i in range(nf)]
            lms = [z[f"lm{i}"] if f"lm{i}" in z.files else None for i in range(nl)]
            return MultiDataSet(feats, labs,
                                fms if any(m is not None for m in fms) else None,
                                lms if any(m is not None for m in lms) else None)
        return DataSet(z["features"],
                       z["labels"] if "labels" in z.files else None,
                       z["features_mask"] if "features_mask" in z.files else None,
                       z["labels_mask"] if "labels_mask" in z.files else None)


def _model_from_meta(meta, device):
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration

    if meta["model_type"] == "ComputationGraph":
        conf = ComputationGraphConfiguration.from_json(meta["config"])
        return ComputationGraph(conf, device=device).init()
    conf = MultiLayerConfiguration.from_json(meta["config"])
    return MultiLayerNetwork(conf, device=device).init()


def _updater_vec(net):
    """The updater state as the reference's flat float32 host vector."""
    return flat_params.updater_state_to_vector_np(net.layers,
                                                  net.updater_states)


def _set_updater_vec(net, vec):
    """Set the updater state from a flat host vector, on the net's device
    (each piece in its template's dtype)."""
    vec = torch.from_numpy(np.ascontiguousarray(vec, np.float32)).to(
        net.device)
    net.updater_states = flat_params.vector_to_updater_state(
        net.layers, net.updater_states, vec)


class TrainingHook:
    """Per-minibatch worker hook SPI (``spark/api/TrainingHook.java``):
    called around every minibatch a distributed worker fits. Subclass it
    and pass it as ``ParameterAveragingTrainingMaster(training_hooks=...)``,
    e.g. to push each minibatch's gradients to a parameter server or to
    collect metrics of one's own."""

    def pre_update(self, minibatch, model):
        """Before the worker fits ``minibatch``."""

    def post_update(self, minibatch, model):
        """After the worker fit ``minibatch``."""


def run_worker_loop(client, data_source, training_hooks=(), device=None):
    """One worker's loop over the splits, shared by the thread mode and
    the process entry point (``ExecuteWorkerFlatMap``'s part).
    ``data_source(split_idx, meta)`` returns the DataSets this worker fits
    for that split; the replica lives on ``device`` (None: the card).

    A worker given no batch in a split (a short final split) contributes
    zeros and flags that it did not take part, as Spark's empty
    partitions return no result: the master divides by the number of
    workers that trained."""
    net = None
    while True:
        meta = _decode_json_payload(_broadcast_blob(client, tag="meta"))
        if meta.get("done"):
            return
        params = client.broadcast(np.zeros(meta["n_params"], np.float32),
                                  tag="params")
        if net is None:
            net = _model_from_meta(meta, device)
        net.set_params(params)
        if meta["upd_len"] > 0:
            upd = client.broadcast(np.zeros(meta["upd_len"], np.float32),
                                   tag="updater")
            _set_updater_vec(net, upd)
        net.iteration = meta["iteration"]
        scores = []
        for ds in data_source(meta["split"], meta):
            for hook in training_hooks:
                hook.pre_update(ds, net)        # TrainingHook.java preUpdate
            scores.append(_fit_one(net, ds))
            for hook in training_hooks:
                hook.post_update(ds, net)       # TrainingHook.java postUpdate
        # one host read of the scores, after the split's work is queued
        score_sum = float(sum(float(s) for s in scores))
        n_fit = len(scores)
        if n_fit > 0:
            client.allreduce(net.params(), tag="agg_params")
            if meta["upd_len"] > 0:
                client.allreduce(_updater_vec(net), tag="agg_updater")
        else:
            client.allreduce(np.zeros(meta["n_params"], np.float32),
                             tag="agg_params")
            if meta["upd_len"] > 0:
                client.allreduce(np.zeros(meta["upd_len"], np.float32),
                                 tag="agg_updater")
        client.allreduce(np.asarray(
            [score_sum, float(n_fit), 1.0 if n_fit > 0 else 0.0], np.float32),
            tag="agg_score")


class TrainingMaster:
    """SPI (``api/TrainingMaster.java``): how distributed fitting is
    orchestrated."""

    def execute_training(self, net, data):
        raise NotImplementedError


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous parameter averaging
    (``impl/paramavg/ParameterAveragingTrainingMaster.java:75``).

    ``mode='thread'`` runs the workers in this process (``local[N]``);
    ``'process'`` starts one OS process a worker
    (``deeplearning4j_tpu_torch.parallel.worker``) with Export-mode data
    files (the reference's default rdd approach, 'Export'). The workers'
    replicas live on the master network's device; a process worker that
    cannot reach it fails, and the master raises its error.
    ``collect_training_stats`` keeps (phase, seconds) in ``stats``
    (``split``, ``export``, ``broadcast``, ``aggregate``).
    """

    def __init__(self, *, n_workers=2, batch_size_per_worker=32,
                 averaging_frequency=1, mode="thread", export_dir=None,
                 average_updaters=True, collect_training_stats=False,
                 prefer_native=True, worker_env=None, join_timeout=120.0,
                 training_hooks=()):
        self.n_workers = n_workers
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(1, averaging_frequency)
        self.mode = mode
        self.export_dir = export_dir
        self.average_updaters = average_updaters
        self.collect_training_stats = collect_training_stats
        self.prefer_native = prefer_native
        self.worker_env = worker_env
        self.join_timeout = join_timeout
        self.training_hooks = tuple(training_hooks)
        if self.training_hooks and mode != "thread":
            # hooks are live objects of this process: dropping them in
            # spawned workers without a word would be worse than refusing
            raise ValueError(
                "training_hooks are only supported in mode='thread' "
                "(process workers cannot receive live hook objects)")
        self.stats = []  # [(phase, seconds)] when collect_training_stats
        self.coordinator_kind = None   # "native" or "python", per fit

    # --- configuration persistence (the JSON/YAML round trip of
    # impl/paramavg/TestJsonYaml.java); training_hooks are live objects
    # and do not serialise, everything else (worker_env too) does ---
    _JSON_FIELDS = ("n_workers", "batch_size_per_worker",
                    "averaging_frequency", "mode", "export_dir",
                    "average_updaters", "collect_training_stats",
                    "prefer_native", "worker_env", "join_timeout")

    def to_dict(self):
        return {k: getattr(self, k) for k in self._JSON_FIELDS}

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self):
        import yaml
        return yaml.safe_dump(self.to_dict())

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_yaml(cls, s):
        import yaml
        return cls.from_dict(yaml.safe_load(s))

    # --- data preparation (split, repartition, export) ---
    def _batches(self, data):
        if isinstance(data, DataSet):
            out = []
            n = data.num_examples()
            b = self.batch_size_per_worker
            for i in range(0, n, b):
                out.append(DataSet(
                    data.features[i:i + b],
                    None if data.labels is None else data.labels[i:i + b],
                    None if data.features_mask is None else data.features_mask[i:i + b],
                    None if data.labels_mask is None else data.labels_mask[i:i + b]))
            return out
        if isinstance(data, (DataSetIterator, MultiDataSetIterator, list,
                             tuple)):
            return self._rebatch(list(data))
        raise TypeError(f"cannot train on {type(data).__name__}")

    def _rebatch(self, items):
        """Re-batch plain DataSets to ``batch_size_per_worker`` (as
        ``BatchAndExportDataSetsFunction`` does). Masked DataSets and
        MultiDataSets pass through as they are: their time dimensions
        need not agree across batches."""
        if not items or not all(
                isinstance(d, DataSet) and d.features_mask is None
                and d.labels_mask is None for d in items):
            return items
        b = self.batch_size_per_worker
        if all(d.num_examples() == b for d in items[:-1]) and \
                items[-1].num_examples() <= b:
            return items  # already the right shape
        merged = DataSet.merge(items)
        out = []
        for i in range(0, merged.num_examples(), b):
            out.append(DataSet(
                merged.features[i:i + b],
                None if merged.labels is None else merged.labels[i:i + b]))
        return out

    def _make_splits(self, batches):
        """A split is n_workers x averaging_frequency batches
        (``doIteration:650``)."""
        per_split = self.n_workers * self.averaging_frequency
        return [batches[i:i + per_split]
                for i in range(0, len(batches), per_split)]

    def _timed(self, phase, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.collect_training_stats:
            self.stats.append((phase, time.perf_counter() - t0))
        return out

    # --- orchestration ---
    def execute_training(self, net, data):
        batches = self._timed("split", lambda: self._batches(data))
        splits = self._make_splits(batches)
        n_params = int(net.num_params())
        upd_vec = _updater_vec(net) if self.average_updaters \
            else np.zeros(0, np.float32)

        export_root = None
        if self.mode == "process":
            export_root = self.export_dir or tempfile.mkdtemp(
                prefix="dl4j_torch_export_")
            self._timed("export", lambda: self._export_splits(splits,
                                                              export_root))

        coord = start_coordinator(self.n_workers + 1,
                                  prefer_native=self.prefer_native)
        self.coordinator_kind = coord.kind
        monitor_stop = threading.Event()
        try:
            master = connect("127.0.0.1", coord.port, self.n_workers,
                             prefer_native=self.prefer_native)
            workers = self._start_workers(coord.port, splits, export_root,
                                          net.device)
            # watchdog: a dead worker can never complete a collective,
            # which would block the master for ever; it stops the
            # coordinator instead, so the master's blocked call fails and
            # the real cause is raised
            monitor = threading.Thread(
                target=self._monitor_workers,
                args=(workers, coord, monitor_stop), daemon=True)
            monitor.start()
            meta_base = {
                "config": net.conf.to_json(),
                "model_type": type(net).__name__,
                "n_params": n_params,
                "upd_len": int(upd_vec.size),
            }
            for si, _ in enumerate(splits):
                meta = dict(meta_base, split=si, iteration=net.iteration,
                            done=False)
                try:
                    self._timed("broadcast", lambda m=meta: self._broadcast_state(
                        master, m, net, upd_vec))
                    sums = self._timed("aggregate", lambda: self._aggregate(
                        master, n_params, upd_vec.size))
                except (RuntimeError, ConnectionError, OSError):
                    self._raise_worker_failure(workers)
                    raise
                psum, usum, ssum = sums
                participants = int(round(float(ssum[2])))
                if participants > 0:
                    net.set_params(psum / participants)
                    if self.average_updaters and upd_vec.size:
                        upd_vec = usum / participants
                        _set_updater_vec(net, upd_vec)
                if ssum[1] > 0:
                    net.score_ = float(ssum[0] / ssum[1])
                net.iteration += self.averaging_frequency
            # the shutdown broadcast
            _broadcast_blob(master, _encode_json_payload({"done": True}),
                            root=True, tag="meta")
            self._join_workers(workers)
            master.close()
        finally:
            monitor_stop.set()
            coord.stop()
            if export_root is not None and self.export_dir is None:
                shutil.rmtree(export_root, ignore_errors=True)
        return net

    def _monitor_workers(self, workers, coord, stop_event):
        kind, handles, errors = workers
        while not stop_event.wait(0.2):
            if kind == "thread" and errors:
                coord.stop()
                return
            if kind == "process" and any(
                    p.poll() is not None and p.returncode != 0
                    for p, _ in handles):
                coord.stop()
                return

    @staticmethod
    def _log_tail(log_path, n=4000):
        try:
            with open(log_path, errors="replace") as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def _raise_worker_failure(self, workers):
        kind, handles, errors = workers
        if kind == "thread" and errors:
            raise errors[0]
        if kind == "process":
            for p, log_path in handles:
                try:
                    p.wait(timeout=10)   # a dying worker: let it finish
                except subprocess.TimeoutExpired:
                    continue
                if p.returncode != 0:
                    raise RuntimeError(
                        f"worker process exited with {p.returncode}:\n"
                        f"{self._log_tail(log_path)}")

    def _broadcast_state(self, master, meta, net, upd_vec):
        _broadcast_blob(master, _encode_json_payload(meta), root=True,
                        tag="meta")
        master.broadcast(net.params(), root=True, tag="params")
        if meta["upd_len"] > 0:
            master.broadcast(upd_vec, root=True, tag="updater")

    def _aggregate(self, master, n_params, upd_len):
        """The master contributes zeros; the sums are the workers'."""
        psum = master.allreduce(np.zeros(n_params, np.float32), tag="agg_params")
        usum = (master.allreduce(np.zeros(upd_len, np.float32), tag="agg_updater")
                if upd_len > 0 else np.zeros(0, np.float32))
        ssum = master.allreduce(np.zeros(3, np.float32), tag="agg_score")
        return psum, usum, ssum

    # --- worker launching ---
    def _worker_batches(self, split, worker_id):
        """Round-robin partition of a split's batches
        (``BalancedPartitioner``)."""
        return [b for j, b in enumerate(split)
                if j % self.n_workers == worker_id]

    def _export_splits(self, splits, root):
        for si, split in enumerate(splits):
            for w in range(self.n_workers):
                d = os.path.join(root, f"worker_{w}", f"split_{si}")
                # made anew: batch files left by an earlier, larger export
                # would otherwise be trained on again
                if os.path.isdir(d):
                    shutil.rmtree(d)
                os.makedirs(d)
                for j, ds in enumerate(self._worker_batches(split, w)):
                    save_dataset(ds, os.path.join(d, f"batch_{j:06d}.npz"))

    def _start_workers(self, port, splits, export_root, device):
        if self.mode == "thread":
            errors = []

            def run(worker_id):
                try:
                    client = connect("127.0.0.1", port, worker_id,
                                     prefer_native=self.prefer_native)
                    run_worker_loop(
                        client,
                        lambda si, meta: self._worker_batches(splits[si], worker_id),
                        training_hooks=self.training_hooks, device=device)
                    client.close()
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                        name=f"dl4j-torch-tm-worker-{i}")
                       for i in range(self.n_workers)]
            for t in threads:
                t.start()
            return ("thread", threads, errors)
        if self.mode == "process":
            procs = []
            env = dict(os.environ)
            if self.worker_env:
                env.update(self.worker_env)
            for i in range(self.n_workers):
                log_path = os.path.join(export_root, f"worker_{i}.log")
                with open(log_path, "w") as log:
                    procs.append((subprocess.Popen(
                        [sys.executable, "-m",
                         "deeplearning4j_tpu_torch.parallel.worker",
                         "--host", "127.0.0.1", "--port", str(port),
                         "--worker-id", str(i),
                         "--data-dir", os.path.join(export_root,
                                                    f"worker_{i}"),
                         "--device", str(device)]
                        + ([] if self.prefer_native else ["--no-native"]),
                        env=env, cwd=_REPO_ROOT, stdout=log,
                        stderr=subprocess.STDOUT), log_path))
            return ("process", procs, None)
        raise ValueError(f"unknown mode {self.mode!r}")

    def _join_workers(self, workers):
        kind, handles, errors = workers
        if kind == "thread":
            for t in handles:
                t.join(timeout=self.join_timeout)
            hung = [t for t in handles if t.is_alive()]
            if hung:
                raise RuntimeError(
                    f"{len(hung)} training worker thread(s) still alive after "
                    "join timeout — aborting instead of reporting a "
                    "partially-aggregated result")
            if errors:
                raise errors[0]
        else:
            for p, log_path in handles:
                rc = p.wait(timeout=300)
                if rc != 0:
                    raise RuntimeError(f"worker process exited with {rc}:\n"
                                       f"{self._log_tail(log_path)}")

    def stats_html(self, path):
        """Phase-timing chart (``StatsUtils.exportStatsAsHtml``'s part)."""
        from deeplearning4j_tpu_torch.ui.components import (
            ChartLine, ComponentTable, render_standalone_html)
        totals = {}
        for phase, sec in self.stats:
            totals[phase] = totals.get(phase, 0.0) + sec
        table = ComponentTable(["phase", "total seconds"],
                               [[k, f"{v:.4f}"] for k, v in totals.items()],
                               title="Training phase timings")
        chart = ChartLine("aggregate time per split", x_label="event",
                          y_label="seconds")
        for phase in totals:
            ys = [s for p, s in self.stats if p == phase]
            chart.add_series(phase, list(range(len(ys))), ys)
        with open(path, "w") as f:
            f.write(render_standalone_html([table, chart],
                                           title="TrainingMaster stats"))
        return path


class DistributedMultiLayerNetwork:
    """``SparkDl4jMultiLayer``: binds a network to a training master
    (``impl/multilayer/SparkDl4jMultiLayer.java:78-122``). Given a
    configuration, it builds the network on ``device`` (None: the card)."""

    def __init__(self, net_or_conf, training_master, device=None):
        from deeplearning4j_tpu_torch.models.multi_layer_network import \
            MultiLayerNetwork
        if hasattr(net_or_conf, "params"):
            self.network = net_or_conf
        else:
            self.network = MultiLayerNetwork(net_or_conf, device=device).init()
        if self.network.params_list is None:
            self.network.init()
        self.training_master = training_master

    def fit(self, data):
        return self.training_master.execute_training(self.network, data)

    def output(self, x):
        return self.network.output(x)


class DistributedComputationGraph(DistributedMultiLayerNetwork):
    """``SparkComputationGraph``."""

    def __init__(self, net_or_conf, training_master, device=None):
        from deeplearning4j_tpu_torch.models.computation_graph import \
            ComputationGraph
        if hasattr(net_or_conf, "params"):
            self.network = net_or_conf
        else:
            self.network = ComputationGraph(net_or_conf, device=device).init()
        if self.network.params_list is None:
            self.network.init()
        self.training_master = training_master
