"""The port's ProfilerListener (``optimize/listeners.py``) on
``torch.profiler``: the window opens after the iteration that reaches
``start_iteration`` and closes ``num_iterations`` later, a CPU fit
writes a Chrome trace under ``log_dir``, ``close()`` finishes a window
that training left open and is idempotent, and a stop that fails is
logged, never raised (the reference's contract). A torch profile is
never stopped twice: a second stop of one profile ends the process."""

import json
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.optimize.listeners import ProfilerListener


def _net():
    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .list().layer(DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax")).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(seed=0):
    r = np.random.RandomState(seed)
    return DataSet(r.randn(16, 6).astype(np.float32),
                   np.eye(3, dtype=np.float32)[r.randint(0, 3, 16)])


class _Spy(ProfilerListener):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.events = []

    def iteration_done(self, model, iteration):
        was = self._active
        super().iteration_done(model, iteration)
        if self._active != was:
            self.events.append(("start" if self._active else "stop",
                                iteration))


def test_window_start_and_stop(tmp_path):
    logs = []
    lst = _Spy(str(tmp_path / "prof"), start_iteration=2, num_iterations=3,
               log_fn=logs.append)
    net = _net()
    net.set_listeners(lst)
    ds = _data()
    for _ in range(8):
        net.fit(ds)
    assert lst.events == [("start", 2), ("stop", 5)]
    assert lst.captured and not lst._active
    assert lst.trace_path == os.path.join(str(tmp_path / "prof"),
                                          "trace_3_5.json")
    assert any("captured" in m for m in logs)


def test_cpu_fit_writes_a_chrome_trace(tmp_path):
    lst = ProfilerListener(str(tmp_path), start_iteration=1,
                           num_iterations=2, log_fn=lambda m: None)
    net = _net()
    net.set_listeners(lst)
    for _ in range(4):
        net.fit(_data())
    with open(lst.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "mm" in n for n in names), sorted(names)[:20]


def test_close_finishes_an_open_window_and_is_idempotent(tmp_path):
    logs = []
    lst = ProfilerListener(str(tmp_path), start_iteration=1,
                           num_iterations=50, log_fn=logs.append)
    net = _net()
    net.set_listeners(lst)
    for _ in range(3):
        net.fit(_data())
    assert lst._active and not lst.captured
    lst.close(net)
    assert lst.captured and os.path.exists(lst.trace_path)
    n = len(logs)
    lst.close(net)
    lst.close()
    assert len(logs) == n
    ProfilerListener(str(tmp_path)).close()   # never started: a no-op
    # a later window in the same process can start: nothing was stranded
    again = ProfilerListener(str(tmp_path / "2"), start_iteration=0,
                             num_iterations=1, log_fn=logs.append)
    again.iteration_done(net, 0)
    again.iteration_done(net, 1)
    assert again.captured


def test_a_failed_stop_or_export_is_logged_not_raised(tmp_path):
    logs = []
    lst = ProfilerListener(str(tmp_path), start_iteration=0,
                           num_iterations=5, log_fn=logs.append)
    net = _net()
    lst.iteration_done(net, 0)
    prof = lst._prof
    real_stop = prof.stop

    def failing_stop():
        real_stop()
        raise RuntimeError("stop failed")
    prof.stop = failing_stop
    lst.iteration_done(net, 5)
    assert not lst.captured and not lst._active and lst._prof is None
    assert any("NOT finalized" in m and "stop failed" not in m
               for m in logs)
    lst.close(net)             # still a no-op: nothing is stopped twice
    # an export that cannot be written (log_dir is a file)
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = ProfilerListener(str(blocker), start_iteration=0,
                           num_iterations=1, log_fn=logs.append)
    bad.iteration_done(net, 0)
    bad.iteration_done(net, 1)
    assert not bad.captured and not bad._active
    assert sum("NOT finalized" in m for m in logs) == 2
    assert torch.profiler is not None
