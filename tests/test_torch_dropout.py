"""Counter-based dropout (``ops/random.py``, ``models/_layered.py``).

A mask is a pure function of ``conf.seed``, the model's device draw
counter, the layer's index and the element's index. JAX's threefry draws
cannot be reproduced in torch, so dropout is held by distribution and by
its contracts, never bitwise against the reference:

- the retain fraction lies within 5 binomial standard deviations of the
  retain probability;
- fused equals per batch bitwise, for MultiLayerNetwork and
  ComputationGraph, tBPTT included;
- a step the guard rejects is reverted with the counter, so its
  successor draws the same masks: the poisoned stream equals the stream
  without the bad batch bitwise;
- remat draws the masks of the first run; a zero-weight (probe or
  padding) step leaves the counter where it was;
- a resumed dropout run equals the uninterrupted one bitwise, and a
  checkpoint written before the counter existed still loads.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator, StackedDataSet)
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as players
from deeplearning4j_tpu_torch.ops import random as prandom
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils import training_checkpoint

V, HID, T, SEG = 7, 8, 12, 5
WINDOWS = 3


def _mlp(dropout=0.5, remat=False):
    conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
            .updater("nesterovs").list()
            .layer(players.DenseLayer(n_in=6, n_out=16, activation="relu",
                                      dropout=dropout))
            .layer(players.DenseLayer(n_in=16, n_out=8, activation="tanh",
                                      dropout=dropout))
            .layer(players.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .build())
    conf.remat = remat
    return MultiLayerNetwork(conf, device="cpu").init()


def _charrnn(graph=False):
    """The zoo's char-RNN with retain 0.8 on the second GravesLSTM, as an
    MLN or as the same chain in a graph."""
    conf = zoo.char_rnn(vocab_size=V, hidden=HID, tbptt_length=SEG,
                        learning_rate=0.01, seed=3)
    conf.layers[1].dropout = 0.8
    if not graph:
        return MultiLayerNetwork(conf, device="cpu").init()
    gb = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.01)
          .updater("rmsprop").rms_decay(0.95).graph_builder()
          .add_inputs("in"))
    prev = "in"
    for i, layer in enumerate(conf.layers):
        gb.add_layer(f"l{i}", layer, prev)
        prev = f"l{i}"
    g = (gb.set_outputs(prev).backprop_type("tbptt").tbptt_fwd_length(SEG)
         .tbptt_back_length(SEG).build())
    return ComputationGraph(g, device="cpu").init()


def _mlp_batches(n, seed=1, rows=8):
    r = np.random.RandomState(seed)
    return [(r.rand(rows, 6).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.randint(0, 3, rows)])
            for _ in range(n)]


def _char_batches(n, seed=0, rows=4):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = r.randint(0, V, (rows, T + 1))
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _fit(net, batches, monkeypatch, k, **kw):
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", str(k))
    if isinstance(net, ComputationGraph):
        from deeplearning4j_tpu_torch.datasets.dataset import (
            ArrayMultiDataSetIterator)
        it = ArrayMultiDataSetIterator(
            [np.concatenate([x for x, _ in batches])],
            [np.concatenate([y for _, y in batches])],
            batch_size=batches[0][0].shape[0])
    else:
        it = ListDataSetIterator([DataSet(x, y) for x, y in batches])
    net.fit(it, **kw)
    return net


def _same(a, b):
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.iteration == b.iteration
    assert int(a._device_iteration()) == int(b._device_iteration())
    assert a.dropout_draws == b.dropout_draws


# ---------------------------------------------------------------------------
# the mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [0.4, 0.5, 0.8])
def test_retain_fraction_within_a_binomial_bound(p):
    key = prandom.DropoutKey(12345, torch.tensor(7, dtype=torch.int64), 2)
    n = 200_000
    kept = prandom.dropout_keep(key, (n,), p, "cpu")
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - p * n) <= 5 * sd


def test_mask_is_a_pure_function_of_seed_counter_layer_and_element():
    x = torch.ones(64, 128)
    layer = players.DenseLayer(n_in=128, n_out=4, dropout=0.5)
    c = torch.tensor(3, dtype=torch.int64)

    def mask(seed, counter, stream, shape=(64, 128)):
        key = prandom.DropoutKey(seed, torch.tensor(counter), stream)
        return layer.apply_dropout(torch.ones(shape), train=True, rng=key)
    base = mask(1, 3, 0)
    assert torch.equal(base, layer.apply_dropout(
        x, train=True, rng=prandom.DropoutKey(1, c, 0)))
    for other in (mask(2, 3, 0), mask(1, 4, 0), mask(1, 3, 1),
                  mask(1, 2 ** 32 + 3, 0)):
        assert not torch.equal(base, other)
    # element e's draw does not depend on the tensor's shape
    assert torch.equal(mask(1, 3, 0, (64 * 128,)), base.reshape(-1))
    kept = base != 0
    assert torch.all(base[kept] == 2.0)
    assert torch.equal(layer.apply_dropout(x, train=False, rng=None), x)


def test_transformer_sampler_shares_the_one_hash():
    from deeplearning4j_tpu_torch.models import transformer
    assert transformer.mix32 is prandom.mix32
    assert transformer.mul32 is prandom.mul32


# ---------------------------------------------------------------------------
# fused against per batch
# ---------------------------------------------------------------------------
def test_mln_fused_equals_per_batch_bitwise_with_dropout(monkeypatch):
    """Seven batches, a ragged trailer row-padded: K 4 against K 1."""
    batches = _mlp_batches(6) + _mlp_batches(1, seed=2, rows=5)
    fused = _fit(_mlp(), batches, monkeypatch, 4)
    plain = _fit(_mlp(), batches, monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 2
    _same(fused, plain)
    assert fused.dropout_draws == 7


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_charrnn_fused_equals_per_batch_bitwise_with_dropout(monkeypatch,
                                                             graph):
    """The char-RNN (tBPTT, windows 5, 5 and 2) with retain 0.8 on its
    second LSTM: K 4 against K 1, one draw a window."""
    batches = _char_batches(6, seed=3)
    fused = _fit(_charrnn(graph), batches, monkeypatch, 4)
    plain = _fit(_charrnn(graph), batches, monkeypatch, 1)
    assert fused._last_fuse_stats["fused_groups"] == 2
    _same(fused, plain)
    assert fused.dropout_draws == 6 * WINDOWS


def test_graph_and_mln_draw_the_same_masks(monkeypatch):
    """The chain as a graph has the MLN's layer order, so the same layer
    index: both draw the same masks and train to the same bits."""
    batches = _char_batches(4, seed=4)
    mln, graph = _charrnn(False), _charrnn(True)
    graph.set_params(mln.params())
    _fit(mln, batches, monkeypatch, 4)
    _fit(graph, batches, monkeypatch, 4)
    np.testing.assert_array_equal(mln.params(), graph.params())


# ---------------------------------------------------------------------------
# reverts: the guard, padding and probe steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4])
def test_rejected_step_redraws_the_same_masks(monkeypatch, k):
    """A batch the guard rejects reverts the counter with the parameters:
    the next batch draws the masks it would have drawn without the bad
    batch, so the run equals the stream without it, bitwise."""
    batches = _mlp_batches(6, seed=7)
    spec = "nan-step@1" if k == 1 else "nan-step@0:1"
    with pytest.warns(RuntimeWarning, match="non-finite"):
        with faults.inject(spec):
            poisoned = _fit(_mlp(), batches, monkeypatch, k)
    control = _fit(_mlp(), batches[:1] + batches[2:], monkeypatch, k)
    np.testing.assert_array_equal(poisoned.params(), control.params())
    assert poisoned.dropout_draws == control.dropout_draws == 5
    assert poisoned.nan_skipped_steps == 1


def test_zero_weight_step_leaves_the_counter(monkeypatch):
    """A zero-weight group (the autotuner's probe, a padding step) is an
    identity: parameters, iteration and the draw counter unchanged."""
    net = _mlp()
    batches = _mlp_batches(4, seed=8)
    xs = np.stack([x for x, _ in batches])
    ys = np.stack([y for _, y in batches])
    before = net.params()
    net._fused_probe_dispatch([torch.from_numpy(xs)],
                              [torch.from_numpy(ys)],
                              torch.zeros(4, 8), True)
    np.testing.assert_array_equal(net.params(), before)
    assert net.dropout_draws == 0 and int(net._device_iteration()) == 0
    net.fit_fused(StackedDataSet(xs, ys, np.ones((4, 8), np.float32), 4))
    assert net.dropout_draws == 4


def test_remat_draws_the_masks_of_the_first_run(monkeypatch):
    """``conf.remat``: each layer recomputed in the backward reads the same
    counter, so the fused and per-batch remat runs equal the plain one."""
    batches = _mlp_batches(5, seed=9)
    plain = _fit(_mlp(), batches, monkeypatch, 4)
    remat = _fit(_mlp(remat=True), batches, monkeypatch, 4)
    np.testing.assert_allclose(remat.params(), plain.params(), rtol=0,
                               atol=1e-7)
    assert remat.dropout_draws == plain.dropout_draws == 5


def test_per_batch_step_reads_nothing_on_the_host(monkeypatch):
    """No ``.item()``/``bool()`` of a device value inside a step: the
    guard's counter is read one step late (a copy), never the draw
    counter."""
    net = _mlp()
    reads = []
    real_bool = torch.Tensor.__bool__

    def spy(t):
        reads.append(t)
        return real_bool(t)
    monkeypatch.setattr(torch.Tensor, "__bool__", spy)
    for x, y in _mlp_batches(3, seed=10):
        net.fit_batch(x, y)
    assert reads == []


# ---------------------------------------------------------------------------
# resume and archives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4])
def test_resume_with_dropout_is_bitwise(tmp_path, monkeypatch, k):
    monkeypatch.setenv("DL4J_TORCH_CKPT_KEEP", "100")
    batches = _mlp_batches(8, seed=11)
    full_dir, res_dir = str(tmp_path / "full"), str(tmp_path / "res")
    full = _fit(_mlp(), batches, monkeypatch, k, epochs=2,
                checkpoint_every=4, checkpoint_dir=full_dir)
    files = training_checkpoint.checkpoint_files(full_dir)
    os.makedirs(res_dir)
    shutil.copy(os.path.join(full_dir, files[0][1]), res_dir)
    net = _fit(_mlp(), batches, monkeypatch, k, epochs=2,
               checkpoint_every=4, resume_from=res_dir)
    _same(net, full)
    assert full.dropout_draws == 16


def test_checkpoint_from_before_the_counter_loads(tmp_path, monkeypatch):
    """A training checkpoint as an earlier version of the package wrote
    it (the generator's state under ``torch_rng``, no counter in the
    metadata or the training state) loads: the counter starts at its
    iteration."""
    d = str(tmp_path / "ck")
    net = _fit(_mlp(), _mlp_batches(4, seed=12), monkeypatch, 1,
               checkpoint_every=4, checkpoint_dir=d)
    (_, name), = training_checkpoint.checkpoint_files(d)
    path = os.path.join(d, name)
    from deeplearning4j_tpu_torch.utils import atomic_io
    entries = atomic_io.read_zip_entries(path)
    meta = json.loads(entries["metadata.json"])
    meta.pop("dropout_draws")
    state = json.loads(entries["trainingState.json"])
    state.pop("dropout_draws")
    state["torch_rng"] = [0] * 16
    state["torch_rng_device"] = "cpu"
    entries["metadata.json"] = json.dumps(meta).encode()
    entries["trainingState.json"] = json.dumps(state).encode()
    atomic_io.write_zip_atomic(path, entries)
    fresh = _mlp()
    cursor = training_checkpoint.apply_training_checkpoint(fresh, path)
    assert cursor == {"epoch": 0, "batch": 4}
    np.testing.assert_array_equal(fresh.params(), net.params())
    assert fresh.dropout_draws == fresh.iteration == 4
