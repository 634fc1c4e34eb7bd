"""ComputationGraph archives and training checkpoints of the port, against
the JAX package's and against the port's own uninterrupted runs, on the
CPU.

- A graph archive the JAX package writes restores in the port, and one
  the port writes restores in the JAX package: parameters, updater state
  and BatchNormalization's running moments arrive bitwise (the same
  float32 vectors, the layers in the same topological order, the layer
  state under ``{vertex}.{key}``), outputs within 1e-5 of their max abs
  (the same f32 formulas in another summation order);
- ``restore_model`` dispatches on the archive's ``model_type``;
- a graph run resumed from a checkpoint equals the uninterrupted run
  bitwise (the same CPU ops on the same rows, the generator's state
  carried in the checkpoint): a ResNet with BatchNormalization over a
  DataSetIterator, and a two-input graph with dropout over a
  MultiDataSetIterator.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayMultiDataSetIterator, DataSet, ListDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.utils import (model_serializer,
                                            training_checkpoint)

REL = 1e-5
SMALL = dict(n_classes=3, height=16, width=16, stages=(1,))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.array(tree)


def _assert_trees_equal(got, want, what=""):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_close(got, want, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= REL * scale, (what, err, scale)


def _images(seed, n=4):
    r = np.random.RandomState(seed)
    return (r.randn(n, 16, 16, 3).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


def test_jax_graph_archive_restores_in_the_port(tmp_path):
    jnet = JGraph(jzoo.resnet50(**SMALL)).init()
    for s in range(2):
        jnet.fit_batch(JMultiDataSet(*[[a] for a in _images(s)]))
    path = str(tmp_path / "jax_graph.zip")
    jser.write_model(jnet, path)
    assert model_serializer.model_type(path) == "ComputationGraph"
    for restore in (model_serializer.restore_computation_graph,
                    model_serializer.restore_model):
        pnet = restore(path, device="cpu")
        assert isinstance(pnet, ComputationGraph)
        assert pnet.iteration == jnet.iteration == 2
        _assert_trees_equal(pnet.params_map, jnet.params_map, "params")
        _assert_trees_equal(pnet.states_map, jnet.states_map, "states")
        _assert_trees_equal(pnet.updater_states_map, jnet.updater_states,
                            "updater")
        x, _ = _images(9)
        _assert_close(pnet.output(x), jnet.output(x), "output")


def test_port_graph_archive_restores_in_jax(tmp_path):
    pnet = ComputationGraph(zoo.resnet50(**SMALL), device="cpu").init()
    for s in range(2):
        pnet.fit(ListDataSetIterator([DataSet(*_images(s))]))
    path = str(tmp_path / "port_graph.zip")
    model_serializer.write_model(pnet, path)
    jnet = jser.restore_model(path)
    assert isinstance(jnet, JGraph) and jnet.iteration == 2
    _assert_trees_equal(pnet.params_map, jnet.params_map, "params")
    _assert_trees_equal(pnet.states_map, jnet.states_map, "states")
    _assert_trees_equal(pnet.updater_states_map, jnet.updater_states,
                        "updater")
    x, _ = _images(9)
    _assert_close(pnet.output(x), jnet.output(x), "output")
    # and back: the port restores its own archive to the same bits
    again = model_serializer.restore_model(path, device="cpu")
    np.testing.assert_array_equal(again.output(x), pnet.output(x))


def _dropout_graph():
    """Two inputs, dropout on a hidden layer, nesterovs."""
    return (NeuralNetConfiguration.Builder().seed(11).learning_rate(0.05)
            .updater("nesterovs").momentum(0.9).weight_init("xavier")
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_in=5, n_out=8, activation="tanh",
                                        dropout=0.7), "a")
            .add_layer("db", DenseLayer(n_in=4, n_out=8, activation="relu"),
                       "b")
            .add_vertex("cat", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_in=16, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"), "cat")
            .set_outputs("out").build())


def _resnet_stream():
    return ListDataSetIterator([DataSet(*_images(10 + s)) for s in range(5)])


def _multi_stream():
    r = np.random.RandomState(3)
    xs = [r.randn(40, 5).astype(np.float32), r.randn(40, 4).astype(np.float32)]
    ys = [np.eye(3, dtype=np.float32)[r.randint(0, 3, 40)]]
    return ArrayMultiDataSetIterator(xs, ys, batch_size=8)


@pytest.mark.parametrize("case", ["resnet_bn", "multi_input_dropout"])
def test_graph_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch,
                                                   case):
    """Two epochs with a checkpoint every 2 updates; a fresh graph resumed
    from the first checkpoint ends with the uninterrupted run's
    parameters, layer and updater state and draw counter, bitwise. The
    per-batch path (K 1: a checkpoint may fall between any two batches);
    the fused loop's resume is ``test_torch_fused_graph.py``'s."""
    monkeypatch.setenv("DL4J_TORCH_FUSE_STEPS", "1")
    if case == "resnet_bn":
        conf, stream, epochs = zoo.resnet50(**SMALL), _resnet_stream, 2
    else:
        conf, stream, epochs = _dropout_graph(), _multi_stream, 2
    monkeypatch.setenv("DL4J_TORCH_CKPT_KEEP", "100")
    full_dir, resume_dir = str(tmp_path / "full"), str(tmp_path / "resume")
    full = ComputationGraph(conf, device="cpu").init()
    full.fit(stream(), epochs=epochs, checkpoint_every=2,
             checkpoint_dir=full_dir)
    files = training_checkpoint.checkpoint_files(full_dir)
    assert files[0][0] == 2 and len(files) == full.iteration // 2
    os.makedirs(resume_dir)
    shutil.copy(os.path.join(full_dir, files[0][1]), resume_dir)
    net = ComputationGraph(conf, device="cpu").init()
    net.fit(stream(), epochs=epochs, checkpoint_every=2,
            resume_from=resume_dir)
    assert net.iteration == full.iteration == epochs * 5
    np.testing.assert_array_equal(net.params(), full.params())
    _assert_trees_equal(net.states_map, full.states_map, "states")
    _assert_trees_equal(net.updater_states_map, full.updater_states_map,
                        "updater")
    assert net.dropout_draws == full.dropout_draws


def test_checkpoint_restores_a_graph_in_place_and_refuses_an_mln(tmp_path):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = ComputationGraph(_dropout_graph(), device="cpu").init()
    net.fit(_multi_stream())
    d = str(tmp_path / "ck")
    training_checkpoint.save_training_checkpoint(net, d,
                                                 cursor={"epoch": 1})
    again = ComputationGraph(ComputationGraphConfiguration.from_json(
        net.conf.to_json()), device="cpu").init()
    assert training_checkpoint.resume_latest(again, d) == {"epoch": 1}
    np.testing.assert_array_equal(again.params(), net.params())
    assert again.iteration == net.iteration == 5
    mln = MultiLayerNetwork(zoo.mlp_mnist(), device="cpu").init()
    with pytest.raises(ValueError, match="holds a ComputationGraph"):
        training_checkpoint.resume_latest(mln, d)
    mln_path = str(tmp_path / "mln.zip")
    model_serializer.write_model(mln, mln_path)
    with pytest.raises(ValueError, match="holds a MultiLayerNetwork"):
        training_checkpoint.apply_training_checkpoint(again, mln_path)
    # the same parameters come across by name too
    again.params_map = params_from_numpy(again.conf,
                                         _np_tree(net.params_map), "cpu")
    np.testing.assert_array_equal(again.params(), net.params())
    x = [np.ones((2, 5), np.float32), np.ones((2, 4), np.float32)]
    np.testing.assert_array_equal(again.output(*x), net.output(*x))
    assert MultiDataSet(x, [np.zeros((2, 3))]).num_examples() == 2
