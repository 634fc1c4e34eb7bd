"""The port's ComputationGraph against the JAX package's, on the CPU.

One ``ComputationGraphConfiguration`` JSON builds both graphs; the port
takes the JAX graph's initial parameters (``params_from_numpy``) and both
train on the same numpy batches. On the CPU the port's LSTM vertices run
the kernels' plain twins behind the same autograd Function a CUDA tensor
takes; the JAX side runs its default LSTM route.

Tolerances, with their reasons:
- configurations: the JSON, ``num_params()`` and the topological order
  exactly;
- outputs: 1e-5 of their max abs (the same f32 formulas; summation order
  only);
- training: parameters and updater state within 1e-5 of each leaf's max
  abs after every compared step, scores 1e-5 relative, as
  ``test_torch_mln.py`` holds the MultiLayerNetwork; BatchNormalization's
  running variance the same, its running mean within 1e-5 of the larger
  of its max abs and the data's spread (``_assert_states_close``);
- bf16 compute: the score and every gradient leaf against the JAX
  graph's bf16 step within ``BF16_BAR`` (below), derived from bf16's
  rounding;
- the port against itself (a graph against the MultiLayerNetwork of the
  same chain, the guard's revert): bitwise, the same CPU ops on the same
  rows.

Dropout draws from each package's own generator, so the streams cannot
agree (ROADMAP.md's North star): the GoogLeNet steps against JAX run
with its head's dropout off, and the port's dropout is held by its
distribution.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (
    ArrayMultiDataSetIterator as JArrayMultiIterator, DataSet as JDataSet,
    ListDataSetIterator as JListIterator, MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.models._device_state import (
    fuse_allowed as jfuse_allowed)
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf.computation_graph import (
    ComputationGraphConfiguration as JGraphConf)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import (
    ArrayMultiDataSetIterator, DataSet, ListDataSetIterator, MultiDataSet,
    StackedMultiDataSet)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph, params_from_numpy, updater_state_from_numpy)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn import layers as players
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

REL = 1e-5
# bf16 compute against the JAX graph's bf16 compute: both round the same
# inputs and weights to bf16 (each within 2^-9 relative), but their dense
# products and activations may round one bf16 step (2^-8 relative)
# apart, and a gradient leaf is a product of an activation and a
# back-propagated error that each carry such a step from every layer
# above: 3 layers, two factors, one step each, 6 x 2^-8 of the leaf's max
# abs
BF16_BAR = 6 * 2.0 ** -8


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.array(tree)


def _assert_close(got, want, what="", rel=REL):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in want:
            _assert_close(got[k], want[k], f"{what}.{k}", rel)
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _pair(jconf, jax_init=True):
    """A JAX graph and the port's graph from its JSON, with the JAX
    graph's initial parameters; or, without ``jax_init``, with the
    port's, which the JAX graph then takes (its own init draws layer by
    layer eagerly: 22 s for the 67x67 GoogLeNet on the CPU)."""
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pnet = ComputationGraph(pconf, device="cpu").init()
    if jax_init:
        jnet = JGraph(jconf).init()
        pnet.params_map = params_from_numpy(
            pconf, _np_tree(jnet.params_map), "cpu")
        return jnet, pnet
    jnet = JGraph(jconf)
    jnet.params_map = {n: {k: jnp.asarray(v) for k, v in p.items()}
                       for n, p in _np_tree(pnet.params_map).items()}
    jnet.states_map = {n: jconf.vertices[n].layer.init_state()
                       for n in jnet.layer_names}
    jnet.updater_states = {
        n: jupd.init_state(jconf.vertices[n].layer.updater_config(
            jconf.max_iterations), jnet.params_map[n])
        for n in jnet.layer_names}
    jnet._rng = jax.random.PRNGKey(jconf.seed)
    return jnet, pnet


def _assert_states_close(got, want, what):
    """BatchNormalization's running moments: the variance within REL of
    its max abs; the mean within REL of the data's spread (the square
    root of the variance) where that is larger, since the batch mean of
    activations centred near 0 cancels and its summation-order error
    scales with the activations, not with the mean."""
    got, want = _np_tree(got), _np_tree(want)
    assert set(got) == set(want), what
    for name, w in want.items():
        _assert_close(got[name]["var"], w["var"], f"{what}.{name}.var")
        spread = float(np.sqrt(np.abs(w["var"]).max()))
        err = float(np.abs(got[name]["mean"] - w["mean"]).max())
        scale = max(float(np.abs(w["mean"]).max()), spread)
        assert err <= REL * scale, (f"{what}.{name}.mean", err, scale)


def _assert_graphs_close(pnet, jnet, what):
    _assert_close(pnet.params_map, jnet.params_map, f"{what} params")
    _assert_states_close({k: v for k, v in pnet.states_map.items() if v},
                         {k: v for k, v in jnet.states_map.items() if v},
                         f"{what} states")
    _assert_close(pnet.updater_states_map, jnet.updater_states,
                  f"{what} updater")


def _images(seed, n, size, classes, channels=3):
    r = np.random.RandomState(seed)
    x = r.randn(n, size, size, channels).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[r.randint(0, classes, n)]
    return x, y


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build", ["resnet50", "googlenet", "vgg16",
                                   "alexnet"])
def test_zoo_configuration_json_and_size_match_jax(build):
    """At full width (built, not initialised): the same JSON, the same
    number of parameters, and for the graphs the same topological order,
    which fixes the flat parameter vector."""
    jconf = getattr(jzoo, build)()
    pconf = getattr(zoo, build)()
    assert pconf.to_json() == jconf.to_json()
    if build in ("resnet50", "googlenet"):
        again = ComputationGraphConfiguration.from_json(jconf.to_json())
        assert again.to_json() == jconf.to_json()
        assert pconf.topological_order == jconf.topological_order
        assert again.layer_names() == jconf.layer_names()
        n = ComputationGraph(pconf, device="cpu").num_params()
        assert n == JGraph(jconf).num_params()
        # the reference's gate: ResNet-50 declined (BatchNormalization),
        # GoogLeNet fused (its head's dropout draws from the counter)
        assert fuse_allowed(pconf, pconf.layer_confs()) == \
            jfuse_allowed(jconf, jconf.layer_confs()) == \
            (build == "googlenet")
    else:
        again = MultiLayerConfiguration.from_json(jconf.to_json())
        assert again.to_json() == jconf.to_json()
        n = MultiLayerNetwork(pconf, device="cpu").num_params()
        assert n == JNet(jconf).num_params()
    assert n == {"resnet50": 25557032, "googlenet": 6998552,
                 "vgg16": 138357544, "alexnet": 62378344}[build]


def _diamond(builder, layers, vertices):
    """A DAG whose Kahn order needs the sorted ready list: names that
    sort against their insertion order, and several vertices ready at
    once."""
    return (builder.seed(1).learning_rate(0.1).updater("sgd")
            .graph_builder().add_inputs("in")
            .add_layer("z_left", layers.DenseLayer(n_in=4, n_out=3), "in")
            .add_layer("a_right", layers.DenseLayer(n_in=4, n_out=3), "in")
            .add_layer("m_mid", layers.DenseLayer(n_in=3, n_out=3), "a_right")
            .add_vertex("b_join", vertices.ElementWiseVertex(op="add"),
                        "z_left", "m_mid")
            .add_vertex("c_side", vertices.ScaleVertex(scale_factor=2.0),
                        "a_right")
            .add_vertex("merge", vertices.MergeVertex(), "c_side", "b_join")
            .add_layer("out", layers.OutputLayer(n_in=6, n_out=2,
                                                 activation="softmax",
                                                 loss="mcxent"), "merge")
            .set_outputs("out").build())


def test_topological_order_matches_jax():
    jconf = _diamond(JBuilder.Builder(), jlayers, jgraph)
    pconf = _diamond(NeuralNetConfiguration.Builder(), players, pgraph)
    assert pconf.topological_order == jconf.topological_order
    assert pconf.layer_names() == jconf.layer_names()
    assert pconf.to_json() == jconf.to_json()
    # the flat vector follows the order: the port's params() is the JAX
    # graph's
    jnet, pnet = _pair(jconf)
    np.testing.assert_array_equal(pnet.params(), np.asarray(jnet.params()))


def test_cycles_and_unknown_inputs_are_rejected():
    def build(edges):
        gb = NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
        for name, src in edges:
            gb.add_layer(name, DenseLayer(n_in=3, n_out=3), *src)
        gb.add_layer("out", OutputLayer(n_in=3, n_out=2), "b")
        return gb.set_outputs("out").build()
    with pytest.raises(ValueError, match="Cycle"):
        build([("a", ("b",)), ("b", ("a",))])
    with pytest.raises(ValueError, match="unknown input 'nowhere'"):
        build([("a", ("in",)), ("b", ("nowhere",))])
    with pytest.raises(ValueError, match="No network outputs"):
        (NeuralNetConfiguration.Builder().graph_builder().add_inputs("in")
         .add_layer("a", DenseLayer(n_in=3, n_out=3), "in").build())
    with pytest.raises(ValueError, match="collide"):
        (NeuralNetConfiguration.Builder().graph_builder().add_inputs("a")
         .add_layer("a", DenseLayer(n_in=3, n_out=3), "a")
         .set_outputs("a").build())


_VAE_RANK = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.sharding_core import (ShardingCore,
                                                             build_mesh)
torch.set_num_threads(1)
rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
with open(d + "/conf.json") as fh:
    conf = ComputationGraphConfiguration.from_json(fh.read())
z = np.load(d + "/in.npz")
g = ComputationGraph(conf, device="cpu").init(params=z["params"])
core = ShardingCore(build_mesh(), level=3)
g._enter_plan(core)
rows = core.data_sharding()
g.pretrain_vertex("vae", [DataSet(rows.take(z["x"][i:i + 8]), None)
                          for i in range(0, 32, 8)])
np.save(d + f"/out{rank}.npy", g.params())
multihost.shutdown()
"""


def _two_rank_vertex_pretraining():
    """(each of two ranks' parameters after pretraining a VAE vertex
    under a 2-rank level-3 plan, (the initial parameters, the same
    vertex pretrained by one process on the whole batches))."""
    import socket
    import subprocess
    import sys
    import tempfile
    from pathlib import Path
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    conf = (NeuralNetConfiguration.Builder().seed(6).learning_rate(0.05)
            .updater("rmsprop").graph_builder().add_inputs("in")
            .add_layer("vae", players.VariationalAutoencoder(
                n_in=6, n_out=2, encoder_layer_sizes=(5,),
                decoder_layer_sizes=(5,), activation="leakyrelu"), "in")
            .add_layer("out", OutputLayer(n_in=2, n_out=3,
                                          activation="softmax"), "vae")
            .set_outputs("out").build())
    one = ComputationGraph(conf, device="cpu").init()
    start = one.params()
    x = np.random.RandomState(3).rand(32, 6).astype(np.float32)
    one.pretrain_vertex("vae", [DataSet(x[i:i + 8], None)
                                for i in range(0, 32, 8)])
    repo = str(Path(__file__).resolve().parent.parent)
    with tempfile.TemporaryDirectory() as d, socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
        s.close()
        with open(d + "/conf.json", "w") as fh:
            fh.write(conf.to_json())
        np.savez(d + "/in.npz", params=start, x=x)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _VAE_RANK, str(r), port, d, repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = [p.communicate(timeout=120)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), logs
        got = [np.load(d + f"/out{r}.npy") for r in range(2)]
    return got, (start, one.params())


def test_not_ported_paths_raise_and_name_the_roadmap():
    """Pretraining under a sharding plan of more than one rank is the
    pretraining of one process on the global batch: a VAE vertex
    pretrained by two gloo ranks, each on its rows of every batch, ends
    within 1e-5 of the max abs of the same vertex pretrained alone on the
    whole batches (the ranks draw their rows of the global batch's
    draws, and average the gradients). The graph has no ``shard`` (as the
    reference's: a plan is injected instead); pretraining runs (a graph
    without pretrain layers is left as it was, and a vertex that is no
    pretrain layer is skipped, as the reference's), and the fused loop
    (``fit_fused``) and the line-search solvers are ported: a graph under
    ``lbfgs`` trains its batch and lowers its score."""
    conf = zoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    net = ComputationGraph(conf, device="cpu").init()
    start = net.params()
    assert net.pretrain([]) is net
    assert net.pretrain_vertex("fc", []) is net
    np.testing.assert_array_equal(net.params(), start)
    assert net.iteration == 0
    assert not hasattr(net, "shard")
    got, want = _two_rank_vertex_pretraining()
    assert not np.array_equal(want[0], want[1])   # the vertex trained
    np.testing.assert_array_equal(got[0], got[1])   # the ranks agree
    np.testing.assert_allclose(got[0], want[1], rtol=0, atol=1e-5 * float(
        np.max(np.abs(want[1]))))
    x, y = _images(0, 2, 16, 3)
    st = StackedMultiDataSet([x[None]], [y[None]],
                             np.ones((1, 2), np.float32), 1)
    before = net.params()
    net.fit_fused(st)
    assert net.iteration == 1 and not np.array_equal(net.params(), before)
    conf.optimization_algo = "lbfgs"
    conf.iterations = 3
    net = ComputationGraph(conf, device="cpu").init()
    s0 = net.score(MultiDataSet([x], [y]), train=True)
    net.fit_batch(MultiDataSet([x], [y]))
    assert net.iteration == 3
    assert float(net.score_) < s0


# ---------------------------------------------------------------------------
# training against the JAX graph
# ---------------------------------------------------------------------------
def _mlp_graph(builder, layers):
    return (builder.seed(7).learning_rate(0.05).updater("nesterovs")
            .momentum(0.9).weight_init("xavier").regularization(True)
            .l2(1e-3).graph_builder().add_inputs("in")
            .add_layer("h1", layers.DenseLayer(n_in=6, n_out=12,
                                               activation="tanh"), "in")
            .add_layer("h2", layers.DenseLayer(n_in=12, n_out=8,
                                               activation="relu"), "h1")
            .add_layer("out", layers.OutputLayer(n_in=8, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "h2")
            .set_outputs("out").build())


def _mlp_data(seed, n=16):
    r = np.random.RandomState(seed)
    return (r.randn(n, 6).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.randint(0, 3, n)])


def test_graph_equivalent_to_an_mln_matches_jax_and_the_port_mln():
    """A chain graph trains as the JAX graph does, and bit for bit as the
    port's MultiLayerNetwork of the same layers."""
    jnet, pnet = _pair(_mlp_graph(JBuilder.Builder(), jlayers))
    mln_conf = (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.05)
                .updater("nesterovs").momentum(0.9).weight_init("xavier")
                .regularization(True).l2(1e-3).list()
                .layer(DenseLayer(n_in=6, n_out=12, activation="tanh"))
                .layer(DenseLayer(n_in=12, n_out=8, activation="relu"))
                .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss="mcxent")).build())
    mln = MultiLayerNetwork(mln_conf, device="cpu").init(params=pnet.params())
    for step in range(3):
        x, y = _mlp_data(step)
        js = float(jnet.fit_batch(JMultiDataSet([x], [y])))
        ps = float(pnet.fit_batch(DataSet(x, y)))
        ms = float(mln.fit_batch(x, y))
        assert abs(ps - js) <= REL * abs(js) and ps == ms, (step, ps, js, ms)
        _assert_graphs_close(pnet, jnet, f"step {step}")
        np.testing.assert_array_equal(pnet.params(), mln.params())
    x, y = _mlp_data(9)
    _assert_close(pnet.output(x), jnet.output(x), "output")
    assert abs(pnet.score(DataSet(x, y)) - jnet.score(JDataSet(x, y))) \
        <= REL * jnet.score(JDataSet(x, y))
    grads, score = pnet.compute_gradient_and_score(DataSet(x, y))
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(x, y))
    assert abs(score - jscore) <= REL * abs(jscore)
    _assert_close(grads, jgrads, "gradients")
    _assert_close(pnet.gradient_vector(), jnet.gradient_vector(),
                  "gradient vector")


def _multi_io_graph(builder, layers, vertices):
    """Two inputs, a merge, an element-wise add, a subset, two outputs
    (softmax/mcxent and identity/mse); adam with l1 and l2."""
    return (builder.seed(3).learning_rate(0.01).updater("adam")
            .weight_init("xavier").regularization(True).l2(1e-3).l1(1e-4)
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", layers.DenseLayer(n_in=5, n_out=8,
                                               activation="tanh"), "a")
            .add_layer("db", layers.DenseLayer(n_in=4, n_out=8,
                                               activation="sigmoid"), "b")
            .add_vertex("sum", vertices.ElementWiseVertex(op="add"),
                        "da", "db")
            .add_vertex("cat", vertices.MergeVertex(), "sum", "da")
            .add_vertex("head", vertices.SubsetVertex(from_index=2,
                                                      to_index=13), "cat")
            .add_layer("cls", layers.OutputLayer(n_in=12, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "head")
            .add_layer("reg", layers.OutputLayer(n_in=16, n_out=2,
                                                 activation="identity",
                                                 loss="mse"), "cat")
            .set_outputs("cls", "reg").build())


def _multi_io_data(seed, n=12):
    r = np.random.RandomState(seed)
    return ([r.randn(n, 5).astype(np.float32),
             r.randn(n, 4).astype(np.float32)],
            [np.eye(3, dtype=np.float32)[r.randint(0, 3, n)],
             r.randn(n, 2).astype(np.float32)])


def test_multi_input_multi_output_fit_matches_jax():
    jnet, pnet = _pair(_multi_io_graph(JBuilder.Builder(), jlayers, jgraph))
    for step in range(3):
        xs, ys = _multi_io_data(step)
        js = float(jnet.fit_batch(JMultiDataSet(xs, ys)))
        ps = float(pnet.fit_batch(MultiDataSet(xs, ys)))
        assert abs(ps - js) <= REL * abs(js), (step, ps, js)
        _assert_graphs_close(pnet, jnet, f"step {step}")
    xs, _ = _multi_io_data(9)
    for got, want in zip(pnet.output(*xs), jnet.output(*xs)):
        _assert_close(got, want, "outputs")
    acts, jacts = pnet.feed_forward(*xs), jnet.feed_forward(*xs)
    assert set(acts) == set(jacts)
    for k in jacts:
        _assert_close(acts[k], jacts[k], f"feed_forward {k}")


def _googlenet_without_dropout(**kw):
    d = json.loads(jzoo.googlenet(**kw).to_json())
    d["vertices"]["out"]["layer"]["dropout"] = 0.0
    return JGraphConf.from_dict(d)


@pytest.mark.parametrize("build", ["resnet50", "googlenet"])
def test_small_zoo_graph_forward_and_fit_match_jax(build):
    """The narrow ResNet (two stages of one block, 32x32) and GoogLeNet at
    67x67 (its smallest input: every pooling keeps a pixel): the output,
    then two steps of the port's ``fit`` against the JAX graph's
    ``fit_batch`` (its ``fit`` would compile a fused scan of the whole
    graph), with parameters, BatchNormalization's running moments and the
    nesterovs state."""
    if build == "resnet50":
        jconf = jzoo.resnet50(n_classes=5, height=32, width=32,
                              stages=(1, 1))
        size, classes, n = 32, 5, 4
    else:
        jconf = _googlenet_without_dropout(n_classes=4, height=67, width=67)
        size, classes, n = 67, 4, 2
    jnet, pnet = _pair(jconf, jax_init=build == "resnet50")
    x, y = _images(1, n, size, classes)
    _assert_close(pnet.output(x), jnet.output(x), "output")
    for step in range(2):
        x, y = _images(10 + step, n, size, classes)
        jnet.fit_batch(JMultiDataSet([x], [y]))
        pnet.fit(ListDataSetIterator([DataSet(x, y)]))
        assert abs(pnet.score_ - float(jnet.score_)) <= \
            REL * abs(float(jnet.score_))
        _assert_graphs_close(pnet, jnet, f"{build} step {step}")
    assert pnet.iteration == jnet.iteration == 2
    _assert_close(pnet.output(x), jnet.output(x), "output after fit")


def test_dropout_draws_from_the_graph_generator():
    """GoogLeNet's head keeps each input with probability 0.4 and scales
    it by 1/0.4: held by distribution (the streams cannot agree with
    JAX's), and reproducible from the graph's seed and its draw counter
    (the mask a pure function of both: the same at the same counter, new
    after the counter moves)."""
    conf = zoo.googlenet(n_classes=4, height=67, width=67)
    out = conf.vertices["out"].layer
    assert out.dropout == 0.4
    x = torch.ones(200, 1024)
    masks = []
    for _ in range(2):
        net = ComputationGraph(conf, device="cpu").init()
        keys = net._dropout_keys()
        i = net.layer_names.index("out")
        masks.append(out.apply_dropout(x, train=True, rng=keys[i]))
    np.testing.assert_array_equal(masks[0].numpy(), masks[1].numpy())
    net.set_dropout_draws(1)
    moved = out.apply_dropout(x, train=True, rng=net._dropout_keys()[i])
    assert not torch.equal(moved, masks[0])
    kept = masks[0] != 0
    assert torch.all(masks[0][kept] == 1 / 0.4)
    n = x.numel()
    # a binomial(n, 0.4) count within 5 standard deviations
    assert abs(int(kept.sum()) - 0.4 * n) <= 5 * (n * 0.4 * 0.6) ** 0.5


def _bf16_graph(builder, layers):
    return (builder.seed(5).learning_rate(0.05).updater("sgd")
            .weight_init("xavier").compute_dtype("bfloat16")
            .graph_builder().add_inputs("in")
            .add_layer("h1", layers.DenseLayer(n_in=6, n_out=16,
                                               activation="tanh"), "in")
            .add_layer("h2", layers.DenseLayer(n_in=16, n_out=16,
                                               activation="tanh"), "h1")
            .add_layer("out", layers.OutputLayer(n_in=16, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "h2")
            .set_outputs("out").build())


def test_bf16_compute_step_matches_jax_within_the_rounding_bar():
    """One bf16 step: the score and every gradient leaf within
    ``BF16_BAR`` of the JAX graph's; the masters stay f32."""
    jnet, pnet = _pair(_bf16_graph(JBuilder.Builder(), jlayers))
    x, y = _mlp_data(3, n=32)
    jscore = float(jnet.fit_batch(JMultiDataSet([x], [y])))
    score = float(pnet.fit_batch(DataSet(x, y)))
    assert abs(score - jscore) <= BF16_BAR * abs(jscore), (score, jscore)
    _assert_close(pnet.gradient(), jnet.gradient(), "bf16 gradients",
                  rel=BF16_BAR)
    assert all(v.dtype == torch.float32 for p in pnet.params_list
               for v in p.values())
    f32 = ComputationGraph(ComputationGraphConfiguration.from_json(
        pnet.conf.to_json().replace('"bfloat16"', '"float32"')),
        device="cpu").init()
    f32.params_map = _pair(_bf16_graph(JBuilder.Builder(),
                                       jlayers))[1].params_map
    f32_score = float(f32.fit_batch(DataSet(x, y)))
    # bf16 is not f32: the same step differs from the f32 one by more
    # than f32 rounding
    assert abs(score - f32_score) > 1e-6 * abs(f32_score)


def test_bf16_batchnorm_keeps_f32_moments():
    conf = zoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf, device="cpu").init()
    x, y = _images(4, 4, 16, 3)
    assert np.isfinite(float(net.fit_batch(DataSet(x, y))))
    for name, s in net.states_map.items():
        for k, v in s.items():
            assert v.dtype == torch.float32, (name, k)
            assert torch.isfinite(v).all()


def test_nan_batch_is_reverted():
    """A batch with NaN features is reverted by the guard: the run equals
    the stream without it, bit for bit, and counts one skipped step."""
    conf = _mlp_graph(NeuralNetConfiguration.Builder(), players)
    batches = [DataSet(*_mlp_data(s)) for s in range(3)]
    bad = DataSet(np.full((16, 6), np.nan, np.float32), batches[0].labels)
    runs = []
    for stream in (batches[:1] + [bad] + batches[1:], batches):
        net = ComputationGraph(conf, device="cpu").init()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            net.fit(ListDataSetIterator(stream))
        runs.append((net.params(), net.nan_skipped_steps, len(seen)))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1:] == (1, 1) and runs[1][1:] == (0, 0)


# ---------------------------------------------------------------------------
# iterators and evaluation
# ---------------------------------------------------------------------------
def test_fit_on_a_multi_dataset_iterator_matches_jax():
    jnet, pnet = _pair(_multi_io_graph(JBuilder.Builder(), jlayers, jgraph))
    xs, ys = _multi_io_data(20, n=30)
    jnet.fit(JArrayMultiIterator(xs, ys, batch_size=8), epochs=2)
    pnet.fit(ArrayMultiDataSetIterator(xs, ys, batch_size=8), epochs=2)
    assert pnet.iteration == jnet.iteration == 8
    assert pnet.epoch_count == 2
    _assert_graphs_close(pnet, jnet, "after 2 epochs")


def test_fit_on_a_dataset_iterator_and_evaluate_match_jax():
    jnet, pnet = _pair(_mlp_graph(JBuilder.Builder(), jlayers))
    data = [_mlp_data(30 + i) for i in range(4)]
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in data]))
    pnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    _assert_graphs_close(pnet, jnet, "after fit")
    # both graphs fuse the four batches into one group, as the reference
    assert pnet._last_fuse_stats == jnet._last_fuse_stats
    assert pnet._last_fuse_stats["fused_groups"] == 1
    ev = pnet.evaluate(ListDataSetIterator([DataSet(x, y) for x, y in data]))
    jev = jnet.evaluate(JListIterator([JDataSet(x, y) for x, y in data]))
    assert ev.accuracy() == jev.accuracy()
    for a in range(3):
        for p in range(3):
            assert ev.confusion.get_count(a, p) == \
                jev.confusion.get_count(a, p)


# ---------------------------------------------------------------------------
# recurrent graphs (the counterparts of tests/test_cg_rnn.py)
# ---------------------------------------------------------------------------
def _seq_data(b=4, t=12, n_in=3, n_out=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, t, n_in).astype(np.float32)
    y = (x.sum(axis=2) > n_in / 2).astype(int)
    return x, np.eye(n_out, dtype=np.float32)[y]


def _chain_rnn(builder, layers, tbptt=True, hidden=8):
    gb = (builder.seed(0).learning_rate(0.05).updater("adam")
          .graph_builder().add_inputs("in")
          .add_layer("lstm", layers.GravesLSTM(n_in=3, n_out=hidden,
                                               activation="tanh"), "in")
          .add_layer("out", layers.RnnOutputLayer(
              n_in=hidden, n_out=2, activation="softmax", loss="mcxent"),
              "lstm")
          .set_outputs("out"))
    if tbptt:
        gb.backprop_type("tbptt").tbptt_fwd_length(4).tbptt_back_length(4)
    return gb.build()


def test_tbptt_graph_matches_jax_and_the_port_mln():
    jnet, pnet = _pair(_chain_rnn(JBuilder.Builder(), jlayers))
    mln_conf = (NeuralNetConfiguration.Builder().seed(0).learning_rate(0.05)
                .updater("adam").list()
                .layer(players.GravesLSTM(n_in=3, n_out=8, activation="tanh"))
                .layer(players.RnnOutputLayer(n_in=8, n_out=2,
                                              activation="softmax",
                                              loss="mcxent"))
                .backprop_type("tbptt").tbptt_fwd_length(4)
                .tbptt_back_length(4).build())
    mln = MultiLayerNetwork(mln_conf, device="cpu").init(params=pnet.params())
    for step in range(2):
        x, y = _seq_data(seed=step)
        jnet.fit_batch(JMultiDataSet([x], [y]))
        pnet.fit_batch(MultiDataSet([x], [y]))
        mln.fit_batch(x, y)
        _assert_graphs_close(pnet, jnet, f"tbptt step {step}")
        np.testing.assert_array_equal(pnet.params(), mln.params())
    assert pnet.iteration == jnet.iteration == 6     # 3 windows a batch


def test_rnn_time_step_matches_jax_and_output():
    jnet, pnet = _pair(_chain_rnn(JBuilder.Builder(), jlayers, tbptt=False))
    x, _ = _seq_data(t=6, seed=4)
    full = pnet.output(x)
    _assert_close(full, jnet.output(x), "output")
    steps = [pnet.rnn_time_step(x[:, t]) for t in range(3)]
    chunk = pnet.rnn_time_step(x[:, 3:])
    jsteps = [jnet.rnn_time_step(x[:, t]) for t in range(3)]
    jchunk = jnet.rnn_time_step(x[:, 3:])
    got = np.concatenate([np.stack(steps, axis=1), chunk], axis=1)
    want = np.concatenate([np.stack(jsteps, axis=1), jchunk], axis=1)
    _assert_close(got, want, "rnn_time_step")
    _assert_close(got, full, "rnn_time_step against output")
    pnet.rnn_clear_previous_state()
    _assert_close(pnet.rnn_time_step(x[:, 0]), steps[0], "after clear")


def test_dag_char_rnn_with_a_skip_connection_matches_jax():

    def build(builder, layers, vertices):
        return (builder.seed(0).learning_rate(0.1).updater("nesterovs")
                .momentum(0.9).graph_builder().add_inputs("in")
                .add_layer("l1", layers.GravesLSTM(n_in=12, n_out=16,
                                                   activation="tanh"), "in")
                .add_layer("l2", layers.GravesLSTM(n_in=16, n_out=16,
                                                   activation="tanh"), "l1")
                .add_vertex("skip", vertices.MergeVertex(), "l1", "l2")
                .add_layer("out", layers.RnnOutputLayer(
                    n_in=32, n_out=12, activation="softmax",
                    loss="mcxent"), "skip")
                .set_outputs("out").backprop_type("tbptt")
                .tbptt_fwd_length(4).tbptt_back_length(4).build())
    jconf = build(JBuilder.Builder(), jlayers, jgraph)
    assert build(NeuralNetConfiguration.Builder(), players,
                 pgraph).to_json() == jconf.to_json()
    jnet, pnet = _pair(jconf)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 12, (6, 12))
    x = np.eye(12, dtype=np.float32)[ids]
    y = np.eye(12, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    for step in range(2):
        js = float(jnet.fit_batch(JMultiDataSet([x], [y])))
        ps = float(pnet.fit_batch(MultiDataSet([x], [y])))
        assert abs(ps - js) <= REL * abs(js)
        _assert_graphs_close(pnet, jnet, f"dag char-rnn step {step}")
    got = pnet.rnn_time_step(x[:, 0])
    _assert_close(got, jnet.rnn_time_step(x[:, 0]), "stateful step")
    assert got.shape == (6, 12)


def test_static_input_and_named_vertex_inputs_match_jax():
    """Mixed inputs under tBPTT (a rank-2 static input goes whole to every
    window, duplicated along time by a DuplicateToTimeSeriesVertex that
    names the sequence input), then a LastTimeStepVertex under the
    sequence input's mask, against the JAX graph."""

    def build(builder, layers, vertices, tbptt):
        gb = (builder.seed(0).learning_rate(0.05).updater("adam")
              .graph_builder().add_inputs("seq", "stat")
              .add_vertex("dup", vertices.DuplicateToTimeSeriesVertex("seq"),
                          "stat")
              .add_vertex("merged", vertices.MergeVertex(), "seq", "dup")
              .add_layer("lstm", layers.GravesLSTM(n_in=8, n_out=6,
                                                   activation="tanh"),
                         "merged"))
        if tbptt:
            gb.add_layer("out", layers.RnnOutputLayer(
                n_in=6, n_out=2, activation="softmax", loss="mcxent"),
                "lstm").backprop_type("tbptt").tbptt_fwd_length(4) \
                .tbptt_back_length(4)
        else:
            gb.add_vertex("last", vertices.LastTimeStepVertex("seq"), "lstm")
            gb.add_layer("out", layers.OutputLayer(
                n_in=6, n_out=2, activation="softmax", loss="mcxent"),
                "last")
        return gb.set_outputs("out").build()
    rng = np.random.RandomState(0)
    seq = rng.rand(4, 8, 3).astype(np.float32)
    stat = rng.rand(4, 5).astype(np.float32)
    lab = (seq.sum(axis=2) + stat.sum(axis=1, keepdims=True) > 4).astype(int)
    for tbptt in (True, False):
        jconf = build(JBuilder.Builder(), jlayers, jgraph, tbptt)
        assert build(NeuralNetConfiguration.Builder(), players, pgraph,
                     tbptt).to_json() == jconf.to_json()
        jnet, pnet = _pair(jconf)
        if tbptt:
            y, fm = np.eye(2, dtype=np.float32)[lab], None
        else:
            y = np.eye(2, dtype=np.float32)[lab[:, -1]]
            fm = [np.ones((4, 8), np.float32), None]
            fm[0][1, 5:] = 0.0
            fm[0][3, 2:] = 0.0
        for step in range(2):
            jnet.fit_batch(JMultiDataSet([seq, stat], [y], fm))
            pnet.fit_batch(MultiDataSet([seq, stat], [y], fm))
            _assert_graphs_close(pnet, jnet, f"tbptt={tbptt} step {step}")
        _assert_close(pnet.output(seq, stat, fmasks=fm),
                      jnet.output(seq, stat, fmasks=fm), "output")


def test_masked_steps_do_not_move_the_score_as_in_jax():
    jnet, pnet = _pair(_chain_rnn(JBuilder.Builder(), jlayers, tbptt=False))
    x, y = _seq_data(b=6, t=8, seed=5)
    mask = np.ones((6, 8), np.float32)
    mask[:, 5:] = 0.0
    x2, y2 = x.copy(), y.copy()
    x2[:, 5:], y2[:, 5:] = 42.0, 0.0
    s1 = pnet.score(MultiDataSet([x], [y], [mask], [mask]))
    s2 = pnet.score(MultiDataSet([x2], [y2], [mask], [mask]))
    js = jnet.score(JMultiDataSet([x], [y], [mask], [mask]))
    assert abs(s1 - s2) <= REL * abs(s1) and abs(s1 - js) <= REL * abs(js)


def test_updater_state_carries_across_from_jax():
    """A JAX graph's parameters and adam state carried into the port
    continue its run."""
    jnet, pnet = _pair(_multi_io_graph(JBuilder.Builder(), jlayers, jgraph))
    xs, ys = _multi_io_data(40)
    jnet.fit_batch(JMultiDataSet(xs, ys))
    pnet.params_map = params_from_numpy(pnet.conf, _np_tree(jnet.params_map),
                                        "cpu")
    pnet.updater_states_map = updater_state_from_numpy(
        pnet.conf, _np_tree(jnet.updater_states), "cpu")
    pnet.iteration = jnet.iteration
    xs, ys = _multi_io_data(41)
    jnet.fit_batch(JMultiDataSet(xs, ys))
    pnet.fit_batch(MultiDataSet(xs, ys))
    _assert_graphs_close(pnet, jnet, "continued")


def test_remat_gives_the_same_step():
    conf = zoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    x, y = _images(6, 4, 16, 3)
    params = []
    for remat in (False, True):
        conf.remat = remat
        net = ComputationGraph(conf, device="cpu").init()
        net.fit_batch(DataSet(x, y))
        params.append(net.params())
    np.testing.assert_array_equal(params[0], params[1])
    conf.remat = False


def test_summary_and_clone():
    net = ComputationGraph(_mlp_graph(NeuralNetConfiguration.Builder(),
                                      players), device="cpu").init()
    assert net.summary().splitlines()[-1] == \
        f"total params: {net.num_params()}"
    twin = net.clone()
    x, y = _mlp_data(1)
    net.fit_batch(DataSet(x, y))
    twin.fit_batch(DataSet(x, y))
    np.testing.assert_array_equal(net.params(), twin.params())
    assert net.get_layer_params("h1")["W"].shape == (6, 12)
    assert isinstance(net.conf.vertices["out"].layer, OutputLayer)
