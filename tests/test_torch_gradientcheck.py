"""The port's gradient checker (``gradientcheck/gradient_check_util.py``)
against the JAX package's, on the cases of ``tests/test_gradients.py``.

Each net is built from the reference's configuration JSON and takes the
JAX net's initial parameters. The port's check must pass where the
reference's does (max relative error 1e-4, as there), and its analytic
float64 gradient must equal JAX's to 1e-10 of its scale, on the whole
flat vector (so on any subset the two checks draw). A layer whose
backward is patched to be 10% off must fail the check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JB
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers.pretrain import (
    VariationalAutoencoder as JVAE)
from deeplearning4j_tpu.utils import enable_x64
from deeplearning4j_tpu.utils import flat_params as jflat
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.gradientcheck import gradient_check_util as gc
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph, params_from_numpy as cg_params)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.ops import activations as pact

MAX_REL = 1e-4


def _mlp(act="tanh", loss="mcxent", out_act="softmax", n_in=4, n_out=3,
         reg=False):
    b = JB.Builder().seed(42)
    if reg:
        b = b.regularization(True).l2(0.1).l1(0.05)
    return (b.list().layer(jl.DenseLayer(n_in=n_in, n_out=5, activation=act))
            .layer(jl.OutputLayer(n_out=n_out, activation=out_act,
                                  loss=loss)).build())


def _loss_labels(loss, r, shape):
    if loss == "xent":
        return (r.rand(*shape) > 0.5).astype(float)
    if loss == "mcxent":
        return np.eye(shape[1])[r.randint(0, shape[1], shape[0])]
    if loss == "squared_hinge":
        return 2.0 * (r.rand(*shape) > 0.5) - 1.0
    if loss == "poisson":
        return r.poisson(2.0, shape).astype(float)
    return r.randn(*shape)


def _case_activation(act):
    r = np.random.RandomState(12345)
    return _mlp(act), r.randn(6, 4), np.eye(3)[r.randint(0, 3, 6)], {}


def _case_loss(loss, out_act):
    r = np.random.RandomState(7)
    x = r.randn(5, 3)
    return (_mlp("tanh", loss, out_act, n_in=3, n_out=4), x,
            _loss_labels(loss, r, (5, 4)), {})


def _case_regularized():
    r = np.random.RandomState(3)
    return (_mlp(n_in=3, n_out=2, reg=True), r.randn(5, 3),
            np.eye(2)[r.randint(0, 2, 5)], {})


def _case_cnn():
    r = np.random.RandomState(0)
    conf = (JB.Builder().seed(42).list()
            .layer(jl.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                       activation="tanh"))
            .layer(jl.SubsamplingLayer(pooling_type="avg",
                                       kernel_size=(2, 2), stride=(2, 2)))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    return conf, r.randn(4, 6, 6, 2), np.eye(2)[r.randint(0, 2, 4)], {}


def _case_pool(pool):
    r = np.random.RandomState(0)
    conf = (JB.Builder().seed(42).list()
            .layer(jl.SubsamplingLayer(pooling_type=pool, kernel_size=(2, 2),
                                       stride=(2, 2)))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.convolutional(4, 4, 2)).build())
    return conf, r.randn(3, 4, 4, 2), np.eye(2)[r.randint(0, 2, 3)], {}


def _case_bn():
    r = np.random.RandomState(0)
    conf = (JB.Builder().seed(42).list()
            .layer(jl.DenseLayer(n_in=4, n_out=5, activation="identity"))
            .layer(jl.BatchNormalization())
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")).build())
    return conf, r.randn(8, 4), np.eye(2)[r.randint(0, 2, 8)], {}


def _case_vae():
    r = np.random.RandomState(1)
    conf = (JB.Builder().seed(42).list()
            .layer(JVAE(n_in=4, n_out=3, encoder_layer_sizes=(5,),
                        decoder_layer_sizes=(5,), activation="tanh"))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")).build())
    return conf, r.randn(5, 4), np.eye(2)[r.randint(0, 2, 5)], {}


def _case_lstm(kind):
    r = np.random.RandomState(0)
    layer = jl.GravesBidirectionalLSTM if kind == "bidirectional" \
        else jl.GravesLSTM
    n_in, t = (2, 3) if kind == "bidirectional" else (3, 4)
    b = 2 if kind == "bidirectional" else 3
    if kind == "masked":
        n_in, t = 2, 5
    conf = (JB.Builder().seed(42).list()
            .layer(layer(n_in=n_in, n_out=3, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent")).build())
    x = r.randn(b, t, n_in)
    y = np.eye(2)[r.randint(0, 2, (b, t))]
    kw = {}
    if kind == "masked":
        mask = np.ones((b, t))
        mask[0, 3:] = 0
        mask[2, 4:] = 0
        # masked steps' gradients ~1e-5 meet central-difference noise
        kw = dict(fmask=mask, lmask=mask, min_abs_error=1e-7)
    return conf, x, y, kw


def _case_global_pool():
    r = np.random.RandomState(0)
    conf = (JB.Builder().seed(42).list()
            .layer(jl.GravesLSTM(n_in=2, n_out=3, activation="tanh"))
            .layer(jl.GlobalPoolingLayer(pooling_type="avg"))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")).build())
    return conf, r.randn(3, 4, 2), np.eye(2)[r.randint(0, 2, 3)], {}


CASES = {
    **{f"mlp_{a}": (_case_activation, (a,))
       for a in ("tanh", "sigmoid", "relu", "elu", "softplus")},
    **{f"loss_{l}_{a}": (_case_loss, (l, a)) for l, a in (
        ("mse", "identity"), ("mse", "tanh"), ("l1", "identity"),
        ("xent", "sigmoid"), ("mcxent", "softmax"),
        ("squared_hinge", "identity"), ("poisson", "softplus"),
        ("cosine_proximity", "identity"))},
    "l1_l2": (_case_regularized, ()),
    "conv_pool_dense": (_case_cnn, ()),
    **{f"pool_{p}": (_case_pool, (p,)) for p in ("max", "avg", "sum",
                                                 "pnorm")},
    "batchnorm": (_case_bn, ()),
    "vae_supervised": (_case_vae, ()),
    **{f"lstm_{k}": (_case_lstm, (k,)) for k in ("graves", "bidirectional",
                                                  "masked")},
    "lstm_global_pool": (_case_global_pool, ()),
}


def _jax_grad(jnet, x, y, fmask, lmask):
    """The reference's analytic float64 gradient (the body of its
    ``check_gradients``)."""
    with enable_x64(True):
        p64 = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
               for p in jnet.params_list]
        s64 = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), s)
               for s in jnet.states_list]
        fm = None if fmask is None else jnp.asarray(fmask, jnp.float64)
        lm = None if lmask is None else jnp.asarray(lmask, jnp.float64)

        def loss(vec):
            pl = jflat.vector_to_params(jnet.layers, vec)
            return jnet._loss_fn(pl, s64, jnp.asarray(x, jnp.float64),
                                 jnp.asarray(y, jnp.float64), fm, lm, None,
                                 train=False)[0]
        return np.asarray(jax.grad(loss)(
            jflat.params_to_vector(jnet.layers, p64)))


def _nets(conf):
    jnet = JNet(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [{k: np.asarray(v) for k, v in p.items()}
                      for p in jnet.params_list], "cpu")
    return jnet, pnet


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_passes_and_gradient_equals_jax(name):
    make, args = CASES[name]
    conf, x, y, kw = make(*args)
    jnet, pnet = _nets(conf)
    # the recurrent nets' numeric half on 40 drawn parameters (the
    # reference's ``subset``): their step-by-step CPU twin makes each
    # evaluation slow; the analytic gradient below is held whole
    subset = 40 if name.startswith("lstm") else None
    ok, max_rel, failures = gc.check_gradients(pnet, x, y,
                                               max_rel_error=MAX_REL,
                                               subset=subset, **kw)
    assert ok, (name, max_rel, failures)
    fmask, lmask = kw.get("fmask"), kw.get("lmask")
    fn, vec0 = gc._mln_loss(pnet, x, y, fmask, lmask)
    assert vec0.dtype == torch.float64
    got = gc.analytic_gradient(fn, vec0)
    want = _jax_grad(jnet, x, y, fmask, lmask)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= 1e-10 * scale, \
        (name, np.abs(got - want).max(), scale)


def _graph_conf():
    return (JB.Builder().seed(3).graph_builder().add_inputs("a", "b")
            .add_layer("da", jl.DenseLayer(n_in=3, n_out=4,
                                           activation="tanh"), "a")
            .add_layer("db", jl.DenseLayer(n_in=2, n_out=4,
                                           activation="sigmoid"), "b")
            .add_vertex("merge", JMerge(), "da", "db")
            .add_layer("out", jl.OutputLayer(n_in=8, n_out=2,
                                             activation="softmax",
                                             loss="mcxent"), "merge")
            .set_outputs("out").build())


def test_graph_check_passes_and_gradient_equals_jax():
    conf = _graph_conf()
    jg = JGraph(conf).init()
    pg = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pg.params_map = cg_params(pg.conf, {
        n: {k: np.asarray(v) for k, v in p.items()}
        for n, p in jg.params_map.items()}, "cpu")
    r = np.random.RandomState(4)
    xa, xb = r.randn(5, 3), r.randn(5, 2)
    y = np.eye(2)[r.randint(0, 2, 5)]
    mds = MultiDataSet([xa, xb], [y])
    ok, max_rel, failures = gc.check_gradients_graph(
        pg, mds, max_rel_error=MAX_REL, subset=30, seed=1)
    assert ok, (max_rel, failures)
    got = gc.analytic_gradient(*gc._graph_loss(pg, mds))
    jm = JMultiDataSet([xa, xb], [y])
    with enable_x64(True):
        names = jg.layer_names
        p64 = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            jg.params_map[n]) for n in names]
        s64 = {n: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), s)
               for n, s in jg.states_map.items()}

        def loss(vec):
            pm = dict(zip(names, jflat.vector_to_params(jg.layers, vec)))
            return jg._loss_fn(pm, s64, [jnp.asarray(f, jnp.float64)
                                         for f in jm.features],
                               [jnp.asarray(l, jnp.float64)
                                for l in jm.labels], None, None, None,
                               train=False)[0]
        want = np.asarray(jax.grad(loss)(jflat.params_to_vector(jg.layers,
                                                                p64)))
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


class _OffTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1 - y * y) * 1.1     # 10% off


def test_a_wrong_gradient_is_caught(monkeypatch):
    conf, x, y, _ = _case_activation("tanh")
    _, pnet = _nets(conf)
    assert gc.check_gradients(pnet, x, y, max_rel_error=MAX_REL)[0]
    monkeypatch.setitem(pact._REGISTRY, "tanh", _OffTanh.apply)
    ok, max_rel, failures = gc.check_gradients(pnet, x, y,
                                               max_rel_error=MAX_REL)
    assert not ok and failures > 0 and max_rel > 0.01, (max_rel, failures)


def test_subset_draws_the_references_indices(monkeypatch):
    """``subset`` checks RandomState(seed).choice(n, subset) indices,
    the reference's; only they are perturbed."""
    conf, x, y, _ = _case_activation("relu")
    _, pnet = _nets(conf)
    seen = []
    real = gc._central_difference

    def spy(fn, vec0, **kw):
        def counting(vec):
            d = torch.nonzero(vec != vec0).flatten().tolist()
            seen.extend(d)
            return fn(vec)
        return real(counting, vec0, **kw)
    monkeypatch.setattr(gc, "_central_difference", spy)
    gc.check_gradients(pnet, x, y, subset=7, seed=5)
    n = pnet.num_params()
    want = np.random.RandomState(5).choice(n, 7, replace=False)
    assert sorted(set(seen)) == sorted(int(i) for i in want)
