"""The port's pretrain layers and layer-wise pretraining against the JAX
package's (``nn/layers/pretrain.py``, ``MultiLayerNetwork.pretrain_layer``,
``ComputationGraph.pretrain_vertex``).

JAX's threefry draws and torch's Philox cannot agree, so every draw is
crossed over: the reference runs with ``jax.random.bernoulli`` and
``jax.random.normal`` wrapped to record what they return (through an
ordered ``jax.debug.callback``, so from inside its jitted pretrain steps
too), and the port's ``_uniform``/``_normal`` seam (``nn/layers/
pretrain.py``) hands the same draws back in the same order: a recorded
Bernoulli mask ``m`` as uniforms ``where(m, 0, 1)`` (so ``u < p`` is
``m``), a recorded normal as itself. Parameters are copied across, never
drawn twice.

Tolerances, with their reasons:
- a layer's loss and gradients: 1e-5 of each value's scale in f32 and
  1e-10 in float64 (the same formulas; summation order only);
- training (pretrain steps, then backprop): parameters within 1e-5 of each
  leaf's max abs after the compared steps;
- the graph vertex against the MultiLayerNetwork's layer: 1e-6.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (
    DataSet as JDataSet, ListDataSetIterator as JListIterator)
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import pretrain as jpre
from deeplearning4j_tpu.utils import enable_x64
from deeplearning4j_tpu.utils import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator,
                                                       MultiDataSet)
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph, params_from_numpy as cg_params_from_numpy)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers import base as pbase
from deeplearning4j_tpu_torch.nn.layers import pretrain as ppre
from deeplearning4j_tpu_torch.utils import model_serializer

N_IN, BATCH = 12, 6

COMPOSITE = [{"dist": "gaussian", "size": 4, "activation": "tanh"},
             {"dist": "bernoulli", "size": 5},
             {"dist": {"loss": "mse", "activation": "identity"}, "size": 3}]
DISTRIBUTIONS = {
    "bernoulli": "bernoulli",
    "gaussian": "gaussian",
    "exponential": "exponential",
    "composite": COMPOSITE,
    "loss_wrapper": {"loss": "mse", "activation": "sigmoid"},
}


# ---------------------------------------------------------------------------
# the draws, crossed over
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recorded_jax_draws(log):
    """Record every Bernoulli mask and normal the reference draws, in
    order, eagerly or from inside its jitted steps (an ordered debug
    callback); ``jax.effects_barrier()`` on exit."""
    real_b, real_n = jax.random.bernoulli, jax.random.normal

    def record(kind, out):
        jax.debug.callback(lambda v: log.append((kind, np.asarray(v))), out,
                           ordered=True)
        return out

    def bern(key, p=0.5, shape=None):
        return record("mask", real_b(key, p, shape))

    def norm(key, shape=(), dtype=float):
        return record("normal", real_n(key, shape, dtype))
    jax.random.bernoulli, jax.random.normal = bern, norm
    try:
        yield log
        jax.effects_barrier()
    finally:
        jax.random.bernoulli, jax.random.normal = real_b, real_n


@pytest.fixture
def inject(monkeypatch):
    """``inject(log)``: the port's draws become the recorded ones, in
    order; ``log`` must be used up by the end of the test."""
    logs = []

    def arm(log):
        queue = list(log)
        logs.append(queue)

        def take(kind, shape, like):
            assert queue, "the port drew more than the reference"
            got_kind, arr = queue.pop(0)
            assert got_kind == kind and tuple(arr.shape) == tuple(shape), \
                (kind, got_kind, arr.shape, shape)
            if kind == "mask":
                arr = np.where(arr, 0.0, 1.0)
            return torch.as_tensor(np.array(arr), dtype=like.dtype,
                                   device=like.device)
        monkeypatch.setattr(ppre, "_uniform",
                            lambda g, shape, like: take("mask", shape, like))
        monkeypatch.setattr(ppre, "_normal",
                            lambda g, shape, like: take("normal", shape,
                                                        like))
    yield arm
    for q in logs:
        assert not q, f"{len(q)} recorded draws left unused"


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _dtypes(name):
    return (jnp.float64, torch.float64, 1e-10) if name == "float64" \
        else (jnp.float32, torch.float32, 1e-5)


def _pair(jlayer):
    """The JAX layer with the reference's defaults and its port twin from
    the same dict."""
    jlayer.apply_global_defaults({})
    return jlayer, pbase.layer_from_dict(jlayer.to_dict())


def _params(jlayer, jdt, tdt, seed=0):
    """The JAX layer's initial parameters (non-zero biases: a bias
    gradient must show) as (jax dict, torch dict)."""
    r = np.random.RandomState(seed)
    shapes = jlayer.param_shapes()
    npp = {k: (r.randn(*s) * (0.4 if len(s) > 1 else 0.1))
           for k, s in shapes.items()}
    return ({k: jnp.asarray(v, jdt) for k, v in npp.items()},
            {k: torch.tensor(v, dtype=tdt) for k, v in npp.items()})


def _x(jdt, tdt, n_in=N_IN, binary=True, seed=1):
    r = np.random.RandomState(seed)
    x = r.rand(BATCH, n_in)
    if binary:
        x = (x > 0.5).astype(np.float64)
    return jnp.asarray(x, jdt), torch.tensor(x, dtype=tdt)


def _layer_grads(jlayer, player, jp, pp, jx, px, inject):
    log = []
    with recorded_jax_draws(log):
        jg, js = jlayer.pretrain_grads(jp, jx, jax.random.PRNGKey(3))
    inject(log)
    pg, ps = player.pretrain_grads(pp, px, torch.Generator())
    return jg, js, pg, ps


def _check_grads(jg, js, pg, ps, rtol):
    _close(ps, js, rtol, "score")
    assert set(pg) == set(jg)
    for k in jg:
        _close(pg[k], jg[k], rtol, k)


# ---------------------------------------------------------------------------
# each layer's loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_loss_and_grads(dtype, loss, inject):
    jdt, tdt, rtol = _dtypes(dtype)
    with enable_x64(dtype == "float64"):
        jl, pl = _pair(jpre.AutoEncoder(n_in=N_IN, n_out=5,
                                        corruption_level=0.3, loss=loss))
        jp, pp = _params(jl, jdt, tdt)
        jx, px = _x(jdt, tdt)
        jg, js, pg, ps = _layer_grads(jl, pl, jp, pp, jx, px, inject)
        _check_grads(jg, js, pg, ps, rtol)
        # no generator: no corruption, as the reference's rng=None
        _close(pl.pretrain_loss(pp, px, None),
               jl.pretrain_loss(jp, jx, None), rtol, "uncorrupted")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("units", [("binary", "binary"),
                                   ("gaussian", "binary"),
                                   ("binary", "gaussian")])
def test_rbm_cd_k_grads_and_reconstruction_error(dtype, k, units, inject):
    jdt, tdt, rtol = _dtypes(dtype)
    with enable_x64(dtype == "float64"):
        jl, pl = _pair(jpre.RBM(n_in=N_IN, n_out=7, k=k,
                                visible_unit=units[0],
                                hidden_unit=units[1]))
        jp, pp = _params(jl, jdt, tdt)
        jx, px = _x(jdt, tdt, binary=units[0] == "binary")
        jg, js, pg, ps = _layer_grads(jl, pl, jp, pp, jx, px, inject)
        _check_grads(jg, js, pg, ps, rtol)
        out, _ = pl.forward(pp, px, {})
        _close(out, jl.forward(jp, jx, {})[0], rtol, "propUp")


def _vae(dist, num_samples=1):
    return jpre.VariationalAutoencoder(
        n_in=N_IN, n_out=3, encoder_layer_sizes=(9, 8),
        decoder_layer_sizes=(8,), activation="leakyrelu",
        pzx_activation="identity", reconstruction_distribution=dist,
        num_samples=num_samples)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num_samples", [1, 3])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_vae_elbo_and_grads(dtype, num_samples, dist, inject):
    jdt, tdt, rtol = _dtypes(dtype)
    with enable_x64(dtype == "float64"):
        jl, pl = _pair(_vae(DISTRIBUTIONS[dist], num_samples))
        assert pl.param_shapes() == jl.param_shapes()
        assert pl.param_order == sorted(jl.param_shapes())
        jp, pp = _params(jl, jdt, tdt)
        # exponential and gaussian data are positive reals, not bits
        jx, px = _x(jdt, tdt, binary=dist in ("bernoulli", "composite"))
        jg, js, pg, ps = _layer_grads(jl, pl, jp, pp, jx, px, inject)
        _check_grads(jg, js, pg, ps, rtol)


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_vae_other_outputs(dist, inject):
    jl, pl = _pair(_vae(DISTRIBUTIONS[dist], 2))
    jp, pp = _params(jl, jnp.float32, torch.float32, seed=4)
    jx, px = _x(jnp.float32, torch.float32)
    out, _ = pl.forward(pp, px, {})
    _close(out, jl.forward(jp, jx, {})[0], 1e-5, "latent mean")
    z = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    _close(pl.generate_at_mean_given_z(pp, torch.tensor(z)),
           jl.generate_at_mean_given_z(jp, z), 1e-5, "generate")
    if pl.has_loss_function():
        assert jl.has_loss_function()
        _close(pl.reconstruction_error(pp, px),
               jl.reconstruction_error(jp, jx), 1e-5, "reconstruction error")
        with pytest.raises(ValueError, match="undefined"):
            pl.reconstruction_log_probability(pp, px)
        return
    with pytest.raises(ValueError, match="loss-function"):
        pl.reconstruction_error(pp, px)
    _close(pl.reconstruction_log_probability(pp, px),
           jl.reconstruction_log_probability(jp, jx), 1e-5, "log p(x), mean")
    log = []
    with recorded_jax_draws(log):
        want = jl.reconstruction_log_probability(
            jp, jx, rng=jax.random.PRNGKey(8), num_samples=4)
    inject(log)
    _close(pl.reconstruction_log_probability(pp, px, torch.Generator(),
                                             num_samples=4),
           want, 1e-5, "log p(x), sampled")


def test_composite_sizes_must_cover_the_input():
    bad = [{"dist": "bernoulli", "size": 5}]
    layer = ppre.VariationalAutoencoder(n_in=N_IN, n_out=2,
                                        reconstruction_distribution=bad)
    with pytest.raises(ValueError, match="sum to 5"):
        layer.param_shapes()


# ---------------------------------------------------------------------------
# networks: pretrain_layer, fit() with conf.pretrain, pretrain_vertex
# ---------------------------------------------------------------------------
def _mln_conf(builder, ae, rbm, out, pretrain=False):
    return (builder.seed(11).learning_rate(0.05).updater("rmsprop")
            .list()
            .layer(ae(n_in=N_IN, n_out=8, activation="sigmoid",
                      corruption_level=0.25))
            .layer(rbm(n_out=6, activation="sigmoid", k=2))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .pretrain(pretrain).build())


def _mln_pair(pretrain=False):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (RBM, AutoEncoder,
                                                    OutputLayer)
    jconf = _mln_conf(JBuilder.Builder(), jpre.AutoEncoder, jpre.RBM, JOut,
                      pretrain)
    pconf = _mln_conf(NeuralNetConfiguration.Builder(), AutoEncoder, RBM,
                      OutputLayer, pretrain)
    assert pconf.to_json() == jconf.to_json()
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [{k: np.asarray(v) for k, v in p.items()}
                      for p in jnet.params_list], "cpu")
    return jnet, pnet


def _batches(n, seed=0, rows=BATCH):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (r.rand(rows, N_IN) > 0.5).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[r.randint(0, 3, rows)]
        out.append((x, y))
    return out


def _same_params(pnet, jnet, rtol=1e-5):
    for i, (pp, jp) in enumerate(zip(pnet.params_list, jnet.params_list)):
        for k in jp:
            _close(pp[k], jp[k], rtol, f"layer {i} {k}")


def test_pretrain_layer_steps_match_jax(inject):
    jnet, pnet = _mln_pair()
    data = _batches(3)
    log = []
    with recorded_jax_draws(log):
        for i in (0, 1):
            jnet.pretrain_layer(i, JListIterator(
                [JDataSet(x, None) for x, _ in data]))
    inject(log)
    for i in (0, 1):
        before = [{k: v.clone() for k, v in p.items()}
                  for p in pnet.params_list]
        pnet.pretrain_layer(i, ListDataSetIterator(
            [DataSet(x, None) for x, _ in data]))
        # only layer i moves
        for j, (b, p) in enumerate(zip(before, pnet.params_list)):
            moved = any(not torch.equal(b[k], p[k]) for k in p)
            assert moved == (j == i), (i, j)
    assert pnet.iteration == jnet.iteration == 6
    assert isinstance(pnet._score, torch.Tensor)   # no host read
    _same_params(pnet, jnet)
    _close(pnet.score_, jnet.score_, 1e-5, "score")
    for pu, ju in zip(pnet.updater_states[:2], jnet.updater_states[:2]):
        for k in ju["r"]:
            _close(pu["r"][k], ju["r"][k], 1e-5, f"rmsprop {k}")


def test_fit_with_pretrain_pretrains_once_then_backprops(inject):
    jnet, pnet = _mln_pair(pretrain=True)
    (x, y), (x2, y2) = _batches(2, seed=3)
    log = []
    with recorded_jax_draws(log):
        jnet.fit(JDataSet(x, y))
        n_draws = len(log)
        jnet.fit(JDataSet(x2, y2))
    assert len(log) == n_draws == 1 + 5    # AE mask; RBM h0, (v, h) x 2
    inject(log)
    pnet.fit(DataSet(x, y))
    assert pnet._pretrained and pnet.iteration == jnet.iteration - 1
    pnet.fit(DataSet(x2, y2))
    assert pnet.iteration == jnet.iteration == 4
    _same_params(pnet, jnet)


def _graph_conf(builder, dense, vae, out, pretrain=False):
    return (builder.seed(5).learning_rate(0.02).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("dense", dense(n_in=N_IN, n_out=10,
                                      activation="tanh"), "in")
            .add_layer("vae", vae(n_in=10, n_out=3, encoder_layer_sizes=(7,),
                                  decoder_layer_sizes=(6,),
                                  activation="leakyrelu", num_samples=2),
                       "dense")
            .add_layer("out", out(n_in=3, n_out=3, activation="softmax",
                                  loss="mcxent"), "vae")
            .set_outputs("out").pretrain(pretrain).build())


def _graph_pair(pretrain=False):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, OutputLayer,
                                                    VariationalAutoencoder)
    jconf = _graph_conf(JBuilder.Builder(), JDense,
                        jpre.VariationalAutoencoder, JOut, pretrain)
    pconf = _graph_conf(NeuralNetConfiguration.Builder(), DenseLayer,
                        VariationalAutoencoder, OutputLayer, pretrain)
    assert pconf.to_json() == jconf.to_json()
    jg = JGraph(jconf).init()
    pg = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pg.params_map = cg_params_from_numpy(
        pg.conf, {n: {k: np.asarray(v) for k, v in p.items()}
                  for n, p in jg.params_map.items()}, "cpu")
    return jg, pg


@pytest.mark.parametrize("pretrain_by", ["pretrain_vertex", "fit"])
def test_graph_pretrain_vertex_matches_jax(pretrain_by, inject):
    jg, pg = _graph_pair(pretrain=pretrain_by == "fit")
    data = _batches(3, seed=7)
    log = []
    with recorded_jax_draws(log):
        if pretrain_by == "fit":
            jg.fit(JDataSet(*data[0]))
        else:
            jg.pretrain_vertex("vae", JListIterator(
                [JDataSet(x, y) for x, y in data]))
    inject(log)
    if pretrain_by == "fit":
        pg.fit(DataSet(*data[0]))
    else:
        pg.pretrain_vertex("vae", ListDataSetIterator(
            [DataSet(x, y) for x, y in data]))
        # the vertices around it did not move
        for n in ("dense", "out"):
            for k, v in pg.params_map[n].items():
                np.testing.assert_array_equal(
                    v.detach().numpy(), np.asarray(jg.params_map[n][k]))
    assert pg.iteration == jg.iteration
    for n, jp in jg.params_map.items():
        for k in jp:
            _close(pg.params_map[n][k], jp[k], 1e-5, f"{n}.{k}")


def test_graph_vertex_equals_the_mln_layer(inject):
    """The same VAE pretrained as a graph vertex and as an MLN layer on
    the same draws: within 1e-6."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (OutputLayer,
                                                    VariationalAutoencoder)

    def vae():
        return VariationalAutoencoder(n_in=N_IN, n_out=3,
                                      encoder_layer_sizes=(7,),
                                      decoder_layer_sizes=(6,),
                                      activation="leakyrelu")
    mconf = (NeuralNetConfiguration.Builder().seed(2).updater("rmsprop")
             .learning_rate(0.01).list().layer(vae())
             .layer(OutputLayer(n_out=3, activation="softmax")).build())
    gconf = (NeuralNetConfiguration.Builder().seed(2).updater("rmsprop")
             .learning_rate(0.01).graph_builder().add_inputs("in")
             .add_layer("vae", vae(), "in")
             .add_layer("out", OutputLayer(n_in=3, n_out=3,
                                           activation="softmax"),
                        "vae").set_outputs("out").build())
    mln = MultiLayerNetwork(mconf, device="cpu").init()
    g = ComputationGraph(gconf, device="cpu").init()
    g.params_map = {"vae": {k: v.detach().clone().requires_grad_(True)
                            for k, v in mln.params_list[0].items()},
                    "out": g.params_map["out"]}
    data = _batches(3, seed=9)
    draws = [("normal", np.random.RandomState(i).randn(BATCH, 3))
             for i in range(3)]
    inject(draws)
    mln.pretrain_layer(0, ListDataSetIterator([DataSet(x, y)
                                               for x, y in data]))
    inject(draws)
    g.pretrain_vertex("vae", ListDataSetIterator([DataSet(x, y)
                                                  for x, y in data]))
    for k, v in mln.params_list[0].items():
        _close(g.params_map["vae"][k], v.detach().numpy(), 1e-6, k)


def test_multi_dataset_and_bare_dataset_are_one_batch():
    _, pg = _graph_pair()
    x, _ = _batches(1)[0]
    pg.pretrain_vertex("vae", MultiDataSet([x], [None]))
    pg.pretrain_vertex("vae", DataSet(x, None))
    assert pg.iteration == 2


# ---------------------------------------------------------------------------
# configuration, persistence, the solver gate
# ---------------------------------------------------------------------------
def _all_three_conf(builder, layers):
    ae, rbm, vae, out = layers
    return (builder.seed(4).list()
            .layer(ae(n_in=N_IN, n_out=9, corruption_level=0.1,
                      loss="xent"))
            .layer(rbm(n_out=8, k=3, visible_unit="binary",
                       hidden_unit="gaussian"))
            .layer(vae(n_out=2, encoder_layer_sizes=(5, 4),
                       decoder_layer_sizes=(4,),
                       reconstruction_distribution=[
                           {"dist": "gaussian", "size": 3},
                           {"dist": {"loss": "mse"}, "size": 5}],
                       num_samples=2))
            .layer(out(n_out=3, activation="softmax"))
            .pretrain(True).build())


def _reference_conf():
    return _all_three_conf(JBuilder.Builder(),
                           (jpre.AutoEncoder, jpre.RBM,
                            jpre.VariationalAutoencoder, JOut))


@pytest.mark.parametrize("form", ["json", "yaml"])
def test_reference_configuration_round_trips(form):
    jconf = _reference_conf()
    if form == "json":
        pconf = MultiLayerConfiguration.from_json(jconf.to_json())
        assert pconf.to_json() == jconf.to_json()
    else:
        pconf = MultiLayerConfiguration.from_yaml(jconf.to_yaml())
        assert pconf.to_yaml() == jconf.to_yaml()
    assert [type(l).__name__ for l in pconf.layers] == \
        ["AutoEncoder", "RBM", "VariationalAutoencoder", "OutputLayer"]
    for pl, jl in zip(pconf.layers, jconf.layers):
        assert pl.param_shapes() == jl.param_shapes()
        assert pl.is_pretrain_layer() == jl.is_pretrain_layer()
    net = MultiLayerNetwork(pconf, device="cpu").init()
    assert net.num_params() == sum(l.n_params() for l in jconf.layers)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_archives_with_pretrain_layers_cross_over(tmp_path, direction):
    jconf = _reference_conf()
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    path = str(tmp_path / "net.zip")
    if direction == "jax_to_port":
        jser.write_model(jnet, path)
        got = model_serializer.restore_multi_layer_network(path,
                                                           device="cpu")
        np.testing.assert_array_equal(got.params(), np.asarray(jnet.params()))
        x = _batches(1)[0][0]
        _close(got.output(x), jnet.output(x), 1e-5, "output")
    else:
        pnet.set_params(np.random.RandomState(2).randn(
            pnet.num_params()).astype(np.float32) * 0.1)
        model_serializer.write_model(pnet, path)
        got = jser.restore_multi_layer_network(path)
        np.testing.assert_array_equal(np.asarray(got.params()),
                                      pnet.params())
        assert got.conf.to_json() == pnet.conf.to_json()


@pytest.mark.parametrize("entry", ["pretrain_layer", "fit", "vertex"])
def test_solver_refused_during_pretraining(entry):
    if entry == "vertex":
        _, net = _graph_pair()
        net.conf.optimization_algo = "lbfgs"
        call = lambda: net.pretrain_vertex("vae", DataSet(  # noqa: E731
            *_batches(1)[0]))
    else:
        _, net = _mln_pair(pretrain=entry == "fit")
        net.conf.optimization_algo = "lbfgs"
        x, y = _batches(1)[0]
        call = (lambda: net.pretrain_layer(0, DataSet(x, None))) \
            if entry == "pretrain_layer" else \
            (lambda: net.fit(DataSet(x, y)))
    before = net.params()
    with pytest.raises(ValueError, match="layer-wise pretraining runs on "
                                         "the SGD updater path"):
        call()
    np.testing.assert_array_equal(net.params(), before)
