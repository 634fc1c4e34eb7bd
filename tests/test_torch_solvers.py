"""The port's line-search solvers (``optimize/solvers.py``) and their
plumbing in both models, against the JAX package's.

Mirrors ``tests/test_solvers.py``. Tolerances, with their reasons:
- the quadratic trajectories (``backtrack_line_search`` and each solver
  over 8 iterations): 1e-5 of each value's scale. The same steps in f32;
  only the dot products sum in another order;
- a net under ``lbfgs`` against the JAX net from the same parameters:
  1e-4 of each leaf's max abs (ten iterations of f32 gradients through
  a tanh layer, each summed in another order; the line searches take the
  same steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as players
from deeplearning4j_tpu_torch.optimize import solvers

REL = 1e-5
NET_REL = 1e-4
SOLVERS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]


@pytest.fixture(scope="module")
def quadratic():
    r = np.random.RandomState(0)
    q = r.randn(16, 16)
    a = (q @ q.T + 0.1 * np.eye(16)).astype(np.float32)
    b = r.randn(16).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jvg = jax.value_and_grad(lambda x: 0.5 * x @ ja @ x - jb @ x)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def pvg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = 0.5 * x @ ta @ x - tb @ x
            (g,) = torch.autograd.grad(f, [x])
        return f.detach(), g
    xstar = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    fstar = float(0.5 * xstar @ a @ xstar - b @ xstar)
    return jvg, pvg, xstar, fstar


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (what, got, want)


@pytest.mark.parametrize("direction", ["descent", "ascent", "steep"])
def test_backtrack_line_search_matches_the_reference(direction):
    """Armijo backtracking: the step it settles on and the value there,
    a rejected ascent direction (step 0, f unchanged) included."""
    x0 = np.linspace(-3.0, 3.0, 6).astype(np.float32)

    def jf(x):
        return jnp.sum(x ** 4) + jnp.sum(x ** 2)

    def pf(x):
        return torch.sum(x ** 4) + torch.sum(x ** 2)
    g = 4 * x0 ** 3 + 2 * x0
    d = {"descent": -g, "ascent": g, "steep": -50.0 * g}[direction]
    jx, jg, jd = jnp.asarray(x0), jnp.asarray(g), jnp.asarray(d)
    js, jfn = jsolvers.backtrack_line_search(jf, jx, jf(jx), jg, jd)
    px, pg, pd = (torch.from_numpy(v.copy()) for v in (x0, g, d))
    ps, pfn = solvers.backtrack_line_search(pf, px, pf(px), pg, pd)
    assert float(ps) == float(js)
    _close(float(pfn), float(jfn), "f_new")
    if direction == "ascent":
        assert float(ps) == 0.0


@pytest.mark.parametrize("algo", SOLVERS)
def test_quadratic_trajectory_matches_the_reference(quadratic, algo):
    """Eight iterations from zero: the point, the score and the score of
    every iteration, against the reference's compiled solver."""
    jvg, pvg, _, _ = quadratic
    jx, jfx, jhist = jsolvers.solver_for(algo).optimize(
        jvg, np.zeros(16, np.float32), 8)
    px, pfx, phist = solvers.solver_for(algo).optimize(
        pvg, np.zeros(16, np.float32), 8)
    _close(px.numpy(), np.asarray(jx), f"{algo} x")
    _close(float(pfx), float(jfx), f"{algo} score")
    _close(phist.numpy(), np.asarray(jhist), f"{algo} history")


def test_solvers_converge_on_the_quadratic(quadratic):
    """The reference's convergence bars: L-BFGS to the optimum, conjugate
    gradient close, steepest descent monotone and making progress."""
    _, pvg, xstar, fstar = quadratic
    x, fx, _ = solvers.LBFGS().optimize(pvg, np.zeros(16, np.float32), 60)
    assert float(fx) == pytest.approx(fstar, abs=1e-3)
    assert np.linalg.norm(x.numpy() - xstar) < 0.05
    _, fx, _ = solvers.ConjugateGradient().optimize(
        pvg, np.zeros(16, np.float32), 80)
    assert float(fx) == pytest.approx(fstar, abs=5e-2)
    _, fx, hist = solvers.LineGradientDescent().optimize(
        pvg, np.zeros(16, np.float32), 100)
    h = hist.numpy()
    assert np.all(np.diff(h) <= 1e-5)
    assert float(fx) < 0.5 * (h[0] + fstar)


def test_forward_evaluations_per_iteration(quadratic):
    """One value-and-gradient an iteration plus one forward a line-search
    probe: the probes the reference's loop runs, no more."""
    _, pvg, _, _ = quadratic
    counts = {"vg": 0, "f": 0}

    def vg(x):
        counts["vg"] += 1
        return pvg(x)

    def f(x):
        counts["f"] += 1
        return pvg(x)[0]
    solvers.LBFGS().make_run(vg, 5, value=f)(torch.zeros(16))
    assert counts["vg"] == 1 + 5
    assert 5 <= counts["f"] <= 5 * 17


def test_solver_for_an_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="newton"):
        solvers.solver_for("newton")


# ---------------------------------------------------------------------------
# the models' solver plumbing against the JAX nets
# ---------------------------------------------------------------------------
def _toy(seed, n=96):
    r = np.random.RandomState(seed)
    x = r.normal(size=(n, 6)).astype(np.float32)
    w = r.normal(size=(6, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def _mln_conf(builder, layers, algo, iterations, bn=False):
    b = (builder.seed(77).optimization_algo(algo).iterations(iterations)
         .list().layer(layers.DenseLayer(n_in=6, n_out=12,
                                         activation="tanh")))
    if bn:
        b = b.layer(layers.BatchNormalization(n_out=12))
    return b.layer(layers.OutputLayer(n_in=12, n_out=3, activation="softmax",
                                      loss="negativeloglikelihood")).build()


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("algo", SOLVERS)
def test_mln_solver_matches_the_jax_net(algo):
    """``fit_batch`` at ``iterations`` 10 from the same parameters:
    parameters, score and the iteration counter against the JAX net."""
    x, y = _toy(1)
    jnet = JNet(_mln_conf(JBuilder.Builder(), jlayers, algo, 10)).init()
    pnet = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.Builder(),
                                       players, algo, 10), device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    s0 = pnet.score(DataSet(x, y))
    js = float(jnet.fit_batch(x, y))
    ps = float(pnet.fit_batch(x, y))
    assert ps < s0
    assert pnet.iteration == jnet.iteration == 10
    _close(pnet.params(), np.asarray(jnet.params()), "params", NET_REL)
    assert abs(ps - js) <= NET_REL * abs(js)
    assert pnet.gradient() is None
    assert pnet.dropout_draws == 1


def test_graph_lbfgs_matches_the_jax_graph():
    x, y = _toy(2)

    def conf(builder, layers):
        return (builder.seed(9).optimization_algo("lbfgs").iterations(10)
                .graph_builder().add_inputs("in")
                .add_layer("h", layers.DenseLayer(n_in=6, n_out=12,
                                                  activation="tanh"), "in")
                .add_layer("out", layers.OutputLayer(
                    n_in=12, n_out=3, activation="softmax",
                    loss="negativeloglikelihood"), "h")
                .set_outputs("out").build())
    jnet = JGraph(conf(JBuilder.Builder(), jlayers)).init()
    pnet = ComputationGraph(conf(NeuralNetConfiguration.Builder(), players),
                            device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    js = float(jnet.fit_batch(JMulti([x], [y])))
    ps = float(pnet.fit_batch(MultiDataSet([x], [y])))
    assert pnet.iteration == jnet.iteration == 10
    _close(pnet.params(), np.asarray(jnet.params()), "params", NET_REL)
    assert abs(ps - js) <= NET_REL * abs(js)


def test_batchnorm_states_refresh_once_after_the_solver():
    """The layer state stays fixed through the line searches and takes
    one forward's moments at the final parameters: the JAX net's."""
    x, y = _toy(3)
    jnet = JNet(_mln_conf(JBuilder.Builder(), jlayers, "lbfgs", 6,
                          bn=True)).init()
    pnet = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.Builder(),
                                       players, "lbfgs", 6, bn=True),
                             device="cpu").init()
    pnet.set_params(np.asarray(jnet.params()))
    before = [v.clone() for v in pnet.states_list[1].values()]
    jnet.fit_batch(x, y)
    pnet.fit_batch(x, y)
    after = list(pnet.states_list[1].values())
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    jstate = _tree_np(jnet.states_list[1])
    for k, v in pnet.states_list[1].items():
        _close(v.numpy(), jstate[k], f"bn {k}", NET_REL)


def test_solver_runs_are_cached_by_signature():
    x, y = _toy(4)
    net = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.Builder(),
                                      players, "lbfgs", 3),
                            device="cpu").init()
    net.fit_batch(x, y)
    net.fit_batch(x, y)
    assert len(net._solver_runs) == 1
    net.conf.optimization_algo = "conjugate_gradient"
    net.fit_batch(x, y)
    assert len(net._solver_runs) == 2


def test_tbptt_with_a_solver_and_an_unknown_algorithm_raise():
    conf = (NeuralNetConfiguration.Builder().seed(1)
            .optimization_algo("lbfgs").iterations(3).list()
            .layer(players.LSTM(n_in=4, n_out=6))
            .layer(players.RnnOutputLayer(n_in=6, n_out=2,
                                          activation="softmax",
                                          loss="mcxent"))
            .backprop_type("tbptt").tbptt_fwd_length(5)
            .tbptt_back_length(5).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.RandomState(0).normal(size=(2, 10, 4)).astype(np.float32)
    y = np.zeros((2, 10, 2), np.float32)
    y[..., 0] = 1.0
    with pytest.raises(ValueError, match="stochastic_gradient_descent"):
        net.fit_batch(x, y)
    x2, y2 = _toy(5)
    bad = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration.Builder(),
                                      players, "newton", 2),
                            device="cpu").init()
    with pytest.raises(ValueError, match="newton"):
        bad.fit_batch(x2, y2)


def test_solver_dropout_masks_fixed_within_a_call():
    """A dropout layer under a solver: the call's probes share one counter
    value (a consistent loss), the counter moves once a call, and two runs
    from one seed agree bitwise."""
    def run():
        conf = _mln_conf(NeuralNetConfiguration.Builder(), players,
                         "conjugate_gradient", 4)
        conf.layers[0].dropout = 0.8
        net = MultiLayerNetwork(conf, device="cpu").init()
        x, y = _toy(6)
        net.fit_batch(x, y)
        net.fit_batch(x, y)
        return net
    a, b = run(), run()
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.dropout_draws == 2
