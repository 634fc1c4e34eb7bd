"""The port's EmbeddingLayer and CenterLossOutputLayer against the JAX
package's.

- EmbeddingLayer in a MultiLayerNetwork and in a ComputationGraph (ids
  into the embedding beside a float input): output and three SGD steps
  from the JAX net's parameters, in f32 within 1e-5 of each tensor's
  scale (summation order only). Under bf16 compute, ids above 256 (which
  bf16 cannot hold) must still pick their own rows: the weight gradient
  is non-zero on exactly the batch's rows, as in the JAX net, and within
  2e-2 of the scale of the JAX net's (both round the forward to bf16).
- CenterLossOutputLayer: ``init_state``, ``center_loss`` and
  ``update_centers`` against the JAX layer within 1e-6 of the scale
  (elementwise f32), its state carried across by ``states_from_numpy``,
  and its score equal to an OutputLayer's on the same parameters (the
  networks call neither center method, as the reference's do not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import (
    CenterLossOutputLayer as JCenter, DenseLayer as JDense,
    EmbeddingLayer as JEmbed, OutputLayer as JOut)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import computation_graph as pcg
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy, states_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (CenterLossOutputLayer,
                                                EmbeddingLayer, OutputLayer,
                                                layer_from_dict)

VOCAB, EMB, N_CLS, B = 600, 8, 5, 6
# ids above 256 that bf16 cannot represent (its 8-bit significand rounds
# 257 to 256, 301 to 300, 599 to 600)
BIG_IDS = np.array([257, 301, 433, 511, 599, 259], np.float32)


def _np_tree(tree):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _mln_pair(compute="float32"):
    jconf = (JBuilder.Builder().seed(7).learning_rate(0.1)
             .compute_dtype(compute).list()
             .layer(JEmbed(n_in=VOCAB, n_out=EMB, activation="identity"))
             .layer(JDense(n_in=EMB, n_out=6, activation="tanh"))
             .layer(JOut(n_in=6, n_out=N_CLS, activation="softmax",
                         loss="mcxent"))
             .build())
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    return jnet, pnet


def _labels(seed):
    r = np.random.RandomState(seed)
    return np.eye(N_CLS, dtype=np.float32)[r.randint(0, N_CLS, B)]


@pytest.mark.parametrize("shape", ["column", "flat"])
def test_mln_embedding_output_and_steps_match_jax(shape):
    jnet, pnet = _mln_pair()
    ids = np.random.RandomState(0).randint(0, VOCAB, B).astype(np.float32)
    x = ids[:, None] if shape == "column" else ids
    y = _labels(1)
    _close(pnet.output(x), np.asarray(jnet.output(x)), 1e-5, "output")
    for _ in range(3):
        js = float(jnet.fit_batch(x, y))
        ps = float(pnet.fit_batch(x, y))
        assert abs(ps - js) <= 1e-5 * abs(js)
    for jp, pp in zip(jnet.params_list, pnet.params_list):
        for k in jp:
            _close(pp[k].detach().numpy(), np.asarray(jp[k]), 1e-5, k)


def _rows(grad_w):
    return set(np.nonzero(np.abs(np.asarray(grad_w)).sum(1))[0])


def test_mln_bf16_ids_above_256_pick_their_own_rows():
    jnet, pnet = _mln_pair("bfloat16")
    x, y = BIG_IDS[:, None], _labels(2)
    jg, js = jnet.compute_gradient_and_score(x, y)
    pg, ps = pnet.compute_gradient_and_score(x, y)
    want_rows = set(BIG_IDS.astype(int))
    assert _rows(pg[0]["W"]) == want_rows == _rows(jg[0]["W"])
    _close(pg[0]["W"].numpy(), jg[0]["W"], 2e-2, "dW")
    assert abs(ps - js) <= 2e-2 * abs(js)


def _graph_pair(compute="float32"):
    jconf = (JBuilder.Builder().seed(9).learning_rate(0.1)
             .compute_dtype(compute).graph_builder()
             .add_inputs("ids", "feat")
             .add_layer("emb", JEmbed(n_in=VOCAB, n_out=EMB,
                                      activation="identity"), "ids")
             .add_vertex("merge", JMerge(), "emb", "feat")
             .add_layer("out", JOut(n_in=EMB + 3, n_out=N_CLS,
                                    activation="softmax", loss="mcxent"),
                        "merge")
             .set_outputs("out")
             .set_input_types(JIT.feed_forward(1), JIT.feed_forward(3))
             .build())
    jnet = JGraph(jconf).init()
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    pnet = ComputationGraph(pconf, device="cpu").init()
    pnet.params_map = pcg.params_from_numpy(
        pconf, {n: _np_tree(p) for n, p in jnet.params_map.items()}, "cpu")
    return jnet, pnet


def test_graph_embedding_output_and_steps_match_jax():
    jnet, pnet = _graph_pair()
    r = np.random.RandomState(3)
    ids = r.randint(0, VOCAB, (B, 1)).astype(np.float32)
    feat = r.randn(B, 3).astype(np.float32)
    y = _labels(4)
    _close(pnet.output(ids, feat), np.asarray(jnet.output(ids, feat)),
           1e-5, "output")
    for _ in range(3):
        js = float(jnet.fit_batch(JMDS([ids, feat], [y])))
        ps = float(pnet.fit_batch(MultiDataSet([ids, feat], [y])))
        assert abs(ps - js) <= 1e-5 * abs(js)
    for name, jp in jnet.params_map.items():
        for k in jp:
            _close(pnet.params_map[name][k].detach().numpy(),
                   np.asarray(jp[k]), 1e-5, f"{name}.{k}")


def test_graph_bf16_ids_above_256_pick_their_own_rows():
    jnet, pnet = _graph_pair("bfloat16")
    feat = np.random.RandomState(5).randn(B, 3).astype(np.float32)
    data = ([BIG_IDS[:, None], feat], [_labels(6)])
    jg, js = jnet.compute_gradient_and_score(JMDS(*data))
    pg, ps = pnet.compute_gradient_and_score(MultiDataSet(*data))
    want_rows = set(BIG_IDS.astype(int))
    assert _rows(pg["emb"]["W"]) == want_rows == _rows(jg["emb"]["W"])
    _close(pg["emb"]["W"].numpy(), jg["emb"]["W"], 2e-2, "dW")
    assert pnet._embedding_fed_inputs() == {"ids"}


def _center_pair():
    jl = JCenter(n_in=4, n_out=3, alpha=0.1, lambda_=0.3,
                 activation="softmax", loss="mcxent") \
        .apply_global_defaults({})
    return jl, layer_from_dict(jl.to_dict())


def test_center_loss_state_and_updates_match_jax():
    jl, pl = _center_pair()
    js, ps = jl.init_state(), pl.init_state()
    assert set(js) == set(ps) == {"centers"}
    np.testing.assert_array_equal(ps["centers"].numpy(),
                                  np.asarray(js["centers"]))
    r = np.random.RandomState(8)
    feats = r.randn(5, 4).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[[0, 0, 2, 0, 2]]   # class 1 absent
    jstate = {"centers": jnp.asarray(r.randn(3, 4).astype(np.float32))}
    pstate = {"centers": torch.tensor(np.asarray(jstate["centers"]))}
    for step in range(3):
        _close(float(pl.center_loss(pstate, torch.tensor(feats),
                                    torch.tensor(labels))),
               float(jl.center_loss(jstate, jnp.asarray(feats),
                                    jnp.asarray(labels))), 1e-6,
               f"center_loss {step}")
        jstate = jl.update_centers(jstate, jnp.asarray(feats),
                                   jnp.asarray(labels))
        pstate = pl.update_centers(pstate, torch.tensor(feats),
                                   torch.tensor(labels))
        _close(pstate["centers"].numpy(), np.asarray(jstate["centers"]),
               1e-6, f"centers {step}")
    # the absent class keeps its center
    assert np.array_equal(pstate["centers"][1].numpy(),
                          np.asarray(jstate["centers"][1]))


def _center_net(layer_cls, jnet_params=None):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer
    conf = (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=4, n_out=4, activation="tanh"))
            .layer(layer_cls(n_in=4, n_out=3, activation="softmax",
                             loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_center_loss_net_scores_and_trains_as_output_layer():
    """The nets call neither center method, so a CenterLossOutputLayer
    net's score, steps and centers equal an OutputLayer net's (centers
    stay at their initial zeros)."""
    center, plain = _center_net(CenterLossOutputLayer), \
        _center_net(OutputLayer)
    plain.set_params(center.params())
    r = np.random.RandomState(4)
    x = r.randn(6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 6)]
    assert center.score(DataSet(x, y)) == plain.score(DataSet(x, y))
    for _ in range(2):
        assert float(center.fit_batch(x, y)) == float(plain.fit_batch(x, y))
    np.testing.assert_array_equal(center.params(), plain.params())
    assert torch.equal(center.states_list[1]["centers"], torch.zeros(3, 4))


def test_center_state_carries_across_from_jax():
    """A JAX net's CenterLossOutputLayer state (and its parameters) carry
    into the port by ``states_from_numpy``/``params_from_numpy``; a
    wrong-shaped state is refused."""
    jconf = (JBuilder.Builder().seed(1).list()
             .layer(JDense(n_in=4, n_out=4, activation="tanh"))
             .layer(JCenter(n_in=4, n_out=3, activation="softmax",
                            loss="mcxent"))
             .build())
    jnet = JNet(jconf).init()
    centers = np.arange(12, dtype=np.float32).reshape(3, 4)
    jnet.states_list[1] = {"centers": jnp.asarray(centers)}
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [_np_tree(p) for p in jnet.params_list], "cpu")
    pnet.states_list = states_from_numpy(
        pnet.layers, [_np_tree(s) for s in jnet.states_list], "cpu")
    np.testing.assert_array_equal(pnet.states_list[1]["centers"].numpy(),
                                  centers)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    _close(pnet.output(x), np.asarray(jnet.output(x)), 1e-6, "output")
    with pytest.raises(ValueError, match="centers"):
        states_from_numpy(pnet.layers, [{}, {"centers": np.zeros((4, 3))}],
                          "cpu")


def test_embedding_conf_round_trips_through_both_packages():
    jl = JEmbed(n_in=VOCAB, n_out=EMB, activation="identity")
    pl = layer_from_dict(jl.to_dict())
    assert isinstance(pl, EmbeddingLayer)
    assert pl.to_dict() == jl.to_dict()
    assert pl.param_shapes() == jl.param_shapes()
    assert pl.param_order == jl.param_order
