"""The port's regression and ROC evaluation against the JAX package's, and
the configurations' YAML round trips.

The same numpy-seeded batches stream through the reference's
``RegressionEvaluation``, ``ROC`` and ``ROCMultiClass`` and the port's;
every metric agrees within 1e-6 (both are float64 numpy; only the
order of nothing differs, so most are equal). YAML: a configuration
written by either package's ``to_yaml`` reads back in the other to the
same JSON (PyYAML, a CPU-lane dependency).
"""

import json

import numpy as np
import pytest
import yaml

from deeplearning4j_tpu.eval.evaluation import (
    RegressionEvaluation as JRegression)
from deeplearning4j_tpu.eval.roc import ROC as JROC
from deeplearning4j_tpu.eval.roc import ROCMultiClass as JROCMulti
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.computation_graph import (
    ComputationGraphConfiguration as JCGConf)
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JMLConf, NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import (
    CenterLossOutputLayer as JCenter, DenseLayer as JDense,
    EmbeddingLayer as JEmbed, RnnOutputLayer as JRnnOut,
    SelfAttentionLayer as JAttn)
from deeplearning4j_tpu_torch.eval import (ROC, ROCMultiClass,
                                           RegressionEvaluation)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

TOL = 1e-6


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _regression_batches(seed, time_series):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(4):
        shape = (5, 7, 3) if time_series else (9, 3)
        y = r.randn(*shape)
        p = y + 0.3 * r.randn(*shape)
        m = (r.rand(5, 7) > 0.3).astype(np.float32) if time_series else None
        out.append((y.astype(np.float32), p.astype(np.float32), m))
    return out


@pytest.mark.parametrize("time_series", [False, True])
def test_regression_evaluation_matches_jax(time_series):
    je, pe = JRegression(), RegressionEvaluation()
    for y, p, m in _regression_batches(1, time_series):
        je.eval(y, p, mask=m)
        pe.eval(y, p, mask=m)
    assert pe.n_columns == je.n_columns == 3
    assert pe._count == je._count
    for name in ("mean_squared_error", "mean_absolute_error",
                 "root_mean_squared_error", "r_squared",
                 "pearson_correlation"):
        _close(getattr(pe, name)(), getattr(je, name)())
        for col in range(3):
            _close(getattr(pe, name)(col), getattr(je, name)(col))
    assert pe.stats() == je.stats()


def _roc_batches(seed, two_columns):
    r = np.random.RandomState(seed)
    out = []
    for n in (7, 13, 4):
        pos = r.rand(n) > 0.4
        prob = np.clip(0.35 * pos + 0.65 * r.rand(n), 0, 1)
        if two_columns:
            out.append((np.stack([~pos, pos], 1).astype(np.float32),
                        np.stack([1 - prob, prob], 1).astype(np.float32)))
        else:
            out.append((pos.astype(np.float32)[:, None],
                        prob.astype(np.float32)[:, None]))
    return out


@pytest.mark.parametrize("steps", [10, 100])
@pytest.mark.parametrize("two_columns", [False, True])
def test_roc_matches_jax(two_columns, steps):
    jr, pr = JROC(steps), ROC(steps)
    for y, p in _roc_batches(2, two_columns):
        jr.eval(y, p)
        pr.eval(y, p)
    for a in ("tp", "fp", "fn_", "tn", "thresholds"):
        np.testing.assert_array_equal(getattr(pr, a), getattr(jr, a))
    for got, want in zip(pr.roc_curve(), jr.roc_curve()):
        _close(got, want)
    _close(pr.area_under_curve(), jr.area_under_curve())
    assert 0.5 < pr.area_under_curve() <= 1.0


def test_roc_multiclass_matches_jax():
    r = np.random.RandomState(3)
    jr, pr = JROCMulti(50), ROCMultiClass(50)
    for n in (8, 11, 5):
        cls = r.randint(0, 4, n)
        y = np.eye(4, dtype=np.float32)[cls]
        logits = r.randn(n, 4) + 1.5 * y
        p = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
            .astype(np.float32)
        jr.eval(y, p)
        pr.eval(y, p)
    assert sorted(pr.per_class) == sorted(jr.per_class) == [0, 1, 2, 3]
    for c in range(4):
        _close(pr.area_under_curve(c), jr.area_under_curve(c))
    _close(pr.average_auc(), jr.average_auc())


def _new_layers_conf():
    return (JBuilder.Builder().seed(4).list()
            .layer(JEmbed(n_in=50, n_out=6, activation="identity"))
            .layer(JDense(n_in=6, n_out=6, activation="tanh"))
            .layer(JCenter(n_in=6, n_out=3, activation="softmax",
                           loss="mcxent"))
            .build())


def _attention_conf():
    return (JBuilder.Builder().seed(4).list()
            .layer(JAttn(n_in=8, n_out=8, n_heads=2, causal=True,
                         block_size=4))
            .layer(JRnnOut(n_in=8, n_out=3, activation="softmax",
                           loss="mcxent"))
            .build())


@pytest.mark.parametrize("build", ["lenet", "new_layers", "attention"])
def test_mln_yaml_round_trips_both_ways(build):
    jconf = {"lenet": jzoo.lenet_mnist, "new_layers": _new_layers_conf,
             "attention": _attention_conf}[build]()
    pconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert MultiLayerConfiguration.from_yaml(jconf.to_yaml()).to_json() == \
        jconf.to_json()
    assert JMLConf.from_yaml(pconf.to_yaml()).to_json() == jconf.to_json()
    # the same document (the texts may differ in YAML anchors, which
    # mark objects a dict shares)
    assert yaml.safe_load(pconf.to_yaml()) == yaml.safe_load(jconf.to_yaml())


def test_graph_yaml_round_trips_both_ways():
    jconf = jzoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    pconf = zoo.resnet50(n_classes=3, height=16, width=16, stages=(1,))
    assert yaml.safe_load(pconf.to_yaml()) == yaml.safe_load(jconf.to_yaml())
    # safe_dump sorts the vertices by name, so the documents are compared
    # as parsed JSON, and the order that fixes the flat vector as a list
    again = ComputationGraphConfiguration.from_yaml(jconf.to_yaml())
    assert json.loads(again.to_json()) == json.loads(jconf.to_json())
    assert again.layer_names() == jconf.layer_names()
    back = JCGConf.from_yaml(pconf.to_yaml())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert back.layer_names() == pconf.layer_names()
