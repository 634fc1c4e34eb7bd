"""The port's TransferLearning and EarlyStoppingTrainer against the JAX
package's (``nn/transfer_learning.py``, ``earlystopping/
early_stopping.py``).

- The same builder calls on nets from one configuration JSON build the
  same layer list, widths, updaters and frozen flags; parameters the
  builder copies equal the source's, and replaced ones are drawn anew
  (by each package's own generator: shapes only).
- A frozen layer's parameters are bitwise unchanged by fine-tuning, the
  source net is bitwise unchanged by the built net's training, and the
  built net shares no storage with the source.
- Early stopping: each termination condition on one scripted score
  sequence gives the reference's result fields exactly; a real MLP under
  both trainers gives the same scores within 1e-5 (f32 summation
  order), the same best epoch and the same reason.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.earlystopping import early_stopping as jes
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn import transfer_learning as jtl
from deeplearning4j_tpu.nn.conf.multi_layer import (
    NeuralNetConfiguration as JBuilder)
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu_torch.datasets.dataset import (ArrayDataSetIterator,
                                                       DataSet)
from deeplearning4j_tpu_torch.earlystopping import early_stopping as pes
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn import transfer_learning as ptl
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.utils import model_serializer


def _conf(builder, dense, out, updater="adam"):
    return (builder.seed(1).learning_rate(0.05).updater(updater).list()
            .layer(dense(n_in=8, n_out=12, activation="relu"))
            .layer(dense(n_out=10, activation="tanh"))
            .layer(out(n_out=4, activation="softmax", loss="mcxent"))
            .build())


def _pair(updater="adam"):
    jconf = _conf(JBuilder.Builder(), JDense, JOut, updater)
    jnet = JNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    pnet.params_list = params_from_numpy(
        pnet.layers, [{k: np.asarray(v) for k, v in p.items()}
                      for p in jnet.params_list], "cpu")
    return jnet, pnet


def _data(n=64, classes=4, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(n, 8).astype(np.float32)
    w = r.rand(8, classes).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[np.argmax(x @ w, 1)]


BUILDS = {
    "feature_extractor": lambda tl, m, D, O: (
        tl.TransferLearning.Builder(m).set_feature_extractor(1)),
    "n_out_replace": lambda tl, m, D, O: (
        tl.TransferLearning.Builder(m).n_out_replace(1, 6, "relu")),
    "replace_head": lambda tl, m, D, O: (
        tl.TransferLearning.Builder(m).set_feature_extractor(0)
        .n_out_replace(2, 2)),
    "remove_and_add": lambda tl, m, D, O: (
        tl.TransferLearning.Builder(m).remove_output_layer()
        .add_layer(D(n_out=5, activation="sigmoid"))
        .add_layer(O(n_out=3, activation="softmax", loss="mcxent"))),
    "fine_tune": lambda tl, m, D, O: (
        tl.TransferLearning.Builder(m).set_feature_extractor(0)
        .fine_tune_configuration(tl.FineTuneConfiguration(
            learning_rate=0.01, updater="sgd", l2=1e-3))),
}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_builder_builds_the_references_net(build):
    jnet, pnet = _pair()
    jt = BUILDS[build](jtl, jnet, JDense, JOut).build()
    pt = BUILDS[build](ptl, pnet, DenseLayer, OutputLayer).build()
    assert pt.conf.to_json() == jt.conf.to_json()
    assert [type(l).__name__ for l in pt.layers] == \
        [type(l).__name__ for l in jt.layers]
    for i, (pl, jl) in enumerate(zip(pt.layers, jt.layers)):
        assert pl.param_shapes() == jl.param_shapes(), i
        pu, ju = vars(pl.updater_config(10)), vars(jl.updater_config(10))
        assert {k: pu[k] for k in ju if k in pu} == \
            {k: ju[k] for k in ju if k in pu}, i
        assert getattr(pl, "frozen", False) == getattr(jl, "frozen", False)
        assert (pl.updater, pl.learning_rate, pl.l2) == \
            (jl.updater, jl.learning_rate, jl.l2)
    # what the builder copies equals the source; nothing is shared
    src_ptrs = {v.data_ptr() for p in pnet.params_list for v in p.values()}
    for i, (pp, jp) in enumerate(zip(pt.params_list, jt.params_list)):
        for k, v in pp.items():
            assert v.data_ptr() not in src_ptrs
            if i < len(pnet.layers) and \
                    pnet.layers[i].param_shapes() == \
                    pt.layers[i].param_shapes() and \
                    np.array_equal(np.asarray(jp[k]),
                                   np.asarray(jnet.params_list[i][k])):
                np.testing.assert_array_equal(v.detach().numpy(),
                                              np.asarray(jp[k]))
    assert pt.conf.pretrain is False and pt._fused is None


def test_frozen_layers_and_source_stay_bitwise():
    _, base = _pair()
    x, y = _data()
    for _ in range(5):
        base.fit(DataSet(x, y))
    src = [p.detach().clone() for p in base.params_list
           for p in p.values()]
    tuned = (ptl.TransferLearning.Builder(base).set_feature_extractor(1)
             .n_out_replace(2, 2).build())
    frozen = [{k: v.detach().clone() for k, v in tuned.params_list[i].items()}
              for i in (0, 1)]
    head = tuned.get_layer_params(2)["W"]
    y2 = np.eye(2, dtype=np.float32)[(x[:, 0] > 0.5).astype(int)]
    for _ in range(5):
        tuned.fit(DataSet(x, y2))
    tuned.fit(ArrayDataSetIterator(x, y2, 16))   # the fused loop
    for i in (0, 1):
        for k, v in frozen[i].items():
            assert torch.equal(tuned.params_list[i][k], v), (i, k)
    assert not torch.equal(tuned.get_layer_params(2)["W"], head)
    for a, b in zip(src, [p for p in base.params_list for p in p.values()]):
        assert torch.equal(a, b)
    assert base._fused is None and tuned._fused is not None


def test_examples_transfer_learning_flow_runs_on_the_port(tmp_path):
    """examples/transfer_learning.py's flow with the port's classes."""
    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .updater("adam").list()
            .layer(DenseLayer(n_in=8, n_out=32, activation="relu"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent")).build())
    base = MultiLayerNetwork(conf, device="cpu").init()
    x, y = _data(256)
    for _ in range(30):
        base.fit(DataSet(x, y))
    tuned = (ptl.TransferLearning.Builder(base).set_feature_extractor(1)
             .n_out_replace(2, n_out=2).build())
    y2 = np.eye(2, dtype=np.float32)[(x[:, 0] > 0.5).astype(int)]
    before = tuned.get_layer_params(0)
    s0 = tuned.score(DataSet(x, y2))
    for _ in range(30):
        tuned.fit(DataSet(x, y2))
    assert tuned.score_ < s0
    after = tuned.get_layer_params(0)
    assert all(torch.equal(before[k], after[k]) for k in before)
    path = str(tmp_path / "tuned.zip")
    model_serializer.write_model(tuned, path)
    back = model_serializer.restore_model(path, device="cpu")
    np.testing.assert_array_equal(back.output(x), tuned.output(x))


# ---------------------------------------------------------------------------
# early stopping
# ---------------------------------------------------------------------------
class _Scripted:
    """A stand-in net (both packages' trainers call ``fit``, ``score_``,
    ``clone``): epoch ``e``'s held-out score is ``scores[e]``, and a batch's
    training score is ``train_score``."""

    params_list = ()

    def __init__(self, train_score=0.5):
        self.score_ = train_score
        self.fits = 0

    def fit(self, ds):
        self.fits += 1

    def clone(self):
        c = _Scripted(self.score_)
        c.fits = self.fits
        return c


class _ScriptCalc:
    def __init__(self, scores):
        self.scores = list(scores)

    def calculate_score(self, model):
        return self.scores.pop(0)


SEQ = [1.0, 0.8, 0.81, 0.79, 0.795, 0.9, 0.7, 0.85, 0.86, 0.87]
CONDITIONS = {
    "max_epochs": lambda m: dict(epoch=[m.MaxEpochsTerminationCondition(4)]),
    "score_improvement": lambda m: dict(
        epoch=[m.ScoreImprovementEpochTerminationCondition(2, 0.005)]),
    "best_score": lambda m: dict(
        epoch=[m.BestScoreEpochTerminationCondition(0.75)]),
    "max_time": lambda m: dict(
        iteration=[m.MaxTimeIterationTerminationCondition(0.0)]),
    "max_score": lambda m: dict(
        iteration=[m.MaxScoreIterationTerminationCondition(0.4)]),
    "invalid_score": lambda m: dict(
        iteration=[m.InvalidScoreIterationTerminationCondition()],
        train_score=math.nan),
    "evaluate_every_2": lambda m: dict(
        epoch=[m.MaxEpochsTerminationCondition(5)], every=2),
}


def _scripted_run(mod, name):
    spec = CONDITIONS[name](mod)
    net = _Scripted(spec.get("train_score", 0.5))
    cfg = mod.EarlyStoppingConfiguration(
        score_calculator=_ScriptCalc(SEQ),
        epoch_termination_conditions=spec.get("epoch"),
        iteration_termination_conditions=spec.get("iteration"),
        evaluate_every_n_epochs=spec.get("every", 1), save_last_model=True)
    res = mod.EarlyStoppingTrainer(cfg, net, [None, None, None]).fit()
    return res, net, cfg


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_termination_conditions_match_the_reference(name):
    jres, jnet, _ = _scripted_run(jes, name)
    pres, pnet, pcfg = _scripted_run(pes, name)
    for f in ("termination_reason", "termination_details", "score_vs_epoch",
              "best_model_epoch", "best_model_score", "total_epochs"):
        assert getattr(pres, f) == getattr(jres, f), f
    assert pnet.fits == jnet.fits
    if pres.best_model is not None:
        assert pres.best_model is not pnet
        assert pcfg.model_saver.get_latest_model().fits == pnet.fits


def _es_run(mod, net, data_cls, x, y, xv, yv, saver):
    train = [data_cls(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)]
    cfg = mod.EarlyStoppingConfiguration(
        score_calculator=mod.DataSetLossCalculator(
            [data_cls(xv[:8], yv[:8]), data_cls(xv[8:], yv[8:])]),
        model_saver=saver,
        epoch_termination_conditions=[
            mod.MaxEpochsTerminationCondition(6),
            mod.ScoreImprovementEpochTerminationCondition(1, 1e-3)])
    return mod.EarlyStoppingTrainer(cfg, net, train).fit()


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_trainer_on_a_real_net_matches_the_reference(tmp_path, saver):
    jnet, pnet = _pair(updater="sgd")
    x, y = _data(48, seed=1)
    xv, yv = _data(16, seed=2)
    jres = _es_run(jes, jnet, JDataSet, x, y, xv, yv, jes.InMemoryModelSaver())
    psaver = pes.InMemoryModelSaver() if saver == "memory" else \
        pes.LocalFileModelSaver(str(tmp_path / "es"), device="cpu")
    pres = _es_run(pes, pnet, DataSet, x, y, xv, yv, psaver)
    assert (pres.termination_reason, pres.termination_details,
            pres.best_model_epoch, pres.total_epochs) == \
        (jres.termination_reason, jres.termination_details,
         jres.best_model_epoch, jres.total_epochs)
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert abs(pres.score_vs_epoch[e] - s) <= 1e-5 * abs(s), e
    best = pres.best_model
    assert best is not pnet
    np.testing.assert_allclose(best.params(), np.asarray(jres.best_model
                                                         .params()),
                               rtol=0, atol=1e-5)
    # the saved best is the net as it was at its epoch, not the live net
    assert abs(best.score(DataSet(xv, yv)) - pres.best_model_score) <= 1e-6
    if pres.best_model_epoch < pres.total_epochs - 1:
        assert not np.array_equal(best.params(), pnet.params())
