"""The port's evaluation reports (``eval/evaluation_tools.py`` over
``ui/components.py``) against the JAX package's: the same evaluation,
fed the same numpy labels and predictions, gives the same HTML bytes;
each component serialises to the same JSON."""

import numpy as np
import pytest

from deeplearning4j_tpu.eval import evaluation_tools as jtools
from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.eval.roc import ROC as JROC
from deeplearning4j_tpu.eval.roc import ROCMultiClass as JROCMulti
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu_torch.eval import (ROC, Evaluation, ROCMultiClass,
                                           evaluation_tools as ptools)
from deeplearning4j_tpu_torch.ui import components as pcomp


def _scores(n, c, seed):
    r = np.random.RandomState(seed)
    labels = np.eye(c, dtype=np.float32)[r.randint(0, c, n)]
    logits = r.randn(n, c) + 1.5 * labels
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return labels, probs.astype(np.float32)


def _both(tmp_path, export, jev, pev, title):
    jp, pp = str(tmp_path / "j.html"), str(tmp_path / "p.html")
    assert getattr(jtools, export)(jev, jp, title=title) == jp
    assert getattr(ptools, export)(pev, pp, title=title) == pp
    with open(jp, "rb") as f, open(pp, "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and got.startswith(b"<!DOCTYPE html>")
    return got


@pytest.mark.parametrize("n_classes", [3, 5])
def test_evaluation_html_matches_the_reference(tmp_path, n_classes):
    labels, probs = _scores(120, n_classes, n_classes)
    jev, pev = JEvaluation(), Evaluation()
    jev.eval(labels, probs)
    pev.eval(labels, probs)
    html = _both(tmp_path, "export_evaluation_to_html_file", jev, pev,
                 "Digits")
    assert b"Confusion matrix" in html


@pytest.mark.parametrize("steps", [20, 100])
def test_binary_roc_html_matches_the_reference(tmp_path, steps):
    labels, probs = _scores(200, 2, 7)
    jr, pr = JROC(steps), ROC(steps)
    jr.eval(labels[:, 1], probs[:, 1])
    pr.eval(labels[:, 1], probs[:, 1])
    html = _both(tmp_path, "export_roc_charts_to_html_file", jr, pr, "ROC")
    assert b"AUC" in html and b"<svg" in html


def test_multiclass_roc_html_matches_the_reference(tmp_path):
    labels, probs = _scores(150, 4, 11)
    jr, pr = JROCMulti(50), ROCMultiClass(50)
    jr.eval(labels, probs)
    pr.eval(labels, probs)
    html = _both(tmp_path, "export_roc_multi_class_to_html_file", jr, pr,
                 "one-vs-all")
    assert b"Per-class AUC" in html


def test_components_serialise_like_the_reference():
    def build(m):
        line = m.ChartLine("loss", "iteration", "score")
        line.add_series("train", [0, 1, 2], [1.0, 0.5, 0.25])
        return [m.ComponentText("hello", 12),
                m.ComponentTable(["a", "b"], [[1, 2], [3, 4]], title="t"),
                line, m.ChartHistogram("h", [0, 1], [1, 2], [3, 4]),
                m.ChartLine("empty"), m.ChartHistogram("none", [], [], [])]
    for jc, pc in zip(build(jcomp), build(pcomp)):
        assert pc.to_json() == jc.to_json()
        assert pc.render_svg() == jc.render_svg()
    assert pcomp.render_standalone_html(build(pcomp), "r") == \
        jcomp.render_standalone_html(build(jcomp), "r")
