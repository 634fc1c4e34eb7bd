"""HTML export of evaluation results: the port's own copy of
``deeplearning4j_tpu/eval/evaluation_tools.py``
(``evaluation/EvaluationTools.java``: ``exportRocChartsToHtmlFile`` and
its multi-class variant render the ROC curve, the AUC and the predicted
probabilities' histogram as a standalone HTML page through the UI
components; an Evaluation's confusion matrix and per-class metrics
likewise). The same evaluation gives the reference's bytes.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram, ChartLine, ComponentTable, ComponentText,
    render_standalone_html)

__all__ = ["export_evaluation_to_html_file", "export_roc_charts_to_html_file",
           "export_roc_multi_class_to_html_file", "roc_chart_components"]


def roc_chart_components(roc, title="ROC"):
    fpr, tpr = roc.roc_curve()
    chart = ChartLine(f"{title} (AUC = {roc.area_under_curve():.4f})",
                      x_label="False positive rate", y_label="True positive rate")
    chart.add_series("ROC", fpr, tpr)
    chart.add_series("chance", [0.0, 1.0], [0.0, 1.0])
    return [chart]


def export_roc_charts_to_html_file(roc, path, title="ROC"):
    """EvaluationTools.exportRocChartsToHtmlFile(ROC, File)."""
    comps = [ComponentText(f"ROC report — AUC {roc.area_under_curve():.4f}", 15)]
    comps += roc_chart_components(roc, title)
    # predicted-probability histogram recovered from the streaming threshold
    # counters: #scores in [t_i, t_{i+1}) = (tp+fp)[i] - (tp+fp)[i+1]
    ge = roc.tp + roc.fp
    counts = (ge[:-1] - ge[1:]).astype(float)
    if counts.sum() > 0:
        comps.append(ChartHistogram("Predicted probability distribution",
                                    roc.thresholds[:-1], roc.thresholds[1:],
                                    counts))
    html = render_standalone_html(comps, title=title)
    with open(path, "w") as f:
        f.write(html)
    return path


def export_roc_multi_class_to_html_file(roc_mc, path, title="ROC (one-vs-all)"):
    """EvaluationTools multi-class variant: one curve per class + AUC table."""
    chart = ChartLine(title, x_label="False positive rate",
                      y_label="True positive rate")
    rows = []
    for c in sorted(roc_mc.per_class):
        fpr, tpr = roc_mc.per_class[c].roc_curve()
        chart.add_series(f"class {c}", fpr, tpr)
        rows.append([f"class {c}", f"{roc_mc.area_under_curve(c):.4f}"])
    chart.add_series("chance", [0.0, 1.0], [0.0, 1.0])
    comps = [ComponentText(f"Average AUC: {roc_mc.average_auc():.4f}", 15),
             chart, ComponentTable(["class", "AUC"], rows, title="Per-class AUC")]
    with open(path, "w") as f:
        f.write(render_standalone_html(comps, title=title))
    return path


def export_evaluation_to_html_file(evaluation, path, title="Evaluation"):
    """Confusion matrix + per-class precision/recall/F1 as standalone HTML."""
    n = evaluation.n_classes
    header = ["actual \\ predicted"] + [str(c) for c in range(n)]
    rows = [[str(a)] + [str(int(evaluation.confusion.get_count(a, p)))
                        for p in range(n)] for a in range(n)]
    metrics = [[str(c), f"{evaluation.precision(c):.4f}",
                f"{evaluation.recall(c):.4f}", f"{evaluation.f1(c):.4f}"]
               for c in range(n)]
    comps = [
        ComponentText(f"Accuracy: {evaluation.accuracy():.4f} — "
                      f"F1 (macro): {evaluation.f1():.4f}", 15),
        ComponentTable(header, rows, title="Confusion matrix"),
        ComponentTable(["class", "precision", "recall", "f1"], metrics,
                       title="Per-class metrics"),
    ]
    with open(path, "w") as f:
        f.write(render_standalone_html(comps, title=title))
    return path
