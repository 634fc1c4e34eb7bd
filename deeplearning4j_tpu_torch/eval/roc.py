"""ROC and AUC, binary and multiclass: the port of
``deeplearning4j_tpu/eval/roc.py`` (``eval/ROC.java``,
``eval/ROCMultiClass.java``, one-vs-all per class), numpy only. Counts
are accumulated at ``threshold_steps + 1`` fixed thresholds, so
evaluation streams over minibatches without storing every score.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ROC", "ROCMultiClass"]


class ROC:
    """Binary ROC (positive class = column 1 of 2-column labels, or a single
    probability column)."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fn_ = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.tn = np.zeros(threshold_steps + 1, dtype=np.int64)

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            actual = labels[:, 1]
            prob = predictions[:, 1]
        else:
            actual = labels.ravel()
            prob = predictions.ravel()
        pos = actual > 0.5
        for i, t in enumerate(self.thresholds):
            pred_pos = prob >= t
            self.tp[i] += int(np.sum(pred_pos & pos))
            self.fp[i] += int(np.sum(pred_pos & ~pos))
            self.fn_[i] += int(np.sum(~pred_pos & pos))
            self.tn[i] += int(np.sum(~pred_pos & ~pos))

    def roc_curve(self):
        """(fpr, tpr) arrays ordered by increasing threshold."""
        tpr = self.tp / np.maximum(self.tp + self.fn_, 1)
        fpr = self.fp / np.maximum(self.fp + self.tn, 1)
        return fpr, tpr

    def area_under_curve(self):
        fpr, tpr = self.roc_curve()
        # lexicographic sort so ties in fpr are ordered by tpr (the curve is
        # monotone; a plain argsort can zig-zag through tied fpr values)
        order = np.lexsort((tpr, fpr))
        return float(np.trapezoid(tpr[order], fpr[order]))


class ROCMultiClass:
    """One-vs-all ROC per class (eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = threshold_steps
        self.per_class: dict[int, ROC] = {}

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n_classes = labels.shape[1]
        for c in range(n_classes):
            if c not in self.per_class:
                self.per_class[c] = ROC(self.threshold_steps)
            self.per_class[c].eval(labels[:, c], predictions[:, c])

    def area_under_curve(self, c):
        return self.per_class[c].area_under_curve()

    def average_auc(self):
        return float(np.mean([r.area_under_curve() for r in self.per_class.values()]))
