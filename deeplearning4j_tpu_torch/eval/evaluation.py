"""Classification evaluation: the port of
``deeplearning4j_tpu/eval/evaluation.py`` (``eval/Evaluation.java``),
numpy only: accuracy, precision, recall, F1, top-N and the confusion
matrix (``Evaluation``), and per-column regression metrics
(``RegressionEvaluation``: MSE, MAE, RMSE, R², Pearson correlation),
accumulated across ``eval()`` calls so they stream over an iterator.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConfusionMatrix", "Evaluation", "Prediction",
           "RegressionEvaluation"]


class ConfusionMatrix:
    """Counts[actual][predicted] (eval/ConfusionMatrix.java)."""

    def __init__(self, n_classes):
        self.n_classes = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual, predicted, count=1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual, predicted):
        return int(self.matrix[actual, predicted])

    def actual_total(self, actual):
        return int(self.matrix[actual].sum())

    def predicted_total(self, predicted):
        return int(self.matrix[:, predicted].sum())

    def total(self):
        return int(self.matrix.sum())

    def __str__(self):
        return str(self.matrix)


class Prediction:
    """One example's (actual, predicted, metadata) triple for
    evaluation-with-metadata (``eval/meta/Prediction.java``): lets a user
    trace a misclassification back to its source record."""

    __slots__ = ("actual", "predicted", "record_meta_data")

    def __init__(self, actual, predicted, record_meta_data):
        self.actual = int(actual)
        self.predicted = int(predicted)
        self.record_meta_data = record_meta_data

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, predicted={self.predicted}, "
                f"meta={self.record_meta_data!r})")


class Evaluation:
    """Streaming classification metrics (eval/Evaluation.java)."""

    def __init__(self, n_classes=None, labels=None, top_n=1):
        self.n_classes = n_classes
        self.label_names = labels
        self.top_n = top_n
        self.confusion = None if n_classes is None else ConfusionMatrix(n_classes)
        self.top_n_correct = 0
        self.top_n_total = 0
        self._predictions: list = []   # Prediction triples when metadata given

    def _ensure(self, n_classes):
        if self.confusion is None:
            self.n_classes = n_classes
            self.confusion = ConfusionMatrix(n_classes)

    def eval(self, labels, predictions, mask=None, record_meta_data=None):
        """Accumulate a minibatch. labels one-hot (or int ids), predictions
        probabilities/scores. Time-series ([b,t,c]) are flattened with mask.
        ``record_meta_data``: optional per-example metadata — one entry per
        batch row (for time-series, one per SEQUENCE, replicated across its
        unmasked timesteps) — recorded as ``Prediction`` triples for error
        tracing (``Evaluation.java`` eval-with-metadata /
        ``meta/Prediction.java``). Validated before any accumulation, so a
        raising call leaves the metrics untouched."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if record_meta_data is not None \
                and len(record_meta_data) != labels.shape[0]:
            raise ValueError(
                f"record_meta_data has {len(record_meta_data)} entries "
                f"for {labels.shape[0]} batch rows")
        meta = record_meta_data
        if labels.ndim == 3:  # [batch, time, classes] → flatten with mask
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if meta is not None:   # per-sequence → per-timestep
                meta = [m for m in meta for _ in range(t)]
            if mask is not None:
                m = np.asarray(mask).reshape(b * t).astype(bool)
                labels = labels[m]
                predictions = predictions[m]
                if meta is not None:
                    meta = [x for x, keep in zip(meta, m) if keep]
        if labels.ndim == 2 and labels.shape[1] > 1:
            actual = labels.argmax(axis=1)
            n_classes = labels.shape[1]
        else:
            actual = labels.astype(int).ravel()
            n_classes = predictions.shape[1]
        self._ensure(n_classes)
        predicted = predictions.argmax(axis=1)
        np.add.at(self.confusion.matrix, (actual, predicted), 1)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(top == actual[:, None]))
            self.top_n_total += len(actual)
        if meta is not None:
            self._predictions.extend(
                Prediction(a, p, m)
                for a, p, m in zip(actual, predicted, meta))

    # ---- eval-with-metadata queries (meta/Prediction.java) -------------
    def get_prediction_errors(self):
        """All recorded misclassifications (actual != predicted)."""
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions(self, actual_class, predicted_class):
        return [p for p in self._predictions
                if p.actual == actual_class and p.predicted == predicted_class]

    def get_predictions_by_actual_class(self, actual_class):
        return [p for p in self._predictions if p.actual == actual_class]

    def get_predictions_by_predicted_class(self, predicted_class):
        return [p for p in self._predictions if p.predicted == predicted_class]

    # ---- metrics -------------------------------------------------------
    def _tp(self, c):
        return self.confusion.get_count(c, c)

    def _fp(self, c):
        return self.confusion.predicted_total(c) - self._tp(c)

    def _fn(self, c):
        return self.confusion.actual_total(c) - self._tp(c)

    def accuracy(self):
        total = self.confusion.total()
        return float(np.trace(self.confusion.matrix)) / total if total else 0.0

    def top_n_accuracy(self):
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def precision(self, c=None):
        if c is not None:
            denom = self._tp(c) + self._fp(c)
            return self._tp(c) / denom if denom else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if self.confusion.actual_total(i) > 0 or self.confusion.predicted_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c=None):
        if c is not None:
            denom = self._tp(c) + self._fn(c)
            return self._tp(c) / denom if denom else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if self.confusion.actual_total(i) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c=None):
        p = self.precision(c)
        r = self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, c):
        tn = self.confusion.total() - self._tp(c) - self._fp(c) - self._fn(c)
        denom = self._fp(c) + tn
        return self._fp(c) / denom if denom else 0.0

    def _class_name(self, c):
        if self.label_names is not None and c < len(self.label_names):
            return str(self.label_names[c])
        return str(c)

    def stats(self):
        if self.confusion is None:
            return "<no data evaluated>"
        lines = [f"# of classes: {self.n_classes}",
                 f"Accuracy:  {self.accuracy():.4f}",
                 f"Precision: {self.precision():.4f}",
                 f"Recall:    {self.recall():.4f}",
                 f"F1 Score:  {self.f1():.4f}"]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        # per-class breakdown with label names (Evaluation.stats() parity);
        # vectorized: one pass over the matrix, not per-class reductions
        # (per-class precision()/recall()/f1() calls would make stats()
        # quadratic with a large constant for big-vocabulary classifiers)
        m = self.confusion.matrix
        tp = np.diag(m).astype(float)
        actual = m.sum(axis=1).astype(float)
        predicted = m.sum(axis=0).astype(float)
        prec = np.where(predicted > 0, tp / np.maximum(predicted, 1), 0.0)
        rec = np.where(actual > 0, tp / np.maximum(actual, 1), 0.0)
        f1 = np.where(prec + rec > 0,
                      2 * prec * rec / np.maximum(prec + rec, 1e-30), 0.0)
        width = max([5] + [len(self._class_name(c))
                           for c in range(self.n_classes)])
        lines.append(f"{'class':>{width}}  precision  recall  f1      count")
        for c in range(self.n_classes):
            if actual[c] == 0 and predicted[c] == 0:
                continue
            lines.append(
                f"{self._class_name(c):>{width}}  "
                f"{prec[c]:9.4f}  {rec[c]:6.4f}  "
                f"{f1[c]:6.4f}  {int(actual[c]):5d}")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)


class RegressionEvaluation:
    """Streaming regression metrics: MSE/MAE/RMSE/RSE/R2/correlation per column
    (eval/RegressionEvaluation.java)."""

    def __init__(self, n_columns=None, column_names=None):
        self.n_columns = n_columns
        self.column_names = column_names
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None
        self._count = 0

    def _ensure(self, n):
        if self._sum_sq_err is None:
            self.n_columns = n
            z = np.zeros(n, dtype=np.float64)
            self._sum_sq_err = z.copy()
            self._sum_abs_err = z.copy()
            self._sum_label = z.copy()
            self._sum_label_sq = z.copy()
            self._sum_pred = z.copy()
            self._sum_pred_sq = z.copy()
            self._sum_label_pred = z.copy()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = np.asarray(mask).reshape(b * t).astype(bool)
                labels = labels[m]
                predictions = predictions[m]
        self._ensure(labels.shape[1])
        err = predictions - labels
        self._sum_sq_err += np.sum(err ** 2, axis=0)
        self._sum_abs_err += np.sum(np.abs(err), axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels ** 2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_pred_sq += (predictions ** 2).sum(axis=0)
        self._sum_label_pred += (labels * predictions).sum(axis=0)
        self._count += labels.shape[0]

    def mean_squared_error(self, col=None):
        mse = self._sum_sq_err / self._count
        return float(mse[col]) if col is not None else mse

    def mean_absolute_error(self, col=None):
        mae = self._sum_abs_err / self._count
        return float(mae[col]) if col is not None else mae

    def root_mean_squared_error(self, col=None):
        r = np.sqrt(self._sum_sq_err / self._count)
        return float(r[col]) if col is not None else r

    def r_squared(self, col=None):
        mean_label = self._sum_label / self._count
        ss_tot = self._sum_label_sq - self._count * mean_label ** 2
        r2 = 1.0 - self._sum_sq_err / np.maximum(ss_tot, 1e-12)
        return float(r2[col]) if col is not None else r2

    def pearson_correlation(self, col=None):
        n = self._count
        cov = self._sum_label_pred - self._sum_label * self._sum_pred / n
        var_l = self._sum_label_sq - self._sum_label ** 2 / n
        var_p = self._sum_pred_sq - self._sum_pred ** 2 / n
        corr = cov / np.maximum(np.sqrt(var_l * var_p), 1e-12)
        return float(corr[col]) if col is not None else corr

    def stats(self):
        return (f"columns: {self.n_columns}\n"
                f"MSE:  {self.mean_squared_error()}\n"
                f"MAE:  {self.mean_absolute_error()}\n"
                f"RMSE: {self.root_mean_squared_error()}\n"
                f"R^2:  {self.r_squared()}")
