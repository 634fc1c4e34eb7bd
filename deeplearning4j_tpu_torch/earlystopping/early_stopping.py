"""Early stopping: the port's own copy of
``deeplearning4j_tpu/earlystopping/early_stopping.py``
(``earlystopping/EarlyStoppingConfiguration.java``,
``trainer/BaseEarlyStoppingTrainer.java``: a fit a batch, a score a
number of epochs and the best model saved;
``saver/{InMemoryModelSaver,LocalFileModelSaver}.java``; the epoch,
score and time ``termination/*.java`` conditions;
``scorecalc/DataSetLossCalculator``).

``InMemoryModelSaver`` keeps the model's ``clone()``, which copies every
tensor: the best model does not follow the live net, whose updates run in
place. ``LocalFileModelSaver`` writes through the port's
``utils/model_serializer.py`` (an atomic, checksummed archive) and
restores on ``device``: the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
import os
import time

__all__ = ["BestScoreEpochTerminationCondition", "DataSetLossCalculator",
           "EarlyStoppingConfiguration", "EarlyStoppingResult",
           "EarlyStoppingTrainer", "EpochTerminationCondition",
           "InMemoryModelSaver", "InvalidScoreIterationTerminationCondition",
           "IterationTerminationCondition", "LocalFileModelSaver",
           "MaxEpochsTerminationCondition",
           "MaxScoreIterationTerminationCondition",
           "MaxTimeIterationTerminationCondition",
           "ScoreImprovementEpochTerminationCondition"]


# ---------------------------------------------------------------------------
# termination conditions (termination/*.java — 7 conditions)
# ---------------------------------------------------------------------------
class EpochTerminationCondition:
    def terminate(self, epoch, score):
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, score):
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (min-delta) improvement."""

    def __init__(self, max_epochs_without_improvement, min_improvement=0.0):
        self.max_no_improve = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = None
        self.since = 0

    def terminate(self, epoch, score):
        if self.best is None or score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since >= self.max_no_improve


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    def __init__(self, best_expected_score):
        self.target = best_expected_score

    def terminate(self, epoch, score):
        return score <= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds):
        self.max_seconds = max_seconds
        self.start = time.time()

    def terminate(self, score):
        return (time.time() - self.start) >= self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return score is None or math.isnan(score) or math.isinf(score)


# ---------------------------------------------------------------------------
# score calculators (scorecalc/DataSetLossCalculator)
# ---------------------------------------------------------------------------
class DataSetLossCalculator:
    def __init__(self, iterator, average=True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model):
        total = 0.0
        n = 0
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


# ---------------------------------------------------------------------------
# model savers (saver/*.java)
# ---------------------------------------------------------------------------
class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, model, score):
        self.best = model.clone()

    def save_latest_model(self, model, score):
        self.latest = model.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver:
    """The best and latest models as archives in ``directory``
    (saver/LocalFileModelSaver.java). Each save commits through the
    atomic write of ``model_serializer.write_model``, so a crash mid-save
    leaves the previous best whole."""

    def __init__(self, directory, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def save_best_model(self, model, score):
        from deeplearning4j_tpu_torch.utils import model_serializer
        model_serializer.write_model(model, self._path("bestModel.zip"))

    def save_latest_model(self, model, score):
        from deeplearning4j_tpu_torch.utils import model_serializer
        model_serializer.write_model(model, self._path("latestModel.zip"))

    def get_best_model(self):
        from deeplearning4j_tpu_torch.utils import model_serializer
        return model_serializer.restore_model(self._path("bestModel.zip"),
                                              device=self.device)

    def get_latest_model(self):
        from deeplearning4j_tpu_torch.utils import model_serializer
        return model_serializer.restore_model(
            self._path("latestModel.zip"), device=self.device)


# ---------------------------------------------------------------------------
# configuration + trainer
# ---------------------------------------------------------------------------
class EarlyStoppingConfiguration:
    """Builder-style config (EarlyStoppingConfiguration.java)."""

    def __init__(self, *, score_calculator, model_saver=None,
                 epoch_termination_conditions=None,
                 iteration_termination_conditions=None,
                 evaluate_every_n_epochs=1, save_last_model=False):
        self.score_calculator = score_calculator
        self.model_saver = model_saver or InMemoryModelSaver()
        self.epoch_conditions = epoch_termination_conditions or []
        self.iteration_conditions = iteration_termination_conditions or []
        self.evaluate_every_n_epochs = evaluate_every_n_epochs
        self.save_last_model = save_last_model


class EarlyStoppingResult:
    def __init__(self, termination_reason, termination_details, score_vs_epoch,
                 best_model_epoch, best_model_score, total_epochs, best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model


class EarlyStoppingTrainer:
    """fit-per-epoch loop with score calc + best-model saving
    (trainer/BaseEarlyStoppingTrainer.java fit loop)."""

    def __init__(self, config: EarlyStoppingConfiguration, network, train_iterator,
                 listener=None):
        self.config = config
        self.network = network
        self.train_iterator = train_iterator
        self.listener = listener

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        net = self.network
        if getattr(net, "params_list", False) is None:   # MLN, graph
            net.init()
        best_score = None
        best_epoch = -1
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", None
        while True:
            terminated_iter = False
            for ds in self.train_iterator:
                net.fit(ds)
                for cond in cfg.iteration_conditions:
                    if cond.terminate(net.score_):
                        reason = "IterationTerminationCondition"
                        details = type(cond).__name__
                        terminated_iter = True
                        break
                if terminated_iter:
                    break
            if terminated_iter:
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(net)
                scores[epoch] = score
                if self.listener is not None:
                    self.listener(epoch, score, net)
                if best_score is None or score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.model_saver.save_best_model(net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(net, score)
                stop = False
                for cond in cfg.epoch_conditions:
                    if cond.terminate(epoch, score):
                        reason = "EpochTerminationCondition"
                        details = type(cond).__name__
                        stop = True
                        break
                if stop:
                    break
            epoch += 1
        return EarlyStoppingResult(reason, details, scores, best_epoch,
                                   best_score, epoch + 1,
                                   cfg.model_saver.get_best_model())
