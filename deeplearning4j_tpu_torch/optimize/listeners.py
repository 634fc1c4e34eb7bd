"""Training listeners: the port's own copy of
``deeplearning4j_tpu/optimize/listeners.py`` (ScoreIterationListener,
PerformanceListener, CollectScoresIterationListener,
TimeIterationListener). A model calls ``iteration_done(model,
iteration)`` after every step; ``model.score_`` may be a device scalar,
read only where a listener prints it.
"""

from __future__ import annotations

import time

__all__ = ["CollectScoresIterationListener", "IterationListener",
           "PerformanceListener", "ScoreIterationListener",
           "TimeIterationListener"]


class IterationListener:
    def iteration_done(self, model, iteration):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(IterationListener):
    """Print the score every ``frequency`` iterations."""

    def __init__(self, frequency=10, log_fn=print):
        self.frequency = max(1, frequency)
        self.log_fn = log_fn

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.log_fn(f"Score at iteration {iteration} is "
                        f"{float(model.score_)}")


class PerformanceListener(IterationListener):
    """Throughput per iteration: batches/sec, and samples/sec where the
    model reports its last batch size."""

    def __init__(self, frequency=1, report_samples=True, log_fn=print):
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self.log_fn = log_fn
        self._last_time = None
        self._last_iter = None
        self.last_samples_per_sec = None
        self.last_batches_per_sec = None

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0:
                self.last_batches_per_sec = iters / dt
                batch = getattr(model, "_last_batch_size", None)
                msg = (f"iteration {iteration}: "
                       f"{self.last_batches_per_sec:.1f} batches/sec")
                if batch:
                    self.last_samples_per_sec = iters * batch / dt
                    msg += f", {self.last_samples_per_sec:.1f} samples/sec"
                self.log_fn(msg)
        self._last_time = now
        self._last_iter = iteration


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs; scores stay as the model
    gave them (device scalars are not read)."""

    def __init__(self, frequency=1):
        self.frequency = max(1, frequency)
        self.scores = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_))


class TimeIterationListener(IterationListener):
    """ETA logging."""

    def __init__(self, total_iterations, log_fn=print, frequency=50):
        self.total = total_iterations
        self.start = time.perf_counter()
        self.log_fn = log_fn
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self.start
            remaining = elapsed / iteration * (self.total - iteration)
            self.log_fn(f"iteration {iteration}/{self.total}, "
                        f"ETA {remaining:.0f}s")
