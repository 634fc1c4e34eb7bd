"""Training listeners: the port's own copy of
``deeplearning4j_tpu/optimize/listeners.py`` (ScoreIterationListener,
PerformanceListener, ProfilerListener, CollectScoresIterationListener,
TimeIterationListener). A model calls ``iteration_done(model,
iteration)`` after every step; ``model.score_`` may be a device scalar,
read only where a listener prints it.
"""

from __future__ import annotations

import os
import time

import torch

__all__ = ["CollectScoresIterationListener", "IterationListener",
           "PerformanceListener", "ProfilerListener",
           "ScoreIterationListener", "TimeIterationListener"]


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


class ProfilerListener(IterationListener):
    """A ``torch.profiler`` trace over a window of training iterations
    (the reference's ``jax.profiler`` window): the iterations after
    ``iteration_done`` first sees ``start_iteration``, ``num_iterations``
    of them, exported as a Chrome trace
    (``<log_dir>/trace_<first>_<last>.json``, ``trace_path``). On the card
    the window is bracketed by ``torch.cuda.synchronize`` and the trace
    holds the device's kernels too.

    >>> net.set_listeners([ProfilerListener("prof", start_iteration=10)])
    """

    def __init__(self, log_dir, start_iteration=5, num_iterations=10,
                 log_fn=print):
        self.log_dir = str(log_dir)
        self.start_iteration = start_iteration
        self.num_iterations = max(1, num_iterations)
        self.log_fn = log_fn
        self._active = False
        self._prof = None
        self._stop_at = None
        self.captured = False
        self.trace_dir = None
        self.trace_path = None

    @staticmethod
    def _on_card(model):
        dev = getattr(model, "device", None)
        return dev is not None and torch.device(dev).type == "cuda"

    def _sync(self, model):
        """Wait for the model's queued device work, so that the window
        brackets what ran in it."""
        if self._on_card(model):
            torch.cuda.synchronize(torch.device(model.device))

    def iteration_done(self, model, iteration):
        if (not self._active and not self.captured
                and iteration >= self.start_iteration):
            self._sync(model)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._on_card(model):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._active = True
            self._first = iteration + 1
            self._stop_at = iteration + self.num_iterations
            return
        if self._active and iteration >= self._stop_at:
            self._finish(model, iteration)

    def _stop_safely(self):
        """Stop the running profile; a stop that fails (the profile was
        stopped elsewhere) is a no-op by contract. Returns the stopped
        profile, or None."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        try:
            prof.stop()
            return prof
        except Exception:   # noqa: BLE001 -- a double stop must not raise
            return None

    def _finish(self, model, iteration):
        # _active goes first: a later close() or __del__ must not stop
        # again, and the stop runs in a finally so that a failed sync
        # (a device error) cannot strand the profile
        self._active = False
        try:
            if model is not None:
                self._sync(model)
        finally:
            prof = self._stop_safely()
        path = os.path.join(self.log_dir,
                            f"trace_{self._first}_{iteration}.json")
        try:
            if prof is None:
                raise RuntimeError("the profile was not running")
            os.makedirs(self.log_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:   # noqa: BLE001 -- logged, never raised
            self.log_fn(f"profiler capture to {self.log_dir} was NOT "
                        f"finalized: {type(e).__name__}: {e}")
            return
        self.captured = True
        self.trace_dir = self.log_dir
        self.trace_path = path
        self.log_fn(f"profiler trace captured to {path} (iterations "
                    f"{self._first}..{iteration})")

    def close(self, model=None):
        """Finish a capture that training ended inside its window. A
        second close, or one without a start, is a no-op."""
        if self._active:
            self._finish(model, self._stop_at)

    def __del__(self):
        if getattr(self, "_active", False):
            self._active = False
            self._stop_safely()


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
