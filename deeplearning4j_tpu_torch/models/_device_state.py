"""Device-state plumbing of the model classes: the port of the parts of
``deeplearning4j_tpu/models/_device_state.py`` that MultiLayerNetwork's
train path needs.

- ``score_`` is kept as a device scalar and read lazily, so the host loop
  does not wait for the card after every step;
- the iteration counter the updaters read lives on the device (mirrored
  by the Python ``iteration`` listeners see), so a step the non-finite
  guard reverts also reverts it without a host read;
- the non-finite guard (``DL4J_TORCH_NANGUARD``, default on): the step
  computes ``step_all_finite`` on the device and selects the old or the
  new state with ``torch.where``; a device counter, bumped in place,
  counts skipped steps, and the host reads it one dispatch late (a step,
  or a fused group: one read a group, not one a step) and warns for each
  new one;
- the fused loop's gate (:func:`fuse_allowed`);
- mixed precision: ``_compute_dtype``/``_cast_floats``.

Not ported here: the solver plumbing, checkpointing and the guard's
divergence policy (patience, auto-checkpoint), which come with the
checkpoint slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import warnings

import torch

from deeplearning4j_tpu_torch.config import env_flag

__all__ = ["DeviceStateMixin", "fuse_allowed", "nanguard_enabled",
           "step_all_finite", "uses_dropout"]


def nanguard_enabled():
    """Whether the train step carries the non-finite guard
    (``DL4J_TORCH_NANGUARD``, read at each step)."""
    return env_flag("DL4J_TORCH_NANGUARD")


def step_all_finite(score, grads):
    """Device-side all-finite predicate over a step's loss and gradients
    (a list of dicts of tensors): a 0-dim bool tensor, no host read."""
    ok = torch.isfinite(score)
    for layer in grads:
        for g in layer.values():
            ok = ok & torch.isfinite(g).all()
    return ok


def uses_dropout(layers):
    """Whether any layer drops inputs in training."""
    return any((l.dropout or 0.0) not in (0.0, 1.0) for l in layers)


def fuse_allowed(conf, layers):
    """Whether ``fit()`` may train K updates a pass through the fused loop
    for this model: the single-update SGD path only (line-search solvers
    and multi-iteration configs interleave host logic between updates).
    tBPTT fuses unless ``DL4J_TORCH_FUSE_TBPTT=0``, the escape hatch back
    to the host window loop.

    Two differences from the reference's gate: a model with dropout is
    declined (a captured step cannot revert a ``torch.Generator`` on the
    device, and the per-batch path computes the same numbers; ROADMAP.md
    lists dropout inside the captured step), and there is no
    batch-statistics layer to decline yet (BatchNormalization comes with
    the LeNet path)."""
    if (conf.optimization_algo != "stochastic_gradient_descent"
            or conf.iterations != 1):
        return False
    if conf.backprop_type == "tbptt" and not env_flag("DL4J_TORCH_FUSE_TBPTT"):
        return False
    return not uses_dropout(layers)


class DeviceStateMixin:
    """Lazy device-resident ``score_``, the device iteration counter and
    the guard's host side."""

    _score = None
    _iter_dev = None        # device int32 iteration the updaters read
    _iter_dev_py = None     # Python iteration the device counter mirrors
    _nan_skipped = None     # device int32 count of skipped steps
    _nan_pending = None     # counter awaiting the deferred host read
    _nan_seen = 0           # last host-read value of the counter

    @property
    def score_(self):
        s = self._score
        if s is None or isinstance(s, float):
            return s
        s = float(s)   # the only read of the device score; cached
        self._score = s
        return s

    @score_.setter
    def score_(self, value):
        self._score = value

    def _device_iteration(self):
        """The device iteration counter, refreshed from the Python one
        only when that was changed from outside (no copy per step)."""
        if self._iter_dev is None or self._iter_dev_py != self.iteration:
            self._iter_dev = torch.tensor(self.iteration, dtype=torch.int32,
                                          device=self.device)
            self._iter_dev_py = self.iteration
        return self._iter_dev

    def _nan_skipped_arg(self):
        if self._nan_skipped is None:
            self._nan_skipped = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        return self._nan_skipped

    def _nanguard_record(self):
        """After a step or a fused group: keep a copy of the device
        counter (the next dispatch bumps it in place) for the deferred
        read, and read the previous dispatch's copy on the host, so the
        read lands on work the card has finished."""
        pending = self._nan_pending
        self._nan_pending = self._nan_skipped_arg().clone()
        if pending is not None:
            self._nanguard_eval(pending)

    def _nanguard_flush(self):
        """Read the last step's counter (at the end of ``fit``)."""
        pending, self._nan_pending = self._nan_pending, None
        if pending is not None:
            self._nanguard_eval(pending)

    def _nanguard_eval(self, counter):
        cur = int(counter)
        if cur <= self._nan_seen:
            return
        new_bad = cur - self._nan_seen
        self._nan_seen = cur
        warnings.warn(
            f"non-finite loss/gradients: {new_bad} training step(s) "
            f"reverted ({cur} total this run); params and updater state "
            "are untouched by the bad step(s)", RuntimeWarning)

    @property
    def nan_skipped_steps(self):
        """Steps the guard has reverted so far (reads the device)."""
        return 0 if self._nan_skipped is None else int(self._nan_skipped)

    # ---- mixed precision: forward/backward in the compute dtype,
    # float32 parameter and updater masters; the cast happens inside the
    # loss, so autograd gives float32 gradients
    def _compute_dtype(self):
        cd = getattr(self.conf, "compute_dtype", "float32") or "float32"
        return None if cd == "float32" else getattr(torch, cd)

    @staticmethod
    def _cast_floats(tree, dtype):
        """Cast every floating tensor of nested dicts/lists/tuples."""
        if isinstance(tree, dict):
            return {k: DeviceStateMixin._cast_floats(v, dtype)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(DeviceStateMixin._cast_floats(v, dtype)
                              for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(dtype)
        return tree
