"""Device-state plumbing of the model classes: the port of the parts of
``deeplearning4j_tpu/models/_device_state.py`` that the train paths of
MultiLayerNetwork and ComputationGraph need.

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
- the guard's divergence policy: after ``DL4J_TORCH_NANGUARD_PATIENCE``
  consecutive dispatches that each held a reverted step, the model (its
  last good parameters) is written to ``DL4J_TORCH_NANGUARD_CKPT`` and
  ``TrainingDivergedError`` raised;
- ``fit``'s periodic training checkpoints and their resume
  (``utils/training_checkpoint.py``);
- the fused loop's gate (:func:`fuse_allowed`), the reference's;
- mixed precision: ``_compute_dtype``/``_cast_floats``;
- the sharding plan's hook (:class:`PlanStateMixin`): ``_shard_plan``, a
  ``parallel/sharding_core.ShardingCore`` that ``ParallelWrapper``,
  ``TransformerLM.shard`` or a caller injects, and the model's trees at
  their ZeRO placements under it.

The solver plumbing (the reference's ``_solver_run`` and its neighbours)
lives beside the train step in ``models/_layered.py``.
"""

from __future__ import annotations

import contextlib
import functools
import warnings

import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.config import env_flag, env_int, env_str
from deeplearning4j_tpu_torch.errors import TrainingDivergedError
from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization

__all__ = ["DeviceStateMixin", "PlanStateMixin", "fuse_allowed",
           "nanguard_enabled", "step_all_finite", "uses_dropout", "whole"]

_OBS_NONFINITE = obs.counter(
    "train.nonfinite_steps_total",
    "Training steps reverted by the non-finite guard")
_OBS_DIVERGED = obs.counter(
    "train.diverged_total",
    "Fits ended by the guard's divergence policy (TrainingDivergedError)")


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
    for this model (a MultiLayerNetwork or a ComputationGraph): the
    single-update SGD path only (line-search solvers and multi-iteration
    configs interleave host logic between updates), and no layer with
    batch statistics: BatchNormalization's batch moments would see the
    rows that bucketing pads a ragged batch with, and normalize the real
    rows (and move the running moments) otherwise than the per-batch
    loop. tBPTT fuses unless ``DL4J_TORCH_FUSE_TBPTT=0``, the escape hatch
    back to the host window loop. Dropout fuses: its masks come from the
    device draw counter, which the step's select-revert keeps with the
    parameters. The reference's gate, clause for clause."""
    if (conf.optimization_algo != "stochastic_gradient_descent"
            or conf.iterations != 1):
        return False
    if conf.backprop_type == "tbptt" and not env_flag("DL4J_TORCH_FUSE_TBPTT"):
        return False
    return not any(isinstance(l, BatchNormalization) for l in layers)


def whole(*attrs):
    """Decorator of a model method that reads its trees: under a plan
    that shards them at rest (parameters and layer state at level 3;
    ``attrs`` names more, e.g. the updater state) they are gathered whole
    for the call. That is a collective: every rank of the plan calls the
    method."""
    attrs = attrs or ("params_list", "states_list")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with self._whole(attrs):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


class PlanStateMixin:
    """A model's side of a sharding plan. ``_plan_trees`` names the
    model's state trees, each with the plan's spec of its rest placement
    (parameters and layer state shard at level 3, updater state from
    1); a subclass gives ``_plan_leaves(attr)`` (the tree's tensors in a
    fixed order) and ``_set_plan_leaves(attr, leaves)``.

    :meth:`_enter_plan` records each leaf's shard axis under the plan's
    per-leaf rule (``_dp_axes``) and at rest (``_dp_rest``) and keeps
    this rank's shards of the trees the level shards; :meth:`_leave_plan`
    gathers them whole again; :meth:`_whole` gathers them for the length
    of a ``with`` (reads of a level-3 model: inference, the flat
    parameters, a save). Each of the three is a collective: every rank
    of the plan calls it. A plan of width 1 shards nothing and the steps
    skip it (``_dp``)."""

    _shard_plan = None   # parallel/sharding_core.ShardingCore, or None
    _dp_axes = None      # attr -> each leaf's axis under the leaf rule
    _dp_rest = None      # attr -> each leaf's axis at rest (None: whole)
    _dp_whole = False    # inside _whole(): the trees are whole now
    _plan_trees = (("params_list", "param_spec"),
                   ("states_list", "state_spec"),
                   ("updater_states", "updater_spec"))

    def _plan_leaves(self, attr):
        raise NotImplementedError

    def _set_plan_leaves(self, attr, leaves):
        raise NotImplementedError

    def _dp(self):
        """The plan when it spans more than one rank, else None."""
        plan = self._shard_plan
        return plan if plan is not None and plan.n > 1 else None

    def _enter_plan(self, core):
        """Adopt ``core`` (leaving any plan held before): the trees go to
        their rest placements."""
        self._leave_plan()
        self._shard_plan = core
        if core.n == 1:
            return
        self._dp_axes, self._dp_rest = {}, {}
        for attr, spec in self._plan_trees:
            if getattr(self, attr) is None:
                continue
            leaves = self._plan_leaves(attr)
            self._dp_axes[attr] = core.axes(leaves, core.leaf_spec)
            self._dp_rest[attr] = core.axes(leaves, getattr(core, spec))
            self._set_plan_leaves(attr, core.place(leaves,
                                                   self._dp_rest[attr]))

    def _gathered(self, attr):
        """``attr``'s leaves whole (a collective under a plan that shards
        them at rest)."""
        leaves = self._plan_leaves(attr)
        plan = self._dp()
        if plan is None or self._dp_whole or attr not in self._dp_rest:
            return leaves
        return plan.gather_params(leaves, self._dp_rest[attr])

    def _leave_plan(self):
        """Drop the plan, with every tree whole again."""
        if self._dp() is not None:
            for attr in list(self._dp_rest):
                self._set_plan_leaves(attr, self._gathered(attr))
        self._shard_plan = None
        self._dp_axes = self._dp_rest = None

    def _drop_plan(self):
        """Forget the plan without a collective: its process group is
        gone (a peer died, an elastic wave re-formed it). Trees that the
        plan shards at rest hold this rank's shards until a restore
        replaces them."""
        self._shard_plan = None
        self._dp_axes = self._dp_rest = None

    @contextlib.contextmanager
    def _whole(self, attrs=("params_list", "states_list")):
        """Within: ``attrs`` hold whole tensors (gathered copies where the
        plan shards them at rest; the shards come back after)."""
        plan = self._dp()
        swap = [] if plan is None or self._dp_whole else \
            [a for a in attrs if a in self._dp_rest
             and any(x is not None for x in self._dp_rest[a])]
        if not swap:
            yield
            return
        saved = {a: self._plan_leaves(a) for a in swap}
        for a in swap:
            self._set_plan_leaves(a, self._gathered(a))
        self._dp_whole = True
        try:
            yield
        finally:
            self._dp_whole = False
            for a in swap:
                self._set_plan_leaves(a, saved[a])


class DeviceStateMixin(PlanStateMixin):
    """Lazy device-resident ``score_``, the device iteration counter and
    the guard's host side."""

    _score = None
    _iter_dev = None        # device int32 iteration the updaters read
    _iter_dev_py = None     # Python iteration the device counter mirrors
    _nan_skipped = None     # device int32 count of skipped steps
    _nan_pending = None     # counter awaiting the deferred host read
    _nan_seen = 0           # last host-read value of the counter
    _nan_bad_consec = 0     # consecutive dispatches with a reverted step

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
        """The policy over one dispatch's counter: warn for new reverted
        steps, and after ``DL4J_TORCH_NANGUARD_PATIENCE`` consecutive
        dispatches with one, write the model (whose parameters the
        reverted steps never touched) to ``DL4J_TORCH_NANGUARD_CKPT`` and
        raise ``TrainingDivergedError``."""
        cur = int(counter)
        if cur <= self._nan_seen:
            self._nan_bad_consec = 0
            return
        new_bad = cur - self._nan_seen
        self._nan_seen = cur
        self._nan_bad_consec += 1
        _OBS_NONFINITE.inc(new_bad)
        warnings.warn(
            f"non-finite loss/gradients: {new_bad} training step(s) "
            f"reverted ({cur} total this run); params and updater state "
            "are untouched by the bad step(s)", RuntimeWarning)
        if self._nan_bad_consec >= env_int("DL4J_TORCH_NANGUARD_PATIENCE",
                                           minimum=1):
            from deeplearning4j_tpu_torch.utils import model_serializer
            path = env_str("DL4J_TORCH_NANGUARD_CKPT")
            try:
                model_serializer.write_model(self, path)
                saved = f"last good params written to {path!r}"
            except Exception as exc:   # the raise below must still happen
                saved = f"writing the model to {path!r} FAILED: {exc!r}"
            _OBS_DIVERGED.inc()
            raise TrainingDivergedError(
                f"training diverged: {self._nan_bad_consec} consecutive "
                f"dispatches held non-finite steps ({cur} steps skipped "
                f"in all); {saved}")

    # ---- periodic training checkpoints of fit() and their resume
    def _resolve_ckpt_args(self, checkpoint_every, checkpoint_dir,
                           resume_from):
        """(every, directory, keep) of a fit call: the argument wins over
        ``DL4J_TORCH_CKPT_EVERY``; the directory falls back to
        ``resume_from`` (a crash-restart loop passes only that)."""
        every = env_int("DL4J_TORCH_CKPT_EVERY", minimum=0) \
            if checkpoint_every is None else max(0, int(checkpoint_every))
        directory = checkpoint_dir or resume_from
        if every and not directory:
            if checkpoint_every is not None:
                raise ValueError(
                    "checkpoint_every requires a checkpoint_dir (or "
                    "resume_from) to write the checkpoints into")
            # the knob is only the cadence's default: a fit that names no
            # directory did not ask for checkpoints
            every = 0
        return every, directory, env_int("DL4J_TORCH_CKPT_KEEP", minimum=1)

    def _save_fit_checkpoint(self, directory, epoch, batch, keep):
        """One periodic checkpoint between dispatches. The guard's pending
        read is flushed first, so that the saved guard counters agree with
        the saved parameters (the flush may raise the divergence policy
        instead)."""
        from deeplearning4j_tpu_torch.utils import training_checkpoint
        with obs.span("fit.checkpoint_commit"):
            self._nanguard_flush()
            return training_checkpoint.save_training_checkpoint(
                self, directory, cursor={"epoch": int(epoch),
                                         "batch": int(batch)}, keep=keep)

    def _resume_fit_checkpoint(self, directory):
        """Restore the newest loadable TrainingCheckpoint of ``directory``
        into this net and return its data cursor, or None when the
        directory holds none yet (a fresh run)."""
        from deeplearning4j_tpu_torch.utils import training_checkpoint
        return training_checkpoint.resume_latest(self, directory)

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
