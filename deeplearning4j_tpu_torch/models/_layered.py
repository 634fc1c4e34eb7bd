"""The training body MultiLayerNetwork and ComputationGraph share.

Both models keep their layers in a flat order (``layers``: the sequence's
order, or the graph's topological order over its layer vertices) with
three lists beside it: ``params_list`` (per-layer dicts of f32 leaves),
``states_list`` (layer state, BatchNormalization's running moments) and
``updater_states`` (the updater rule's state). Over these this module
holds one copy of:

- the per-batch train step: the rng draw, loss and gradients
  (``torch.autograd.grad`` through the model's ``_loss_fn``), and the
  update (:meth:`LayeredModel._apply_update`): each layer's updater rule
  written in place, the tBPTT carries detached, the iteration counter,
  and the non-finite guard's select-revert and skipped counter;
- remat through ``torch.utils.checkpoint``;
- the flat parameter API (``params()``, ``set_params()``);
- ``fit(iterator)``'s loop: the prefetch wrap, the resume cursor, the
  periodic checkpoints and the guard's flush at the end. What a batch
  does is each model's own (``_fit_item``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator, default_stage)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSetIterator,
                                                       MultiDataSetIterator)
from deeplearning4j_tpu_torch.models._device_state import (
    DeviceStateMixin, nanguard_enabled, step_all_finite, uses_dropout)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.tuning import autotuner
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["LayeredModel", "host", "is_carry_layer", "leaves",
           "tensor_leaves"]


def leaves(params, device):
    """Trainable f32 leaves on ``device`` from a dict of arrays/tensors."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)))
            .to(device=device, dtype=torch.float32).detach().clone()
            .requires_grad_(True) for k, v in params.items()}


def host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def is_carry_layer(layer):
    """A layer whose (h, c) carry crosses tBPTT windows and
    ``rnn_time_step`` calls."""
    return isinstance(layer, LSTM) and \
        not isinstance(layer, GravesBidirectionalLSTM)


def tensor_leaves(tree):
    """The tensors of nested dicts/lists/tuples, in a fixed order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class LayeredModel(DeviceStateMixin):
    """The shared part of the two layer models. A subclass sets ``conf``,
    ``layers``, ``device``, the three per-layer lists, ``_rng``,
    ``listeners``, ``iteration`` and ``epoch_count``, and defines
    ``_loss_fn(params_list, states_list, x, y, fmask, lmask, rngs, train,
    carries, ew)`` (``x``/``y``/masks: tensors, or lists of them for a
    graph) and ``_fit_item(ds, use_ew)``."""

    _last_fuse_stats = None

    # ---- parameters ---------------------------------------------------
    def reset_updater_state(self):
        self.updater_states = [
            updaters_mod.init_state(
                l.updater_config(self.conf.max_iterations), p)
            for l, p in zip(self.layers, self.params_list)]

    def num_params(self):
        return flat_params.n_params(self.layers)

    def params(self):
        """The flattened parameter vector (reference params()), as numpy."""
        with torch.no_grad():
            return host(flat_params.params_to_vector(self.layers,
                                                     self.params_list))

    def set_params(self, vec):
        vec = torch.as_tensor(host(vec).astype(np.float32)).to(self.device)
        self.params_list = [
            {k: v.requires_grad_(True) for k, v in p.items()}
            for p in flat_params.vector_to_params(self.layers, vec)]

    def set_listeners(self, listeners):
        self.listeners = list(listeners) \
            if isinstance(listeners, (list, tuple)) else [listeners]

    def _tensor(self, a):
        """``a`` on the model's device (float64 arrays become f32, as the
        reference's default precision makes them)."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            t = a
        else:
            arr = np.asarray(a)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)

    def _check_solver_supported(self):
        algo = self.conf.optimization_algo
        if algo != "stochastic_gradient_descent":
            raise NotImplementedError(
                f"optimization_algo={algo!r}: the line-search solvers are "
                "not ported to the PyTorch package yet (ROADMAP.md, "
                "queue 1, \"Line-search solvers and the optax rules\")")

    # ---- forward ------------------------------------------------------
    def _layer_forward(self, layer, train, rng):
        """The layer's forward, under ``torch.utils.checkpoint`` when the
        configuration asks for remat. A recomputation draws its dropout
        masks from the generator state the first run started from."""
        def fwd(p, x, s, m):
            return layer.forward(p, x, s, train=train, rng=rng, mask=m)
        if not (self.conf.remat and train):
            return fwd
        start = None if rng is None else rng.get_state()

        def replay(p, x, s, m):
            if start is None:
                return fwd(p, x, s, m)
            after = rng.get_state()
            rng.set_state(start)
            try:
                return fwd(p, x, s, m)
            finally:
                if recomputing[0]:
                    rng.set_state(after)
                recomputing[0] = True
        recomputing = [False]
        return lambda p, x, s, m: checkpoint(replay, p, x, s, m,
                                             use_reentrant=False)

    # ---- the train step -----------------------------------------------
    def _uses_dropout(self):
        return uses_dropout(self.layers)

    def _value_and_grad(self, x, y, fmask, lmask, rngs, train, carries, ew):
        """(score, (new_states, new_carries), grads as a list of dicts) at
        the current parameters."""
        named = [(i, k, v) for i, p in enumerate(self.params_list)
                 for k, v in p.items()]
        with torch.enable_grad():
            score, aux = self._loss_fn(self.params_list, self.states_list, x,
                                       y, fmask, lmask, rngs, train, carries,
                                       ew)
            flat = torch.autograd.grad(score, [v for _, _, v in named],
                                       allow_unused=True)
        grads = [{} for _ in self.params_list]
        for (i, k, v), g in zip(named, flat):
            grads[i][k] = torch.zeros_like(v) if g is None else g
        return score.detach(), aux, grads

    def _train_step(self, x, y, fmask, lmask, ew, carries):
        """One update, eagerly: the body of the reference's
        ``_build_train_step``; tBPTT ``carries`` are updated in place to
        the ones the next window starts from. Returns (score, grads)."""
        rng = self._rng if self._uses_dropout() else None
        rng_start = None if rng is None else rng.get_state()
        rngs = None if rng is None else [rng] * len(self.layers)
        score, (new_states, new_carries), grads = self._value_and_grad(
            x, y, fmask, lmask, rngs, True, carries, ew)
        guard = nanguard_enabled()
        self._apply_update(score, grads, new_states, new_carries, carries,
                           guard, rng_start=rng_start)
        if guard:
            # the host reads the counter one step late
            self._nanguard_record()
        return score, grads

    def _apply_update(self, score, grads, new_states, new_carries, carries,
                      guard, real=None, rng_start=None):
        """The update half of the step, written in place into the
        model's tensors: each layer's updater rule, the tBPTT
        ``carries`` (None without tBPTT) set to the window's final ones
        without their graph, and the iteration counter, all of it
        select-reverted where ``keep`` is false. ``keep`` is ``real`` (the
        fused loop's device bool: the window weighs anything) and, under
        the guard, the step's loss and gradients being finite; a real,
        non-finite step bumps the skipped counter. No host read, but one:
        when dropout drew from the generator (``rng_start``, its state
        before the step), the guard decides on the host whether to put it
        back, since a generator cannot be selected on the device."""
        it = self._device_iteration()
        with torch.no_grad():
            keep = real
            if guard:
                ok = step_all_finite(score, grads)
                keep = ok if real is None else real & ok
                self._nan_skipped_arg().add_(
                    (~ok if real is None else real & ~ok).to(torch.int32))

            def put(old, new):
                old.copy_(new if keep is None
                          else torch.where(keep, new, old))
            for layer, p, g, s in zip(self.layers, self.params_list, grads,
                                      self.updater_states):
                if not p:
                    continue
                upd, s2 = updaters_mod.compute_updates(
                    layer.updater_config(self.conf.max_iterations), g, s, it,
                    params=p)
                for k in p:
                    put(p[k], p[k] - upd[k])
                for new, old in zip(tensor_leaves(s2), tensor_leaves(s)):
                    put(old, new)
            for new, old in zip(tensor_leaves(new_states),
                                tensor_leaves(self.states_list)):
                put(old, new)
            if carries is not None:
                # truncation: the next window starts from these values
                for new, old in zip(tensor_leaves(new_carries),
                                    tensor_leaves(carries)):
                    put(old, new.detach())
            put(it, it + 1)
            if guard and rng_start is not None and not bool(ok):
                self._rng.set_state(rng_start)

    def _after_update(self, score, grads, batch):
        self.score_ = score   # device scalar; read lazily
        self._last_gradients = grads
        self._last_batch_size = int(batch)
        self.iteration += 1
        self._iter_dev_py = self.iteration
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    # ---- fit(iterator) ------------------------------------------------
    def _fit_item(self, ds, use_ew):
        """Train on one item of the (prefetched) stream; returns the real
        batches it held."""
        raise NotImplementedError

    def _fit_iterator(self, data, epochs, every=0, ck_dir=None, keep=1,
                      resume_from=None):
        """The reference's ``fit(DataSetIterator)``: wrap a plain iterator
        (a DataSetIterator, or a graph's MultiDataSetIterator) in the
        prefetcher with ``fuse_wrap_config``'s grouping and hand each item
        to ``_fit_item``. A resume skips the cursor's batches in the
        prefetch worker, before grouping, so the groups form as they did
        in the uninterrupted run; checkpoints are committed only between
        dispatches."""
        wrapped = None
        use_ew = False
        self._last_fuse_stats = None
        if isinstance(data, (DataSetIterator, MultiDataSetIterator)) and \
                not isinstance(data, AsyncDataSetIterator):
            fuse, k_resolver, bucket_pad, _ = autotuner.fuse_wrap_config(self)
            use_ew = bucket_pad
            data = wrapped = AsyncDataSetIterator(
                data, queue_size=4, stage=default_stage(), fuse=fuse,
                k_resolver=k_resolver, bucket_pad=bucket_pad,
                device=self.device)
        start_epoch = skip = 0
        if resume_from is not None:
            cursor = self._resume_fit_checkpoint(resume_from)
            if cursor:
                start_epoch = min(int(cursor.get("epoch", 0)), epochs)
                skip = int(cursor.get("batch", 0))
        last_ck = self.iteration
        try:
            for ep in range(start_epoch, epochs):
                # the cursor applies to the first resumed epoch only; the
                # prefetcher skips in its worker, anything else is drained
                to_skip, skip = (skip, 0) if ep == start_epoch else (0, 0)
                batches = to_skip
                if to_skip and wrapped is not None:
                    wrapped.skip_next(to_skip)
                    to_skip = 0
                for ds in data:
                    if to_skip:
                        n = getattr(ds, "n_steps", 1)
                        if n > to_skip:
                            raise ValueError(
                                "the resume cursor does not align with this "
                                "iterator's grouping; resume with the "
                                "iterator configuration the checkpoint was "
                                "written under")
                        to_skip -= n
                        continue
                    batches += self._fit_item(ds, use_ew)
                    if every and self.iteration - last_ck >= every:
                        self._save_fit_checkpoint(ck_dir, ep, batches, keep)
                        last_ck = self.iteration
                for lst in self.listeners:
                    if hasattr(lst, "on_epoch_end"):
                        lst.on_epoch_end(self)
                self.epoch_count += 1
            # the last group's counter must not ride past the fit unread
            self._nanguard_flush()
        finally:
            if wrapped is not None:
                wrapped.shutdown()
                self._last_fuse_stats = wrapped.fuse_stats()
            if obs.tracing.enabled():
                obs.tracing.flush()
        return self

