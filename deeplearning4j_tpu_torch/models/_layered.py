"""The training body MultiLayerNetwork and ComputationGraph share.

Both models keep their layers in a flat order (``layers``: the sequence's
order, or the graph's topological order over its layer vertices) with
three lists beside it: ``params_list`` (per-layer dicts of f32 leaves),
``states_list`` (layer state, BatchNormalization's running moments) and
``updater_states`` (the updater rule's state). Over these this module
holds one copy of:

- the per-batch train step: the dropout keys, loss and gradients
  (``torch.autograd.grad`` through the model's ``_loss_fn``), and the
  update (:meth:`LayeredModel._apply_update`): each layer's updater rule
  written in place, the tBPTT carries detached, the iteration and draw
  counters, and the non-finite guard's select-revert and skipped
  counter;
- the fused loop (``fit_fused``): a ``StackedDataSet`` (or a graph's
  ``StackedMultiDataSet``) one window step at a time over static tensors
  updated in place (:class:`_FusedLoop`); on the card each window
  signature is captured once in a CUDA graph (:class:`_WindowGraph`) and
  replayed, on the CPU the same function is called directly; with the
  fusion autotuner armed, ``tuning/autotuner.py`` plans the chunks;
- layer-wise pretraining's step (``_pretrain_loop``): a pretrain
  layer's ``pretrain_grads`` on the activations below it and its updater
  rule, in place, drawing from the model's pretrain generator;
- the line-search solvers' plumbing (``_fit_batch_solver``): the flat
  parameter vector through ``optimize/solvers.py``, the layer state fixed
  during the line searches and refreshed once after;
- remat through ``torch.utils.checkpoint``;
- the flat parameter API (``params()``, ``set_params()``);
- ``fit(iterator)``'s loop: the prefetch wrap, the resume cursor, the
  periodic checkpoints and the guard's flush at the end. What a batch
  does is each model's own (``_fit_item``);
- the per-batch step under a sharding plan that spans ranks
  (``_shard_plan``, ``parallel/sharding_core.py``): at ZeRO level 3 the
  parameters and layer state gathered whole for the forward; the loss
  over the global batch (:func:`global_denominator`; BatchNormalization
  takes the global moments); the gradients and the loss reduced over
  the ranks, reduce-scattered to shards at levels 2-3; the guard's
  finite check and the gradient norms over the reduced, whole leaves;
  each layer's updater rule on this rank's shard of its leaves; the
  updated shards gathered back onto whole parameters at levels 1-2. The
  line-search solvers and layer-wise pretraining run on whole trees under
  a plan, their losses and gradients the mean over the ranks. The fused
  loop runs without a plan or at width 1 only.

Dropout draws no generator: each layer's mask is a pure function of
``conf.seed``, the model's device int64 draw counter, the layer's index
and the element's index (``ops/random.py``). Every update advances the
counter, and the guard's select-revert puts it back with the parameters
where the step is not kept, so a rejected step's successor draws the
same masks, a remat recomputation draws the masks of its first run, and
the per-batch and fused paths draw the same masks. No step reads the
device on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator, default_stage)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSetIterator,
                                                       MultiDataSetIterator)
from deeplearning4j_tpu_torch.models._device_state import (
    DeviceStateMixin, nanguard_enabled, step_all_finite, uses_dropout, whole)
from deeplearning4j_tpu_torch.nn.layers.pretrain import RowShare
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.ops.random import DropoutKey
from deeplearning4j_tpu_torch.parallel.sharding_core import (
    current_batch_plan, global_batch)
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.tuning import autotuner
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["LayeredModel", "clone_tree", "global_denominator", "host",
           "is_carry_layer", "leaves", "tensor_leaves", "whole"]

_OBS_GROUP_SECONDS = obs.histogram(
    "train.dispatch_group_seconds",
    "Host wall-clock of one fused dispatch group (its windows' graph "
    "replays and their input copies)")
_OBS_STEPS = obs.counter("train.steps_total",
                         "Real (non-padding) parameter updates dispatched")
_OBS_GROUPS = obs.counter("train.dispatch_groups_total",
                          "Fused dispatch groups (fit_fused calls)")

# warm-up calls of a window step on a side stream before its capture
_GRAPH_WARMUP = 2


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


def global_denominator(rows, ew):
    """(denominator, scale) of a layer model's loss: the loss is the sum
    of the per-example losses times ``scale`` over ``denominator``, plus
    the l1/l2 term over ``denominator``. Alone that is the batch's rows
    (or the real examples' weight, ``ew``'s sum) and 1. In a train step
    under a plan of N ranks (``current_batch_plan``) it is the global
    batch's: N times the rows (every rank holds as many), or the weights
    summed over the ranks with the data term scaled by N, so that the
    mean of the ranks' losses is the global batch's loss and counts the
    l1/l2 term once."""
    plan = current_batch_plan()
    n = 1 if plan is None else plan.n
    if ew is None:
        return rows * n, 1
    wsum = ew.sum() if plan is None else plan.all_reduce_sum(ew.sum())
    return torch.clamp(wsum, min=1.0), n


def _captures_graphs(t):
    """Whether window steps on ``t``'s device run as captured CUDA graphs
    (the card) or as direct calls of the same function (the CPU)."""
    return t.is_cuda


def _rebuild(tree, leaves_iter):
    """``tree``'s containers around the tensors drawn from
    ``leaves_iter``, in :func:`tensor_leaves` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves_iter) for k in sorted(tree)}
        return {k: out[k] for k in tree}   # the tree's own key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves_iter) for v in tree)
    return next(leaves_iter) if isinstance(tree, torch.Tensor) else tree


def clone_tree(tree):
    """A copy of nested dicts/lists of tensors, each tensor cloned."""
    return _rebuild(tree, iter([t.detach().clone()
                                for t in tensor_leaves(tree)]))


class _WindowGraph:
    """One window signature of the fused loop: static input buffers (one
    per feature and label stream) and, on the card, the CUDA graph of the
    window step over them. Warm-up and capture run with an all-zero
    ``ew``, so that the padding-step revert leaves every state as it was;
    every real window fills x, y and ew and replays."""

    def __init__(self, xw, yw, ew):
        self.x = [torch.empty_like(a, memory_format=torch.contiguous_format)
                  for a in xw]
        self.y = [torch.empty_like(a, memory_format=torch.contiguous_format)
                  for a in yw]
        self.ew = torch.zeros_like(ew)
        self.graph = None

    def fill(self, xw, yw):
        for dst, src in zip(self.x + self.y, list(xw) + list(yw)):
            dst.copy_(src)

    def capture(self, step):
        """Warm ``step`` up on a side stream, then capture it. A failed
        capture raises: there is no eager fallback on the card."""
        dev = self.ew.device
        self.ew.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_GRAPH_WARMUP):
                step(self)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(self)
        self.graph = graph


class _FusedLoop:
    """The static tensors the fused window step reads and writes in place,
    and its window graphs (one per signature; ``captures`` counts them).

    The graphs point at the tensors they were captured over, so those are
    kept: :meth:`bind` copies a rebound value (``init``,
    ``reset_updater_state``, ``set_params``, a restore) into the bound
    tensor and points the model back at it. The graph cache stays valid;
    a new model (``clone``) starts its own."""

    def __init__(self, device):
        self.device = device
        self.bound = {}        # model attribute -> the tensors bound
        self.iteration = torch.zeros((), dtype=torch.int32, device=device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=device)
        self.draws = torch.zeros((), dtype=torch.int64, device=device)
        self.score = torch.zeros((), dtype=torch.float32, device=device)
        self.last_grads = None
        self.carries = {}      # (batch, dtype) -> (flat buffer, views)
        self.graphs = {}       # window signature -> _WindowGraph
        self.captures = 0

    def bind(self, net):
        """Point ``net`` at the bound tensors, copying in any value it was
        given since the last group."""
        for attr in ("params_list", "updater_states", "states_list"):
            tree = getattr(net, attr)
            cur = tensor_leaves(tree)
            bound = self.bound.setdefault(attr, cur)
            if len(cur) != len(bound):
                raise RuntimeError(f"the model's {attr} changed structure "
                                   "under the fused loop")
            if any(c is not b for c, b in zip(cur, bound)):
                with torch.no_grad():
                    for c, b in zip(cur, bound):
                        if c is not b:
                            b.copy_(c)
                setattr(net, attr, _rebuild(tree, iter(bound)))
        if self.last_grads is None:
            self.last_grads = [{k: torch.zeros_like(v).detach()
                                for k, v in p.items()}
                               for p in net.params_list]
        with torch.no_grad():
            it = net._device_iteration()
            if it is not self.iteration:
                self.iteration.copy_(it)
                net._iter_dev = self.iteration
            sk = net._nan_skipped_arg()
            if sk is not self.skipped:
                self.skipped.copy_(sk)
                net._nan_skipped = self.skipped
            dc = net._draw_counter_arg()
            if dc is not self.draws:
                self.draws.copy_(dc)
                net._draw_counter = self.draws

    def batch_carries(self, net, batch, dtype):
        """The carries of a batch's windows, zeroed: one flat buffer per
        batch size, (h, c) views per carry layer, None elsewhere."""
        key = (batch, dtype)
        if key not in self.carries:
            widths = [l.n_out if is_carry_layer(l) else 0
                      for l in net.layers]
            flat = torch.zeros(2 * batch * sum(widths), dtype=dtype,
                               device=self.device)
            views, pos = [], 0
            for w in widths:
                if not w:
                    views.append(None)
                    continue
                h = flat[pos:pos + batch * w].view(batch, w)
                c = flat[pos + batch * w:pos + 2 * batch * w].view(batch, w)
                views.append((h, c))
                pos += 2 * batch * w
            self.carries[key] = (flat, views)
        flat, views = self.carries[key]
        flat.zero_()
        return views


class LayeredModel(DeviceStateMixin):
    """The shared part of the two layer models. A subclass sets ``conf``,
    ``layers``, ``device``, the three per-layer lists, ``listeners``,
    ``iteration`` and ``epoch_count``, and defines ``_loss_fn(params_list,
    states_list, x, y, fmask, lmask, rngs, train, carries, ew)``
    (``x``/``y``/masks: tensors, or lists of them for a graph),
    ``_fit_item(ds, use_ew)`` and the fused loop's four hooks
    (``_fused_streams``, ``_poison_step``, ``_tbptt_window_plan``,
    ``_window_xy``)."""

    _last_fuse_stats = None
    _fused = None              # _FusedLoop, made by the first group
    _fuse_autotune = False     # set by fit() while the tuner is armed
    _draw_counter = None       # device int64: the dropout stream
    _solver_runs = None        # solver signature -> run function
    _solver_plan = None        # the plan a solver call reduces over
    _pretrain_gen = None       # torch.Generator of the pretrain layers
    _pretrained = False        # fit() has pretrained this model

    # ---- the sharding plan's trees ---------------------------------------
    def _plan_leaves(self, attr):
        return tensor_leaves(getattr(self, attr))

    def _set_plan_leaves(self, attr, leaves):
        setattr(self, attr, _rebuild(getattr(self, attr), iter(leaves)))

    # ---- parameters ---------------------------------------------------
    def reset_updater_state(self):
        self.updater_states = [
            updaters_mod.init_state(
                l.updater_config(self.conf.max_iterations), p,
                device=self.device)
            for l, p in zip(self.layers, self.params_list)]

    def num_params(self):
        return flat_params.n_params(self.layers)

    def params(self):
        """The flattened parameter vector (reference params()), as numpy."""
        with torch.no_grad(), self._whole():
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

    # ---- the dropout draw counter ---------------------------------------
    def _draw_counter_arg(self):
        if self._draw_counter is None:
            self._draw_counter = torch.zeros((), dtype=torch.int64,
                                             device=self.device)
        return self._draw_counter

    @property
    def dropout_draws(self):
        """The draw counter (reads the device): one a kept update, one a
        solver call. The dropout masks of the next update are a function
        of it."""
        return int(self._draw_counter_arg())

    def set_dropout_draws(self, n):
        """Continue the dropout stream from draw ``n`` (a restore)."""
        with torch.no_grad():
            self._draw_counter_arg().fill_(int(n))

    def _uses_dropout(self):
        return uses_dropout(self.layers)

    def _dropout_keys(self):
        """Each layer's dropout key at the current counter value, or None
        for a model without dropout."""
        if not self._uses_dropout():
            return None
        c = self._draw_counter_arg()
        return [DropoutKey(self.conf.seed, c, i)
                for i in range(len(self.layers))]

    # ---- forward ------------------------------------------------------
    def _layer_forward(self, layer, train, rng):
        """The layer's forward, under ``torch.utils.checkpoint`` when the
        configuration asks for remat. A recomputation reads the same draw
        counter as the first run, so it draws the same dropout masks."""
        def fwd(p, x, s, m):
            return layer.forward(p, x, s, train=train, rng=rng, mask=m)
        if not (self.conf.remat and train):
            return fwd
        return lambda p, x, s, m: checkpoint(fwd, p, x, s, m,
                                             use_reentrant=False)

    # ---- the train step -----------------------------------------------
    def _value_and_grad(self, x, y, fmask, lmask, rngs, train, carries, ew,
                        params_list=None, states_list=None):
        """(score, (new_states, new_carries), grads as a list of dicts) at
        the current parameters (or at ``params_list``/``states_list``)."""
        params_list = self.params_list if params_list is None \
            else params_list
        states_list = self.states_list if states_list is None \
            else states_list
        named = [(i, k, v) for i, p in enumerate(params_list)
                 for k, v in p.items()]
        with torch.enable_grad():
            score, aux = self._loss_fn(params_list, states_list, x, y, fmask,
                                       lmask, rngs, train, carries, ew)
            flat = torch.autograd.grad(score, [v for _, _, v in named],
                                       allow_unused=True)
        grads = [{} for _ in params_list]
        for (i, k, v), g in zip(named, flat):
            grads[i][k] = torch.zeros_like(v) if g is None else g
        return score.detach(), aux, grads

    def _train_step(self, x, y, fmask, lmask, ew, carries):
        """One update, eagerly: the body of the reference's
        ``_build_train_step``; tBPTT ``carries`` are updated in place to
        the ones the next window starts from. Returns (score, grads).
        Under a plan that spans ranks the batch is this rank's share of
        the global batch, and the score returned is the global one."""
        plan = self._dp()
        params_list = states_list = None
        if plan is not None and plan.level >= 3:
            # just-in-time gather of the shards, outside autograd: the
            # explicit reduce-scatter below places the gradients
            params_list = _rebuild(self.params_list, iter(
                [t.requires_grad_(True)
                 for t in self._gathered("params_list")]))
            states_list = _rebuild(self.states_list,
                                   iter(self._gathered("states_list")))
        with global_batch(plan):
            score, (new_states, new_carries), grads = self._value_and_grad(
                x, y, fmask, lmask, self._dropout_keys(), True, carries, ew,
                params_list, states_list)
        if plan is not None:
            flat, (score,) = plan.constrain_grads(
                tensor_leaves(grads), self._dp_axes["params_list"],
                scalars=(score,))
            grads = _rebuild(grads, iter(flat))
        guard = nanguard_enabled()
        self._apply_update(score, grads, new_states, new_carries, carries,
                           guard)
        if guard:
            # the host reads the counter one step late
            self._nanguard_record()
        return score, grads

    def _apply_update(self, score, grads, new_states, new_carries, carries,
                      guard, real=None):
        """The update half of the step, written in place into the
        model's tensors: each layer's updater rule, the tBPTT
        ``carries`` (None without tBPTT) set to the window's final ones
        without their graph, and the iteration and draw counters, all of
        it select-reverted where ``keep`` is false. ``keep`` is ``real``
        (the fused loop's device bool: the window weighs anything) and,
        under the guard, the step's loss and gradients being finite; a
        real, non-finite step bumps the skipped counter. No host read."""
        it = self._device_iteration()
        draws = self._draw_counter_arg()
        plan = self._dp()
        with torch.no_grad():
            keep = real
            if guard:
                ok = step_all_finite(score, grads)
                if plan is not None and plan.level >= 2:
                    # each rank holds shards: finite everywhere or nowhere
                    bad = plan.all_reduce_sum((~ok).to(torch.float32))
                    ok = bad == 0
                keep = ok if real is None else real & ok
                self._nan_skipped_arg().add_(
                    (~ok if real is None else real & ~ok).to(torch.int32))

            def put(old, new):
                old.copy_(new if keep is None
                          else torch.where(keep, new, old))
            confs = [l.updater_config(self.conf.max_iterations)
                     for l in self.layers]
            if plan is None:
                views, shard_grads = self.params_list, grads
            else:
                views, shard_grads, confs = self._shard_update_inputs(
                    plan, grads, confs)
            for conf_u, p, g, s in zip(confs, views, shard_grads,
                                       self.updater_states):
                if not p:
                    continue
                upd, s2 = updaters_mod.compute_updates(conf_u, g, s, it,
                                                       params=p)
                for k in p:
                    put(p[k], p[k] - upd[k])
                for new, old in zip(tensor_leaves(s2), tensor_leaves(s)):
                    put(old, new)
            if plan is not None and plan.level in (1, 2):
                # the updated shards back onto the whole parameters
                axes = self._dp_axes["params_list"]
                whole = plan.gather_params(tensor_leaves(views), axes)
                for p, w, a in zip(tensor_leaves(self.params_list), whole,
                                   axes):
                    if a is not None:
                        p.copy_(w)
            new_leaves = tensor_leaves(new_states)
            if plan is not None and plan.level >= 3:
                # layer state computed whole; this rank keeps its shards
                new_leaves = [plan.shard(t, a) for t, a in zip(
                    new_leaves, self._dp_rest["states_list"])]
            for new, old in zip(new_leaves, tensor_leaves(self.states_list)):
                put(old, new)
            if carries is not None:
                # truncation: the next window starts from these values
                for new, old in zip(tensor_leaves(new_carries),
                                    tensor_leaves(carries)):
                    put(old, new.detach())
            put(it, it + 1)
            put(draws, draws + 1)

    def _shard_update_inputs(self, plan, grads, confs):
        """Under a plan: (parameter views, gradients, updater configs) the
        update loop runs on, each layer's leaves cut to this rank's shard
        where the per-leaf rule shards them (the updater state is held so
        from level 1). Gradient normalization runs first, over whole
        leaves (at levels 2-3 the shards' squared sums are all-reduced),
        and the configs handed on carry none."""
        if plan.level >= 1 and any(c.rule.lower() == "optax:lamb"
                                   for c in confs):
            raise ValueError(
                "optax:lamb's trust ratio takes norms of whole parameter "
                "and update leaves; under a sharding plan it trains at "
                "level 0 (dp_shard=0)")
        axes = iter(self._dp_axes["params_list"])
        layer_axes = [{k: next(axes) for k in sorted(p)}
                      for p in self.params_list]
        if plan.level >= 2:
            sq = updaters_mod.whole_sq_sums(confs, grads, layer_axes, plan)
            grads = [updaters_mod.normalize_gradients(c, g, sq=q)
                     for c, g, q in zip(confs, grads, sq)]
        else:
            grads = [updaters_mod.normalize_gradients(c, g)
                     for c, g in zip(confs, grads)]
        confs = [dataclasses.replace(c, gradient_normalization=None)
                 for c in confs]
        views, shard_grads = [], []
        for p, g, ax in zip(self.params_list, grads, layer_axes):
            if plan.level >= 3:   # the parameters are the shards already
                views.append(p)
            else:
                views.append({k: plan.shard(v, ax[k]) if plan.level >= 1
                              else v for k, v in p.items()})
            shard_grads.append({k: plan.shard(v, ax[k]) if plan.level == 1
                                else v for k, v in g.items()})
        return views, shard_grads, confs

    def _after_update(self, score, grads, batch):
        self.score_ = score   # device scalar; read lazily
        plan = self._dp()
        # at levels 2-3 this rank holds gradient shards only
        self._last_gradients = None if plan is not None and \
            plan.level >= 2 else grads
        self._last_batch_size = int(batch)
        self.iteration += 1
        self._iter_dev_py = self.iteration
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    # ---- layer-wise pretraining ------------------------------------------
    def _pretrain_generator(self):
        """The ``torch.Generator`` the pretrain layers draw from (corruption
        masks, Gibbs samples, the VAE's eps), seeded with ``conf.seed`` on
        the model's device at first use."""
        if self._pretrain_gen is None:
            self._pretrain_gen = torch.Generator(
                device=self.device).manual_seed(self.conf.seed)
        return self._pretrain_gen

    def _pretrain_loop(self, i, data, epochs, layer_input):
        """Pretrain layer ``i`` (the reference's ``pretrain_layer`` /
        ``pretrain_vertex`` body): for each batch, the layer's input from
        ``layer_input(batch)`` under ``torch.no_grad()`` (the layers below
        in inference mode), the layer's ``pretrain_grads``, and its
        updater rule written in place. ``score_`` stays a device scalar and
        the device iteration counter grows with the Python one: no host
        read a batch. A single (Multi)DataSet, labels or not, is one
        batch."""
        if self._uses_solver():
            raise ValueError(
                "layer-wise pretraining runs on the SGD updater path; "
                f"optimization_algo={self.conf.optimization_algo!r} would "
                "be silently ignored. Pretrain with "
                "'stochastic_gradient_descent', then fine-tune with the "
                "line-search solver.")
        layer = self.layers[i]
        if not layer.is_pretrain_layer():
            return self
        plan = self._dp()
        if plan is None:
            return self._pretrain_batches(i, layer, data, epochs,
                                          layer_input, None)
        # under a plan: the trees whole for the pretraining, placed again
        # after it (each a collective every rank of the plan makes)
        self._leave_plan()
        try:
            return self._pretrain_batches(i, layer, data, epochs,
                                          layer_input, plan)
        finally:
            self._enter_plan(plan)

    def _pretrain_batches(self, i, layer, data, epochs, layer_input, plan):
        """The pretraining loop on whole trees. Under ``plan`` each batch
        is this rank's equal share of a global batch: the draws are its
        rows of the global batch's (``RowShare``), and the gradients and
        the score are the mean over the ranks before the rule applies, so
        every rank takes the update one process takes on the global
        batch."""
        conf_u = layer.updater_config(self.conf.max_iterations)
        gen = self._pretrain_generator()
        if plan is not None:
            gen = RowShare(gen, plan.rank, plan.n)
        p, state = self.params_list[i], self.updater_states[i]
        names = sorted(p)
        for _ in range(epochs):
            for ds in data:
                with torch.no_grad():
                    h = layer_input(ds)
                grads, score = layer.pretrain_grads(p, h, gen)
                if plan is not None:
                    flat, (score,) = plan.constrain_grads(
                        [grads[k] for k in names], [None] * len(names),
                        scalars=(score,))
                    grads = dict(zip(names, flat))
                it = self._device_iteration()
                with torch.no_grad():
                    upd, new_state = updaters_mod.compute_updates(
                        conf_u, grads, state, it, params=p)
                    for k in p:
                        p[k].copy_(p[k] - upd[k])
                    for new, old in zip(tensor_leaves(new_state),
                                        tensor_leaves(state)):
                        old.copy_(new)
                    it.add_(1)
                self.score_ = score
                self.iteration += 1
                self._iter_dev_py = self.iteration
        return self

    # ---- the line-search solvers --------------------------------------
    def _uses_solver(self):
        return self.conf.optimization_algo != "stochastic_gradient_descent"

    def _refuse_solver_tbptt(self):
        raise ValueError(
            "truncated BPTT training supports only "
            "'stochastic_gradient_descent'; got optimization_algo="
            f"{self.conf.optimization_algo!r}")

    @staticmethod
    def _solver_signature(x, y, fmask, lmask):
        """The batch part of a solver run's cache key: shapes and dtypes
        of the streams (tensors or lists of them) and the masks'
        presence."""
        def sig(a):
            if isinstance(a, (list, tuple)):
                return tuple(sig(b) for b in a)
            return None if a is None else (tuple(a.shape), str(a.dtype))
        return (sig(x), sig(y), sig(fmask), sig(lmask))

    def _solver_run(self, sig_extra, x0, args):
        """Fetch or build the run function of this batch signature and
        (algorithm, iterations), and run it from ``x0``."""
        from deeplearning4j_tpu_torch.optimize import solvers as solvers_mod
        conf = self.conf
        sig = ("solver", conf.optimization_algo, int(conf.iterations)) \
            + tuple(sig_extra)
        if self._solver_runs is None:
            self._solver_runs = {}
        run = self._solver_runs.get(sig)
        if run is None:
            run = self._solver_runs[sig] = solvers_mod.solver_for(
                conf.optimization_algo).make_run(
                    self._solver_value_and_grad, max(1, conf.iterations),
                    value=self._solver_value)
        vec, score, _hist = run(x0, *args)
        return vec, score

    def _solver_loss(self, vec, x, y, fmask, lmask, keys):
        plist = flat_params.vector_to_params(self.layers, vec)
        score, _ = self._loss_fn(plist, self.states_list, x, y, fmask, lmask,
                                 keys, True, None)
        return score

    def _solver_value_and_grad(self, vec, *args):
        """(loss, flat gradient) at the flat parameter vector ``vec``,
        the layer state held fixed; under a plan, the global batch's (the
        mean over the ranks)."""
        v = vec.detach().requires_grad_(True)
        with torch.enable_grad():
            score = self._solver_loss(v, *args)
            (g,) = torch.autograd.grad(score, [v], allow_unused=True)
        score, g = score.detach(), (torch.zeros_like(v) if g is None else g)
        plan = self._solver_plan
        if plan is not None:
            (g,), (score,) = plan.constrain_grads([g], [None],
                                                  scalars=(score,))
        return score, g

    def _solver_value(self, vec, *args):
        """The loss alone: one forward evaluation (a line-search probe);
        under a plan, the global batch's."""
        with torch.no_grad():
            score = self._solver_loss(vec, *args)
        plan = self._solver_plan
        if plan is not None:
            _, (score,) = plan.constrain_grads([], [], scalars=(score,))
        return score

    def _fit_batch_solver(self, x, y, fmask, lmask):
        """The line-search path (Solver.java:48 → ConjugateGradient, LBFGS,
        LineGradientDescent): ``conf.iterations`` whole-batch solver
        iterations over the flat parameter vector. The layer state stays
        fixed during the line searches (a consistent loss is what makes
        the Armijo probes meaningful) and is refreshed by one forward at
        the final parameters; the dropout masks are those of one counter
        value for the whole call, which then advances the counter once.

        Under a plan of N ranks the batch is this rank's share: the trees
        are whole for the call (placed again after it), and every loss
        and gradient is the global batch's, the mean over the ranks
        (BatchNormalization takes the global moments), so every line
        search reads the same values on every rank and all ranks take the
        same steps. At N = 1 nothing changes."""
        plan = self._dp()
        if plan is None:
            return self._solver_batch(x, y, fmask, lmask)
        self._leave_plan()
        self._solver_plan = plan
        try:
            with global_batch(plan):
                return self._solver_batch(x, y, fmask, lmask)
        finally:
            self._solver_plan = None
            self._enter_plan(plan)

    def _solver_batch(self, x, y, fmask, lmask):
        keys = self._dropout_keys()
        args = (x, y, fmask, lmask, keys)
        x0 = flat_params.params_to_vector(self.layers,
                                          self.params_list).detach()
        vec, score = self._solver_run(self._solver_signature(x, y, fmask,
                                                             lmask), x0, args)
        with torch.no_grad():
            new = flat_params.vector_to_params(self.layers, vec)
            for p, q in zip(tensor_leaves(self.params_list),
                            tensor_leaves(new)):
                p.copy_(q)
        self._refresh_states_after_solver(args)
        with torch.no_grad():
            self._draw_counter_arg().add_(1)
        first = x[0] if isinstance(x, (list, tuple)) else x
        self._post_solver_bookkeeping(score, int(first.shape[0]))
        return score

    def _refresh_states_after_solver(self, args):
        """One forward at the final parameters adopts the layer state it
        computes (BatchNormalization's running moments)."""
        with torch.no_grad():
            _, (new_states, _) = self._loss_fn(
                self.params_list, self.states_list, *args, True, None)
            for new, old in zip(tensor_leaves(new_states),
                                tensor_leaves(self.states_list)):
                old.copy_(new)

    def _post_solver_bookkeeping(self, score, batch_size):
        self.score_ = score
        # the solvers keep no per-layer gradient: gradient() reads None
        self._last_gradients = None
        self._last_batch_size = batch_size
        self.iteration += max(1, self.conf.iterations)
        self._iter_dev = None   # the device counter refreshes next step
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)

    # ---- the fused loop -------------------------------------------------
    def _fused_streams(self, stacked):
        """(feature tensors, label tensors, [K, B] weights) of a stacked
        group on the model's device."""
        raise NotImplementedError

    def _poison_step(self, xs, ys, j):
        """The ``nan-step`` fault's poisoned copy of step ``j``."""
        raise NotImplementedError

    def _tbptt_window_plan(self, xs):
        """``(seg, full windows, remainder)`` of a stacked group, or None
        when it trains standard backprop."""
        raise NotImplementedError

    def _window_xy(self, win):
        """A window's static buffers as ``_loss_fn`` takes them."""
        raise NotImplementedError

    def _fused_carries(self, views):
        """The per-layer carry views as ``_loss_fn`` takes them."""
        return views

    def fit_fused(self, stacked):
        """The real steps of a stacked group ([K, B, ...] streams, [K, B]
        weights, ``n_steps`` real steps leading): each step's windows
        (tBPTT) or whole batch as one window step of the fused loop.
        Padding steps are identity updates by contract, so only the
        ``n_steps`` real ones run; padded rows (weight 0) leave the loss
        through the example weights. Listeners are replayed afterwards,
        one ``iteration_done`` per update. The ``nan-step`` fault fires
        once a group; its param is the step it poisons. With the fusion
        autotuner armed (``fit()`` under ``DL4J_TORCH_FUSE_AUTOTUNE=1``)
        the first full group of an undecided bucket is probed and groups
        are re-chunked to the decided K (``tuning/autotuner.py``)."""
        if self.params_list is None:
            self.init()
        if self._dp() is not None:
            raise ValueError(
                "the fused loop runs unsharded or at width 1; under a plan "
                "of more than one rank train per batch (ParallelWrapper "
                "takes K = 1 there)")
        xs, ys, ews = self._fused_streams(stacked)
        spec = faults.fire("nan-step")
        step = None if spec is None else spec.param_int(0)
        if step is not None and 0 <= step < ews.shape[0]:
            xs, ys = self._poison_step(xs, ys, step)
        guard = nanguard_enabled()
        k = stacked.n_steps
        plan = autotuner.plan_fused(
            self, xs, ys, ews, k, guard,
            autotuner.stacked_bucket_key(stacked)) \
            if self._fuse_autotune else [(xs, ys, ews, k)]
        score = None
        for cxs, cys, cews, ck in plan:
            score = self._fused_dispatch(cxs, cys, cews, ck, guard)
        return score

    def _fused_loop(self):
        if self._fused is None:
            self._fused = _FusedLoop(self.device)
        return self._fused

    def _fused_run(self, xs, ys, ews, n, guard):
        """The first ``n`` steps of a group through the window graphs;
        returns the device scores of their windows and the windows a
        step."""
        plan = self._tbptt_window_plan(xs)
        if plan is None:
            windows = [slice(None)]
        else:
            seg, n_full, rem = plan
            windows = [slice(a, a + seg)
                       for a in range(0, seg * n_full + rem, seg)]
        n_w = len(windows)
        fl = self._fused_loop()
        fl.bind(self)
        scores = torch.empty(n * n_w, dtype=torch.float32, device=self.device)
        for i in range(n):
            x, y, ew = [a[i] for a in xs], [a[i] for a in ys], ews[i]
            carries = None if plan is None else self._fused_carries(
                fl.batch_carries(self, x[0].shape[0], x[0].dtype))
            for j, w in enumerate(windows):
                xw = [a[:, w] if plan is not None and a.ndim == 3 else a
                      for a in x]
                yw = [a[:, w] if plan is not None and a.ndim == 3 else a
                      for a in y]
                self._fused_window(xw, yw, ew, carries, guard)
                scores[i * n_w + j].copy_(fl.score)
        return scores, n_w

    def _fused_window_step(self, win, carries, guard):
        """One window's update, written into the fused loop's static
        tensors in place: loss and gradients, the per-layer update, the
        tBPTT carries detached, and the select-revert of all of it
        (params, layer and updater state, carries, iteration and draw
        counters) where ``keep = real and finite`` (``real``: a row of
        ``win.ew`` weighs more than 0), the skipped counter bumped for a
        real, non-finite step, and the last gradients taken where
        ``real``. No host read: a CUDA graph holds it."""
        fl = self._fused
        x, y = self._window_xy(win)
        score, (new_states, new_carries), grads = self._value_and_grad(
            x, y, None, None, self._dropout_keys(), True, carries, win.ew)
        with torch.no_grad():
            real = (win.ew > 0).any()
            self._apply_update(score, grads, new_states, new_carries,
                               carries, guard, real=real)
            for lg, g in zip(fl.last_grads, grads):
                for k in lg:
                    lg[k].copy_(torch.where(real, g[k], lg[k]))
            fl.score.copy_(score)

    def _fused_window(self, xw, yw, ew, carries, guard):
        """Run one window of the fused loop: fill its signature's static
        inputs and replay its graph (capturing it on first use), or on the
        CPU call the step directly."""
        fl = self._fused
        sig = (tuple((tuple(a.shape), a.dtype) for a in xw),
               tuple((tuple(a.shape), a.dtype) for a in yw),
               carries is not None, guard, xw[0].device)
        win = fl.graphs.get(sig)
        if win is None:
            win = fl.graphs[sig] = _WindowGraph(xw, yw, ew)
        win.fill(xw, yw)
        if _captures_graphs(win.ew):
            if win.graph is None:
                win.capture(lambda w: self._fused_window_step(w, carries,
                                                              guard))
                fl.captures += 1
            win.ew.copy_(ew)
            win.graph.replay()
        else:
            win.ew.copy_(ew)
            self._fused_window_step(win, carries, guard)

    def _fused_dispatch(self, xs, ys, ews, k, guard):
        """The ``k`` real steps of a group through the fused loop, then the
        host bookkeeping: the guard's record (one deferred read a group),
        metrics and span, fresh copies of the scores and last gradients,
        and the listener replay (``k`` times the windows a batch)."""
        t0 = time.perf_counter()
        scores, n_w = self._fused_run(xs, ys, ews, k, guard)
        if guard:
            self._nanguard_record()
        self._last_gradients = [{name: g.clone() for name, g in lg.items()}
                                for lg in self._fused.last_grads]
        ku = k * n_w
        dt = time.perf_counter() - t0
        _OBS_GROUP_SECONDS.record(dt)
        _OBS_GROUPS.inc()
        _OBS_STEPS.inc(ku)
        obs.add_span("fit.dispatch_group", t0, dt, steps=ku)
        it0 = self.iteration
        self._last_batch_size = int(xs[0].shape[1])
        if self.listeners:
            for i in range(ku):
                self.iteration = it0 + i + 1
                self._score = scores[i]
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration)
        self.iteration = it0 + ku
        self._iter_dev_py = self.iteration
        self._score = scores[ku - 1]
        return self._score

    def _fused_probe_dispatch(self, xs, ys, ews, guard):
        """One ZERO-WEIGHT group for the autotuner: every window step
        select-reverts (the padding-step mechanism), so parameters,
        updater and layer state, iteration and draw counters come back
        bit-equal. The last score's read is the timing barrier. Returns
        wall seconds."""
        t0 = time.perf_counter()
        scores, _ = self._fused_run(xs, ys, ews, int(ews.shape[0]), guard)
        float(scores[-1])
        return time.perf_counter() - t0

    # ---- fit(iterator) ------------------------------------------------
    def _fit_item(self, ds, use_ew):
        """Train on one item of the (prefetched) stream; returns the real
        batches it held."""
        raise NotImplementedError

    def _fit_iterator(self, data, epochs, every=0, ck_dir=None, keep=1,
                      resume_from=None):
        """The reference's ``fit(DataSetIterator)``: wrap a plain iterator
        (a DataSetIterator, or a graph's MultiDataSetIterator) in the
        prefetcher with ``fuse_wrap_config``'s grouping (and, with the
        autotuner armed, its bucket resolver) and hand each item to
        ``_fit_item``. A resume skips the cursor's batches in the prefetch
        worker, before grouping, so the groups form as they did in the
        uninterrupted run; checkpoints are committed only between
        dispatches."""
        wrapped = None
        use_ew = False
        self._last_fuse_stats = None
        if isinstance(data, (DataSetIterator, MultiDataSetIterator)) and \
                not isinstance(data, AsyncDataSetIterator):
            fuse, k_resolver, bucket_pad, armed = \
                autotuner.fuse_wrap_config(self)
            self._fuse_autotune = armed
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
            self._fuse_autotune = False
            if wrapped is not None:
                wrapped.shutdown()
                self._last_fuse_stats = wrapped.fuse_stats()
            if obs.tracing.enabled():
                obs.tracing.flush()
        return self
