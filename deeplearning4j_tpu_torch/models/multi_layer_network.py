"""MultiLayerNetwork: the sequential model, the port of
``deeplearning4j_tpu/models/multi_layer_network.py``
(``nn/multilayer/MultiLayerNetwork.java``).

The reference's train step is one jitted program; here the same body runs
eagerly: rng draw, loss and gradients (``torch.autograd.grad``), the
per-layer updater rule, tBPTT carries detached, and the non-finite
guard's select-revert, all on the network's device. ``fit_batch`` takes
one minibatch (tBPTT models: one update per window of
``tbptt_fwd_length`` steps, carries zero at the start of each call);
``fit`` walks a DataSet or an iterator.

``fit(iterator)`` follows the reference's default path: the iterator is
wrapped in an ``AsyncDataSetIterator`` that groups up to
``DL4J_TORCH_FUSE_STEPS`` same-shape batches into a ``StackedDataSet``,
and ``fit_fused`` trains each group. Its unit is a window's whole train
step (a tBPTT window, or the whole batch for standard backprop) written
over static tensors updated in place (:class:`_FusedLoop`): on the card
it is captured once per window signature in a CUDA graph and replayed;
on the CPU the same function is called directly. Masked batches, models
``fuse_allowed`` declines and ``DL4J_TORCH_FUSE_STEPS=1`` keep the
per-batch path. ``fit`` also writes periodic training checkpoints and
resumes from them (``checkpoint_every``, ``checkpoint_dir``,
``resume_from``). Inference: ``output``, ``feed_forward``, ``score``,
``rnn_time_step``, ``evaluate``. Features are [B, F], [B, T, F] or NHWC
[B, H, W, C], as the reference's.

Parameters are per-layer dicts of f32 tensors under the reference's names
and layouts; :func:`params_from_numpy` and :func:`updater_state_from_numpy`
carry a JAX net's parameters and updater state across, and ``params()``
/``set_params()`` use the reference's flat vector. The network runs on
the card unless the caller passes ``device="cpu"``; its randomness (init,
dropout) comes from one ``torch.Generator`` seeded with ``conf.seed``.

Not ported yet (ROADMAP.md, queue 1): line-search solvers, pretraining
and the fusion autotuner.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator, default_stage)
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       StackedDataSet)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._device_state import (
    DeviceStateMixin, nanguard_enabled, step_all_finite, uses_dropout)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import BaseOutputLayer, LossLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.tuning import autotuner
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["MultiLayerNetwork", "params_from_numpy",
           "updater_state_from_numpy"]

_OBS_GROUP_SECONDS = obs.histogram(
    "train.dispatch_group_seconds",
    "Host wall-clock of one fused dispatch group (its windows' graph "
    "replays and their input copies)")
_OBS_STEPS = obs.counter("train.steps_total",
                         "Real (non-padding) parameter updates dispatched")
_OBS_GROUPS = obs.counter("train.dispatch_groups_total",
                          "Fused dispatch groups (fit_fused calls)")


def _leaves(params, device):
    """Trainable f32 leaves on ``device`` from a dict of arrays/tensors."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)))
            .to(device=device, dtype=torch.float32).detach().clone()
            .requires_grad_(True) for k, v in params.items()}


def params_from_numpy(layers, params_list, device=None):
    """The port's parameters from a JAX net's ``params_list`` given as
    dicts of numpy arrays (``[{k: np.asarray(v)} for ...]``). The layouts
    are the same (Dense ``W [n_in, n_out]``, conv ``W`` HWIO, LSTM
    ``W [n_in, 4H]`` and ``RW [H, 4H]`` with gates ``[i, f, g, o]``,
    ``P [3, H]``): nothing is transposed. Keys are checked against each
    layer's ``param_shapes``."""
    dev = resolve_device(device)
    out = []
    for layer, p in zip(layers, params_list):
        shapes = layer.param_shapes()
        if set(p) != set(shapes) or any(
                tuple(np.shape(p[k])) != tuple(s) for k, s in shapes.items()):
            raise ValueError(
                f"{type(layer).__name__}: params "
                f"{ {k: tuple(np.shape(v)) for k, v in p.items()} } do not "
                f"match its shapes {shapes}")
        out.append(_leaves(p, dev))
    return out


def updater_state_from_numpy(updater_states, device=None):
    """The port's updater state from a JAX net's ``updater_states``
    (per layer ``{rule key: {param name: array}}``, e.g. rmsprop's
    ``{"r": {...}}``), so that a JAX run continues in the port."""
    dev = resolve_device(device)
    return [{key: {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                   for k, v in sub.items()} for key, sub in s.items()}
            for s in updater_states]


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _is_carry_layer(layer):
    return isinstance(layer, LSTM) and \
        not isinstance(layer, GravesBidirectionalLSTM)


def _tensor_leaves(tree):
    """The tensors of nested dicts/lists/tuples, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, leaves):
    """``tree``'s containers around the tensors drawn from ``leaves``, in
    :func:`_tensor_leaves` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}   # the tree's own key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves) if isinstance(tree, torch.Tensor) else tree


# warm-up calls of a window step on a side stream before its capture
_GRAPH_WARMUP = 2


def _captures_graphs(t):
    """Whether window steps on ``t``'s device run as captured CUDA graphs
    (the card) or as direct calls of the same function (the CPU)."""
    return t.is_cuda


class _WindowGraph:
    """One window signature of the fused loop: static input buffers and,
    on the card, the CUDA graph of the window step over them. Warm-up and
    capture run with an all-zero ``ew``, so that the padding-step revert
    leaves every state as it was; every real window fills x, y and ew and
    replays."""

    def __init__(self, xw, yw, ew):
        self.x = torch.empty_like(xw, memory_format=torch.contiguous_format)
        self.y = torch.empty_like(yw, memory_format=torch.contiguous_format)
        self.ew = torch.zeros_like(ew)
        self.graph = None

    def capture(self, step):
        """Warm ``step`` up on a side stream, then capture it. A failed
        capture raises: there is no eager fallback on the card."""
        dev = self.x.device
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
    ``reset_updater_state``, ``set_params``) into the bound tensor and
    points the model back at it. The graph cache stays valid; a new model
    (``clone``) starts its own."""

    def __init__(self, device):
        self.device = device
        self.bound = {}        # model attribute -> the tensors bound
        self.iteration = torch.zeros((), dtype=torch.int32, device=device)
        self.skipped = torch.zeros((), dtype=torch.int32, device=device)
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
            cur = _tensor_leaves(tree)
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

    def batch_carries(self, net, batch, dtype):
        """The carries of a batch's windows, zeroed: one flat buffer per
        batch size, (h, c) views per carry layer, None elsewhere."""
        key = (batch, dtype)
        if key not in self.carries:
            widths = [l.n_out if _is_carry_layer(l) else 0
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


class MultiLayerNetwork(DeviceStateMixin):
    def __init__(self, conf: MultiLayerConfiguration, *, device=None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.params_list = None
        self.states_list = None
        self.updater_states = None
        self.iteration = 0
        self.epoch_count = 0
        self.listeners = []
        self._rng = None
        self._rnn_carries = None
        self._last_gradients = None
        self._last_batch_size = None
        self._fused = None            # _FusedLoop, made by the first group
        self._last_fuse_stats = None

    # ------------------------------------------------------------------
    # init & parameter API
    # ------------------------------------------------------------------
    def init(self, params=None):
        """Parameters and updater state (MultiLayerNetwork.init): drawn
        layer by layer from a ``torch.Generator`` seeded with
        ``conf.seed`` on the network's device, which then serves dropout."""
        g = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._rng = g
        self.params_list = [_leaves(l.init_params(g), self.device)
                            for l in self.layers]
        self.states_list = [{k: v.to(self.device)
                             for k, v in l.init_state().items()}
                            for l in self.layers]
        self.reset_updater_state()
        self.iteration = 0
        self._iter_dev = None
        if params is not None:
            self.set_params(params)
        return self

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
            return _host(flat_params.params_to_vector(self.layers,
                                                      self.params_list))

    def set_params(self, vec):
        vec = torch.as_tensor(_host(vec).astype(np.float32)).to(self.device)
        self.params_list = [
            {k: v.requires_grad_(True) for k, v in p.items()}
            for p in flat_params.vector_to_params(self.layers, vec)]

    def get_layer_params(self, i):
        """Copies of layer ``i``'s parameters."""
        return {k: v.detach().clone() for k, v in self.params_list[i].items()}

    def set_listeners(self, listeners):
        self.listeners = list(listeners) \
            if isinstance(listeners, (list, tuple)) else [listeners]

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
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

    def _forward_layers(self, params_list, states_list, x, *, train, rngs,
                        fmask, carries=None):
        """Walk preprocessors and layers; returns (acts, preout,
        new_states, out_mask, new_carries); ``acts[0]`` is the input."""
        acts = [x]
        new_states = []
        new_carries = [None] * len(self.layers) if carries is None \
            else list(carries)
        mask = fmask
        n = len(self.layers)
        preout = None
        for i, layer in enumerate(self.layers):
            pre = self.conf.input_preprocessors.get(i)
            if pre is not None:
                x = pre.pre_process(x, mask)
                mask = pre.feed_forward_mask(mask)
            rng_i = None if rngs is None else rngs[i]
            is_last = i == n - 1
            if is_last and isinstance(layer, BaseOutputLayer):
                x_in = layer.apply_dropout(x, train=train, rng=rng_i)
                preout = layer.pre_output(params_list[i], x_in)
                x = layer.activation_fn()(preout)
                new_states.append(states_list[i])
            elif is_last and isinstance(layer, LossLayer):
                preout = x
                x, s = layer.forward(params_list[i], x, states_list[i],
                                     train=train, rng=rng_i, mask=mask)
                new_states.append(s)
            elif carries is not None and _is_carry_layer(layer):
                x_in = layer.apply_dropout(x, train=train, rng=rng_i)
                carry = new_carries[i]
                if carry is None:
                    carry = layer.initial_carry(x_in.shape[0], x_in.dtype,
                                                x_in.device)
                out, (hf, cf) = layer._scan(params_list[i], x_in, *carry,
                                            mask)
                new_carries[i] = (hf, cf)
                x = out
                new_states.append(states_list[i])
            else:
                x, s = self._layer_forward(layer, train, rng_i)(
                    params_list[i], x, states_list[i], mask)
                new_states.append(s)
            mask = layer.feed_forward_mask(mask)
            acts.append(x)
        return acts, preout, new_states, mask, new_carries

    def _output_layer(self):
        last = self.layers[-1]
        if not isinstance(last, (BaseOutputLayer, LossLayer)):
            raise ValueError("Last layer is not an output/loss layer; no "
                             "loss defined")
        return last

    def _loss_fn(self, params_list, states_list, x, y, fmask, lmask, rngs,
                 train=True, carries=None, ew=None):
        master_params = params_list
        cd = self._compute_dtype()
        if cd is not None:   # mixed precision: forward in cd, f32 loss
            params_list = self._cast_floats(params_list, cd)
            if x.is_floating_point():
                x = x.to(cd)
            if carries is not None:
                carries = self._cast_floats(carries, cd)
        acts, preout, new_states, _, new_carries = self._forward_layers(
            params_list, states_list, x, train=train, rngs=rngs, fmask=fmask,
            carries=carries)
        if cd is not None:
            preout = preout.to(torch.float32)
        out_layer = self._output_layer()
        if ew is None:
            score = out_layer.compute_score(y, preout, mask=lmask,
                                            average=True)
            denom = x.shape[0]
        else:
            # row-padded batch: ``ew`` [batch] zeroes the padding out of
            # the loss; average over the real examples
            denom = torch.clamp(ew.sum(), min=1.0)
            score = out_layer.compute_score(y, preout, mask=ew,
                                            average=False) / denom
        for layer, p in zip(self.layers, master_params):
            if p:
                score = score + updaters_mod.l1_l2_score(
                    p, l1=layer.l1 or 0.0, l2=layer.l2 or 0.0,
                    l1_bias=layer.l1_bias or 0.0,
                    l2_bias=layer.l2_bias or 0.0) / denom
        return score, (new_states, new_carries)

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _uses_dropout(self):
        return uses_dropout(self.layers)

    def _value_and_grad(self, x, y, fmask, lmask, rngs, train, carries, ew):
        """(score, (new_states, new_carries), grads as a list of dicts) at
        the current parameters."""
        leaves = [(i, k, v) for i, p in enumerate(self.params_list)
                  for k, v in p.items()]
        with torch.enable_grad():
            score, aux = self._loss_fn(self.params_list, self.states_list, x,
                                       y, fmask, lmask, rngs, train, carries,
                                       ew)
            flat = torch.autograd.grad(score, [v for _, _, v in leaves],
                                       allow_unused=True)
        grads = [{} for _ in self.params_list]
        for (i, k, v), g in zip(leaves, flat):
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
        network's tensors: each layer's updater rule, the tBPTT
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
                for new, old in zip(_tensor_leaves(s2), _tensor_leaves(s)):
                    put(old, new)
            for new, old in zip(_tensor_leaves(new_states),
                                _tensor_leaves(self.states_list)):
                put(old, new)
            if carries is not None:
                # truncation: the next window starts from these values
                for new, old in zip(_tensor_leaves(new_carries),
                                    _tensor_leaves(carries)):
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

    def _tensor(self, a):
        """``a`` on the network's device (float64 arrays become f32, as
        the reference's default precision makes them)."""
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
                "queue 1)")

    def fit_batch(self, x, y, fmask=None, lmask=None, ew=None):
        """One parameter update on one minibatch (tBPTT models: one update
        per window). Returns the score as a device scalar (also kept as
        ``score_``, read lazily).

        ``ew`` ([batch] example weights) zeroes padded rows out of the
        loss and the gradient (the maskless SGD path only)."""
        if self.params_list is None:
            self.init()
        x, y = self._tensor(x), self._tensor(y)
        if faults.fire("nan-step") is not None:
            # poison this step's float inputs with NaN so the loss and
            # gradients go non-finite and the guard must catch it
            if x.is_floating_point():
                x = torch.full_like(x, float("nan"))
            else:
                y = torch.full_like(y, float("nan"))
        fmask, lmask = self._tensor(fmask), self._tensor(lmask)
        self._check_solver_supported()
        if ew is not None:
            if lmask is not None:
                raise ValueError("example weights (ew) apply only to the "
                                 "maskless SGD path (tBPTT included)")
            ew = self._tensor(ew)
        if self.conf.backprop_type == "tbptt" and x.ndim == 3:
            return self._fit_tbptt(x, y, fmask, lmask, ew)
        score, grads = self._train_step(x, y, fmask, lmask, ew, None)
        self._after_update(score, grads, x.shape[0])
        return score

    def _fit_tbptt(self, x, y, fmask, lmask, ew=None):
        """Truncated BPTT (doTruncatedBPTT): one update per window of
        ``tbptt_fwd_length`` steps, the LSTM carries starting at zero and
        passed on, detached, from window to window."""
        t = x.shape[1]
        seg = self.conf.tbptt_fwd_length
        carries = [layer.initial_carry(x.shape[0], x.dtype, x.device)
                   if _is_carry_layer(layer) else None
                   for layer in self.layers]
        last_score = None
        for start in range(0, t, seg):
            xs = x[:, start:start + seg]
            ys = y[:, start:start + seg] if y.ndim == 3 else y
            fm = None if fmask is None else fmask[:, start:start + seg]
            lm = None if lmask is None else lmask[:, start:start + seg]
            score, grads = self._train_step(xs, ys, fm, lm, ew, carries)
            last_score = score
            self._after_update(score, grads, xs.shape[0])
        self.score_ = last_score
        return last_score

    # ------------------------------------------------------------------
    # the fused loop: a StackedDataSet, one window step at a time over
    # static tensors (a replayed CUDA graph on the card)
    # ------------------------------------------------------------------
    def _tbptt_window_plan(self, xs):
        """The tBPTT window plan ``(seg, full windows, remainder)`` of a
        stacked [K, B, T, F] group, or None when the group trains standard
        backprop; from the configuration and the group's shape only."""
        if self.conf.backprop_type != "tbptt" or xs.ndim != 4:
            return None
        seg = int(self.conf.tbptt_fwd_length)
        t = xs.shape[2]
        return (seg, t // seg, t % seg)

    def _fused_window_step(self, win, carries, guard):
        """One window's update, written into the fused loop's static
        tensors in place: loss and gradients, the per-layer update, the
        tBPTT carries detached, and the select-revert of all of it (params,
        layer and updater state, carries, iteration) where ``keep = real
        and finite`` (``real``: a row of ``win.ew`` weighs more than 0),
        the skipped counter bumped for a real, non-finite step, and the
        last gradients taken where ``real``. No host read: a CUDA graph
        holds it."""
        fl = self._fused
        score, (new_states, new_carries), grads = self._value_and_grad(
            win.x, win.y, None, None, None, True, carries, win.ew)
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
        sig = (tuple(xw.shape), xw.dtype, tuple(yw.shape), yw.dtype,
               carries is not None, guard, xw.device)
        win = fl.graphs.get(sig)
        if win is None:
            win = fl.graphs[sig] = _WindowGraph(xw, yw, ew)
        win.x.copy_(xw)
        win.y.copy_(yw)
        if _captures_graphs(win.x):
            if win.graph is None:
                win.capture(lambda w: self._fused_window_step(w, carries,
                                                              guard))
                fl.captures += 1
            win.ew.copy_(ew)
            win.graph.replay()
        else:
            win.ew.copy_(ew)
            self._fused_window_step(win, carries, guard)

    def fit_fused(self, stacked):
        """The real steps of a ``StackedDataSet`` ([K, B, ...] features and
        labels, [K, B] weights, ``n_steps`` real steps leading): each
        step's windows (tBPTT) or whole batch as one window step of the
        fused loop. Padding steps are identity updates by contract, so
        only the ``n_steps`` real ones run; padded rows (weight 0) leave
        the loss through the example weights. Listeners are replayed
        afterwards, one ``iteration_done`` per update. The ``nan-step``
        fault fires once a group; its param is the step it poisons."""
        if self.params_list is None:
            self.init()
        self._check_solver_supported()
        if self._uses_dropout():
            raise NotImplementedError(
                "fit_fused with dropout: the captured step cannot revert "
                "the generator on the device yet (ROADMAP.md, queue 1 "
                "item 1); fit() keeps such models on the per-batch path")
        xs, ys = self._tensor(stacked.features), self._tensor(stacked.labels)
        ews = self._tensor(stacked.weights)
        spec = faults.fire("nan-step")
        step = None if spec is None else spec.param_int(0)
        if step is not None and 0 <= step < xs.shape[0]:
            if xs.is_floating_point():
                xs = xs.clone()
                xs[step] = float("nan")
            else:
                ys = ys.clone()
                ys[step] = float("nan")
        return self._fused_dispatch(xs, ys, ews, stacked.n_steps,
                                    nanguard_enabled())

    def _fused_dispatch(self, xs, ys, ews, k, guard):
        """The ``k`` real steps of a group through the fused loop, then the
        host bookkeeping: the guard's record (one deferred read a group),
        metrics and span, fresh copies of the scores and last gradients,
        and the listener replay (``k`` times the windows a batch)."""
        t0 = time.perf_counter()
        plan = self._tbptt_window_plan(xs)
        windows = [slice(None)] if plan is None else \
            [slice(a, a + plan[0]) for a in range(0, xs.shape[2], plan[0])]
        n_w = len(windows)
        ku = k * n_w
        if self._fused is None:
            self._fused = _FusedLoop(self.device)
        fl = self._fused
        fl.bind(self)
        scores = torch.empty(ku, dtype=torch.float32, device=self.device)
        for i in range(k):
            x, y, ew = xs[i], ys[i], ews[i]
            carries = None if plan is None else fl.batch_carries(
                self, x.shape[0], x.dtype)
            for j, w in enumerate(windows):
                yw = y[:, w] if plan is not None and y.ndim == 3 else y
                self._fused_window(x[:, w], yw, ew, carries, guard)
                scores[i * n_w + j].copy_(fl.score)
        if guard:
            self._nanguard_record()
        self._last_gradients = [{name: g.clone() for name, g in lg.items()}
                                for lg in fl.last_grads]
        dt = time.perf_counter() - t0
        _OBS_GROUP_SECONDS.record(dt)
        _OBS_GROUPS.inc()
        _OBS_STEPS.inc(ku)
        obs.add_span("fit.dispatch_group", t0, dt, steps=ku)
        it0 = self.iteration
        self._last_batch_size = int(xs.shape[1])
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

    # ------------------------------------------------------------------
    # public training API
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, *, epochs=1, checkpoint_every=None,
            checkpoint_dir=None, resume_from=None):
        """fit(DataSetIterator) / fit(DataSet) / fit(X, y): ``conf.iterations``
        updates per minibatch, ``epochs`` passes over an iterator.

        ``checkpoint_every=N`` (default ``DL4J_TORCH_CKPT_EVERY``) commits
        a TrainingCheckpoint into ``checkpoint_dir`` once at least N
        updates have passed since the last, between dispatches (a batch,
        or a fused group); ``resume_from=dir`` restores the newest good
        checkpoint there (parameters, layer and updater state, generator,
        counters, guard state) and skips the data stream to its cursor,
        so that the resumed run is bitwise the uninterrupted one. Passing
        ``resume_from`` with ``checkpoint_every`` from the first call is
        the whole crash-restart contract: an empty directory starts from
        scratch. Iterator fits only."""
        if self.params_list is None:
            self.init()
        if self.conf.pretrain:
            raise NotImplementedError(
                "layer-wise pretraining is not ported to the PyTorch "
                "package yet (ROADMAP.md, queue 1)")
        if labels is not None:
            data = DataSet(data, labels)
        every, ck_dir, keep = self._resolve_ckpt_args(
            checkpoint_every, checkpoint_dir, resume_from)
        if isinstance(data, DataSet):
            if every or resume_from:
                raise ValueError(
                    "checkpoint_every/resume_from need a data iterator (the "
                    "checkpoint's cursor is a position in a stream); wrap "
                    "the DataSet in an iterator to use them")
            for _ in range(self.conf.iterations):
                self.fit_batch(data.features, data.labels,
                               data.features_mask, data.labels_mask)
            self._nanguard_flush()
            return self
        if isinstance(data, DataSetIterator) or hasattr(data, "__iter__"):
            return self._fit_iterator(data, epochs, every, ck_dir, keep,
                                      resume_from)
        raise ValueError(f"Cannot fit on {type(data)}")

    def _fit_iterator(self, data, epochs, every=0, ck_dir=None, keep=1,
                      resume_from=None):
        """The reference's ``fit(DataSetIterator)``: wrap a plain iterator
        in the prefetcher with ``fuse_wrap_config``'s grouping, route each
        ``StackedDataSet`` to ``fit_fused`` and every other batch to
        ``fit_batch`` (with unit example weights where the run is bucketed,
        so a row-padded ragged batch takes the same path). A resume skips
        the cursor's batches in the prefetch worker, before grouping, so
        the groups form as they did in the uninterrupted run; checkpoints
        are committed only between dispatches."""
        wrapped = None
        use_ew = False
        self._last_fuse_stats = None
        if isinstance(data, DataSetIterator) and \
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
                    if isinstance(ds, StackedDataSet):
                        self.fit_fused(ds)
                        batches += ds.n_steps
                    else:
                        ew = getattr(ds, "example_weights", None)
                        if (ew is None and use_ew and ds.features_mask is None
                                and ds.labels_mask is None):
                            ew = np.ones(int(ds.features.shape[0]),
                                         np.float32)
                        for _ in range(self.conf.iterations):
                            self.fit_batch(ds.features, ds.labels,
                                           ds.features_mask, ds.labels_mask,
                                           ew=ew)
                        batches += 1
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

    # ------------------------------------------------------------------
    # inference / scoring
    # ------------------------------------------------------------------
    def output(self, x, train=False, fmask=None):
        """Inference output (MultiLayerNetwork.output) as host numpy."""
        x, fmask = self._tensor(x), self._tensor(fmask)
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_layers(
                self.params_list, self.states_list, x, train=False,
                rngs=None, fmask=fmask)
            return _host(acts[-1])

    def feed_forward(self, x, train=False):
        """All layer activations, input first, as host numpy."""
        x = self._tensor(x)
        rngs = [self._rng] * len(self.layers) if train else None
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_layers(
                self.params_list, self.states_list, x, train=train,
                rngs=rngs, fmask=None)
        return [_host(a) for a in acts]

    def score(self, dataset: DataSet, train=False):
        """Loss on a dataset without updating params."""
        with torch.no_grad():
            score, _ = self._loss_fn(
                self.params_list, self.states_list,
                self._tensor(dataset.features), self._tensor(dataset.labels),
                self._tensor(dataset.features_mask),
                self._tensor(dataset.labels_mask), None, train=False)
        return float(score)

    def compute_gradient_and_score(self, x, y, fmask=None, lmask=None):
        """Per-layer gradients and score without updating params
        (computeGradientAndScore)."""
        score, _, grads = self._value_and_grad(
            self._tensor(x), self._tensor(y), self._tensor(fmask),
            self._tensor(lmask), None, False, None, None)
        self._last_gradients = grads
        self.score_ = float(score)
        return grads, self.score_

    def gradient(self):
        """Most recent per-layer gradients (Model.gradient())."""
        return self._last_gradients

    def gradient_vector(self):
        if self._last_gradients is None:
            return None
        return _host(flat_params.params_to_vector(self.layers,
                                                  self._last_gradients))

    # ------------------------------------------------------------------
    # rnn stateful inference
    # ------------------------------------------------------------------
    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def rnn_time_step(self, x):
        """Stateful stepping inference (rnnTimeStep): [B, F] for one step
        or [B, T, F]; the LSTM carries persist between calls."""
        x = self._tensor(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = [
                l.initial_carry(x.shape[0], x.dtype, x.device)
                if _is_carry_layer(l) else None for l in self.layers]
        with torch.no_grad():
            acts, _, _, _, self._rnn_carries = self._forward_layers(
                self.params_list, self.states_list, x, train=False,
                rngs=None, fmask=None, carries=self._rnn_carries)
        out = _host(acts[-1])
        return out[:, 0] if single and out.ndim == 3 else out

    # ------------------------------------------------------------------
    # evaluation / misc
    # ------------------------------------------------------------------
    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in iterator:
            out = self.output(ds.features)
            ev.eval(_host(ds.labels), out,
                    mask=None if ds.labels_mask is None
                    else _host(ds.labels_mask))
        return ev

    def clone(self):
        """An independent copy: parameters, layer and updater state,
        iteration and generator state."""
        net = MultiLayerNetwork(self.conf, device=self.device)
        net.params_list = [_leaves(p, self.device) for p in self.params_list]
        net.states_list = [{k: v.clone() for k, v in s.items()}
                           for s in self.states_list]
        net.updater_states = [
            {key: {k: v.clone() for k, v in sub.items()}
             for key, sub in s.items()} for s in self.updater_states]
        net.iteration = self.iteration
        net._rng = torch.Generator(device=self.device)
        net._rng.set_state(self._rng.get_state())
        return net

    def summary(self):
        lines = ["idx  type                        n_params   shapes"]
        for i, l in enumerate(self.layers):
            lines.append(f"{i:<4d} {type(l).__name__:<27s} "
                         f"{l.n_params():<10d} "
                         f"{ {k: v for k, v in l.param_shapes().items()} }")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)
