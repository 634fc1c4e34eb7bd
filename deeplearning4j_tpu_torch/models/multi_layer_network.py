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
and layouts; :func:`params_from_numpy`, :func:`states_from_numpy` and
:func:`updater_state_from_numpy` carry a JAX net's parameters, layer state
and updater state across, and ``params()``
/``set_params()`` use the reference's flat vector. The network runs on
the card unless the caller passes ``device="cpu"``; its randomness (init,
dropout) comes from one ``torch.Generator`` seeded with ``conf.seed``.
The per-batch step's body, the flat parameter API and ``fit(iterator)``'s
loop are ComputationGraph's too (``models/_layered.py``).

Not ported yet (ROADMAP.md, queue 1): line-search solvers, pretraining
and the fusion autotuner.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, StackedDataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._device_state import nanguard_enabled
from deeplearning4j_tpu_torch.models._layered import (LayeredModel, host,
                                                      is_carry_layer, leaves,
                                                      tensor_leaves)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.core import (BaseOutputLayer,
                                                     EmbeddingLayer,
                                                     LossLayer)
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["MultiLayerNetwork", "params_from_numpy", "states_from_numpy",
           "updater_state_from_numpy"]

_OBS_GROUP_SECONDS = obs.histogram(
    "train.dispatch_group_seconds",
    "Host wall-clock of one fused dispatch group (its windows' graph "
    "replays and their input copies)")
_OBS_STEPS = obs.counter("train.steps_total",
                         "Real (non-padding) parameter updates dispatched")
_OBS_GROUPS = obs.counter("train.dispatch_groups_total",
                          "Fused dispatch groups (fit_fused calls)")


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
        out.append(leaves(p, dev))
    return out


def states_from_numpy(layers, states_list, device=None):
    """The port's layer state from a JAX net's ``states_list`` given as
    dicts of numpy arrays (BatchNormalization's running ``mean``/``var``,
    CenterLossOutputLayer's ``centers``). Keys and shapes are checked
    against each layer's ``init_state``."""
    dev = resolve_device(device)
    out = []
    for layer, s in zip(layers, states_list):
        want = {k: tuple(v.shape) for k, v in layer.init_state().items()}
        got = {k: tuple(np.shape(v)) for k, v in s.items()}
        if got != want:
            raise ValueError(f"{type(layer).__name__}: state {got} does "
                             f"not match its shapes {want}")
        out.append({k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                    for k, v in s.items()})
    return out


def updater_state_from_numpy(updater_states, device=None):
    """The port's updater state from a JAX net's ``updater_states``
    (per layer ``{rule key: {param name: array}}``, e.g. rmsprop's
    ``{"r": {...}}``), so that a JAX run continues in the port."""
    dev = resolve_device(device)
    return [{key: {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                   for k, v in sub.items()} for key, sub in s.items()}
            for s in updater_states]


def _rebuild(tree, leaves_iter):
    """``tree``'s containers around the tensors drawn from
    ``leaves_iter``, in :func:`tensor_leaves` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves_iter) for k in sorted(tree)}
        return {k: out[k] for k in tree}   # the tree's own key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves_iter) for v in tree)
    return next(leaves_iter) if isinstance(tree, torch.Tensor) else tree


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


class MultiLayerNetwork(LayeredModel):
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
        self.params_list = [leaves(l.init_params(g), self.device)
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

    def get_layer_params(self, i):
        """Copies of layer ``i``'s parameters."""
        return {k: v.detach().clone() for k, v in self.params_list[i].items()}

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
            elif carries is not None and is_carry_layer(layer):
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
            # embedding ids stay exact (bf16 would round ids above 256)
            if x.is_floating_point() and \
                    not isinstance(self.layers[0], EmbeddingLayer):
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
                   if is_carry_layer(layer) else None
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
                "the generator on the device yet (ROADMAP.md, queue 1, "
                "\"The fused loop's remaining pieces\": dropout inside the "
                "captured step); fit() keeps such models on the per-batch "
                "path")
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
                "package yet (ROADMAP.md, queue 1, \"Pretraining\")")
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
        if hasattr(data, "__iter__"):
            return self._fit_iterator(data, epochs, every, ck_dir, keep,
                                      resume_from)
        raise ValueError(f"Cannot fit on {type(data)}")

    def _fit_item(self, ds, use_ew):
        """One item of ``fit(iterator)``'s stream: a ``StackedDataSet``
        through ``fit_fused``, any other batch through ``fit_batch`` (with
        unit example weights where the run is bucketed, so a row-padded
        ragged batch takes the same path). Returns the real batches."""
        if isinstance(ds, StackedDataSet):
            self.fit_fused(ds)
            return ds.n_steps
        ew = getattr(ds, "example_weights", None)
        if (ew is None and use_ew and ds.features_mask is None
                and ds.labels_mask is None):
            ew = np.ones(int(ds.features.shape[0]), np.float32)
        for _ in range(self.conf.iterations):
            self.fit_batch(ds.features, ds.labels, ds.features_mask,
                           ds.labels_mask, ew=ew)
        return 1

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
            return host(acts[-1])

    def feed_forward(self, x, train=False):
        """All layer activations, input first, as host numpy."""
        x = self._tensor(x)
        rngs = [self._rng] * len(self.layers) if train else None
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_layers(
                self.params_list, self.states_list, x, train=train,
                rngs=rngs, fmask=None)
        return [host(a) for a in acts]

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
        return host(flat_params.params_to_vector(self.layers,
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
                if is_carry_layer(l) else None for l in self.layers]
        with torch.no_grad():
            acts, _, _, _, self._rnn_carries = self._forward_layers(
                self.params_list, self.states_list, x, train=False,
                rngs=None, fmask=None, carries=self._rnn_carries)
        out = host(acts[-1])
        return out[:, 0] if single and out.ndim == 3 else out

    # ------------------------------------------------------------------
    # evaluation / misc
    # ------------------------------------------------------------------
    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in iterator:
            out = self.output(ds.features)
            ev.eval(host(ds.labels), out,
                    mask=None if ds.labels_mask is None
                    else host(ds.labels_mask))
        return ev

    def clone(self):
        """An independent copy: parameters, layer and updater state,
        iteration and generator state."""
        net = MultiLayerNetwork(self.conf, device=self.device)
        net.params_list = [leaves(p, self.device) for p in self.params_list]
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
