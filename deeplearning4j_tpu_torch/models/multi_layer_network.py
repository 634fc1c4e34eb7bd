"""MultiLayerNetwork: the sequential model, the port of
``deeplearning4j_tpu/models/multi_layer_network.py``
(``nn/multilayer/MultiLayerNetwork.java``).

The reference's train step is one jitted program; here the same body runs
eagerly: rng draw, loss and gradients (``torch.autograd.grad``), the
per-layer updater rule, tBPTT carries detached, and the non-finite
guard's select-revert, all on the network's device. ``fit_batch`` takes
one minibatch (tBPTT models: one update per window of
``tbptt_fwd_length`` steps, carries zero at the start of each call);
``fit`` walks a DataSet or an iterator; with ``conf.pretrain`` its first
call pretrains every pretrain layer first (``pretrain``,
``pretrain_layer``: AutoEncoder, RBM, VariationalAutoencoder), once a
net.

``fit(iterator)`` follows the reference's default path: the iterator is
wrapped in an ``AsyncDataSetIterator`` that groups up to
``DL4J_TORCH_FUSE_STEPS`` same-shape batches into a ``StackedDataSet``,
and ``fit_fused`` trains each group. Its unit is a window's whole train
step (a tBPTT window, or the whole batch for standard backprop) written
over static tensors updated in place (:class:`_FusedLoop`): on the card
it is captured once per window signature in a CUDA graph and replayed;
on the CPU the same function is called directly. Masked batches, models
``fuse_allowed`` declines and ``DL4J_TORCH_FUSE_STEPS=1`` keep the
per-batch path; ``DL4J_TORCH_FUSE_AUTOTUNE=1`` picks K per shape bucket
(``tuning/autotuner.py``). ``fit`` also writes periodic training
checkpoints and resumes from them (``checkpoint_every``,
``checkpoint_dir``, ``resume_from``). Inference: ``output``, ``feed_forward``, ``score``,
``rnn_time_step``, ``evaluate``. Features are [B, F], [B, T, F] or NHWC
[B, H, W, C], as the reference's.

Parameters are per-layer dicts of f32 tensors under the reference's names
and layouts; :func:`params_from_numpy`, :func:`states_from_numpy` and
:func:`updater_state_from_numpy` carry a JAX net's parameters, layer state
and updater state across, and ``params()``
/``set_params()`` use the reference's flat vector. The network runs on
the card unless the caller passes ``device="cpu"``; its init draws from a
``torch.Generator`` seeded with ``conf.seed``, its dropout masks from the
counter-based hash of ``ops/random.py`` keyed by ``conf.seed`` and the
device draw counter (``models/_layered.py``). The per-batch step's body,
the fused loop, the line-search solvers' plumbing (``optimization_algo``
``lbfgs``, ``conjugate_gradient``, ``line_gradient_descent``), the flat
parameter API and ``fit(iterator)``'s loop are ComputationGraph's too
(``models/_layered.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, StackedDataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._layered import (
    LayeredModel, clone_tree, global_denominator, host, is_carry_layer,
    leaves, whole)
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
    ``{"r": {...}}``; an optax rule's ``{"optax": [leaves]}`` given as
    the list ``jax.tree.leaves`` makes of its state, dtypes kept), so that
    a JAX run continues in the port."""
    dev = resolve_device(device)

    def sub_state(sub):
        if isinstance(sub, dict):
            return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                    for k, v in sub.items()}
        return [torch.from_numpy(np.array(v)).to(dev) for v in sub]
    return [{key: sub_state(sub) for key, sub in s.items()}
            for s in updater_states]


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
        self._rnn_carries = None
        self._last_gradients = None
        self._last_batch_size = None

    # ------------------------------------------------------------------
    # init & parameter API
    # ------------------------------------------------------------------
    def init(self, params=None):
        """Parameters and updater state (MultiLayerNetwork.init): drawn
        layer by layer from a ``torch.Generator`` seeded with
        ``conf.seed`` on the network's device. The dropout draw counter
        starts at 0."""
        g = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self.params_list = [leaves(l.init_params(g), self.device)
                            for l in self.layers]
        self.states_list = [{k: v.to(self.device)
                             for k, v in l.init_state().items()}
                            for l in self.layers]
        self.reset_updater_state()
        self.iteration = 0
        self._iter_dev = None
        self._draw_counter = None
        if params is not None:
            self.set_params(params)
        return self

    @whole()
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
        denom, scale = global_denominator(x.shape[0], ew)
        if ew is None:
            score = out_layer.compute_score(y, preout, mask=lmask,
                                            average=True)
        else:
            # row-padded batch: ``ew`` [batch] zeroes the padding out of
            # the loss; average over the real examples
            score = out_layer.compute_score(y, preout, mask=ew,
                                            average=False) / denom
            if scale != 1:
                score = score * scale
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
        tbptt = self.conf.backprop_type == "tbptt" and x.ndim == 3
        solver = self._uses_solver()
        if tbptt and solver:
            self._refuse_solver_tbptt()
        if ew is not None:
            if lmask is not None or solver:
                raise ValueError("example weights (ew) apply only to the "
                                 "maskless SGD path (tBPTT included)")
            ew = self._tensor(ew)
        if tbptt:
            return self._fit_tbptt(x, y, fmask, lmask, ew)
        if solver:
            return self._fit_batch_solver(x, y, fmask, lmask)
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
    def _fused_streams(self, stacked):
        return ([self._tensor(stacked.features)],
                [self._tensor(stacked.labels)], self._tensor(stacked.weights))

    def _poison_step(self, xs, ys, j):
        """Step ``j``'s float features (else its labels) set to NaN."""
        (x,), (y,) = xs, ys
        if x.is_floating_point():
            x = x.clone()
            x[j] = float("nan")
        else:
            y = y.clone()
            y[j] = float("nan")
        return [x], [y]

    def _tbptt_window_plan(self, xs):
        """The tBPTT window plan ``(seg, full windows, remainder)`` of a
        stacked [K, B, T, F] group, or None when the group trains standard
        backprop; from the configuration and the group's shape only."""
        x = xs[0]
        if self.conf.backprop_type != "tbptt" or x.ndim != 4:
            return None
        seg = int(self.conf.tbptt_fwd_length)
        t = x.shape[2]
        return (seg, t // seg, t % seg)

    def _window_xy(self, win):
        return win.x[0], win.y[0]

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
        if self.conf.pretrain and not self._pretrained:
            # once a net, then backprop (the reference ignores backprop=False)
            self.pretrain(data if labels is None else DataSet(data, labels))
            self._pretrained = True
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

    # ------------------------------------------------------------------
    # unsupervised layer-wise pretraining (fit:932 -> pretrainLayer:178)
    # ------------------------------------------------------------------
    def pretrain(self, data, epochs=1):
        """Greedy layer-wise pretraining of every pretrain layer, in
        order (MultiLayerNetwork.pretrain)."""
        if self.params_list is None:
            self.init()
        for i, layer in enumerate(self.layers):
            if layer.is_pretrain_layer():
                self.pretrain_layer(i, data, epochs=epochs)
        return self

    def pretrain_layer(self, i, data, epochs=1):
        """Pretrain layer ``i`` on the activations of the layers below it
        (MultiLayerNetwork.pretrainLayer): the input goes through layers
        [0, i) in inference mode, then the layer's own unsupervised update
        runs. ``data``: an iterator, or one DataSet (labels may be None)."""
        if self.params_list is None:
            self.init()
        if isinstance(data, DataSet):
            data = [data]

        def layer_input(ds):
            h = self._tensor(ds.features)
            for j in range(i + 1):
                pre = self.conf.input_preprocessors.get(j)
                if pre is not None:
                    h = pre.pre_process(h, None)
                if j < i:
                    h, _ = self.layers[j].forward(
                        self.params_list[j], h, self.states_list[j],
                        train=False, rng=None, mask=None)
            return h
        return self._pretrain_loop(i, data, epochs, layer_input)

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
    @whole()
    def output(self, x, train=False, fmask=None):
        """Inference output (MultiLayerNetwork.output) as host numpy."""
        x, fmask = self._tensor(x), self._tensor(fmask)
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_layers(
                self.params_list, self.states_list, x, train=False,
                rngs=None, fmask=fmask)
            return host(acts[-1])

    @whole()
    def feed_forward(self, x, train=False):
        """All layer activations, input first, as host numpy."""
        x = self._tensor(x)
        rngs = self._dropout_keys() if train else None
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_layers(
                self.params_list, self.states_list, x, train=train,
                rngs=rngs, fmask=None)
        return [host(a) for a in acts]

    @whole()
    def score(self, dataset: DataSet, train=False):
        """Loss on a dataset without updating params."""
        with torch.no_grad():
            score, _ = self._loss_fn(
                self.params_list, self.states_list,
                self._tensor(dataset.features), self._tensor(dataset.labels),
                self._tensor(dataset.features_mask),
                self._tensor(dataset.labels_mask), None, train=False)
        return float(score)

    @whole()
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

    @whole()
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
    @whole()
    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in iterator:
            out = self.output(ds.features)
            ev.eval(host(ds.labels), out,
                    mask=None if ds.labels_mask is None
                    else host(ds.labels_mask))
        return ev

    @whole("params_list", "states_list", "updater_states")
    def clone(self):
        """An independent copy: parameters, layer and updater state,
        iteration and dropout draw counter."""
        net = MultiLayerNetwork(self.conf, device=self.device)
        net.params_list = [leaves(p, self.device) for p in self.params_list]
        net.states_list = [{k: v.clone() for k, v in s.items()}
                           for s in self.states_list]
        net.updater_states = clone_tree(self.updater_states)
        net.iteration = self.iteration
        net._draw_counter = self._draw_counter_arg().clone()
        return net

    def summary(self):
        lines = ["idx  type                        n_params   shapes"]
        for i, l in enumerate(self.layers):
            lines.append(f"{i:<4d} {type(l).__name__:<27s} "
                         f"{l.n_params():<10d} "
                         f"{ {k: v for k, v in l.param_shapes().items()} }")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)
