"""ComputationGraph, the DAG model: the port of
``deeplearning4j_tpu/models/computation_graph.py``
(``nn/graph/ComputationGraph.java``).

The forward walks the vertices in the configuration's topological order:
a layer vertex runs its preprocessor and its layer (an output layer
stops at its preout, which the loss reads; an LSTM vertex carries its
(h, c) across tBPTT windows and ``rnn_time_step`` calls through
``layer._scan``), any other vertex combines its inputs
(``nn/conf/graph.py``). The loss is the sum of every output's loss, plus
l1/l2 over the f32 masters; under a ``compute_dtype`` the forward runs in
it and the preouts go back to f32 before the loss.

The layers are kept in topological order with their parameters, layer
state and updater state as per-layer lists (``params_list``,
``states_list``, ``updater_states``), the MultiLayerNetwork's own form,
so both models share one train step and update body
(``models/_layered.py``): rng draw, loss and gradients, the per-layer
updater rule written in place, the tBPTT carries detached, and the
non-finite guard's select-revert. ``params_map``/``states_map`` (and
``updater_states_map``) give the reference's by-name view; ``params()``
and ``set_params()`` use its flat vector (layers in topological order).

``fit`` takes a (Multi)DataSet, X and y, or an iterator (DataSetIterator
or MultiDataSetIterator), with the periodic checkpoints and resume of the
MultiLayerNetwork. An iterator goes through ``fuse_wrap_config`` as the
MultiLayerNetwork's does: the prefetcher stacks up to
``DL4J_TORCH_FUSE_STEPS`` maskless batches into a ``StackedMultiDataSet``
and ``fit_fused`` trains each group through the shared fused loop (one
captured CUDA graph a window signature on the card; tBPTT windows over
the LSTM vertices included); masked batches keep the per-batch path. The
line-search solvers (``optimization_algo``) share the MultiLayerNetwork's
plumbing too. The graph runs on the card unless the caller passes
``device="cpu"``; its init draws from a ``torch.Generator`` seeded with
``conf.seed``, its dropout masks from the counter-based hash keyed by
``conf.seed`` and the device draw counter.

Layer-wise pretraining (``pretrain``, ``pretrain_vertex``; with
``conf.pretrain``, ``fit``'s first call) shares the MultiLayerNetwork's
step. Data parallelism is the reference's: a sharding plan injected as
``_shard_plan`` (``parallel/sharding_core.py``; ``_enter_plan`` places
the trees) applies in the per-batch step, as ``ParallelWrapper`` applies
it to a MultiLayerNetwork (``models/_layered.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet, MultiDataSet,
                                                       StackedDataSet,
                                                       StackedMultiDataSet)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._layered import (
    LayeredModel, clone_tree, global_denominator, host, is_carry_layer,
    leaves, whole)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    params_from_numpy as _mln_params_from_numpy,
    states_from_numpy as _mln_states_from_numpy,
    updater_state_from_numpy as _mln_updater_state_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import (
    ComputationGraphConfiguration, LayerVertex)
from deeplearning4j_tpu_torch.nn.conf.graph import (
    DuplicateToTimeSeriesVertex, LastTimeStepVertex)
from deeplearning4j_tpu_torch.nn.layers.core import (BaseOutputLayer,
                                                     EmbeddingLayer,
                                                     LossLayer)
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.testing import faults
from deeplearning4j_tpu_torch.utils import flat_params

__all__ = ["ComputationGraph", "params_from_numpy", "states_from_numpy",
           "updater_state_from_numpy"]


def _as_multi(data) -> MultiDataSet:
    if isinstance(data, MultiDataSet):
        return data
    if isinstance(data, DataSet):
        return MultiDataSet(
            [data.features], [data.labels],
            None if data.features_mask is None else [data.features_mask],
            None if data.labels_mask is None else [data.labels_mask])
    raise ValueError(f"Cannot convert {type(data)} to MultiDataSet")


def params_from_numpy(conf, params_map, device=None):
    """The port's parameters ({vertex name: leaves}) from a JAX graph's
    ``params_map`` given as dicts of numpy arrays. The layouts are the
    same (see ``multi_layer_network.params_from_numpy``)."""
    names = conf.layer_names()
    return dict(zip(names, _mln_params_from_numpy(
        conf.layer_confs(), [params_map[n] for n in names], device)))


def states_from_numpy(conf, states_map, device=None):
    """The port's layer state ({vertex name: {key: tensor}}) from a JAX
    graph's ``states_map`` given as dicts of numpy arrays."""
    names = conf.layer_names()
    return dict(zip(names, _mln_states_from_numpy(
        conf.layer_confs(), [states_map[n] for n in names], device)))


def updater_state_from_numpy(conf, updater_states, device=None):
    """The port's updater state ({vertex name: {rule key: {param:
    tensor}}}) from a JAX graph's ``updater_states``."""
    names = conf.layer_names()
    return dict(zip(names, _mln_updater_state_from_numpy(
        [updater_states[n] for n in names], device)))


class ComputationGraph(LayeredModel):
    def __init__(self, conf: ComputationGraphConfiguration, *, device=None):
        self.conf = conf
        self.topological_order = conf.topological_order
        self.layer_names = conf.layer_names()
        self.layers = conf.layer_confs()   # the flattening order
        self._index = {n: i for i, n in enumerate(self.layer_names)}
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
        """Parameters, layer state and updater state, layer vertex by
        layer vertex in topological order, drawn from a
        ``torch.Generator`` seeded with ``conf.seed`` on the graph's
        device. The dropout draw counter starts at 0."""
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

    def _by_name(self, lst):
        return None if lst is None else dict(zip(self.layer_names, lst))

    def _from_names(self, mapping):
        return None if mapping is None else \
            [mapping[n] for n in self.layer_names]

    @property
    def params_map(self):
        """{layer vertex name: parameters} (the reference's form)."""
        return self._by_name(self.params_list)

    @params_map.setter
    def params_map(self, mapping):
        self.params_list = self._from_names(mapping)

    @property
    def states_map(self):
        return self._by_name(self.states_list)

    @states_map.setter
    def states_map(self, mapping):
        self.states_list = self._from_names(mapping)

    @property
    def updater_states_map(self):
        """{layer vertex name: updater state}: the reference's
        ``updater_states``."""
        return self._by_name(self.updater_states)

    @updater_states_map.setter
    def updater_states_map(self, mapping):
        self.updater_states = self._from_names(mapping)

    @whole()
    def get_layer_params(self, name):
        """Copies of a layer vertex's parameters."""
        return {k: v.detach().clone()
                for k, v in self.params_list[self._index[name]].items()}

    # ------------------------------------------------------------------
    # forward over the DAG
    # ------------------------------------------------------------------
    def _forward_graph(self, params_list, states_list, inputs, *, train, rngs,
                       fmasks, carries=None):
        """Walk the vertices in topological order. Returns (acts: name ->
        activation, the inputs included; preouts of the output layers;
        the new layer states, a list; masks: name -> mask; the new
        carries, or None).

        ``carries`` ({LSTM vertex name: (h, c)}, or None) runs the LSTM
        vertices from the given carry and returns their final ones: the
        substrate of tBPTT windows and ``rnn_time_step``
        (ComputationGraph.java:711,770,828)."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        masks = {n: None for n in conf.network_inputs}
        if fmasks is not None:
            masks.update(zip(conf.network_inputs, fmasks))
        preouts = {}
        new_states = list(states_list)
        new_carries = None if carries is None else dict(carries)
        out_set = set(conf.network_outputs)
        for name in self.topological_order:
            v = conf.vertices[name]
            in_names = conf.vertex_inputs[name]
            xs = [acts[i] for i in in_names]
            ms = [masks[i] for i in in_names]
            if not isinstance(v, LayerVertex):
                # a network input named by an RNN vertex takes part
                if isinstance(v, LastTimeStepVertex) and \
                        v.mask_input_name is not None:
                    ms = [masks.get(v.mask_input_name)]
                if (isinstance(v, DuplicateToTimeSeriesVertex)
                        and v.ts_input_name is not None and len(xs) == 1):
                    # one wired input: the time length comes from the
                    # named network input (DuplicateToTimeSeriesVertex.java)
                    xs = xs + [acts[v.ts_input_name]]
                    ms = ms + [masks.get(v.ts_input_name)]
                acts[name] = v.forward(xs, ms)
                masks[name] = v.feed_forward_mask(ms)
                continue
            i = self._index[name]
            layer, p, s = v.layer, params_list[i], states_list[i]
            x, m = xs[0], ms[0]
            if v.preprocessor is not None:
                x = v.preprocessor.pre_process(x, m)
                m = v.preprocessor.feed_forward_mask(m)
            rng_i = None if rngs is None else rngs[i]
            if name in out_set and isinstance(layer, BaseOutputLayer):
                x_in = layer.apply_dropout(x, train=train, rng=rng_i)
                preouts[name] = layer.pre_output(p, x_in)
                acts[name] = layer.activation_fn()(preouts[name])
            elif name in out_set and isinstance(layer, LossLayer):
                preouts[name] = x
                acts[name], new_states[i] = layer.forward(
                    p, x, s, train=train, rng=rng_i, mask=m)
            elif carries is not None and is_carry_layer(layer):
                x_in = layer.apply_dropout(x, train=train, rng=rng_i)
                carry = new_carries.get(name)
                if carry is None:
                    carry = layer.initial_carry(x_in.shape[0], x_in.dtype,
                                                x_in.device)
                acts[name], new_carries[name] = layer._scan(p, x_in, *carry,
                                                            m)
            else:
                acts[name], new_states[i] = self._layer_forward(
                    layer, train, rng_i)(p, x, s, m)
            masks[name] = layer.feed_forward_mask(m)
        return acts, preouts, new_states, masks, new_carries

    def _embedding_fed_inputs(self):
        """Network inputs that an EmbeddingLayer vertex reads (ids, not
        values: no compute-dtype cast)."""
        if getattr(self, "_emb_inputs", None) is None:
            conf = self.conf
            self._emb_inputs = {
                i for name, ins in conf.vertex_inputs.items()
                if isinstance(getattr(conf.vertices.get(name), "layer",
                                      None), EmbeddingLayer)
                for i in ins if i in conf.network_inputs}
        return self._emb_inputs

    def _output_layer(self, name):
        layer = self.conf.vertices[name].layer
        if not isinstance(layer, (BaseOutputLayer, LossLayer)):
            raise ValueError(f"Network output {name!r} is not an "
                             "output/loss layer")
        return layer

    def _loss_fn(self, params_list, states_list, inputs, labels, fmasks,
                 lmasks, rngs, train=True, carries=None, ew=None):
        """(summed output losses + l1/l2 over the f32 masters, (new layer
        states, new carries)). Under a compute dtype the forward runs in
        it; the preouts go back to f32 before the loss."""
        master_params = params_list
        cd = self._compute_dtype()
        if cd is not None:
            params_list = self._cast_floats(params_list, cd)
            # inputs an EmbeddingLayer reads are ids: they stay exact
            skip = self._embedding_fed_inputs()
            inputs = [x.to(cd) if x.is_floating_point() and n not in skip
                      else x for n, x in zip(self.conf.network_inputs,
                                             inputs)]
            if carries is not None:
                carries = self._cast_floats(carries, cd)
        _, preouts, new_states, _, new_carries = self._forward_graph(
            params_list, states_list, inputs, train=train, rngs=rngs,
            fmasks=fmasks, carries=carries)
        if cd is not None:
            preouts = {k: v.to(torch.float32) for k, v in preouts.items()}
        # row-padded batch: zero-weight rows leave every output's loss;
        # average over the real examples (over the global batch in a
        # train step under a plan)
        denom, scale = global_denominator(inputs[0].shape[0], ew)
        score = 0.0
        for i, name in enumerate(self.conf.network_outputs):
            layer = self._output_layer(name)
            if ew is None:
                lm = None if lmasks is None else lmasks[i]
                score = score + layer.compute_score(
                    labels[i], preouts[name], mask=lm, average=True)
            else:
                term = layer.compute_score(
                    labels[i], preouts[name], mask=ew, average=False) / denom
                score = score + (term * scale if scale != 1 else term)
        for layer, p in zip(self.layers, master_params):
            if p:
                score = score + updaters_mod.l1_l2_score(
                    p, l1=layer.l1 or 0.0, l2=layer.l2 or 0.0,
                    l1_bias=layer.l1_bias or 0.0,
                    l2_bias=layer.l2_bias or 0.0) / denom
        return score, (new_states, new_carries)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _tensors(self, arrs):
        return None if arrs is None else [self._tensor(a) for a in arrs]

    def fit_batch(self, mds, ew=None):
        """One update (a tBPTT model: one a window) on one multi-minibatch
        (a MultiDataSet, or a DataSet for a one-input, one-output graph).
        Returns the score as a device scalar (also ``score_``, read
        lazily). ``ew`` ([batch] example weights) zeroes padded rows out
        of the loss (the maskless SGD path only)."""
        if self.params_list is None:
            self.init()
        mds = _as_multi(mds)
        inputs, labels = self._tensors(mds.features), self._tensors(mds.labels)
        if faults.fire("nan-step") is not None:
            # poison the first input, where it is a float one, with NaN so
            # the loss and gradients go non-finite and the guard must act
            if inputs[0].is_floating_point():
                inputs[0] = torch.full_like(inputs[0], float("nan"))
        fmasks = self._tensors(mds.features_masks)
        lmasks = self._tensors(mds.labels_masks)
        tbptt = self.conf.backprop_type == "tbptt" and \
            any(x.ndim == 3 for x in inputs)
        solver = self._uses_solver()
        if tbptt and solver:
            self._refuse_solver_tbptt()
        if ew is not None:
            if lmasks is not None or solver:
                raise ValueError("example weights (ew) apply only to the "
                                 "maskless SGD path (tBPTT included)")
            ew = self._tensor(ew)
        if tbptt:
            return self._fit_tbptt(inputs, labels, fmasks, lmasks, ew)
        if solver:
            return self._fit_batch_solver(inputs, labels, fmasks, lmasks)
        score, grads = self._train_step(inputs, labels, fmasks, lmasks, ew,
                                        None)
        self._after_update(score, grads, inputs[0].shape[0])
        return score

    def _lstm_vertex_names(self):
        return [n for n, l in zip(self.layer_names, self.layers)
                if is_carry_layer(l)]

    def _zero_carries(self, batch, dtype):
        return {n: self.layers[self._index[n]].initial_carry(batch, dtype,
                                                             self.device)
                for n in self._lstm_vertex_names()}

    def _fit_tbptt(self, inputs, labels, fmasks, lmasks, ew=None):
        """Truncated BPTT on the DAG (doTruncatedBPTT,
        ComputationGraph.java:711): one update per window of
        ``tbptt_fwd_length`` steps, the LSTM carries starting at zero and
        passed on, detached, from window to window. Only rank-3 arrays are
        temporal: a static [B, F] or NHWC input goes whole to every
        window."""
        t = max(x.shape[1] for x in inputs if x.ndim == 3)
        seg = self.conf.tbptt_fwd_length

        def slice_time(arrs, start):
            if arrs is None:
                return None
            return [a[:, start:start + seg] if a is not None and a.ndim == 3
                    else a for a in arrs]

        def slice_masks(arrs, start):
            if arrs is None:
                return None
            return [None if m is None else m[:, start:start + seg]
                    for m in arrs]

        batch = inputs[0].shape[0]
        carries = self._zero_carries(batch, inputs[0].dtype)
        last_score = None
        for start in range(0, t, seg):
            score, grads = self._train_step(
                slice_time(inputs, start), slice_time(labels, start),
                slice_masks(fmasks, start), slice_masks(lmasks, start), ew,
                carries)
            last_score = score
            self._after_update(score, grads, batch)
        self.score_ = last_score
        return last_score

    # ------------------------------------------------------------------
    # the fused loop's hooks (the loop itself: models/_layered.py)
    # ------------------------------------------------------------------
    def _fused_streams(self, stacked):
        """A ``StackedMultiDataSet`` (a ``StackedDataSet`` counts as one
        input and one output) as lists of [K, B, ...] tensors."""
        if isinstance(stacked, StackedDataSet):
            stacked = StackedMultiDataSet([stacked.features],
                                          [stacked.labels], stacked.weights,
                                          stacked.n_steps)
        return (self._tensors(stacked.features),
                self._tensors(stacked.labels), self._tensor(stacked.weights))

    def _poison_step(self, xs, ys, j):
        """Step ``j`` of the first input stream, where it is a float one,
        set to NaN."""
        if xs[0].is_floating_point():
            x0 = xs[0].clone()
            x0[j] = float("nan")
            xs = [x0] + list(xs[1:])
        return xs, ys

    def _tbptt_window_plan(self, xs):
        """``(seg, full windows, remainder)`` of a stacked group whose
        temporal streams are the rank-4 [K, B, T, F] ones, or None for
        standard backprop. The temporal streams must share one length: the
        windows cut them all alike."""
        if self.conf.backprop_type != "tbptt":
            return None
        ts = sorted({x.shape[2] for x in xs if x.ndim == 4})
        if not ts:
            return None
        if len(ts) > 1:
            raise ValueError(
                "fused tBPTT needs all temporal inputs to share one "
                f"sequence length, got {ts}; set DL4J_TORCH_FUSE_TBPTT=0 to "
                "train mixed-length multi-input graphs through the host "
                "window loop")
        seg = int(self.conf.tbptt_fwd_length)
        return (seg, ts[0] // seg, ts[0] % seg)

    def _window_xy(self, win):
        return win.x, win.y

    def _fused_carries(self, views):
        return {n: views[i] for i, n in enumerate(self.layer_names)
                if views[i] is not None}

    def fit(self, data, labels=None, *, epochs=1, checkpoint_every=None,
            checkpoint_dir=None, resume_from=None):
        """fit(MultiDataSetIterator) / fit(DataSetIterator) /
        fit((Multi)DataSet) / fit(X, y) (ComputationGraph.java:674,751):
        ``conf.iterations`` updates per minibatch, ``epochs`` passes over
        an iterator, with the MultiLayerNetwork's periodic checkpoints
        (``checkpoint_every``, ``checkpoint_dir``) and resume
        (``resume_from``): the resumed run is bitwise the uninterrupted
        one. Iterator fits only, for those."""
        if self.params_list is None:
            self.init()
        if self.conf.pretrain and not self._pretrained:
            # once a graph, then backprop (as the reference)
            self.pretrain(data if labels is None else DataSet(data, labels))
            self._pretrained = True
        if labels is not None:
            data = DataSet(data, labels)
        every, ck_dir, keep = self._resolve_ckpt_args(
            checkpoint_every, checkpoint_dir, resume_from)
        if isinstance(data, (DataSet, MultiDataSet)):
            if every or resume_from:
                raise ValueError(
                    "checkpoint_every/resume_from need a data iterator (the "
                    "checkpoint's cursor is a position in a stream); wrap "
                    "the DataSet in an iterator to use them")
            for _ in range(self.conf.iterations):
                self.fit_batch(_as_multi(data))
            self._nanguard_flush()
            return self
        if hasattr(data, "__iter__"):
            return self._fit_iterator(data, epochs, every, ck_dir, keep,
                                      resume_from)
        raise ValueError(f"Cannot fit on {type(data)}")

    def _fit_item(self, ds, use_ew):
        """One item of ``fit(iterator)``'s stream: a stacked group through
        ``fit_fused``, any other batch through ``fit_batch`` (with unit
        example weights where the run is bucketed, so a row-padded ragged
        batch takes the same path). Returns the real batches."""
        if isinstance(ds, (StackedDataSet, StackedMultiDataSet)):
            self.fit_fused(ds)
            return ds.n_steps
        mds = _as_multi(ds)
        ew = getattr(ds, "example_weights", None)
        if (ew is None and use_ew and mds.features_masks is None
                and mds.labels_masks is None):
            ew = np.ones(int(mds.features[0].shape[0]), np.float32)
        for _ in range(self.conf.iterations):
            self.fit_batch(mds, ew=ew)
        return 1

    # ------------------------------------------------------------------
    # unsupervised layer-wise pretraining (ComputationGraph.pretrain:529)
    # ------------------------------------------------------------------
    def pretrain(self, data, epochs=1):
        """Greedy pretraining of every pretrain layer vertex, in
        topological order."""
        if self.params_list is None:
            self.init()
        for name in self.topological_order:
            v = self.conf.vertices[name]
            if isinstance(v, LayerVertex) and v.layer.is_pretrain_layer():
                self.pretrain_vertex(name, data, epochs=epochs)
        return self

    def _forward_until(self, inputs, upto_name):
        """The (preprocessed) input of vertex ``upto_name``, computing only
        the vertices before it in topological order, in inference mode."""
        conf = self.conf
        acts = dict(zip(conf.network_inputs, inputs))
        for name in self.topological_order:
            if name == upto_name:
                break
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                x = xs[0]
                if v.preprocessor is not None:
                    x = v.preprocessor.pre_process(x, None)
                i = self._index[name]
                acts[name], _ = v.layer.forward(
                    self.params_list[i], x, self.states_list[i],
                    train=False, rng=None, mask=None)
            else:
                acts[name] = v.forward(xs, None)
        v = conf.vertices[upto_name]
        x = acts[conf.vertex_inputs[upto_name][0]]
        if v.preprocessor is not None:
            x = v.preprocessor.pre_process(x, None)
        return x

    def pretrain_vertex(self, name, data, epochs=1):
        """Pretrain layer vertex ``name`` on its input, computed from the
        network inputs through the vertices before it
        (ComputationGraph.pretrainLayer). ``data``: an iterator, or one
        (Multi)DataSet (labels may be None)."""
        if self.params_list is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]

        def layer_input(ds):
            mds = _as_multi(ds)
            return self._forward_until(self._tensors(mds.features), name)
        return self._pretrain_loop(self._index[name], data, epochs,
                                   layer_input)

    # ------------------------------------------------------------------
    # stateful RNN inference (ComputationGraph.rnnTimeStep:770)
    # ------------------------------------------------------------------
    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    @whole()
    def rnn_time_step(self, *inputs):
        """Stateful stepping inference: [B, F] single steps or [B, T, F]
        chunks, one per network input; the LSTM carries persist between
        calls. One output as an array, several as a list."""
        inputs = [self._tensor(x) for x in inputs]
        single = inputs[0].ndim == 2
        if single:
            inputs = [x[:, None, :] for x in inputs]
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(inputs[0].shape[0],
                                                   inputs[0].dtype)
        with torch.no_grad():
            acts, _, _, _, self._rnn_carries = self._forward_graph(
                self.params_list, self.states_list, inputs, train=False,
                rngs=None, fmasks=None, carries=self._rnn_carries)
        outs = [host(acts[n]) for n in self.conf.network_outputs]
        if single:
            outs = [o[:, 0] if o.ndim == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------------
    # inference / scoring
    # ------------------------------------------------------------------
    @whole()
    def output(self, *inputs, fmasks=None):
        """The network outputs for the given inputs, as host numpy: one
        array for one output, else a list."""
        inputs = self._tensors(inputs)
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_graph(
                self.params_list, self.states_list, inputs, train=False,
                rngs=None, fmasks=self._tensors(fmasks))
            outs = [host(acts[n]) for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    @whole()
    def feed_forward(self, *inputs, train=False):
        """Every vertex's activation by name, the inputs included, as host
        numpy (feedForward)."""
        rngs = self._dropout_keys() if train else None
        with torch.no_grad():
            acts, _, _, _, _ = self._forward_graph(
                self.params_list, self.states_list, self._tensors(inputs),
                train=train, rngs=rngs, fmasks=None)
        return {k: host(v) for k, v in acts.items()}

    def _multi_tensors(self, data):
        mds = _as_multi(data)
        return (self._tensors(mds.features), self._tensors(mds.labels),
                self._tensors(mds.features_masks),
                self._tensors(mds.labels_masks))

    @whole()
    def score(self, data, train=False):
        """The loss on a (Multi)DataSet without updating anything."""
        with torch.no_grad():
            s, _ = self._loss_fn(self.params_list, self.states_list,
                                 *self._multi_tensors(data), None,
                                 train=train)
        return float(s)

    @whole()
    def compute_gradient_and_score(self, data):
        """Per-vertex gradients and the score without updating anything
        (computeGradientAndScore)."""
        x, y, fm, lm = self._multi_tensors(data)
        score, _, grads = self._value_and_grad(x, y, fm, lm, None, False,
                                               None, None)
        self._last_gradients = grads
        self.score_ = float(score)
        return self.gradient(), self.score_

    def gradient(self):
        """The latest gradients, {layer vertex name: {param: tensor}}."""
        return self._by_name(self._last_gradients)

    def gradient_vector(self):
        if self._last_gradients is None:
            return None
        return host(flat_params.params_to_vector(self.layers,
                                                 self._last_gradients))

    @whole()
    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        if len(self.conf.network_outputs) != 1:
            raise ValueError("evaluate() requires a single network output")
        ev = Evaluation()
        for ds in iterator:
            mds = _as_multi(ds)
            out = self.output(*mds.features)
            lm = None if mds.labels_masks is None else mds.labels_masks[0]
            ev.eval(host(mds.labels[0]), out,
                    mask=None if lm is None else host(lm))
        return ev

    @whole("params_list", "states_list", "updater_states")
    def clone(self):
        """An independent copy: parameters, layer and updater state,
        iteration and dropout draw counter."""
        net = ComputationGraph(self.conf, device=self.device)
        net.params_list = [leaves(p, self.device) for p in self.params_list]
        net.states_list = [{k: v.clone() for k, v in s.items()}
                           for s in self.states_list]
        net.updater_states = clone_tree(self.updater_states)
        net.iteration = self.iteration
        net._draw_counter = self._draw_counter_arg().clone()
        return net

    def summary(self):
        lines = ["name                 type                        "
                 "n_params   inputs"]
        for n in self.topological_order:
            v = self.conf.vertices[n]
            ins = self.conf.vertex_inputs[n]
            if isinstance(v, LayerVertex):
                lines.append(f"{n:<20s} {type(v.layer).__name__:<27s} "
                             f"{v.layer.n_params():<10d} {ins}")
            else:
                lines.append(f"{n:<20s} {type(v).__name__:<27s} "
                             f"{0:<10d} {ins}")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)
