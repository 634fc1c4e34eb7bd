"""Transfer learning: the port of ``deeplearning4j_tpu/nn/transfer_learning.py``
(``nn/transferlearning/TransferLearning.java:34``: the Builder's
``setFeatureExtractor:86``, ``nOutReplace:100-162``, layer removal and
addition; ``FineTuneConfiguration.java``; ``FrozenLayer.java``).

A frozen layer is the reference's: its updater rule is ``"none"``, so its
gradients are computed and never applied, and its parameters stay
bitwise what they were. The built network owns fresh tensors for every
layer (copies of the source's, or new draws): the port's updates run in
place and its captured CUDA graphs bind their tensors' storage, so the
built net must never share storage with the source net, nor replay a
graph the source captured. ``n_out_replace`` draws the replaced layers
from a ``torch.Generator`` seeded with ``conf.seed + 1`` on the source's
device.
"""

from __future__ import annotations

import copy

import torch

from deeplearning4j_tpu_torch.models._layered import leaves
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

__all__ = ["FineTuneConfiguration", "TransferLearning"]


class FineTuneConfiguration:
    """Hyperparameter overrides applied to every layer that is not frozen
    (FineTuneConfiguration.java)."""

    def __init__(self, **overrides):
        self.overrides = overrides

    def apply(self, layer):
        for k, v in self.overrides.items():
            if hasattr(layer, k):
                setattr(layer, k, v)


class TransferLearning:
    class Builder:
        def __init__(self, network: MultiLayerNetwork):
            self._net = network
            self._fine_tune = None
            self._freeze_until = None
            self._nout_replace = {}   # idx -> (n_out, weight_init)
            self._remove_from = None
            self._append = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx):
            """Freeze layers [0, layer_idx] (setFeatureExtractor:86)."""
            self._freeze_until = layer_idx
            return self

        def n_out_replace(self, layer_idx, n_out, weight_init="xavier"):
            self._nout_replace[layer_idx] = (n_out, weight_init)
            return self

        def remove_layers_from_output(self, n):
            self._remove_from = len(self._net.layers) - n
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def add_layer(self, layer):
            self._append.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._net
            dev = src.device
            layers = [copy.deepcopy(l) for l in src.layers]
            params = [dict(p) for p in src.params_list]  # leaves() copies
            states = [{k: v.detach().clone() for k, v in s.items()}
                      for s in src.states_list]

            if self._remove_from is not None:
                layers = layers[:self._remove_from]
                params = params[:self._remove_from]
                states = states[:self._remove_from]

            # nOutReplace: a new n_out re-initialises this layer and the
            # next layer's n_in (nOutReplace:100-162)
            gen = torch.Generator(device=dev).manual_seed(src.conf.seed + 1)

            def fresh(i):
                params[i] = layers[i].init_params(gen)
                states[i] = {k: v.to(dev)
                             for k, v in layers[i].init_state().items()}

            for idx, (n_out, winit) in sorted(self._nout_replace.items()):
                layers[idx].n_out = n_out
                layers[idx].weight_init = winit
                fresh(idx)
                if idx + 1 < len(layers) and hasattr(layers[idx + 1],
                                                      "n_in"):
                    layers[idx + 1].n_in = n_out
                    fresh(idx + 1)

            for layer in self._append:
                if getattr(layer, "n_in", None) is None and \
                        hasattr(layers[-1], "n_out"):
                    layer.n_in = layers[-1].n_out
                layer.apply_global_defaults({})
                if self._fine_tune is not None:
                    self._fine_tune.apply(layer)
                layers.append(layer)
                params.append(layer.init_params(gen))
                states.append({k: v.to(dev)
                               for k, v in layer.init_state().items()})

            if self._fine_tune is not None:
                for i, layer in enumerate(layers):
                    if self._freeze_until is None or i > self._freeze_until:
                        self._fine_tune.apply(layer)

            if self._freeze_until is not None:
                for i in range(self._freeze_until + 1):
                    layers[i].frozen = True
                    layers[i].updater = "none"   # FrozenLayer: no update

            c = src.conf
            conf = MultiLayerConfiguration(
                layers, seed=c.seed, iterations=c.iterations,
                optimization_algo=c.optimization_algo, backprop=c.backprop,
                pretrain=False, backprop_type=c.backprop_type,
                tbptt_fwd_length=c.tbptt_fwd_length,
                tbptt_back_length=c.tbptt_back_length,
                input_preprocessors=dict(c.input_preprocessors),
                use_regularization=c.use_regularization,
                max_iterations=c.max_iterations)
            net = MultiLayerNetwork(conf, device=dev)
            net.params_list = [leaves(p, dev) for p in params]
            net.states_list = states
            net.reset_updater_state()
            return net
