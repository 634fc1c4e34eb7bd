"""NeuralNetConfiguration builder + MultiLayerConfiguration: the port of
``deeplearning4j_tpu/nn/conf/multi_layer.py``.

The same builder (global hyperparameters cascaded into every layer), the
same shape inference with automatic preprocessor insertion, and the same
JSON: ``to_json`` writes what the reference writes and ``from_json`` reads
the reference's JSON, so one string builds a net in either package
(``to_yaml``/``from_yaml`` likewise, through PyYAML, imported when they
are called). An unknown layer type raises ``ValueError`` naming the known
types; an unknown preprocessor type raises ``KeyError``.
"""

from __future__ import annotations

import json

from deeplearning4j_tpu_torch.nn.conf.input_type import (FeedForward,
                                                         InputType,
                                                         Recurrent)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor, FeedForwardToRnnPreProcessor,
    InputPreProcessor, RnnToFeedForwardPreProcessor, preprocessor_from_dict)
from deeplearning4j_tpu_torch.nn.layers import conv as conv_layers
from deeplearning4j_tpu_torch.nn.layers import core as core_layers
from deeplearning4j_tpu_torch.nn.layers import norm as norm_layers
from deeplearning4j_tpu_torch.nn.layers import recurrent as recurrent_layers
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, layer_from_dict

__all__ = ["ListBuilder", "MultiLayerConfiguration", "NeuralNetConfiguration"]


def _layer_family(layer) -> str:
    """Which InputType family a layer consumes: 'ff' | 'rnn' | 'cnn' |
    'any'."""
    if isinstance(layer, (conv_layers.ConvolutionLayer,
                          conv_layers.SubsamplingLayer,
                          conv_layers.ZeroPaddingLayer,
                          norm_layers.LocalResponseNormalization)):
        return "cnn"
    if isinstance(layer, (recurrent_layers.LSTM, core_layers.RnnOutputLayer)):
        return "rnn"
    if isinstance(layer, core_layers.DenseLayer):
        return "ff"
    return "any"


class MultiLayerConfiguration:
    """Sequential network configuration (MultiLayerConfiguration.java)."""

    def __init__(self, layers, *, seed=12345, iterations=1,
                 optimization_algo="stochastic_gradient_descent",
                 minimize=True, backprop=True, pretrain=False,
                 backprop_type="standard", tbptt_fwd_length=20,
                 tbptt_back_length=20, input_preprocessors=None,
                 input_type=None, use_regularization=False,
                 max_iterations=10000, compute_dtype="float32", remat=False):
        self.layers: list[BaseLayer] = layers
        self.seed = seed
        self.iterations = iterations
        self.optimization_algo = optimization_algo
        self.minimize = minimize
        self.backprop = backprop
        self.pretrain = pretrain
        self.backprop_type = backprop_type
        self.tbptt_fwd_length = tbptt_fwd_length
        self.tbptt_back_length = tbptt_back_length
        self.input_preprocessors: dict[int, InputPreProcessor] = \
            input_preprocessors or {}
        self.input_type = input_type
        self.use_regularization = use_regularization
        self.max_iterations = max_iterations
        # forward/backward compute dtype; parameters and updater state stay
        # float32 masters
        self.compute_dtype = compute_dtype
        # recompute each layer's activations in the backward
        # (torch.utils.checkpoint per layer)
        self.remat = bool(remat)
        if input_type is None:
            input_type = self._infer_input_type()
            self.input_type = input_type
        if input_type is not None:
            self._setup_shapes(input_type)

    def _infer_input_type(self):
        """The input type from the first layer's explicit n_in when none
        was given."""
        if not self.layers:
            return None
        first = self.layers[0]
        n_in = getattr(first, "n_in", None)
        if n_in is None:
            return None
        if isinstance(first, (recurrent_layers.LSTM,
                              core_layers.RnnOutputLayer)):
            return Recurrent(n_in)
        if isinstance(first, conv_layers.ConvolutionLayer):
            return None   # a conv needs H and W: an explicit input type
        return FeedForward(n_in)

    # ---- shape inference + automatic preprocessor insertion -----------
    def _setup_shapes(self, input_type):
        current = input_type
        for i, layer in enumerate(self.layers):
            pre = self.input_preprocessors.get(i)
            if pre is None:
                pre = self._auto_preprocessor(current, layer)
                if pre is not None:
                    self.input_preprocessors[i] = pre
            if pre is not None:
                current = pre.output_type(current)
            current = layer.set_input_type(current)
        self.output_type_ = current

    @staticmethod
    def _auto_preprocessor(current, layer):
        fam = _layer_family(layer)
        kind = current.kind
        if fam == "any" or kind == fam:
            return None
        if kind == "cnnflat" and fam == "cnn":
            return FeedForwardToCnnPreProcessor(current.height, current.width,
                                                current.channels)
        if kind == "cnn" and fam == "ff":
            return CnnToFeedForwardPreProcessor(current.height, current.width,
                                                current.channels)
        if kind == "cnnflat" and fam == "ff":
            return None   # already flat
        if kind == "rnn" and fam == "ff":
            return RnnToFeedForwardPreProcessor()
        if kind == "ff" and fam == "rnn":
            return FeedForwardToRnnPreProcessor()
        if kind == "cnn" and fam == "rnn":
            return CnnToRnnPreProcessor(current.height, current.width,
                                        current.channels)
        raise ValueError(f"No automatic preprocessor from {current} to "
                         f"{type(layer).__name__}; set one explicitly via "
                         "input_preprocessors")

    # ---- serialization -------------------------------------------------
    def to_dict(self):
        return {
            "layers": [l.to_dict() for l in self.layers],
            "seed": self.seed,
            "iterations": self.iterations,
            "optimization_algo": self.optimization_algo,
            "minimize": self.minimize,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "input_preprocessors": {str(k): v.to_dict() for k, v in
                                    self.input_preprocessors.items()},
            "input_type": None if self.input_type is None
            else self.input_type.to_dict(),
            "use_regularization": self.use_regularization,
            "max_iterations": self.max_iterations,
            "compute_dtype": self.compute_dtype,
            "remat": self.remat,
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self):
        import yaml
        return yaml.safe_dump(self.to_dict())

    @staticmethod
    def from_dict(d):
        d = dict(d)
        layers = [layer_from_dict(ld) for ld in d.pop("layers")]
        pres = {int(k): preprocessor_from_dict(v)
                for k, v in d.pop("input_preprocessors", {}).items()}
        it = d.pop("input_type", None)
        conf = MultiLayerConfiguration(layers, input_preprocessors=pres, **d)
        # layers arrive with shapes already inferred; re-run only if an
        # input type was given
        if it is not None:
            conf.input_type = InputType.from_dict(it)
            conf._setup_shapes(conf.input_type)
        return conf

    @staticmethod
    def from_json(s):
        return MultiLayerConfiguration.from_dict(json.loads(s))

    @staticmethod
    def from_yaml(s):
        import yaml
        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))


class ListBuilder:
    """NeuralNetConfiguration.ListBuilder."""

    def __init__(self, global_conf):
        self._global = global_conf
        self._layers: dict[int, BaseLayer] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._preprocessors: dict[int, InputPreProcessor] = {}
        self._input_type = None

    def layer(self, index_or_layer, layer=None):
        if layer is None:
            idx = len(self._layers)
            layer = index_or_layer
        else:
            idx = index_or_layer
        if not isinstance(layer, BaseLayer):
            raise ValueError(f"layer must be a BaseLayer, got {type(layer)}")
        self._layers[idx] = layer
        return self

    def input_preprocessor(self, index, preprocessor):
        self._preprocessors[index] = preprocessor
        return self

    def backprop(self, flag):
        self._backprop = flag
        return self

    def pretrain(self, flag):
        self._pretrain = flag
        return self

    def backprop_type(self, t):
        self._backprop_type = str(t).lower()
        return self

    def tbptt_fwd_length(self, n):
        self._tbptt_fwd = n
        return self

    def tbptt_back_length(self, n):
        self._tbptt_back = n
        return self

    def set_input_type(self, input_type):
        self._input_type = input_type
        return self

    def build(self) -> MultiLayerConfiguration:
        if not self._layers:
            raise ValueError("No layers added")
        n = max(self._layers) + 1
        missing = [i for i in range(n) if i not in self._layers]
        if missing:
            raise ValueError(f"Missing layer indices: {missing}")
        g = self._global
        layers = []
        for i in range(n):
            layer = self._layers[i].copy()
            layer.apply_global_defaults(g.as_cascade_dict())
            if not g.use_regularization:
                layer.l1 = layer.l2 = layer.l1_bias = layer.l2_bias = 0.0
            layers.append(layer)
        return MultiLayerConfiguration(
            layers, seed=g.seed_, iterations=g.iterations_,
            optimization_algo=g.optimization_algo_, minimize=g.minimize_,
            backprop=self._backprop, pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_preprocessors=self._preprocessors,
            input_type=self._input_type,
            use_regularization=g.use_regularization,
            max_iterations=g.max_iterations_,
            compute_dtype=g.compute_dtype_, remat=g.remat_)


class NeuralNetConfiguration:
    """Namespace mirroring the reference's NeuralNetConfiguration.Builder
    entry point."""

    class Builder:
        def __init__(self):
            self.seed_ = 12345
            self.iterations_ = 1
            self.optimization_algo_ = "stochastic_gradient_descent"
            self.minimize_ = True
            self.use_regularization = False
            self.max_iterations_ = 10000
            self.compute_dtype_ = "float32"
            self.remat_ = False
            self._cascade = {}

        def _set(self, key, value):
            self._cascade[key] = value
            return self

        def seed(self, s):
            self.seed_ = int(s)
            return self

        def iterations(self, n):
            self.iterations_ = int(n)
            return self

        def remat(self, enabled=True):
            """Recompute each layer's internal activations in the backward
            instead of storing them."""
            self.remat_ = bool(enabled)
            return self

        def compute_dtype(self, dtype):
            """Mixed-precision compute dtype ('float32' | 'bfloat16');
            parameter and updater masters stay float32."""
            dtype = str(dtype).lower()
            if dtype == "float16":
                raise ValueError("compute_dtype 'float16' needs loss "
                                 "scaling, which is not implemented; use "
                                 "'bfloat16'")
            if dtype not in ("float32", "bfloat16"):
                raise ValueError(f"unsupported compute_dtype {dtype!r}")
            self.compute_dtype_ = dtype
            return self

        def optimization_algo(self, algo):
            self.optimization_algo_ = str(algo).lower()
            return self

        def minimize(self, flag):
            self.minimize_ = flag
            return self

        def regularization(self, flag):
            self.use_regularization = bool(flag)
            return self

        def max_iterations(self, n):
            self.max_iterations_ = int(n)
            return self

        def activation(self, a):
            return self._set("activation", a)

        def weight_init(self, w):
            return self._set("weight_init", w)

        def dist(self, d):
            return self._set("dist", d)

        def bias_init(self, b):
            return self._set("bias_init", float(b))

        def learning_rate(self, lr):
            return self._set("learning_rate", float(lr))

        def bias_learning_rate(self, lr):
            return self._set("bias_learning_rate", float(lr))

        def updater(self, u):
            return self._set("updater", str(u).lower())

        def momentum(self, m):
            return self._set("momentum", float(m))

        def rho(self, r):
            return self._set("rho", float(r))

        def rms_decay(self, r):
            return self._set("rms_decay", float(r))

        def adam_mean_decay(self, b):
            return self._set("adam_mean_decay", float(b))

        def adam_var_decay(self, b):
            return self._set("adam_var_decay", float(b))

        def epsilon(self, e):
            return self._set("epsilon", float(e))

        def l1(self, v):
            return self._set("l1", float(v))

        def l2(self, v):
            return self._set("l2", float(v))

        def l1_bias(self, v):
            return self._set("l1_bias", float(v))

        def l2_bias(self, v):
            return self._set("l2_bias", float(v))

        def dropout(self, v):
            return self._set("dropout", float(v))

        def drop_out(self, v):
            return self.dropout(v)

        def gradient_normalization(self, g):
            return self._set("gradient_normalization", g)

        def gradient_normalization_threshold(self, t):
            return self._set("gradient_normalization_threshold", float(t))

        def learning_rate_policy(self, p):
            return self._set("lr_policy", str(p).lower())

        def lr_policy_decay_rate(self, r):
            return self._set("lr_policy_decay_rate", float(r))

        def lr_policy_steps(self, s):
            return self._set("lr_policy_steps", float(s))

        def lr_policy_power(self, p):
            return self._set("lr_policy_power", float(p))

        def learning_rate_schedule(self, sched):
            return self._set("lr_schedule", dict(sched))

        def as_cascade_dict(self):
            return dict(self._cascade)

        def list(self) -> ListBuilder:
            return ListBuilder(self)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
                GraphBuilder
            return GraphBuilder(self)
