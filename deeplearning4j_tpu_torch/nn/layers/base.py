"""Layer base: the port of ``deeplearning4j_tpu/nn/layers/base.py``.

As in the reference, one dataclass per layer carries the hyperparameters
(JSON-serializable, cascaded from the global builder) and the layer's
init and forward functions; backprop comes from autograd. Parameters are
plain dicts of tensors that the network owns. Init draws from an
explicit ``torch.Generator`` the network passes in; dropout masks come
from the counter-based hash of ``ops/random.py``. Both differ from JAX's
threefry draws, so init and dropout agree with the reference in
distribution only.

Cascade semantics: fields default to ``None`` = "inherit from the global
NeuralNetConfiguration builder values".
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import activations as activations_mod
from deeplearning4j_tpu_torch.ops import random as random_mod
from deeplearning4j_tpu_torch.ops import weights as weights_mod
from deeplearning4j_tpu_torch.ops.updaters import UpdaterConfig

__all__ = ["BaseLayer", "CASCADE_FIELDS", "FeedForwardLayer",
           "LAYER_REGISTRY", "layer_from_dict", "register_layer"]

LAYER_REGISTRY: dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d):
    d = dict(d)
    name = d.pop("type")
    if name not in LAYER_REGISTRY:
        raise ValueError(f"Unknown layer type {name!r}. Known: "
                         f"{sorted(LAYER_REGISTRY)}")
    cls = LAYER_REGISTRY[name]
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - field_names
    if unknown:
        raise ValueError(f"Unknown fields for {name}: {sorted(unknown)}")
    return cls(**d)


# Fields cascaded from the global builder when the layer leaves them None.
CASCADE_FIELDS = (
    "activation", "weight_init", "dist", "bias_init",
    "learning_rate", "bias_learning_rate", "updater",
    "momentum", "rho", "rms_decay", "adam_mean_decay", "adam_var_decay",
    "epsilon", "l1", "l2", "l1_bias", "l2_bias", "dropout",
    "gradient_normalization", "gradient_normalization_threshold",
    "lr_policy", "lr_policy_decay_rate", "lr_policy_steps",
    "lr_policy_power", "lr_schedule",
)

_HARD_DEFAULTS = {
    "activation": "sigmoid", "weight_init": "xavier", "bias_init": 0.0,
    "learning_rate": 0.1, "updater": "sgd", "momentum": 0.9, "rho": 0.95,
    "rms_decay": 0.95, "adam_mean_decay": 0.9, "adam_var_decay": 0.999,
    "epsilon": 1e-8, "l1": 0.0, "l2": 0.0, "l1_bias": 0.0, "l2_bias": 0.0,
    "dropout": 0.0, "lr_policy": "none", "lr_policy_decay_rate": 0.0,
    "lr_policy_steps": 1.0, "lr_policy_power": 1.0}


@dataclass
class BaseLayer:
    """Common hyperparameters for all layers."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[dict] = None
    bias_init: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    rho: Optional[float] = None
    rms_decay: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    epsilon: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None  # retain probability; 0 = off
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: Optional[float] = None
    lr_policy_steps: Optional[float] = None
    lr_policy_power: Optional[float] = None
    lr_schedule: Optional[dict] = None

    # ---- serialization -------------------------------------------------
    def to_dict(self):
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                d[f.name] = v
        return d

    def copy(self, **overrides):
        return dataclasses.replace(self, **overrides)

    # ---- cascade -------------------------------------------------------
    def apply_global_defaults(self, global_conf: dict):
        for f in CASCADE_FIELDS:
            if hasattr(self, f) and getattr(self, f) is None \
                    and f in global_conf:
                setattr(self, f, global_conf[f])
        for f, v in _HARD_DEFAULTS.items():
            if hasattr(self, f) and getattr(self, f) is None:
                setattr(self, f, v)
        return self

    def updater_config(self, max_iterations=10000) -> UpdaterConfig:
        def pick(v, default):
            return v if v is not None else default
        return UpdaterConfig(
            rule=self.updater or "sgd",
            learning_rate=pick(self.learning_rate, 0.1),
            bias_learning_rate=self.bias_learning_rate,
            momentum=pick(self.momentum, 0.9),
            adam_mean_decay=pick(self.adam_mean_decay, 0.9),
            adam_var_decay=pick(self.adam_var_decay, 0.999),
            epsilon=pick(self.epsilon, 1e-8),
            rho=pick(self.rho, 0.95),
            rms_decay=pick(self.rms_decay, 0.95),
            lr_policy=self.lr_policy or "none",
            lr_policy_decay_rate=self.lr_policy_decay_rate or 0.0,
            lr_policy_steps=self.lr_policy_steps or 1.0,
            lr_policy_power=self.lr_policy_power or 1.0,
            lr_schedule=self.lr_schedule,
            max_iterations=max_iterations,
            gradient_normalization=self.gradient_normalization,
            gradient_normalization_threshold=pick(
                self.gradient_normalization_threshold, 1.0),
        )

    # ---- shape / params -----------------------------------------------
    def set_input_type(self, input_type):
        """Infer unset size fields from the incoming InputType; return the
        output type."""
        return self.output_type(input_type)

    def output_type(self, input_type):
        return input_type

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    @property
    def param_order(self):
        return sorted(self.param_shapes())

    def n_params(self):
        total = 0
        for shape in self.param_shapes().values():
            n = 1
            for s in shape:
                n *= s
            total += n
        return total

    def init_params(self, generator, dtype=torch.float32) -> dict:
        return {}

    def init_state(self) -> dict:
        """Non-trainable state (BatchNormalization's running moments), as
        CPU tensors; the network moves them to its device."""
        return {}

    def is_pretrain_layer(self):
        return False

    # ---- forward -------------------------------------------------------
    def activation_fn(self):
        return activations_mod.get(self.activation or "identity")

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        """Return (output, new_state)."""
        raise NotImplementedError

    def feed_forward_mask(self, mask):
        """Propagate the time-step mask through this layer."""
        return mask

    def apply_dropout(self, x, *, train, rng):
        """Inverted dropout on the layer input, ``dropout`` being the
        RETAIN probability (DL4J 0.7); 0 disables. ``rng`` is the layer's
        :class:`~deeplearning4j_tpu_torch.ops.random.DropoutKey`: the mask
        is a pure function of the seed, the model's draw counter, the
        layer's index and the element's index (``ops/random.py``)."""
        p = self.dropout or 0.0
        if not train or p == 0.0 or p == 1.0 or rng is None:
            return x
        keep = random_mod.dropout_keep(rng, x.shape, p, x.device)
        return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    # ---- helpers for subclasses ---------------------------------------
    def _init_weight(self, generator, shape, fan_override=None,
                     dtype=torch.float32):
        return weights_mod.init(generator, self.weight_init or "xavier",
                                shape, dtype=dtype, distribution=self.dist,
                                fan_override=fan_override)

    def _init_bias(self, generator, shape, dtype=torch.float32):
        b = self.bias_init if self.bias_init is not None else 0.0
        return torch.full(shape, b, dtype=dtype, device=generator.device)


class FeedForwardLayer(BaseLayer):
    """Base for layers with n_in/n_out."""
