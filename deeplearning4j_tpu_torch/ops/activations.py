"""Activation functions: the port of ``deeplearning4j_tpu/ops/activations.py``.

One registry of names (case-insensitive) to functions on tensors, with the
reference's definitions. ``gelu`` is the tanh approximation, as
``jax.nn.gelu`` defaults to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get", "names", "register"]

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


@register("identity")
def identity(x):
    return x


@register("relu")
def relu(x):
    return torch.relu(x)


@register("leakyrelu")
def leakyrelu(x, alpha=0.01):
    return F.leaky_relu(x, alpha)


@register("relu6")
def relu6(x):
    return F.relu6(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("hardsigmoid")
def hardsigmoid(x):
    # reference HardSigmoid: clip(0.2*x + 0.5, 0, 1)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


@register("softplus")
def softplus(x):
    # jax.nn.softplus = logaddexp(x, 0), with no linear cut-over
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


@register("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register("elu")
def elu(x, alpha=1.0):
    return F.elu(x, alpha)


@register("selu")
def selu(x):
    return F.selu(x)


@register("gelu")
def gelu(x):
    return F.gelu(x, approximate="tanh")


@register("swish")
def swish(x):
    return F.silu(x)


@register("cube")
def cube(x):
    return x ** 3


@register("rationaltanh")
def rationaltanh(x):
    # reference ActivationRationalTanh: 1.7159 * tanh_approx(2x/3)
    a = 0.6666667 * x
    tanh_approx = torch.sign(a) * (1.0 - 1.0 / (1.0 + torch.abs(a) + a * a
                                                + 1.41645 * a ** 4))
    return 1.7159 * tanh_approx


@register("rectifiedtanh")
def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def get(name):
    """Look up an activation by name (case-insensitive); callables pass
    through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {name!r}. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(_REGISTRY)
