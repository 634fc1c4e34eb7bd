"""Weight initialization: the port of ``deeplearning4j_tpu/ops/weights.py``
(WeightInit.java / WeightInitUtil.java).

The same schemes, scales and fans, drawn from an explicit
``torch.Generator``. Its values differ from JAX's threefry draws from the
same seed, so the two agree in distribution only. fan_in/fan_out follow
the reference: for a 2-D weight ``[nin, nout]`` they are ``nin`` and
``nout``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fans", "init"]


def fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def _normal(g, shape, dtype, device):
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def _uniform(g, shape, dtype, device, lo, hi):
    u = torch.rand(shape, generator=g, dtype=dtype, device=device)
    return lo + (hi - lo) * u


def init(generator, scheme, shape, dtype=torch.float32, distribution=None,
         fan_override=None, device=None):
    """One weight tensor on ``device`` (the generator's by default).

    ``distribution`` is a dict like ``{"type": "normal", "mean": 0,
    "std": 1}`` for the DISTRIBUTION scheme; ``fan_override`` optionally
    supplies (fan_in, fan_out)."""
    scheme = str(scheme).lower()
    shape = tuple(shape)
    dev = generator.device if device is None else device
    fan_in, fan_out = fan_override if fan_override is not None \
        else fans(shape)
    g = generator

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY weight init requires a square 2-D "
                             "shape")
        return torch.eye(shape[0], dtype=dtype, device=dev)
    if scheme == "distribution":
        return _from_distribution(g, distribution or {"type": "normal",
                                                      "mean": 0.0,
                                                      "std": 1.0},
                                  shape, dtype, dev)
    if scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(g, shape, dtype, dev, -a, a)
    if scheme == "xavier":
        return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(g, shape, dtype,
                                                             dev)
    if scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(g, shape, dtype, dev, -a, a)
    if scheme == "xavier_fan_in":
        return _normal(g, shape, dtype, dev) / math.sqrt(fan_in)
    if scheme == "xavier_legacy":
        std = 1.0 / math.sqrt(shape[0] + (shape[1] if len(shape) > 1 else 0))
        return std * _normal(g, shape, dtype, dev)
    if scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(g, shape, dtype, dev, -a, a)
    if scheme == "relu":
        return math.sqrt(2.0 / fan_in) * _normal(g, shape, dtype, dev)
    if scheme == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return _uniform(g, shape, dtype, dev, -a, a)
    if scheme in ("lecun_normal", "normal"):
        return _normal(g, shape, dtype, dev) / math.sqrt(fan_in)
    raise ValueError(f"Unknown weight init scheme: {scheme!r}")


def _from_distribution(g, dist, shape, dtype, dev):
    kind = str(dist.get("type", "normal")).lower()
    if kind in ("normal", "gaussian"):
        mean = float(dist.get("mean", 0.0))
        std = float(dist.get("std", dist.get("standardDeviation", 1.0)))
        return mean + std * _normal(g, shape, dtype, dev)
    if kind == "uniform":
        return _uniform(g, shape, dtype, dev, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)))
    if kind == "binomial":
        n = int(dist.get("numberOfTrials", dist.get("n", 1)))
        p = float(dist.get("probabilityOfSuccess", dist.get("p", 0.5)))
        count = torch.full(shape, float(n), device=dev)
        return torch.binomial(count, torch.full(shape, p, device=dev),
                              generator=g).to(dtype)
    raise ValueError(f"Unknown distribution: {dist!r}")
