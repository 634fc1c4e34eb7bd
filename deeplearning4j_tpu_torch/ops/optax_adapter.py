"""The ``optax:*`` updater rules: the port of
``deeplearning4j_tpu/ops/optax_adapter.py``.

The reference routes a layer whose updater is ``optax:<name>`` through
the named optax ``GradientTransformation``. The port does not import
optax: it carries the six rules the reference wires to ``UpdaterConfig``
fields, written by hand in torch after the formulas of optax 0.2.6:

- ``adam``: ``scale_by_adam`` (eps outside the root, ``eps_root`` 0,
  both moments bias-corrected by ``1 - b**count``), then ``-lr``;
- ``adamw``: the same, then ``+ weight_decay * param``, then ``-lr``;
- ``lion``: ``sign((1 - b1) g + b1 m)``, the moment an EMA at ``b2``,
  then ``+ weight_decay * param``, then ``-lr`` (``b1`` is
  ``adam_mean_decay``, ``b2`` ``adam_var_decay``, as the reference maps
  them);
- ``lamb``: adam's direction (``eps`` = ``epsilon``), ``+ weight_decay *
  param``, scaled by the trust ratio ``|param| / |update|``, which is 1
  where either norm is 0, then ``-lr``;
- ``sgd``: a momentum trace ``g + momentum * trace`` (none when the
  momentum is 0), then ``-lr``;
- ``rmsprop``: ``nu = (1 - decay) g**2 + decay nu`` from 0, ``g /
  sqrt(nu + eps)`` (eps inside the root), then ``-lr``.

A rule is a :class:`Transformation`: ``init(params)`` gives the state
as a list of tensors in the order ``jax.tree.leaves`` gives the optax
state's leaves (a step ``count`` first where the rule keeps one, int32;
then each moment's tensors in sorted parameter-name order), so the flat
updater vector (``utils/flat_params.py``) and the archives cross to and
from the reference; ``update(grads, state, params)`` gives (updates to
ADD, new state), as optax's does. :func:`register_optax` adds a rule by
name (it wins over a built-in one). The reference's last resort,
``getattr(optax, name)``, cannot be carried across: any other name
raises, naming the six rules and ROADMAP.md. As in the reference, the
framework's ``lr_policy`` is not applied on top of a rule.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["BUILTIN_RULES", "Transformation", "register_optax", "resolve"]

BUILTIN_RULES = ("adam", "adamw", "lamb", "lion", "rmsprop", "sgd")
_INT32_MAX = 2 ** 31 - 1

_REGISTRY: dict[str, Callable] = {}


class Transformation(NamedTuple):
    """An optax rule in the port: ``init(params) -> state`` (a list of
    tensors) and ``update(grads, state, params) -> (updates, state)``,
    the updates to be ADDED to the parameters."""

    init: Callable
    update: Callable


def register_optax(name, factory):
    """``factory(conf: UpdaterConfig) -> Transformation`` under ``name``
    (``updater("optax:<name>")``); it wins over a built-in rule."""
    _REGISTRY[name.lower()] = factory
    return factory


def _names(params):
    return sorted(params)


def _zeros(params):
    return [torch.zeros_like(params[k]).detach() for k in _names(params)]


def _count0(params):
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _increment(count):
    """optax's ``safe_increment``: +1, held at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_corrected(t, decay, count):
    """``t / (1 - decay**count)``, the power in f32 on the device (no host
    value is copied in: the step may run inside a captured graph)."""
    return t / (1.0 - torch.pow(decay, count.to(torch.float32))).to(t.dtype)


def _norm(x):
    return torch.linalg.vector_norm(x.reshape(-1))


def _adam_direction(grads, mu, nu, count, b1, b2, eps):
    """``scale_by_adam``: the new moments, the incremented count and the
    direction ``mu_hat / (sqrt(nu_hat) + eps)``, per sorted name."""
    names = _names(grads)
    mu = [(1 - b1) * grads[k] + b1 * m for k, m in zip(names, mu)]
    nu = [(1 - b2) * (grads[k] * grads[k]) + b2 * v
          for k, v in zip(names, nu)]
    c = _increment(count)
    out = [_bias_corrected(m, b1, c) / (torch.sqrt(_bias_corrected(v, b2, c))
                                        + eps)
           for m, v in zip(mu, nu)]
    return out, mu, nu, c


def _finish(names, u, lr):
    """``scale_by_learning_rate``: times ``-lr``, back to a dict."""
    return {k: (-lr) * x for k, x in zip(names, u)}


def _adam_like(conf, decay, trust):
    b1, b2, eps = conf.adam_mean_decay, conf.adam_var_decay, conf.epsilon
    wd, lr = conf.weight_decay, conf.learning_rate

    def init(params):
        return [_count0(params)] + _zeros(params) + _zeros(params)

    def update(grads, state, params):
        names = _names(grads)
        n = len(names)
        count, mu, nu = state[0], state[1:1 + n], state[1 + n:]
        u, mu, nu, c = _adam_direction(grads, mu, nu, count, b1, b2, eps)
        if decay:
            u = [x + wd * params[k] for k, x in zip(names, u)]
        if trust:
            def scaled(x, p):
                pn, un = _norm(p), _norm(x)
                ratio = torch.where((pn == 0.0) | (un == 0.0),
                                    torch.ones((), dtype=p.dtype,
                                               device=p.device), pn / un)
                return x * ratio
            u = [scaled(x, params[k]) for k, x in zip(names, u)]
        return _finish(names, u, lr), [c] + mu + nu
    return Transformation(init, update)


def _lion(conf):
    b1, b2 = conf.adam_mean_decay, conf.adam_var_decay
    wd, lr = conf.weight_decay, conf.learning_rate

    def init(params):
        return [_count0(params)] + _zeros(params)

    def update(grads, state, params):
        names = _names(grads)
        count, mu = state[0], state[1:]
        u = [torch.sign((1.0 - b1) * grads[k] + b1 * m)
             for k, m in zip(names, mu)]
        mu = [(1 - b2) * grads[k] + b2 * m for k, m in zip(names, mu)]
        u = [x + wd * params[k] for k, x in zip(names, u)]
        return _finish(names, u, lr), [_increment(count)] + mu
    return Transformation(init, update)


def _sgd(conf):
    momentum, lr = conf.momentum or None, conf.learning_rate

    def init(params):
        return [] if momentum is None else _zeros(params)

    def update(grads, state, params):
        names = _names(grads)
        if momentum is None:
            return _finish(names, [grads[k] for k in names], lr), state
        trace = [grads[k] + momentum * t for k, t in zip(names, state)]
        return _finish(names, trace, lr), trace
    return Transformation(init, update)


def _rmsprop(conf):
    decay, eps, lr = conf.rms_decay, conf.epsilon, conf.learning_rate

    def init(params):
        return _zeros(params)

    def update(grads, state, params):
        names = _names(grads)
        nu = [(1 - decay) * (grads[k] * grads[k]) + decay * v
              for k, v in zip(names, state)]
        u = [torch.rsqrt(v + eps) * grads[k] for k, v in zip(names, nu)]
        return _finish(names, u, lr), nu
    return Transformation(init, update)


def _builtin(name, conf):
    if name == "adam":
        return _adam_like(conf, decay=False, trust=False)
    if name == "adamw":
        return _adam_like(conf, decay=True, trust=False)
    if name == "lamb":
        return _adam_like(conf, decay=True, trust=True)
    if name == "lion":
        return _lion(conf)
    if name == "sgd":
        return _sgd(conf)
    if name == "rmsprop":
        return _rmsprop(conf)
    return None


def resolve(conf):
    """An ``UpdaterConfig`` with rule ``optax:<name>`` to its
    :class:`Transformation`: a registered factory first, then the six
    built-in rules; any other name raises ``ValueError``."""
    rule = conf.rule.lower()
    if not rule.startswith("optax:"):
        raise ValueError(f"not an optax rule: {conf.rule!r}")
    name = rule.split(":", 1)[1]
    if name in _REGISTRY:
        return _REGISTRY[name](conf)
    tx = _builtin(name, conf)
    if tx is not None:
        return tx
    raise ValueError(
        f"unknown optax rule {name!r}: the PyTorch package carries "
        f"{list(BUILTIN_RULES)} and the rules registered with "
        "register_optax; the reference's fallback to getattr(optax, "
        "name) does not cross over (ROADMAP.md, queue 2, known "
        "differences)")
