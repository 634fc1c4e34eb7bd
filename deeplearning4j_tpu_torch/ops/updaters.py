"""Updaters: the port of ``deeplearning4j_tpu/ops/updaters.py``
(LayerUpdater.java:30): per-parameter update rules, gradient
normalization and the l1/l2 score term.

Functions of dicts of tensors that return new dicts, as the reference's
pure functions do; the train step applies them. Updates are subtracted
from the parameters. ``iteration`` may be a Python int or a 0-dim device
tensor. An ``optax:<name>`` rule dispatches to ``ops/optax_adapter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.schedules import learning_rate

__all__ = ["UpdaterConfig", "compute_updates", "init_state",
           "l1_l2_score", "normalize_gradients", "whole_sq_sums"]

_BIAS_NAMES = ("b", "gb", "vb", "beta")


@dataclass
class UpdaterConfig:
    """Hyperparameters for one layer's updater."""

    rule: str = "sgd"
    learning_rate: float = 0.1
    bias_learning_rate: Optional[float] = None
    momentum: float = 0.9
    adam_mean_decay: float = 0.9       # beta1
    adam_var_decay: float = 0.999      # beta2
    epsilon: float = 1e-8
    rho: float = 0.95                  # adadelta
    rms_decay: float = 0.95
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: Optional[dict] = None
    max_iterations: int = 10000
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    weight_decay: float = 0.0          # optax:* rules (adamw/lion/lamb)


def init_state(conf: UpdaterConfig, params, device=None):
    """The updater state for a layer's param dict: zeros shaped like each
    parameter under the rule's keys. An optax rule's state goes to
    ``device`` (a layer without parameters still keeps its step count,
    as the reference's optax state does)."""
    rule = conf.rule.lower()
    if rule.startswith("optax:"):
        from deeplearning4j_tpu_torch.ops import optax_adapter
        state = optax_adapter.resolve(conf).init(params)
        return {"optax": [t.to(device) if device is not None else t
                          for t in state]}

    def zeros():
        return {k: torch.zeros_like(v).detach() for k, v in params.items()}
    if rule in ("sgd", "none"):
        return {}
    if rule == "adagrad":
        return {"h": zeros()}
    if rule == "nesterovs":
        return {"v": zeros()}
    if rule == "rmsprop":
        return {"r": zeros()}
    if rule == "adadelta":
        return {"eg": zeros(), "edx": zeros()}
    if rule in ("adam", "adamax"):
        return {"m": zeros(), "v": zeros()}
    raise ValueError(f"Unknown updater rule {conf.rule!r}")


def _global_norm(grads, sq=None):
    if sq is not None:
        return torch.sqrt(sum(sq[k] for k in grads) + 1e-12)
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()) + 1e-12)


# the normalizations that take a gradient norm
_NORM_RULES = frozenset(("renormalizel2perlayer", "renormalizel2perparamtype",
                         "clipl2perlayer", "clipl2perparamtype"))


def normalize_gradients(conf: UpdaterConfig, grads, sq=None):
    """Gradient normalization/clipping per layer
    (LayerUpdater.java:184-224). ``sq`` (name -> the whole leaf's
    squared sum) supplies the norms when ``grads`` holds shards of the
    leaves (a sharding plan's levels 2-3)."""
    gn = (conf.gradient_normalization or "none").lower()
    if gn in ("none", ""):
        return grads
    thr = conf.gradient_normalization_threshold

    def leaf_norm(k, g):
        if sq is not None:
            return torch.sqrt(sq[k])
        return torch.linalg.norm(g.reshape(-1))
    if gn == "renormalizel2perlayer":
        norm = _global_norm(grads, sq)
        return {k: g / norm for k, g in grads.items()}
    if gn == "renormalizel2perparamtype":
        return {k: g / (leaf_norm(k, g) + 1e-12) for k, g in grads.items()}
    if gn == "clipelementwiseabsolutevalue":
        return {k: torch.clamp(g, -thr, thr) for k, g in grads.items()}
    if gn == "clipl2perlayer":
        scale = torch.clamp(thr / _global_norm(grads, sq), max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if gn == "clipl2perparamtype":
        def clip_one(k, g):
            norm = leaf_norm(k, g) + 1e-12
            return g * torch.clamp(thr / norm, max=1.0)
        return {k: clip_one(k, g) for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization "
                     f"{conf.gradient_normalization!r}")


def whole_sq_sums(confs, grads, axes, plan):
    """Per layer, the squared sums of its whole gradient leaves (name ->
    0-dim tensor) where its normalization takes a norm, else None.
    ``grads[i][k]`` is a shard where ``axes[i][k]`` is not None: those
    shards' sums are all-reduced over ``plan``'s ranks, in one call."""
    out, sharded = [], []
    for conf, g, ax in zip(confs, grads, axes):
        if (conf.gradient_normalization or "none").lower() not in \
                _NORM_RULES:
            out.append(None)
            continue
        q = {k: torch.sum(v * v) for k, v in g.items()}
        sharded += [(q, k) for k in q if ax[k] is not None]
        out.append(q)
    if sharded:
        total = torch.stack([q[k] for q, k in sharded])
        total = plan.all_reduce_sum(total)
        for j, (q, k) in enumerate(sharded):
            q[k] = total[j]
    return out


def compute_updates(conf: UpdaterConfig, grads, state, iteration,
                    params=None):
    """(updates to subtract, new state) for one layer. Bias parameters
    ("b", "gb", "vb", "beta") take ``bias_learning_rate`` when set."""
    rule = conf.rule.lower()
    grads = normalize_gradients(conf, grads)
    if rule.startswith("optax:"):
        from deeplearning4j_tpu_torch.ops import optax_adapter
        updates, inner = optax_adapter.resolve(conf).update(
            grads, state["optax"], params)
        # optax updates are ADDED; this contract subtracts
        return {k: -u for k, u in updates.items()}, {"optax": inner}
    sched = dict(decay_rate=conf.lr_policy_decay_rate,
                 steps=conf.lr_policy_steps, power=conf.lr_policy_power,
                 schedule=conf.lr_schedule,
                 max_iterations=conf.max_iterations)
    lr = learning_rate(conf.lr_policy, conf.learning_rate, iteration,
                       **sched)
    bias_lr = lr if conf.bias_learning_rate is None else learning_rate(
        conf.lr_policy, conf.bias_learning_rate, iteration, **sched)

    def lr_for(name):
        return bias_lr if name in _BIAS_NAMES else lr

    if rule == "none":
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state
    if rule == "sgd":
        return {k: lr_for(k) * g for k, g in grads.items()}, state
    if rule == "adagrad":
        h = {k: state["h"][k] + g * g for k, g in grads.items()}
        upd = {k: lr_for(k) * g / (torch.sqrt(h[k]) + conf.epsilon)
               for k, g in grads.items()}
        return upd, {"h": h}
    if rule == "nesterovs":
        mu = conf.momentum
        v = {k: mu * state["v"][k] + g for k, g in grads.items()}
        upd = {k: lr_for(k) * (g + mu * v[k]) for k, g in grads.items()}
        return upd, {"v": v}
    if rule == "rmsprop":
        d = conf.rms_decay
        r = {k: d * state["r"][k] + (1 - d) * g * g for k, g in grads.items()}
        upd = {k: lr_for(k) * g / torch.sqrt(r[k] + conf.epsilon)
               for k, g in grads.items()}
        return upd, {"r": r}
    if rule == "adadelta":
        rho, eps = conf.rho, conf.epsilon
        eg = {k: rho * state["eg"][k] + (1 - rho) * g * g
              for k, g in grads.items()}
        dx = {k: torch.sqrt(state["edx"][k] + eps) / torch.sqrt(eg[k] + eps)
              * g for k, g in grads.items()}
        edx = {k: rho * state["edx"][k] + (1 - rho) * dx[k] ** 2 for k in dx}
        return dx, {"eg": eg, "edx": edx}
    t = torch.as_tensor(iteration).to(torch.float32) + 1.0
    if rule == "adam":
        b1, b2, eps = conf.adam_mean_decay, conf.adam_var_decay, conf.epsilon
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * g * g
             for k, g in grads.items()}
        alpha = torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        upd = {k: lr_for(k) * alpha * m[k] / (torch.sqrt(v[k]) + eps)
               for k in grads}
        return upd, {"m": m, "v": v}
    if rule == "adamax":
        b1, b2, eps = conf.adam_mean_decay, conf.adam_var_decay, conf.epsilon
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: torch.maximum(b2 * state["v"][k], torch.abs(g))
             for k, g in grads.items()}
        upd = {k: lr_for(k) / (1.0 - b1 ** t) * m[k] / (v[k] + eps)
               for k in grads}
        return upd, {"m": m, "v": v}
    raise ValueError(f"Unknown updater rule {conf.rule!r}")


def l1_l2_score(params, l1=0.0, l2=0.0, l1_bias=0.0, l2_bias=0.0):
    """Regularization score term (calcL1/calcL2), added into the loss."""
    s = 0.0
    for k, p in params.items():
        is_bias = k in _BIAS_NAMES
        this_l1 = l1_bias if is_bias else l1
        this_l2 = l2_bias if is_bias else l2
        if this_l2:
            s = s + 0.5 * this_l2 * torch.sum(p * p)
        if this_l1:
            s = s + this_l1 * torch.sum(torch.abs(p))
    return s
