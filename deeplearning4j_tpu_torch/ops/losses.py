"""Loss functions: the port of ``deeplearning4j_tpu/ops/losses.py``.

Every loss has the reference's signature
``loss(labels, preout, activation, mask=None, weights=None)`` and returns
the per-example score: the per-element loss (times the mask, broadcast
over the trailing dims) summed over every axis but the first. For a time
series ``[B, T, C]`` with a ``[B, T]`` mask that is the sum over time and
classes. :func:`compute_score` sums the examples and divides by the batch
size when ``average``.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import activations

__all__ = ["compute_score", "get", "names", "register"]

_EPS = 1e-7

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def _score_array(per_elem, mask):
    """Sum per-element loss across feature dims → per-example score; apply
    mask."""
    if mask is not None:
        mask = torch.as_tensor(mask, device=per_elem.device)
        while mask.ndim < per_elem.ndim:
            mask = mask[..., None]
        per_elem = per_elem * mask
    reduce_axes = tuple(range(1, per_elem.ndim))
    return per_elem.sum(dim=reduce_axes) if reduce_axes else per_elem


def _apply_weights(per_elem, weights):
    if weights is not None:
        per_elem = per_elem * torch.as_tensor(weights, device=per_elem.device)
    return per_elem


def _activate(preout, activation):
    return activations.get(activation)(preout)


def _log1p_relu_clamped(x):
    return torch.log1p(torch.clamp(x, min=-1 + _EPS))


@register("l2")
def l2(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    return _score_array(_apply_weights((out - labels) ** 2, weights), mask)


@register("mse")
@register("squared_loss")
def mse(labels, preout, activation="identity", mask=None, weights=None):
    # reference LossMSE = LossL2 / nColumns
    return l2(labels, preout, activation, mask, weights) / labels.shape[-1]


@register("l1")
def l1(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    return _score_array(_apply_weights(torch.abs(out - labels), weights),
                        mask)


@register("mae")
def mae(labels, preout, activation="identity", mask=None, weights=None):
    return l1(labels, preout, activation, mask, weights) / labels.shape[-1]


@register("xent")
@register("binary_crossentropy")
def xent(labels, preout, activation="sigmoid", mask=None, weights=None):
    if str(activation).lower() == "sigmoid":
        # stable form: max(x,0) - x*z + log(1+exp(-|x|))
        x = preout
        per = torch.clamp(x, min=0) - x * labels \
            + torch.log1p(torch.exp(-torch.abs(x)))
    else:
        out = torch.clamp(_activate(preout, activation), _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return _score_array(_apply_weights(per, weights), mask)


def _log_probs(preout, activation):
    if str(activation).lower() == "softmax":
        return torch.log_softmax(preout, dim=-1)
    return torch.log(torch.clamp(_activate(preout, activation), _EPS, 1.0))


@register("mcxent")
@register("categorical_crossentropy")
@register("negativeloglikelihood")
def mcxent(labels, preout, activation="softmax", mask=None, weights=None):
    per = _apply_weights(-labels * _log_probs(preout, activation), weights)
    return _score_array(per, mask)


@register("sparse_mcxent")
def sparse_mcxent(labels, preout, activation="softmax", mask=None,
                  weights=None):
    """labels are integer class ids, not one-hot; ``weights`` are
    per-class: each example is weighted by weights[label]."""
    logp = _log_probs(preout, activation)
    lab = torch.as_tensor(labels, device=logp.device).long()
    if lab.ndim == logp.ndim:   # (..., 1) trailing dim
        lab = lab[..., 0]
    per = -torch.gather(logp, -1, lab[..., None])[..., 0]
    if weights is not None:
        per = per * torch.as_tensor(weights, device=per.device)[lab]
    if mask is not None:
        mask = torch.as_tensor(mask, device=per.device)
        if mask.ndim > per.ndim:
            mask = mask[..., 0]
        per = per * mask
    reduce_axes = tuple(range(1, per.ndim))
    return per.sum(dim=reduce_axes) if reduce_axes else per


@register("cosine_proximity")
def cosine_proximity(labels, preout, activation="identity", mask=None,
                     weights=None):
    out = _activate(preout, activation)
    ln = torch.linalg.norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.norm(out, dim=-1, keepdim=True)
    cos = (labels * out).sum(-1, keepdim=True) / torch.clamp(ln * on,
                                                             min=_EPS)
    return _score_array(_apply_weights(-cos, weights), mask)


@register("hinge")
def hinge(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    per = torch.clamp(1.0 - labels * out, min=0.0)
    return _score_array(_apply_weights(per, weights), mask)


@register("squared_hinge")
def squared_hinge(labels, preout, activation="identity", mask=None,
                  weights=None):
    out = _activate(preout, activation)
    per = torch.clamp(1.0 - labels * out, min=0.0) ** 2
    return _score_array(_apply_weights(per, weights), mask)


@register("kl_divergence")
@register("reconstruction_crossentropy")
def kl_divergence(labels, preout, activation="identity", mask=None,
                  weights=None):
    out = torch.clamp(_activate(preout, activation), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    per = lab * (torch.log(lab) - torch.log(out))
    return _score_array(_apply_weights(per, weights), mask)


@register("mean_absolute_percentage_error")
@register("mape")
def mape(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    per = 100.0 * torch.abs((labels - out)
                            / torch.clamp(torch.abs(labels), min=_EPS))
    return _score_array(_apply_weights(per, weights), mask)


@register("mean_squared_logarithmic_error")
@register("msle")
def msle(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    per = (_log1p_relu_clamped(out) - _log1p_relu_clamped(labels)) ** 2
    return _score_array(_apply_weights(per, weights), mask)


@register("poisson")
def poisson(labels, preout, activation="identity", mask=None, weights=None):
    out = _activate(preout, activation)
    per = out - labels * torch.log(torch.clamp(out, min=_EPS))
    return _score_array(_apply_weights(per, weights), mask)


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss function: {name!r}. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names():
    return sorted(set(_REGISTRY))


def compute_score(name, labels, preout, activation, mask=None, average=True):
    """Scalar score (ILossFunction.computeScore): the per-example scores
    summed, divided by the batch size when ``average``."""
    total = get(name)(labels, preout, activation, mask).sum()
    if average:
        return total / labels.shape[0]
    return total
