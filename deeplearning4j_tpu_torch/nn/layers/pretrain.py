"""Unsupervised pretrain layers: the port of
``deeplearning4j_tpu/nn/layers/pretrain.py`` (AutoEncoder, RBM,
VariationalAutoencoder).

The same parameter names, shapes and ``param_order`` as the reference
(``W``/``b``/``vb`` for the AutoEncoder and the RBM; the VAE's encoder
``e{i}W``/``e{i}b``, q(z|x) head ``pZXMeanW``/``pZXMeanb``/
``pZXLogStd2W``/``pZXLogStd2b``, decoder ``d{i}W``/``d{i}b`` and p(x|z)
head ``pXZW``/``pXZb``), so flat vectors and archives cross over.

Each layer has ``pretrain_grads(params, x, generator) -> (grads,
score)``: the AutoEncoder's and the VAE's come from autograd of their
loss, the RBM's CD-k update is written by hand (it is no tractable
loss's gradient; the reference hand-codes it too). Every random draw of
a pretrain step comes from the ``torch.Generator`` passed in, through
:func:`_uniform` (the corruption mask, the binary units' samples:
``u < p``, as JAX's ``bernoulli``) and :func:`_normal` (gaussian units,
the VAE's ``eps``). Torch's Philox and JAX's threefry do not agree, so
these two functions are the seam where tests inject the reference's
draws. With ``generator=None`` nothing is drawn: the AutoEncoder is not
corrupted and the VAE takes ``z`` at the mean. Under a sharding plan of
N ranks the generator comes wrapped in a :class:`RowShare`: each draw is
this rank's rows of the draw the global batch would take, so N ranks
draw what one process draws for their rows together.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import FeedForward
from deeplearning4j_tpu_torch.nn.layers.base import (FeedForwardLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.ops import activations as act_mod
from deeplearning4j_tpu_torch.ops import losses as losses_mod

__all__ = ["AutoEncoder", "BasePretrainLayer", "RBM", "RowShare",
           "VariationalAutoencoder"]

_LOG_2PI = math.log(2 * math.pi)


class RowShare:
    """A generator for rank ``rank`` of ``n`` ranks that each hold an
    equal share of a global batch: every draw (batch first) is taken for
    the global batch, ``n`` times the rows, from ``generator``, and this
    rank keeps its rows. Every rank seeds the same generator, so the
    ranks' draws together are one process's draws on the global batch."""

    def __init__(self, generator, rank, n):
        self.generator = generator
        self.rank = int(rank)
        self.n = int(n)

    def rows(self, draw, shape, like):
        b = shape[0]
        full = draw(self.generator, (b * self.n, *shape[1:]), like)
        return full[self.rank * b:(self.rank + 1) * b]


def _uniform(generator, shape, like):
    """U[0, 1) draws shaped ``shape``, in ``like``'s dtype and device."""
    if isinstance(generator, RowShare):
        return generator.rows(_uniform, shape, like)
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _normal(generator, shape, like):
    """N(0, 1) draws shaped ``shape``, in ``like``'s dtype and device."""
    if isinstance(generator, RowShare):
        return generator.rows(_normal, shape, like)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _autograd_pretrain(loss_fn, params, x, generator):
    """(grads, loss) of ``loss_fn(params, x, generator)`` by autograd
    over the layer's parameters."""
    names = list(params)
    with torch.enable_grad():
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        loss = loss_fn(leaves, x, generator)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return dict(zip(names, grads)), loss.detach()


def _n_in_from(layer, input_type):
    if layer.n_in is None:
        if hasattr(input_type, "size"):
            layer.n_in = input_type.size
        elif hasattr(input_type, "flattened_size"):
            layer.n_in = input_type.flattened_size
        else:
            raise ValueError(f"{type(layer).__name__} got non-FF input "
                             f"{input_type}")


class BasePretrainLayer(FeedForwardLayer):
    """Shape and parameter logic of the W/b/vb pretrain layers
    (BasePretrainNetwork.java)."""

    def set_input_type(self, input_type):
        _n_in_from(self, input_type)
        return self.output_type(input_type)

    def output_type(self, input_type):
        return FeedForward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}

    @property
    def param_order(self):
        return ["W", "b", "vb"]

    def init_params(self, generator, dtype=torch.float32):
        return {"W": self._init_weight(generator, (self.n_in, self.n_out),
                                       dtype=dtype),
                "b": self._init_bias(generator, (self.n_out,), dtype=dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype,
                                  device=generator.device)}

    def is_pretrain_layer(self):
        return True


@register_layer
@dataclass
class AutoEncoder(BasePretrainLayer):
    """Denoising autoencoder (AutoEncoder.java): masking noise with
    probability ``corruption_level``, decoder the tied ``W^T``."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def encode(self, params, x):
        return self.activation_fn()(x @ params["W"] + params["b"])

    def decode_pre(self, params, h):
        return h @ params["W"].T + params["vb"]

    def decode(self, params, h):
        return self.activation_fn()(self.decode_pre(params, h))

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, generator):
        corrupted = x
        if self.corruption_level > 0 and generator is not None:
            keep = _uniform(generator, x.shape, x) < \
                1.0 - self.corruption_level
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        recon_pre = self.decode_pre(params, self.encode(params, corrupted))
        per_example = losses_mod.get(self.loss)(
            x, recon_pre, self.activation or "sigmoid")
        return per_example.mean()

    def pretrain_grads(self, params, x, generator):
        return _autograd_pretrain(self.pretrain_loss, params, x, generator)


@register_layer
@dataclass
class RBM(BasePretrainLayer):
    """Restricted Boltzmann machine trained with CD-k (RBM.java:67, its
    Gibbs chain :102-276). ``visible_unit``/``hidden_unit``: 'binary' or
    'gaussian'."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    k: int = 1
    visible_unit: str = "binary"
    hidden_unit: str = "binary"

    def prop_up(self, params, v):
        pre = v @ params["W"] + params["b"]
        return pre if self.hidden_unit == "gaussian" else torch.sigmoid(pre)

    def prop_down(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        return pre if self.visible_unit == "gaussian" else torch.sigmoid(pre)

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        # supervised use: propUp through the layer's activation
        x = self.apply_dropout(x, train=train, rng=rng)
        return self.activation_fn()(x @ params["W"] + params["b"]), state

    @staticmethod
    def _sample(p, unit, generator):
        if unit == "gaussian":
            return p + _normal(generator, p.shape, p)
        return (_uniform(generator, p.shape, p) < p).to(p.dtype)

    def pretrain_grads(self, params, x, generator):
        """CD-k: grad = -(<v h>_data - <v h>_model) / batch (the
        minimisation form). The draws: h0, then (v, h) for each of the k
        Gibbs steps."""
        with torch.no_grad():
            batch = x.shape[0]
            ph0 = self.prop_up(params, x)
            h = self._sample(ph0, self.hidden_unit, generator)
            vk, hk_prob = x, ph0
            for _ in range(self.k):
                vk = self._sample(self.prop_down(params, h),
                                  self.visible_unit, generator)
                hk_prob = self.prop_up(params, vk)
                h = self._sample(hk_prob, self.hidden_unit, generator)
            # the positive and negative statistics take probabilities for
            # the final hidden units (CD's variance reduction), as the
            # reference does
            grads = {"W": -(x.T @ ph0 - vk.T @ hk_prob) / batch,
                     "b": -(ph0 - hk_prob).mean(0),
                     "vb": -(x - vk).mean(0)}
            recon_err = ((x - self.prop_down(params, ph0)) ** 2).mean()
        return grads, recon_err


# ---------------------------------------------------------------------------
# Variational autoencoder
# ---------------------------------------------------------------------------

def _recon_log_prob(distribution, activation_name, x, dist_params):
    """log p(x|z) per example for a reconstruction-distribution spec
    (the reference's ``_recon_log_prob``). A spec is ``"bernoulli"``,
    ``"gaussian"`` or ``"exponential"``; ``{"loss": name, "activation":
    act}`` (LossFunctionWrapper: a loss stands in for -log p(x|z)); or a
    list of ``{"dist": spec, "size": n, "activation": act}``
    (CompositeReconstructionDistribution: contiguous feature slices, each
    scored by its own spec)."""
    if isinstance(distribution, dict):
        fn = losses_mod.get(distribution["loss"])
        act = distribution.get("activation", activation_name) or "identity"
        return -fn(x, dist_params, act)
    if isinstance(distribution, (list, tuple)):
        out, in_ofs, par_ofs = 0.0, 0, 0
        for comp in distribution:
            size = int(comp["size"])
            sub = comp["dist"]
            n_par = _recon_param_count(sub, size)
            out = out + _recon_log_prob(
                sub, comp.get("activation"), x[:, in_ofs:in_ofs + size],
                dist_params[:, par_ofs:par_ofs + n_par])
            in_ofs += size
            par_ofs += n_par
        return out
    if distribution == "bernoulli":
        p = act_mod.get(activation_name or "sigmoid")(dist_params)
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        return (x * torch.log(p) + (1 - x) * torch.log(1 - p)).sum(1)
    if distribution == "gaussian":
        n = x.shape[1]
        mean = act_mod.get(activation_name or "identity")(dist_params[:, :n])
        log_var = dist_params[:, n:]
        return (-0.5 * (_LOG_2PI + log_var
                        + (x - mean) ** 2 / torch.exp(log_var))).sum(1)
    if distribution == "exponential":
        # gamma = log(lambda); log p = gamma - lambda x
        gamma = dist_params
        return (gamma - torch.exp(gamma) * x).sum(1)
    raise ValueError(f"Unknown reconstruction distribution {distribution!r}")


def _recon_param_count(distribution, n_in):
    """The decoder's output width for a spec over ``n_in`` features
    (distributionInputSize); a composite's sizes must cover the input."""
    if isinstance(distribution, dict):
        return n_in
    if isinstance(distribution, (list, tuple)):
        total = sum(int(c["size"]) for c in distribution)
        if total != n_in:
            raise ValueError(
                f"composite reconstruction sizes sum to {total}, but the "
                f"layer has {n_in} input features; sizes "
                f"{[c['size'] for c in distribution]}")
        return sum(_recon_param_count(c["dist"], int(c["size"]))
                   for c in distribution)
    return 2 * n_in if distribution == "gaussian" else n_in


def _recon_has_loss(distribution):
    """hasLossFunction(): every leaf is a LossFunctionWrapper."""
    if isinstance(distribution, dict):
        return True
    if isinstance(distribution, (list, tuple)):
        return all(_recon_has_loss(c["dist"]) for c in distribution)
    return False


def _recon_mean(distribution, activation_name, dist_params):
    """E[x|z] from the decoder's pre-output (generateAtMeanGivenZ)."""
    if isinstance(distribution, dict):
        act = distribution.get("activation", activation_name) or "identity"
        return act_mod.get(act)(dist_params)
    if isinstance(distribution, (list, tuple)):
        parts, par_ofs = [], 0
        for comp in distribution:
            n_par = _recon_param_count(comp["dist"], int(comp["size"]))
            parts.append(_recon_mean(comp["dist"], comp.get("activation"),
                                     dist_params[:, par_ofs:par_ofs + n_par]))
            par_ofs += n_par
        return torch.cat(parts, dim=1)
    if distribution == "bernoulli":
        return act_mod.get(activation_name or "sigmoid")(dist_params)
    if distribution == "gaussian":
        n = dist_params.shape[1] // 2
        return act_mod.get(activation_name or "identity")(dist_params[:, :n])
    return torch.exp(-dist_params)   # the exponential's mean, 1 / lambda


def _std_normal_log_prob(z):
    return (-0.5 * (_LOG_2PI + z ** 2)).sum(1)


@register_layer
@dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """The VAE as a layer (variational/VariationalAutoencoder.java:48).
    ``n_out`` is the latent size; pretraining minimises the negative
    single- or multi-sample ELBO with reparametrised z; the supervised
    forward outputs the q(z|x) mean, as the reference's activate()."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    encoder_layer_sizes: tuple = (100,)
    decoder_layer_sizes: tuple = (100,)
    pzx_activation: str = "identity"
    reconstruction_distribution: str = "bernoulli"
    reconstruction_activation: Optional[str] = None
    num_samples: int = 1

    def __post_init__(self):
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)

    def set_input_type(self, input_type):
        _n_in_from(self, input_type)
        return self.output_type(input_type)

    def output_type(self, input_type):
        return FeedForward(self.n_out)

    def is_pretrain_layer(self):
        return True

    def param_shapes(self):
        shapes = {}
        last = self.n_in
        for i, sz in enumerate(self.encoder_layer_sizes):
            shapes[f"e{i}W"] = (last, sz)
            shapes[f"e{i}b"] = (sz,)
            last = sz
        shapes["pZXMeanW"] = (last, self.n_out)
        shapes["pZXMeanb"] = (self.n_out,)
        shapes["pZXLogStd2W"] = (last, self.n_out)
        shapes["pZXLogStd2b"] = (self.n_out,)
        last = self.n_out
        for i, sz in enumerate(self.decoder_layer_sizes):
            shapes[f"d{i}W"] = (last, sz)
            shapes[f"d{i}b"] = (sz,)
            last = sz
        n_dist = _recon_param_count(self.reconstruction_distribution,
                                    self.n_in)
        shapes["pXZW"] = (last, n_dist)
        shapes["pXZb"] = (n_dist,)
        return shapes

    def init_params(self, generator, dtype=torch.float32):
        """Weights drawn in sorted name order (the reference's key
        split order), biases zero."""
        params = {}
        for name, shape in sorted(self.param_shapes().items()):
            if name.endswith("W"):
                params[name] = self._init_weight(generator, shape,
                                                 dtype=dtype)
            else:
                params[name] = torch.zeros(shape, dtype=dtype,
                                           device=generator.device)
        return params

    # ---- network pieces ------------------------------------------------
    def _encode(self, params, x):
        h = x
        act = self.activation_fn()
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"e{i}W"] + params[f"e{i}b"])
        mean = act_mod.get(self.pzx_activation)(
            h @ params["pZXMeanW"] + params["pZXMeanb"])
        log_var = h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]
        return mean, log_var

    def _decode(self, params, z):
        h = z
        act = self.activation_fn()
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"d{i}W"] + params[f"d{i}b"])
        return h @ params["pXZW"] + params["pXZb"]

    def forward(self, params, x, state, *, train=False, rng=None, mask=None):
        x = self.apply_dropout(x, train=train, rng=rng)
        mean, _ = self._encode(params, x)
        return mean, state

    def has_loss_function(self):
        """True when the reconstruction spec is made of
        LossFunctionWrappers only: no probabilistic reading exists."""
        return _recon_has_loss(self.reconstruction_distribution)

    def reconstruction_error(self, params, x):
        """Per-example reconstruction error at z = the mean, for
        loss-function specs (reconstructionError)."""
        if not self.has_loss_function():
            raise ValueError(
                "reconstruction_error() requires a loss-function "
                "reconstruction spec; use reconstruction_log_probability() "
                "for probabilistic distributions")
        mean, _ = self._encode(params, x)
        return -_recon_log_prob(self.reconstruction_distribution,
                                self.reconstruction_activation, x,
                                self._decode(params, mean))

    def reconstruction_log_probability(self, params, x, generator=None,
                                       num_samples=None):
        """Per-example log p(x) by importance sampling over q(z|x)
        (reconstructionLogProbability): log(1/S sum_s p(x|z_s) p(z_s) /
        q(z_s|x)). ``generator=None`` takes every z_s at the mean."""
        if self.has_loss_function():
            raise ValueError(
                "reconstruction_log_probability is undefined for "
                "loss-function reconstruction specs (no probabilistic "
                "interpretation); use reconstruction_error() instead")
        n_samples = num_samples or max(1, self.num_samples)
        mean, log_var = self._encode(params, x)
        std = torch.exp(0.5 * log_var)
        log_ws = []
        for _ in range(n_samples):
            eps = torch.zeros_like(mean) if generator is None \
                else _normal(generator, mean.shape, mean)
            z = mean + eps * std
            log_p_xz = _recon_log_prob(
                self.reconstruction_distribution,
                self.reconstruction_activation, x, self._decode(params, z))
            log_q_zx = (-0.5 * (_LOG_2PI + log_var + (z - mean) ** 2
                                / torch.exp(log_var))).sum(1)
            log_ws.append(log_p_xz + _std_normal_log_prob(z) - log_q_zx)
        return torch.logsumexp(torch.stack(log_ws), dim=0) - \
            math.log(float(n_samples))

    def generate_at_mean_given_z(self, params, z):
        return _recon_mean(self.reconstruction_distribution,
                           self.reconstruction_activation,
                           self._decode(params, z))

    # ---- ELBO pretraining ----------------------------------------------
    def pretrain_loss(self, params, x, generator):
        mean, log_var = self._encode(params, x)
        kl = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum(1)
        n_samples = max(1, self.num_samples)
        recon = 0.0
        for _ in range(n_samples):
            if generator is None:
                z = mean
            else:
                z = mean + _normal(generator, mean.shape, mean) * \
                    torch.exp(0.5 * log_var)
            recon = recon + _recon_log_prob(
                self.reconstruction_distribution,
                self.reconstruction_activation, x, self._decode(params, z))
        return (kl - recon / n_samples).mean()

    def pretrain_grads(self, params, x, generator):
        return _autograd_pretrain(self.pretrain_loss, params, x, generator)
