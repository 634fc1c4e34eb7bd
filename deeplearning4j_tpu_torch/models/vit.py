"""Vision Transformer classifier: the port of
``deeplearning4j_tpu/models/vit.py``.

Patchify, a pre-LN transformer encoder, mean pool, a linear head: the
reference's model on the fit/score surface of the other models. Images
come in NHWC ``[B, S, S, C]``, as the reference takes them; a patch is
flattened in ``(P, P, C)`` order, so the reference's ``wpatch [P·P·C,
d]`` carries over unchanged. Parameters form the reference's tree
(``wpatch``, ``wpatch_b``, ``wpe``, ``b{i}`` → ``qkv``, ...,
``lnf_g``/``lnf_b``, ``head``/``head_b``) as nested
``nn.ParameterDict``s; ``models/transformer.py``'s
:func:`~deeplearning4j_tpu_torch.models.transformer.params_from_numpy`
carries a JAX tree over. The step is the LM's AdamW with the GPT-2 decay
discipline (matmul weights decay; LayerNorm, biases and ``wpe`` do not)
at a constant learning rate.

Attention is non-causal. On the card it goes through
``ops.flash_attention``: the hand-written forward kernel, and the dQ and
dK/dV kernels in training. On the CPU it is the reference's dense math
(``parallel/sequence_parallel.py`` ``dense_attention``). Any other device
raises: a card tensor reaches the kernels or an error.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerLM, _adamw_apply, _flatten, _fresh_opt_state, _layer_norm,
    _parameter_tree, _tree_map, _unflatten)
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
    dense_attention

__all__ = ["ViTConfig", "ViT"]


@dataclass
class ViTConfig:
    image_size: int                # square inputs (H = W)
    n_channels: int = 3
    patch_size: int = 4
    n_classes: int = 10
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    dropout: float = 0.0
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    compute_dtype: Optional[str] = None   # e.g. "bfloat16"
    remat: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size "
                f"{self.patch_size}")
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}")

    @property
    def n_patches(self):
        return (self.image_size // self.patch_size) ** 2


def _attend(q, k, v):
    """Non-causal attention over [B, H, T, hd]: the flash kernels for a
    CUDA tensor, the dense reference math for a CPU tensor."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=False)
    if q.device.type == "cpu":
        return dense_attention(q, k, v, causal=False)
    raise ValueError(f"ViT attention runs on cuda or cpu, not {q.device}")


class ViT(nn.Module):
    """Patchify → pre-LN transformer encoder → mean pool → linear head.

    ``device=None`` means the card; pass ``device="cpu"`` to run on the
    CPU. Parameters come from :meth:`init` (seeded) or from
    ``params_from_numpy`` assigned to ``params``; ``fit_batch`` makes a
    fresh optimizer state if none was given."""

    def __init__(self, config: ViTConfig, *, device=None):
        super().__init__()
        self.conf = config
        self.device = resolve_device(device)
        self.params = None
        self.opt_state = None
        self.iteration = 0
        self.score_ = float("nan")
        self.listeners = []
        self._rng = None   # dropout generator, seeded conf.seed + 1

    # the LM's listener, dropout-stream and dropout-mask surface
    set_listeners = TransformerLM.set_listeners
    rng_state = TransformerLM.rng_state
    set_rng_state = TransformerLM.set_rng_state
    _drop = TransformerLM._drop

    # ---- parameters ----------------------------------------------------
    def init(self):
        """Random parameters with the reference's shapes and scales, from a
        ``torch.Generator`` seeded with ``conf.seed`` on this device (the
        values differ from JAX's threefry draws), and a fresh optimizer
        state."""
        c = self.conf
        g = torch.Generator(device=self.device).manual_seed(c.seed)
        d, h = c.d_model, c.d_ff
        pdim = c.patch_size * c.patch_size * c.n_channels
        std = 0.02

        def normal(shape, scale=std):
            return scale * torch.randn(shape, generator=g,
                                       device=self.device)

        def ones(n):
            return torch.ones(n, device=self.device)

        def zeros(n):
            return torch.zeros(n, device=self.device)
        p = {"wpatch": normal((pdim, d)), "wpatch_b": zeros(d),
             "wpe": normal((c.n_patches, d)),
             "lnf_g": ones(d), "lnf_b": zeros(d),
             "head": normal((d, c.n_classes)), "head_b": zeros(c.n_classes)}
        rs = std / math.sqrt(2 * c.n_layers)
        for i in range(c.n_layers):
            p[f"b{i}"] = {
                "ln1_g": ones(d), "ln1_b": zeros(d),
                "qkv": normal((d, 3 * d)), "qkv_b": zeros(3 * d),
                "proj": normal((d, d), rs), "proj_b": zeros(d),
                "ln2_g": ones(d), "ln2_b": zeros(d),
                "fc": normal((d, h)), "fc_b": zeros(h),
                "out": normal((h, d), rs), "out_b": zeros(d),
            }
        self.params = _parameter_tree(p)
        self.opt_state = _fresh_opt_state(c, self.params)
        self.iteration = 0
        return self

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    # ---- forward -------------------------------------------------------
    def _patchify(self, x):
        """NHWC [B, S, S, C] → [B, patches, P·P·C], each patch flattened in
        (P, P, C) order (reshapes only: the embedding is one matmul)."""
        c = self.conf
        B, P = x.shape[0], c.patch_size
        n = c.image_size // P
        x = x.reshape(B, n, P, n, P, c.n_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, n * n, P * P * c.n_channels)

    def _keep_masks(self, B, rng):
        """Per layer, the two residual branches' keep-masks [B, T, d],
        drawn from ``rng`` before any block runs (outside what remat
        recomputes), as the LM draws its own."""
        c = self.conf
        if rng is None or c.dropout <= 0.0:
            return [None] * c.n_layers
        shape = (B, c.n_patches, c.d_model)

        def draw():
            return torch.rand(shape, generator=rng,
                              device=self.device) < 1.0 - c.dropout
        return [(draw(), draw()) for _ in range(c.n_layers)]

    def _block(self, bp, x, keep=None):
        c = self.conf
        B, T, d = x.shape
        hd = d // c.n_heads
        r1, r2 = keep if keep is not None else (None, None)
        hloc = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
        qkv = hloc @ bp["qkv"] + bp["qkv_b"]
        q, k, v = (a.reshape(B, T, c.n_heads, hd).transpose(1, 2)
                   for a in torch.split(qkv, d, dim=-1))
        o = _attend(q, k, v).transpose(1, 2).reshape(B, T, d)
        x = x + self._drop(o @ bp["proj"] + bp["proj_b"], r1)
        hloc = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
        # jax.nn.gelu defaults to the tanh approximation
        m = F.gelu(hloc @ bp["fc"] + bp["fc_b"], approximate="tanh") \
            @ bp["out"] + bp["out_b"]
        return x + self._drop(m, r2)

    def _logits(self, params, x, rng=None):
        """Logits [B, n_classes] in f32: the patch embedding, the blocks
        and the head in the compute dtype, mean pooled over patches."""
        c = self.conf
        keeps = self._keep_masks(x.shape[0], rng)
        x = self._patchify(x)
        if c.compute_dtype:
            cd = getattr(torch, c.compute_dtype)
            x = x.to(cd)
            params = _tree_map(
                lambda a: a.to(cd) if a.is_floating_point() else a, params)
        x = x @ params["wpatch"] + params["wpatch_b"] + params["wpe"]
        for i in range(c.n_layers):
            bp = params[f"b{i}"]
            if c.remat:
                x = checkpoint(self._block, bp, x, keeps[i],
                               use_reentrant=False)
            else:
                x = self._block(bp, x, keeps[i])
        x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
        logits = x.mean(dim=1) @ params["head"] + params["head_b"]
        return logits.to(torch.float32)

    def _loss(self, params, x, y_onehot, rng=None):
        logp = torch.log_softmax(self._logits(params, x, rng), dim=-1)
        return -(y_onehot * logp).sum() / x.shape[0]

    # ---- training ------------------------------------------------------
    def _value_and_grad(self, x, y, rng=None):
        """(loss, gradient tree) at the current parameters."""
        leaves = _flatten(self.params)
        with obs.span("fit.forward", device=self.device):
            loss = self._loss(self.params, x, y, rng)
        with obs.span("fit.backward", device=self.device):
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), _unflatten(dict(zip(leaves, grads)))

    def _train_step(self, x, y):
        """One step, eagerly: the reference's jitted step (loss and
        gradients, AdamW at the constant ``learning_rate``). Returns the
        loss as a device scalar."""
        c = self.conf
        rng = None
        if c.dropout > 0:
            if self._rng is None:
                self._rng = torch.Generator(device=self.device).manual_seed(
                    c.seed + 1)
            rng = self._rng
        loss, grads = self._value_and_grad(x, y, rng)
        t = self.iteration + 1
        with obs.span("fit.update", device=self.device):
            _adamw_apply(c, self.params, grads, self.opt_state, t,
                         c.learning_rate)
        self.iteration = t
        return loss

    def _device_images(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def _device_labels(self, y):
        """[B, n_classes] f32 one-hot rows from int class ids [B] or
        one-hot (or soft) rows."""
        y = y if isinstance(y, torch.Tensor) else \
            torch.from_numpy(np.asarray(y))
        y = y.to(self.device)
        if y.ndim == 1:
            return F.one_hot(y.to(torch.int64),
                             self.conf.n_classes).to(torch.float32)
        return y.to(torch.float32)

    def fit_batch(self, x, y):
        """One step. x: [B, S, S, C] floats; y: [B, n_classes] one-hot or
        [B] int class ids. Returns the loss, also kept as ``score_``: a
        device scalar, read lazily."""
        with obs.span("fit.step"):
            if self.params is None:
                self.init()
            if self.opt_state is None:
                self.opt_state = _fresh_opt_state(self.conf, self.params)
            with obs.span("fit.input_copy", device=self.device):
                x, y = self._device_images(x), self._device_labels(y)
            self.score_ = self._train_step(x, y)
            with obs.span("fit.listeners"):
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration)
            return self.score_

    def fit(self, data, *, epochs=1):
        """Train over a DataSetIterator (``reset()`` honoured) or an
        iterable of (x, y) / DataSet batches, the MLN fit() surface."""
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for batch in data:
                if hasattr(batch, "features"):
                    self.fit_batch(batch.features, batch.labels)
                else:
                    self.fit_batch(*batch)
        return self

    def output(self, x):
        """Class probabilities [B, n_classes] as host numpy (no update):
        one copy of the images to the device, one of the result back."""
        if self.params is None:
            raise ValueError("ViT has no parameters: call init() or assign "
                             "params_from_numpy(...)")
        xs = self._device_images(x)
        with torch.inference_mode():
            probs = torch.softmax(self._logits(self.params, xs), dim=-1)
        return probs.cpu().numpy()

    def predict(self, x):
        return np.argmax(self.output(x), axis=-1)

    def evaluate(self, x, y_ids):
        """Top-1 accuracy against int class ids."""
        return float((self.predict(x) == np.asarray(y_ids)).mean())
