"""Decoder-only Transformer language model: inference and training.

Ports ``deeplearning4j_tpu/models/transformer.py`` piece by piece under
the same names: the config, rotary embeddings, the pre-LN block with its
residual-branch dropout, the token forward with its ``compute_dtype``
cast and tied f32 head, ``TransformerLM.init``/``output``, and the train
path: ``_loss`` (mask, label smoothing, z-loss), ``_lr_at``,
``_decay_mask``, ``_adamw_apply``, global-norm clipping, EMA, remat,
``fit_batch``/``fit``, ``eval_loss``/``perplexity``, ``clone`` and
``ema_model``. Generation, the decode and prefill programs and sharding
come with later slices.

Layouts are the reference's: dense weights are ``[in, out]`` applied as
``x @ W``; q/k/v are ``[B, H, T, hd]``; parameters form the same tree of
names (``wte``, ``wpe``, ``lnf_g``, ``b0`` → ``qkv``, ...), held as
nested ``nn.ParameterDict``s. :func:`params_from_numpy` carries a JAX
parameter tree over, :func:`opt_state_from_numpy` its optimizer state.

Attention with ``block_size`` set goes through
``ops.flash_attention`` — the hand-written CUDA kernels on the card,
forward and backward — and without it through the dense oracle, as in
the reference. The step runs eagerly: where the reference jits one
program, the port launches the same math op by op.
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
from deeplearning4j_tpu_torch.config import env_str
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    blockwise_attention, dense_attention)

__all__ = ["TransformerConfig", "TransformerLM", "opt_state_from_numpy",
           "params_from_numpy"]

_OBS_OUTPUT_SECONDS = obs.histogram(
    "infer.output_seconds",
    "Host wall-clock of one output() inference dispatch + fetch (the "
    "batch the serving tier groups requests into)")


def _rope_cos_sin(c, hd, positions):
    """cos/sin tables for rotary embeddings at ``positions`` (any shape),
    returned shaped positions.shape + [hd/2], in f32."""
    inv = c.rope_base ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """Rotate interleaved pairs of the head dim. x: [..., T, hd];
    cos/sin: [T, hd/2] (broadcast over the leading dims)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _full_heads(c, k, v):
    """Expand GQA K/V to full query heads for routes that assume MHA.
    Consecutive query heads share a kv head, as in the kernel's
    b // kv_group map."""
    if c.kv_group > 1:
        k = k.repeat_interleave(c.kv_group, dim=1)
        v = v.repeat_interleave(c.kv_group, dim=1)
    return k, v


def _blockwise_route(c, q, k, v):
    """Route the block_size attention: ``flash_attention`` (the CUDA
    kernel for CUDA tensors, its plain twin for CPU tensors), unless
    ``DL4J_TORCH_LM_ATTN=scan`` asks for the plain blockwise recurrence.
    ``scan`` is a CPU parity route: on any other device it raises, so a
    card tensor reaches the kernel or an error, never plain attention.
    A sliding window rides the flash route; the recurrence has no window
    support, so that combination falls back to masked dense attention."""
    if env_str("DL4J_TORCH_LM_ATTN") != "scan":
        # GQA rides the kernel's index map: no repeat materialised
        return flash_attention(q, k, v, causal=True, block_q=c.block_size,
                               block_k=c.block_size, window=c.window)
    if q.device.type != "cpu":
        raise ValueError(f"DL4J_TORCH_LM_ATTN=scan runs on the CPU only; "
                         f"{q.device} tensors take the flash kernel")
    k, v = _full_heads(c, k, v)
    if c.window is not None:
        return dense_attention(q, k, v, causal=True, window=c.window)
    return blockwise_attention(q, k, v, causal=True,
                               block_size=c.block_size)


@dataclass
class TransformerConfig:
    vocab_size: int
    max_len: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    dropout: float = 0.0           # residual-branch dropout (train only)
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"  # "constant" | "cosine"
    warmup_steps: int = 0          # linear warmup before the schedule
    total_steps: int = 10000       # cosine horizon (floor = 10% of peak)
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    compute_dtype: Optional[str] = None   # e.g. "bfloat16"
    remat: bool = False
    block_size: Optional[int] = None      # flash-attention block; None=dense
    window: Optional[int] = None          # causal sliding-window width
    n_kv_heads: Optional[int] = None      # GQA: K/V heads (None = MHA)
    pos_embed: str = "learned"            # "learned" (wpe) | "rope"
    rope_base: float = 10000.0
    grad_clip_norm: Optional[float] = None   # global-norm gradient clip
    label_smoothing: float = 0.0
    z_loss: float = 0.0                   # PaLM logit-normalizer penalty
    ema_decay: Optional[float] = None     # Polyak weight averaging
    seed: int = 0

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads "
                f"{self.n_kv_heads}")
        if self.pos_embed not in ("learned", "rope"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}")
        if self.pos_embed == "rope" and (self.d_model // self.n_heads) % 2:
            raise ValueError("rope needs an even head dim")
        if self.ema_decay is not None and not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), "
                             f"got {self.ema_decay}")

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    @property
    def kv_group(self):
        return self.n_heads // self.kv_heads


def _decay_mask(params):
    """GPT-2 decay discipline: weight decay applies only to matmul weight
    matrices; biases (``*_b``), LayerNorm gains/biases and the position
    embedding are exempt. Returns a tree of 0.0/1.0 matching ``params``."""
    return {k: _decay_mask(v) if isinstance(v, (dict, nn.ParameterDict))
            else (1.0 if v.ndim >= 2 and k != "wpe" and not k.endswith("_b")
                  else 0.0)
            for k, v in params.items()}


def _layer_norm(x, g, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)   # biased variance
    return (x - m) / torch.sqrt(v + eps) * g + b


def _block_apply(c, bp, x, drop=None, keep=None):
    """One pre-LN block from its parameter dict (the reference's
    canonical block math). ``drop(a, mask)`` applies residual-branch
    dropout with ``keep``, this block's pair of keep-masks. The masks
    stand for the reference's ``rng``: they are drawn before the block, so
    a block recomputed under remat applies the same ones."""
    B, T, d = x.shape
    hd = d // c.n_heads
    r1, r2 = keep if keep is not None else (None, None)
    hloc = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = hloc @ bp["qkv"] + bp["qkv_b"]
    kvd = c.kv_heads * hd
    q, k, v = torch.split(qkv, [d, kvd, kvd], dim=-1)   # [q | k | v]

    def split(a, heads):
        return a.reshape(B, T, heads, hd).transpose(1, 2)
    q = split(q, c.n_heads)
    k, v = split(k, c.kv_heads), split(v, c.kv_heads)
    if c.pos_embed == "rope":
        cos, sin = _rope_cos_sin(c, hd, torch.arange(T, device=x.device))
        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    if c.block_size:
        o = _blockwise_route(c, q, k, v)
    else:
        k, v = _full_heads(c, k, v)
        o = dense_attention(q, k, v, causal=True, window=c.window)
    o = o.transpose(1, 2).reshape(B, T, d)
    a = o @ bp["proj"] + bp["proj_b"]
    x = x + (drop(a, r1) if drop else a)
    hloc = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation
    m = F.gelu(hloc @ bp["fc"] + bp["fc_b"], approximate="tanh") \
        @ bp["out"] + bp["out_b"]
    return x + (drop(m, r2) if drop else m)


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict / ParameterDict;
    returns plain nested dicts."""
    return {k: _tree_map(fn, v) if isinstance(v, (dict, nn.ParameterDict))
            else fn(v) for k, v in tree.items()}


def _flatten(tree, prefix=""):
    """{"b0.qkv": leaf, ...} of a nested dict / ParameterDict. The
    optimizer pairs the trees' leaves by these paths, so trees built in a
    different key order (the port's init, a JAX tree) still line up."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, nn.ParameterDict)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return tree


def _forward_tokens(c, params, tokens, apply_block):
    """The token forward: embed (gathered in f32) + compute_dtype cast +
    per-layer ``apply_block(i, block_params, x)`` + final LN + tied
    logits, returned in f32."""
    T = tokens.shape[1]
    x = params["wte"][tokens]
    if "wpe" in params:            # absent under rope (rotary in-block)
        x = x + params["wpe"][:T]
    if c.compute_dtype:
        cd = getattr(torch, c.compute_dtype)
        x = x.to(cd)
        params = _tree_map(
            lambda a: a.to(cd) if a.is_floating_point() else a, params)
    for i in range(c.n_layers):
        x = apply_block(i, params[f"b{i}"], x)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return (x @ params["wte"].T).to(torch.float32)   # tied embeddings


def _lr_at(c, t):
    """Warmup + optional cosine schedule on the config's learning rate at
    step ``t`` (1-based), as a host float: the reference's formula."""
    lr = c.learning_rate
    if c.lr_schedule == "cosine":
        frac = min(max((t - c.warmup_steps)
                       / max(1, c.total_steps - c.warmup_steps), 0.0), 1.0)
        lr = lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))
    if c.warmup_steps > 0:
        lr = lr * min(1.0, t / c.warmup_steps)
    return lr


def _adamw_apply(c, params, grads, opt, t, lr_t):
    """One bias-corrected AdamW update with the GPT-2 decay mask, in
    place on ``params`` and ``opt["m"]``/``opt["v"]``, by the reference's
    formula ``p - lr (m̂ / (√v̂ + eps) + wd mask p)`` (written out here:
    ``torch.optim.AdamW`` decays in another order and takes the mask only
    as parameter groups). Each step of the formula runs as one
    multi-tensor op over all leaves."""
    b1, b2 = c.beta1, c.beta2
    fp = _flatten(params)
    fg, fm, fv = _flatten(grads), _flatten(opt["m"]), _flatten(opt["v"])
    fmask = _flatten(_decay_mask(params))
    names = list(fp)
    p, g, m, v = ([f[n] for n in names] for f in (fp, fg, fm, fv))
    decayed = [i for i, n in enumerate(names) if fmask[n]]
    with torch.no_grad():
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        upd = torch._foreach_div(m, 1 - b1 ** t)              # m̂
        den = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
        torch._foreach_add_(den, c.eps)
        torch._foreach_div_(upd, den)
        if c.weight_decay and decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                [p[i] for i in decayed],
                                alpha=c.weight_decay)
        torch._foreach_mul_(upd, lr_t)
        torch._foreach_sub_(p, upd)


def _parameter_tree(tree):
    """Trainable ``nn.Parameter`` leaves; ``output()`` runs under
    ``torch.inference_mode()``, so serving records no graph."""
    return nn.ParameterDict({
        k: _parameter_tree(v) if isinstance(v, dict)
        else nn.Parameter(v) for k, v in tree.items()})


def _fresh_opt_state(c, params):
    opt = {"m": _tree_map(torch.zeros_like, params),
           "v": _tree_map(torch.zeros_like, params)}
    if c.ema_decay is not None:   # Polyak shadow starts at the parameters
        opt["ema"] = _tree_map(lambda a: a.detach().clone(), params)
    return opt


def _to_device(tree, dev):
    return _tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)


def params_from_numpy(tree, device=None):
    """The port's parameters from a JAX ``TransformerLM`` parameter tree
    given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, lm.params)``), as f32 tensors on
    ``device`` (None means cuda). This is the one place a layout change
    between the two packages would go; today there is none: both keep
    dense weights ``[in, out]`` and the embedding ``[vocab, d]``."""
    return _parameter_tree(_to_device(tree, resolve_device(device)))


def opt_state_from_numpy(tree, device=None):
    """``(opt_state, iteration)`` from a JAX ``TransformerLM``'s optimizer
    state as nested dicts of numpy arrays: ``{"m": ..., "v": ...}`` plus
    ``"ema"`` when the run keeps one, and optionally ``"iteration"`` (the
    steps taken; 0 if absent). Assign both to a port model that holds
    the same parameters and it continues the JAX run::

        lm.params = params_from_numpy(jax.tree.map(np.asarray, jlm.params))
        lm.opt_state, lm.iteration = opt_state_from_numpy(
            {**jax.tree.map(np.asarray, jlm.opt_state),
             "iteration": int(jlm.iteration)})
    """
    dev = resolve_device(device)
    state = {k: _to_device(tree[k], dev) for k in ("m", "v", "ema")
             if k in tree}
    return state, int(tree.get("iteration", 0))


def _token_array(tokens, vocab_size):
    """Validate a host [B, T] integer token array."""
    toks = np.asarray(tokens)
    if toks.ndim != 2 or not np.issubdtype(toks.dtype, np.integer):
        raise ValueError(f"tokens must be a [B, T] integer array, "
                         f"got {toks.dtype} {toks.shape}")
    if toks.size and (toks.min() < 0 or toks.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size})")
    return toks


class TransformerLM(nn.Module):
    """Pre-LN decoder-only LM with tied input/output embeddings.

    ``device=None`` means the card; pass ``device="cpu"`` to run on the
    CPU. Parameters come from :meth:`init` (seeded) or from
    :func:`params_from_numpy` assigned to ``params``; ``fit_batch`` makes
    a fresh optimizer state if none was given."""

    # row dtype the serving front end warms with: token ids
    input_dtype = "int32"

    def __init__(self, config: TransformerConfig, *, device=None):
        super().__init__()
        self.conf = config
        self.device = resolve_device(device)
        self.params = None
        self.opt_state = None
        self.iteration = 0
        self.score_ = float("nan")
        self.listeners = []
        self._rng = None   # dropout generator, seeded conf.seed + 1

    def set_listeners(self, *listeners):
        """Iteration listeners (``optimize/listeners.py``): each gets
        ``iteration_done(model, iteration)`` after every step."""
        self.listeners = list(listeners)
        return self

    def clone(self):
        """Deep copy of parameters, optimizer state, step count and
        score; ``type(self)`` so a subclass clones as itself."""
        other = type(self)(self.conf, device=self.device)
        if self.params is not None:
            other.params = _parameter_tree(
                _tree_map(lambda a: a.detach().clone(), self.params))
        if self.opt_state is not None:
            other.opt_state = _tree_map(lambda a: a.clone(), self.opt_state)
        other.iteration = self.iteration
        other.score_ = self.score_
        return other

    def ema_model(self):
        """A clone evaluating with the Polyak-averaged (EMA) weights."""
        if self.opt_state is None or "ema" not in self.opt_state:
            raise ValueError("ema_model() needs ema_decay set before init")
        other = self.clone()
        other.params = _parameter_tree(
            _tree_map(lambda a: a.clone(), self.opt_state["ema"]))
        return other

    def init(self):
        """Random parameters with the reference's shapes and scales, from
        a ``torch.Generator`` seeded with ``conf.seed`` on this device
        (the values differ from JAX's threefry draws), and a fresh
        optimizer state."""
        c = self.conf
        g = torch.Generator(device=self.device).manual_seed(c.seed)
        d, h = c.d_model, c.d_ff
        std = 0.02

        def normal(shape, scale=std):
            return scale * torch.randn(shape, generator=g,
                                       device=self.device)

        def ones(n):
            return torch.ones(n, device=self.device)

        def zeros(n):
            return torch.zeros(n, device=self.device)
        p = {"wte": normal((c.vocab_size, d)), "lnf_g": ones(d),
             "lnf_b": zeros(d)}
        if c.pos_embed == "learned":   # rope needs no position table
            p["wpe"] = normal((c.max_len, d))
        # GQA shrinks the K/V projections: q keeps d columns, k/v carry
        # kv_heads*hd each
        qkv_cols = d + 2 * c.kv_heads * (d // c.n_heads)
        # residual-branch output projections scaled 1/sqrt(2L) (GPT-2)
        rs = std / math.sqrt(2 * c.n_layers)
        for i in range(c.n_layers):
            p[f"b{i}"] = {
                "ln1_g": ones(d), "ln1_b": zeros(d),
                "qkv": normal((d, qkv_cols)), "qkv_b": zeros(qkv_cols),
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
    def _drop(self, x, keep):
        """Inverted dropout on a residual branch with a drawn keep-mask;
        identity without one (eval/generate) or at rate 0."""
        rate = self.conf.dropout
        if keep is None or rate <= 0.0:
            return x
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)

    def _keep_masks(self, tokens, rng):
        """Per layer, the two residual branches' keep-masks [B, T, d],
        drawn from ``rng`` before any block runs (outside what remat
        recomputes; ``torch.utils.checkpoint`` restores only the default
        generators, never an explicit one)."""
        c = self.conf
        if rng is None or c.dropout <= 0.0:
            return [None] * c.n_layers
        shape = (*tokens.shape, c.d_model)

        def draw():
            return torch.rand(shape, generator=rng,
                              device=tokens.device) < 1.0 - c.dropout
        return [(draw(), draw()) for _ in range(c.n_layers)]

    def _logits(self, params, tokens, rng=None):
        c = self.conf
        keeps = self._keep_masks(tokens, rng)
        drop = self._drop if keeps[0] is not None else None

        def apply(i, bp, x):
            if c.remat:
                return checkpoint(
                    _block_apply, c, bp, x, drop, keeps[i],
                    use_reentrant=False)
            return _block_apply(c, bp, x, drop, keeps[i])

        return _forward_tokens(c, params, tokens, apply)

    def _loss(self, params, tokens, targets, mask, rng=None):
        c = self.conf
        logits = self._logits(params, tokens, rng)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if c.label_smoothing > 0.0:
            # smoothed CE: (1-a)*nll + a*mean over the vocabulary
            a = c.label_smoothing
            nll = (1.0 - a) * nll - a * logp.mean(-1)
        m = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        denom = torch.clamp(m.sum(), min=1.0)
        loss = (nll * m).sum() / denom
        if c.z_loss > 0.0:
            # PaLM z-loss: pulls log Z toward 0, stabilizing bf16 logits
            z = torch.logsumexp(logits, dim=-1)
            loss = loss + c.z_loss * ((z ** 2) * m).sum() / denom
        return loss

    # ---- training ------------------------------------------------------
    def _value_and_grad(self, tokens, targets, mask, rng=None):
        """(loss, gradient tree) at the current parameters."""
        leaves = _flatten(self.params)
        loss = self._loss(self.params, tokens, targets, mask, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), _unflatten(dict(zip(leaves, grads)))

    def _apply_update(self, grads):
        """Global-norm clip, AdamW at step ``iteration + 1``, EMA; the
        update half of the reference's ``_build_step``."""
        c = self.conf
        if c.grad_clip_norm is not None:
            g = list(_flatten(grads).values())
            gn = torch.sqrt(sum(torch.sum(torch.square(x)) for x in g))
            scale = torch.clamp(c.grad_clip_norm / torch.clamp(gn, min=1e-12),
                                max=1.0)
            torch._foreach_mul_(g, scale)
        t = self.iteration + 1
        _adamw_apply(c, self.params, grads, self.opt_state, t, _lr_at(c, t))
        if c.ema_decay is not None:
            d = c.ema_decay
            fe = _flatten(self.opt_state["ema"])
            fp = _flatten(self.params)
            e = [fe[n] for n in fp]
            with torch.no_grad():
                torch._foreach_mul_(e, d)
                torch._foreach_add_(e, list(fp.values()), alpha=1.0 - d)
        self.iteration = t

    def _train_step(self, tokens, targets, mask):
        """One step, eagerly: the reference's jitted ``_build_step``
        (loss and gradients, clip, AdamW, EMA). Returns the loss as a
        device scalar."""
        c = self.conf
        rng = None
        if c.dropout > 0:
            if self._rng is None:
                self._rng = torch.Generator(device=self.device).manual_seed(
                    c.seed + 1)
            rng = self._rng
        loss, grads = self._value_and_grad(tokens, targets, mask, rng)
        self._apply_update(grads)
        return loss

    def _device_tokens(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        toks = _token_array(tokens, self.conf.vocab_size)
        return torch.from_numpy(toks.astype(np.int64)).to(self.device)

    def fit_batch(self, tokens, targets=None, mask=None):
        """One LM step. ``targets=None`` trains next-token on ``tokens``
        (inputs = tokens[:, :-1], targets = tokens[:, 1:]). Returns the
        loss, also kept as ``score_``: a device scalar, read lazily (the
        host loop never waits for the card)."""
        if self.params is None:
            self.init()
        if self.opt_state is None:
            self.opt_state = _fresh_opt_state(self.conf, self.params)
        tokens = self._device_tokens(tokens)
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        else:
            targets = self._device_tokens(targets)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask), device=self.device)
        self.score_ = self._train_step(tokens, targets, mask)
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration)
        return self.score_

    def fit(self, data, *, epochs=1):
        """Train over ``data``: one token batch (array) or an iterable of
        batches, the MLN fit() surface."""
        is_iterable = (hasattr(data, "__next__") or hasattr(data, "reset")
                       or isinstance(data, (list, tuple)))
        if epochs > 1 and hasattr(data, "__next__") \
                and not hasattr(data, "reset"):
            # a plain generator exhausts after epoch 1: materialise it so
            # every epoch sees the data
            data = list(data)
        for _ in range(epochs):
            if not is_iterable:
                self.fit_batch(np.asarray(data))
                continue
            if hasattr(data, "reset"):
                data.reset()
            for batch in data:
                self.fit_batch(batch)
        return self

    def eval_loss(self, tokens):
        """Mean next-token NLL on held-out tokens (no update)."""
        toks = self._device_tokens(tokens)
        with torch.no_grad():
            return float(self._loss(self.params, toks[:, :-1], toks[:, 1:],
                                    None))

    def perplexity(self, tokens):
        return float(np.exp(self.eval_loss(tokens)))

    def output(self, tokens):
        """Logits [B, T, V] as host numpy: one host-to-device copy of the
        tokens and one fetch of the logits per call, timed into
        ``infer.output_seconds``."""
        if self.params is None:
            raise ValueError("TransformerLM has no parameters: call init() "
                             "or assign params_from_numpy(...)")
        c = self.conf
        with _OBS_OUTPUT_SECONDS.time():
            toks = _token_array(tokens, c.vocab_size)
            if c.pos_embed == "learned" and toks.shape[1] > c.max_len:
                raise ValueError(f"T={toks.shape[1]} exceeds max_len="
                                 f"{c.max_len}")
            t = torch.from_numpy(toks.astype(np.int64)).to(self.device)
            with torch.inference_mode():
                logits = self._logits(self.params, t)
            return logits.cpu().numpy()
