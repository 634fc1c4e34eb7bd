"""Decoder-only Transformer language model: inference and training.

Ports ``deeplearning4j_tpu/models/transformer.py`` piece by piece under
the same names: the config, rotary embeddings, the pre-LN block with its
residual-branch dropout, the token forward with its ``compute_dtype``
cast and tied f32 head, ``TransformerLM.init``/``output``, and the train
path: ``_loss`` (mask, label smoothing, z-loss), ``_lr_at``,
``_decay_mask``, ``_adamw_apply``, global-norm clipping, EMA, remat,
``fit_batch``/``fit``, ``eval_loss``/``perplexity``, ``clone`` and
``ema_model``; and generation: the one-token decode step
(``_make_token_step``, scalar or per-row positions), the top-k/nucleus
filters, ``generate()`` and ``beam_search()`` (one captured CUDA graph
per signature on the card, in a cache bounded by
``DL4J_TORCH_SERVE_GEN_CACHE``), and the programs the continuous-
batching server (``serving/decode.py``) drives: the decode chunk over a
paged window of the slot pool, the slot admit, and chunked prefill.
Data parallelism is the reference's: :meth:`TransformerLM.shard` puts the
model under a sharding plan over a process group
(``parallel/sharding_core.py``: each rank its rows of the global batch,
the loss over the global batch's mask count, the gradients reduced over
the ranks before the global-norm clip, AdamW on this rank's shards at
ZeRO levels 1-3); :meth:`TransformerLM.fsdp_trainer` hands the loss to
``parallel/fsdp.py``'s FSDPTrainer.

Layouts are the reference's: dense weights are ``[in, out]`` applied as
``x @ W``; q/k/v are ``[B, H, T, hd]``; parameters form the same tree of
names (``wte``, ``wpe``, ``lnf_g``, ``b0`` → ``qkv``, ...), held as
nested ``nn.ParameterDict``s. :func:`params_from_numpy` carries a JAX
parameter tree over, :func:`opt_state_from_numpy` its optimizer state.

Attention with ``block_size`` set goes through
``ops.flash_attention`` — the hand-written CUDA kernels on the card,
forward and backward — and without it through the dense oracle, as in
the reference. The train step runs eagerly: where the reference jits
one program, the port launches the same math op by op.

Decode programs mutate static tensors in place (the reference returns
a new state dict), so that on the card each one is captured once as a
CUDA graph and replayed (``models/_cuda_graph.py``). On the CPU their
matmuls and softmax run in a fixed summation order (``_mm``,
``_attend``): a row then decodes to the same bits alone, in a slot pool
of any width, over any KV window, or in a prefill window, which is
what the serving contracts hold exactly on the CPU. On the card they
are cuBLAS GEMMs, whose rounding may depend on the batch.
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
from deeplearning4j_tpu_torch.config import env_int, env_str
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph
from deeplearning4j_tpu_torch.models._device_state import (PlanStateMixin,
                                                           whole)
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
from deeplearning4j_tpu_torch.ops.random import M32, mix32, mul32
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.sharding_core import (
    ShardingCore, as_mesh, current_batch_plan, global_batch)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    blockwise_attention, dense_attention)

__all__ = ["DECODE_MODES", "TransformerConfig", "TransformerLM",
           "decode_state_from_numpy", "gumbel_noise", "leaf_paths",
           "opt_state_from_numpy", "params_from_numpy"]

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


def mask_denominator(m):
    """The masked-mean denominator: the mask's sum (at least 1). In a
    train step under a plan of N ranks, the global batch's sum over N:
    the mean over the ranks of each rank's masked sum over it is then
    the global batch's masked mean, whatever count each rank holds."""
    plan = current_batch_plan()
    if plan is None:
        return torch.clamp(m.sum(), min=1.0)
    return torch.clamp(plan.all_reduce_sum(m.sum()), min=1.0) / plan.n


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


def _block_apply(c, bp, x, drop=None, keep=None, ffn=None, attend=None):
    """One pre-LN block from its parameter dict (the reference's
    canonical block math). ``drop(a, mask)`` applies residual-branch
    dropout with ``keep``, this block's pair of keep-masks. The masks
    stand for the reference's ``rng``: they are drawn before the block, so
    a block recomputed under remat applies the same ones. ``ffn(bp,
    hloc)``, when given, takes the place of the dense FFN (the MoE
    family's expert routing); ``attend(q, k, v)`` takes the place of the
    attention (the sequence-parallel ring), on full heads."""
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
    if attend is not None:
        k, v = _full_heads(c, k, v)   # custom attends (the ring) assume MHA
        o = attend(q, k, v)
    elif c.block_size:
        o = _blockwise_route(c, q, k, v)
    else:
        k, v = _full_heads(c, k, v)
        o = dense_attention(q, k, v, causal=True, window=c.window)
    o = o.transpose(1, 2).reshape(B, T, d)
    a = o @ bp["proj"] + bp["proj_b"]
    x = x + (drop(a, r1) if drop else a)
    hloc = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    if ffn is not None:
        m = ffn(bp, hloc)
    else:
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


def leaf_paths(tree, prefix=""):
    """The paths of ``tree``'s leaves (``"b0.qkv"``, as :func:`_flatten`
    names them) in the reference's leaf order, which the archives' flat
    vectors follow. ``jax.tree.leaves`` walks a dict's keys sorted as
    strings at every level, so the blocks come ``b0, b1, b10, b11, b2,
    ...`` once there are more than ten; a block's leaves come ``fc, fc_b,
    ln1_b, ln1_g, ln2_b, ln2_g, out, out_b, proj, proj_b, qkv, qkv_b``;
    then ``lnf_b, lnf_g, wpe`` (absent under rope) and ``wte``. ``qkv``
    has ``d + 2 kv_heads hd`` columns (GQA), and an optimizer state
    ``{"ema", "m", "v"}`` flattens its trees in that order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, (dict, nn.ParameterDict)):
            out += leaf_paths(v, f"{prefix}{k}.")
        else:
            out.append(prefix + k)
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


def _adamw_apply(c, params, grads, opt, t, lr_t, mask=None):
    """One bias-corrected AdamW update with the GPT-2 decay mask, in
    place on ``params`` and ``opt["m"]``/``opt["v"]``, by the reference's
    formula ``p - lr (m̂ / (√v̂ + eps) + wd mask p)`` (written out here:
    ``torch.optim.AdamW`` decays in another order and takes the mask only
    as parameter groups). ``mask`` (a tree of 0.0/1.0 like ``params``)
    overrides the ndim-keyed :func:`_decay_mask`, as stacked layouts need.
    Each step of the formula runs as one multi-tensor op over all
    leaves."""
    b1, b2 = c.beta1, c.beta2
    fp = _flatten(params)
    fg, fm, fv = _flatten(grads), _flatten(opt["m"]), _flatten(opt["v"])
    fmask = _flatten(mask if mask is not None else _decay_mask(params))
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
    # the ViT's configuration has no EMA field
    if getattr(c, "ema_decay", None) is not None:   # Polyak shadow
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


def decode_state_from_numpy(tree, device=None):
    """The port's continuous-batching decode state (the layout of
    ``TransformerLM._init_decode_state``) from a JAX decode state given
    as numpy (``jax.tree.map(np.asarray, state)``), on ``device`` (None
    means cuda): the K/V pools keep their dtype (a bf16 pool stays bf16),
    the integer fields become int64, ``temp``/``topp`` f32, ``active``
    bool, and ``rng`` (a ``PRNGKey(seed)``, whose second word is the
    seed) becomes the pool's base seed."""
    dev = resolve_device(device)

    def pool(a):
        dt = torch.bfloat16 if str(a.dtype) == "bfloat16" else torch.float32
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dt)

    def ints(a):
        return torch.tensor(np.asarray(a, np.int64), device=dev)
    state = {"k": [pool(a) for a in tree["k"]],
             "v": [pool(a) for a in tree["v"]],
             "temp": torch.tensor(np.asarray(tree["temp"], np.float32),
                                  device=dev),
             "topp": torch.tensor(np.asarray(tree["topp"], np.float32),
                                  device=dev),
             "active": torch.tensor(np.asarray(tree["active"], bool),
                                    device=dev),
             "rng": torch.tensor(int(np.asarray(tree["rng"]).reshape(-1)[-1]),
                                 dtype=torch.int64, device=dev)}
    for k in ("pos", "last", "out", "prompts", "plen", "nnew", "topk",
              "seed"):
        state[k] = ints(tree[k])
    return state

def _token_array(tokens, vocab_size):
    """Validate a host [B, T] integer token array."""
    toks = np.asarray(tokens)
    if toks.ndim != 2 or not np.issubdtype(toks.dtype, np.integer):
        raise ValueError(f"tokens must be a [B, T] integer array, "
                         f"got {toks.dtype} {toks.shape}")
    if toks.size and (toks.min() < 0 or toks.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size})")
    return toks


# ---- generation: the decode math and its helpers ----------------------

# the decode chunk's sampler variants, one program (graph) each: the host
# knows every admitted request's sampler, so it picks the variant where
# the reference branches on the device (``lax.cond`` over the filter)
DECODE_MODES = ("greedy", "sample", "filter")

# int64 fields of the admit staging record before the prompt row
_ADMIT_FIELDS = 8
# int64 fields of the prefill staging record before the window's tokens
_PREFILL_FIELDS = 4

def _mm(x, w):
    """``x @ w``. On the card one GEMM. On the CPU every output element
    is summed over the inner dim in one fixed order, in f32, whatever the
    number of rows (MKL's gemv and gemm round differently, so ``x @ w``
    would give a row other bits alone than in a batch)."""
    if x.is_cuda:
        return x @ w
    dt = torch.result_type(x, w)
    return (x.to(torch.float32)[..., :, None]
            * w.to(torch.float32)).sum(-2).to(dt)


def _linear(x, w, b):
    """``x @ w + b`` (``w`` [in, out]): on the card one cuBLASLt GEMM with
    the bias in its epilogue, on the CPU the fixed-order :func:`_mm`."""
    if x.is_cuda:
        return F.linear(x, w.t(), b)
    return _mm(x, w) + b


def _norm(x, g, b):
    """LayerNorm of the last dim (biased variance, eps 1e-5): on the card
    one fused kernel, on the CPU the reference's formula written out
    (:func:`_layer_norm`, whose reductions are row-invariant)."""
    if x.is_cuda:
        return F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)
    return _layer_norm(x, g, b)


def _gelu(x):
    """``jax.nn.gelu``'s tanh form. On the CPU written out: torch's fused
    kernel rounds its vectorised body and its scalar tail differently,
    which would tie a row's bits to its place in the batch."""
    if x.is_cuda:
        return F.gelu(x, approximate="tanh")
    return x * (0.5 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3))))


def _attend(q, kc, vc, keep, hd):
    """Softmax attention of ``q`` [..., Q, hd] over ``kc``/``vc``
    [..., T, hd] where ``keep`` (broadcast to [..., Q, T]) holds; other
    scores are -1e30, as in the reference. In q's dtype. On the card two
    batched GEMMs around ``torch.softmax``; on the CPU a fixed-order form
    whose bits depend neither on the batch nor on masked keys past the
    last kept one (the denominator by ``cumsum``, the values by a
    reduction over T), so every KV window rung gives a row the same
    bits."""
    scale = math.sqrt(hd)
    if q.is_cuda:
        s = torch.matmul(q, kc.transpose(-1, -2)) / scale
        s = torch.where(keep, s, -1e30)
        return torch.matmul(torch.softmax(s, dim=-1), vc)
    f32 = torch.float32
    s = (q.to(f32)[..., :, None, :]
         * kc.to(f32)[..., None, :, :]).sum(-1).to(q.dtype) / scale
    s = torch.where(keep, s, -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.cumsum(-1)[..., -1:]
    return (p.to(f32)[..., :, :, None]
            * vc.to(f32)[..., None, :, :]).sum(-2).to(q.dtype)


def _write_index(pos, write, T):
    """Where each row writes its token's K/V into a cache of T positions:
    ``(rows, idx, ok)``, ``ok`` false for a row that must not write (not
    active, or past the cache's end). Shared by every layer's K and V."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    ok = (write & (pos >= 0) & (pos < T))[:, None, None]
    return rows, pos.clamp(0, T - 1), ok


def _write_at(cache, val, where):
    """``cache[b, :, pos[b]] = val[b]`` where row b may write (an indexed
    scatter, one position a row; the others keep their entries). cache:
    [B, kv_heads, T, hd], possibly a window view of a longer pool; val:
    [B, kv_heads, hd]; ``where`` from :func:`_write_index`."""
    rows, idx, ok = where
    cache[rows, :, idx] = torch.where(ok, val.to(cache.dtype),
                                      cache[rows, :, idx])


def _scatter_window(row, pages, idx, valid):
    """Write window ``pages`` [kv_heads, W, hd] into the cache ``row``
    [kv_heads, T, hd] at positions ``idx`` [W] where ``valid`` holds.
    ``idx`` must be distinct (the prefill wraps positions past the end,
    which are never valid, onto the row's start)."""
    row[:, idx] = torch.where(valid[None, :, None], pages.to(row.dtype),
                              row[:, idx])


def gumbel_noise(base, seeds, pos, vocab):
    """Gumbel(0, 1) noise [B, vocab] in f32 for the sampler
    ``argmax(logits / temperature + noise)`` (what
    ``jax.random.categorical`` does with its own noise). Counter-based:
    entry (b, v) is a pure function of (``base``, ``seeds[b]``,
    ``pos[b]``, v), integer hash rounds over int64 tensors, so a sampled
    row does not depend on how admits interleave and the whole source
    runs inside a captured graph. ``base``: 0-d int64; ``seeds``, ``pos``:
    [B] int64. JAX's threefry draws cannot be reproduced in torch: the
    values differ from the reference's, the property is the same."""
    h = mix32((base & M32) ^ 0x3C6EF372)
    h = mix32(h ^ (seeds & M32))
    h = mix32(h ^ (pos & M32))
    v = torch.arange(vocab, device=h.device, dtype=torch.int64)
    x = mix32(h[:, None] ^ mul32(v, 0x9E3779B9))
    x = mix32(x ^ 0x85EBCA6B)
    # 23 bits: (k + 0.5) / 2**23 is exact in f32 and lies in (0, 1)
    u = ((x >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)
    return -torch.log(-torch.log(u))


def _f32_bits(x):
    """An int64 tensor holding f32 bit patterns (as signed int32 values)
    viewed as float32."""
    return x.to(torch.int32).view(torch.float32)


def admit_record(c, slot, prompt, plen, nnew, temp, topk, topp, active,
                 seed):
    """The host int64 staging record the admit program reads: eight
    scalar fields (the two float ones as their f32 bits), then the
    ``max_len`` prompt row."""
    rec = np.zeros(_ADMIT_FIELDS + c.max_len, np.int64)
    rec[:_ADMIT_FIELDS] = (
        slot, plen, nnew, np.float32(temp).view(np.int32), topk,
        np.float32(topp).view(np.int32), int(bool(active)), seed)
    rec[_ADMIT_FIELDS:_ADMIT_FIELDS + len(prompt)] = prompt
    return rec


def prefill_record(slot, toks, start, nvalid, final, W):
    """The host int64 staging record a prefill program reads: slot,
    window start, valid tokens, final flag, then the W window tokens
    (zero past ``nvalid``)."""
    rec = np.zeros(_PREFILL_FIELDS + W, np.int64)
    rec[:_PREFILL_FIELDS] = (slot, start, nvalid, int(bool(final)))
    rec[_PREFILL_FIELDS:_PREFILL_FIELDS + len(toks)] = toks
    return rec

class TransformerLM(PlanStateMixin, nn.Module):
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
        self._jit_gen = {}      # _gen_signature -> generate/beam program
        self._jit_decode = {}   # decode/admit/prefill signature -> body

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

    def rng_state(self):
        """The dropout generator's state (a uint8 host tensor), or None
        while no dropout step has drawn from it."""
        return None if self._rng is None else self._rng.get_state()

    def set_rng_state(self, state):
        """Continue the dropout stream from ``state`` (from
        :meth:`rng_state`); None starts it afresh, seeded ``conf.seed +
        1`` at the next dropout step, as a new model's is."""
        if state is None:
            self._rng = None
            return
        if self._rng is None:
            self._rng = torch.Generator(device=self.device)
        self._rng.set_state(torch.as_tensor(state, dtype=torch.uint8))

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
        denom = mask_denominator(m)
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
        plan = self._dp()
        if plan is not None:
            return self._sharded_step(plan, tokens, targets, mask, rng)
        loss, grads = self._value_and_grad(tokens, targets, mask, rng)
        self._apply_update(grads)
        return loss

    # ---- data parallelism ------------------------------------------------
    _plan_trees = (("params", "param_spec"), ("opt_state", "updater_spec"))

    def _plan_leaves(self, attr):
        return list(_flatten(getattr(self, attr)).values())

    def _set_plan_leaves(self, attr, leaves):
        tree = _unflatten(dict(zip(_flatten(getattr(self, attr)), leaves)))
        setattr(self, attr, _parameter_tree(tree) if attr == "params"
                else tree)

    def _rank_device(self, device):
        """This rank's device (``multihost.rank_device``), which must be
        the model's."""
        dev = multihost.rank_device(device)
        if dev != self.device:
            raise ValueError(f"the model lives on {self.device}, this rank "
                             f"trains on {dev}")
        return dev

    def shard(self, mesh=None, axis="data", level=None, *, device=None):
        """Data parallelism over ``mesh`` (a ``DataMesh``, a process group,
        or None for the whole default group): each rank trains on its rows
        of every global batch, with the parameters and the AdamW state at
        the ZeRO level's placements (``level``, else
        ``DL4J_TORCH_DP_SHARD``): 0 whole, 1 the moments (and the EMA)
        1/N, 2 the gradients reduce-scattered too, 3 the parameters 1/N
        between steps, gathered for the forward. ``device`` is this
        rank's device (``multihost.rank_device``), where the model must
        live. Every rank calls it, and then each ``fit_batch``, in step."""
        self._rank_device(device)
        if self.params is None:
            self.init()
        if self.opt_state is None:
            self.opt_state = _fresh_opt_state(self.conf, self.params)
        self._enter_plan(ShardingCore(as_mesh(mesh, axis), level=level,
                                      batch_axis=axis))
        return self

    def fsdp_trainer(self, mesh=None, *, device=None):
        """ZeRO-3 training of this LM's loss with parameters, gradients
        and Adam moments 1/N at rest (``parallel/fsdp.FSDPTrainer``);
        feed it (tokens, targets) global batches and read the whole
        parameters back with ``trainer.gathered_params()``."""
        from deeplearning4j_tpu_torch.parallel.fsdp import FSDPTrainer
        dev = self._rank_device(device)
        if self.params is None:
            self.init()
        c = self.conf

        def loss_fn(params, tokens, targets):
            return self._loss(params, tokens, targets, None)

        return FSDPTrainer(mesh, self.params, loss_fn, lr=c.learning_rate,
                           beta1=c.beta1, beta2=c.beta2, eps=c.eps,
                           weight_decay=c.weight_decay,
                           weight_decay_mask=_decay_mask(self.params),
                           device=dev)

    def _sharded_step(self, plan, tokens, targets, mask, rng):
        """The step under a plan of N ranks (``tokens``: this rank's rows):
        level 3 gathers the parameters whole for the forward; the loss
        takes the global batch's mask count; the gradients and the loss
        are reduced over the ranks (reduce-scattered to shards at levels
        2-3) before the global-norm clip, whose norm spans the whole
        leaves; AdamW and the EMA run on this rank's shards, and levels
        1-2 gather the updated shards back onto the whole parameters."""
        c = self.conf
        names = list(_flatten(self.params))
        axes = self._dp_axes["params"]
        leaves = self._plan_leaves("params")
        whole = [t.requires_grad_(True) for t in self._gathered("params")]
        params = _unflatten(dict(zip(names, whole))) if plan.level >= 3 \
            else self.params
        with global_batch(plan):
            loss = self._loss(params, tokens, targets, mask, rng)
        grads = torch.autograd.grad(loss, whole)
        grads, (loss,) = plan.constrain_grads(list(grads), axes,
                                           scalars=(loss.detach(),))
        if c.grad_clip_norm is not None:
            sq = [torch.sum(torch.square(g)) for g in grads]
            split = [q for q, a in zip(sq, axes) if a is not None] \
                if plan.level >= 2 else []
            total = sum(q for q, a in zip(sq, axes)
                        if a is None or plan.level < 2)
            if split:
                total = total + plan.all_reduce_sum(torch.stack(split).sum())
            scale = torch.clamp(
                c.grad_clip_norm / torch.clamp(torch.sqrt(total), min=1e-12),
                max=1.0)
            torch._foreach_mul_(grads, scale)
        if plan.level >= 3:
            views = leaves
        elif plan.level >= 1:
            views = [plan.shard(p, a) for p, a in zip(leaves, axes)]
        else:
            views = leaves
        if plan.level == 1:
            grads = [plan.shard(g, a) for g, a in zip(grads, axes)]
        t = self.iteration + 1
        tree = _unflatten(dict(zip(names, views)))
        _adamw_apply(c, tree, _unflatten(dict(zip(names, grads))),
                     self.opt_state, t, _lr_at(c, t))
        with torch.no_grad():
            if plan.level in (1, 2):
                for p, w, a in zip(leaves, plan.gather_params(views, axes), axes):
                    if a is not None:
                        p.copy_(w)
            if c.ema_decay is not None:
                d = c.ema_decay
                fe = _flatten(self.opt_state["ema"])
                e = [fe[n] for n in names]
                ema_views = views if plan.level >= 1 else leaves
                torch._foreach_mul_(e, d)
                torch._foreach_add_(e, ema_views, alpha=1.0 - d)
        self.iteration = t
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
        plan = self._dp()
        if plan is not None:   # this rank's rows of the global batch
            tokens, targets, mask = (
                multihost.take_rows(a, plan.rank, plan.n)
                for a in (tokens, targets, mask))
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

    @whole("params")
    def eval_loss(self, tokens):
        """Mean next-token NLL on held-out tokens (no update)."""
        toks = self._device_tokens(tokens)
        with torch.no_grad():
            return float(self._loss(self.params, toks[:, :-1], toks[:, 1:],
                                    None))

    def perplexity(self, tokens):
        return float(np.exp(self.eval_loss(tokens)))

    @whole("params")
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

    # ---- generation ----------------------------------------------------
    def _check_decodable(self):
        """Raise if this model has no decode programs (the MoE family);
        the continuous-batching server asks before it takes a model."""

    @whole("params")
    def generate(self, prompt, n_new, *, temperature=1.0, seed=0,
                 top_k=None, top_p=None, repetition_penalty=None):
        """Autoregressive sampling over a preallocated KV cache, greedy at
        ``temperature=0``. ``top_k`` keeps the k most likely tokens,
        ``top_p`` the smallest nucleus whose mass reaches p (top_k prunes
        first); ``repetition_penalty`` > 1 divides the positive logits
        (and multiplies the negative ones) of every token already in the
        row, before the filters. The prompt is prefilled one token at a
        time through the same step. On the card the whole run is one
        captured CUDA graph per signature (batch, prompt length, n_new,
        sampler), replayed for every later call with that signature.

        prompt: [B, P] int tokens; returns [B, P + n_new] int32. Sampled
        tokens draw the counter-based ``gumbel_noise`` keyed by (seed,
        row, position): the same distribution as the reference's split
        stream, not its values."""
        c = self.conf
        if self.params is None:
            raise ValueError("TransformerLM has no parameters: call init() "
                             "or assign params_from_numpy(...)")
        prompt = _token_array(prompt, c.vocab_size)
        B, P = prompt.shape
        total = P + n_new
        if total > c.max_len:
            raise ValueError(f"P+n_new={total} exceeds max_len={c.max_len}")
        if top_k is not None and not 1 <= int(top_k) <= c.vocab_size:
            raise ValueError(f"top_k must be in [1, {c.vocab_size}]")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if repetition_penalty is not None and float(repetition_penalty) <= 0:
            raise ValueError("repetition_penalty must be > 0")
        extra = (float(temperature), top_k and int(top_k),
                 top_p and float(top_p),
                 repetition_penalty and float(repetition_penalty))
        sig = self._gen_signature("sample", B, P, n_new, *extra)
        prog = self._jit_gen.get(sig)
        if prog is None or prog.params is not self.params:
            self._jit_gen.pop(sig, None)   # parameters assigned anew
            self._evict_gen()
            prog = self._jit_gen[sig] = self._build_generate(B, P, n_new,
                                                             *extra)
        prog.prompt.copy_(torch.from_numpy(prompt.astype(np.int64)))
        prog.seed.fill_(int(seed))
        prog.graph()
        return prog.out.cpu().numpy().astype(np.int32)

    @staticmethod
    def _filter_logits_rows(logits, k, p):
        """Per-row top-k/nucleus filtering for the continuous-batching
        decode step: ``k``/``p`` are [B] tensors riding the slot state
        (``k = vocab_size`` and ``p = 1.0`` leave a row whole). The
        semantics of :meth:`_filter_logits`, rank-based so k can vary per
        row: a stable sort of ``-logits`` (``jnp.argsort`` is stable), the
        nucleus rule ``(cum - probs) < p``."""
        B, V = logits.shape
        idx = torch.argsort(-logits, dim=-1, stable=True)
        srt = torch.gather(logits, -1, idx)
        rank_keep = torch.arange(V, device=logits.device)[None, :] \
            < k[:, None]
        probs = torch.softmax(torch.where(rank_keep, srt, -math.inf), -1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the tokens BEFORE the mass crosses p (always >= 1 token)
        keep_sorted = rank_keep & ((cum - probs) < p[:, None])
        keep = torch.zeros_like(keep_sorted).scatter(-1, idx, keep_sorted)
        return torch.where(keep, logits, -math.inf)

    @staticmethod
    def _filter_logits(logits, top_k, top_p):
        """Top-k / nucleus filtering: logits outside the set go to -inf.
        The top-k threshold keeps every tie of the k-th value
        (``lax.top_k``'s rule)."""
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, -math.inf, logits)
        if top_p is not None and top_p < 1.0:
            idx = torch.argsort(-logits, dim=-1, stable=True)
            srt = torch.gather(logits, -1, idx)
            probs = torch.softmax(srt, dim=-1)
            # keep the tokens BEFORE the mass crosses p (always >= 1 token)
            cum = torch.cumsum(probs, dim=-1)
            keep_sorted = (cum - probs) < top_p
            keep = torch.zeros_like(keep_sorted).scatter(-1, idx,
                                                         keep_sorted)
            logits = torch.where(keep, logits, -math.inf)
        return logits

    def _cache_dtype(self):
        """KV caches follow the compute dtype: a bf16 model decodes with a
        bf16 cache; logits still come back f32."""
        return getattr(torch, self.conf.compute_dtype or "float32")

    def _gumbel(self, base, seeds, pos, vocab):
        """The sampler's noise source (:func:`gumbel_noise`); tests
        replace it on an instance to inject the reference's draws."""
        return gumbel_noise(base, seeds, pos, vocab)

    def _step_params(self, params):
        """``(params, cast)``: the f32 masters the embeddings are gathered
        from, and the tree in the compute dtype the blocks and the tied
        head use (the same tree when there is no compute dtype). Decode
        programs cast once a dispatch, inside their graph, so a trained
        parameter is never read stale."""
        cd = self.conf.compute_dtype
        if not cd:
            return params, params
        dt = getattr(torch, cd)
        return params, _tree_map(
            lambda a: a.to(dt) if a.is_floating_point() else a, params)

    # ---- inference-program signatures ------------------------------------
    def _gen_signature(self, kind, B, P, n_new, *extra):
        """The ``generate``/``beam_search`` program cache key
        (``_jit_gen``): everything the program's shape and control flow
        depend on."""
        return (kind, B, P, n_new) + tuple(extra)

    def _evict_gen(self):
        """Bound ``_jit_gen`` to ``DL4J_TORCH_SERVE_GEN_CACHE`` programs,
        oldest first, before a new one is built: a server answering many
        shapes must not pin an unbounded set of graphs."""
        bound = env_int("DL4J_TORCH_SERVE_GEN_CACHE", minimum=1)
        while len(self._jit_gen) >= bound:
            self._jit_gen.pop(next(iter(self._jit_gen)))

    def _decode_signature(self, slots, chunk, window, mode):
        """Decode-chunk program key: slot width, tokens a dispatch, the KV
        window rung, and the sampler variant (``DECODE_MODES``)."""
        return ("decode", slots, chunk, window, mode)

    def _admit_signature(self, slots):
        """Slot-admission program key."""
        return ("admit", slots)

    def _prefill_signature(self, slots, window, inject):
        """Chunked-prefill program key: one per prompt-window rung and
        variant (computing the window, or injecting prefix-cache
        pages)."""
        return ("prefill", slots, window, "inject" if inject else "compute")

    # ---- continuous-batching decode (serving/decode.py drives this) ----
    def _init_decode_state(self, slots, seed=0):
        """Fresh continuous-batching decode state: the persistent
        [slots, kv_heads, max_len, hd] KV slot pool (allocated once and
        updated in place by every program) and per-row counters; the
        scheduler keeps host mirrors of pos/plen/nnew/active. ``rng`` is
        the pool's constant base seed: sampling noise is derived from
        (base, request seed, position), never from a carried stream."""
        c = self.conf
        hd = c.d_model // c.n_heads
        S, total, dev = slots, c.max_len, self.device
        cdt = self._cache_dtype()
        i64 = dict(dtype=torch.int64, device=dev)
        return {
            "k": [torch.zeros((S, c.kv_heads, total, hd), dtype=cdt,
                              device=dev) for _ in range(c.n_layers)],
            "v": [torch.zeros((S, c.kv_heads, total, hd), dtype=cdt,
                              device=dev) for _ in range(c.n_layers)],
            "pos": torch.zeros(S, **i64),
            "last": torch.zeros(S, **i64),
            "out": torch.zeros((S, total), **i64),
            "prompts": torch.zeros((S, total), **i64),
            "plen": torch.ones(S, **i64),
            "nnew": torch.zeros(S, **i64),
            "temp": torch.zeros(S, dtype=torch.float32, device=dev),
            # k = vocab_size and p = 1.0 leave a row unfiltered
            "topk": torch.full((S,), c.vocab_size, **i64),
            "topp": torch.ones(S, dtype=torch.float32, device=dev),
            "active": torch.zeros(S, dtype=torch.bool, device=dev),
            "seed": torch.zeros(S, **i64),
            "rng": torch.tensor(int(seed), **i64),
        }

    def _reset_decode_state(self, state, seed=0):
        """Bring ``state`` back to ``_init_decode_state``'s values in
        place, so graphs bound to its storage stay valid."""
        with torch.no_grad():
            for buf in state["k"] + state["v"]:
                buf.zero_()
            for k in ("pos", "last", "out", "prompts", "nnew", "temp",
                      "active", "seed"):
                state[k].zero_()
            state["plen"].fill_(1)
            state["topk"].fill_(self.conf.vocab_size)
            state["topp"].fill_(1.0)
            state["rng"].fill_(int(seed))

    def _decode_fns(self, slots, chunk, window, mode):
        """The (admit, decode chunk) program bodies for a slot width, KV
        window rung and sampler variant, cached under
        ``_admit_signature``/``_decode_signature`` in ``_jit_decode``. A
        body mutates the state it is given; the server captures each one
        as a graph bound to its slot pool."""
        ks = self._decode_signature(slots, chunk, window, mode)
        if ks not in self._jit_decode:
            self._jit_decode[ks] = self._build_decode_step(slots, chunk,
                                                           window, mode)
        return self._admit_fn(slots), self._jit_decode[ks]

    def _admit_fn(self, slots):
        """The admit program body of a slot width (window-independent: it
        writes whole ``max_len`` rows)."""
        ka = self._admit_signature(slots)
        if ka not in self._jit_decode:
            self._jit_decode[ka] = self._build_admit(slots)
        return self._jit_decode[ka]

    def _prefill_fn(self, slots, window, inject):
        """The chunked-prefill program body for a prompt-window rung and
        variant, cached under ``_prefill_signature``."""
        kp = self._prefill_signature(slots, window, inject)
        if kp not in self._jit_decode:
            self._jit_decode[kp] = self._build_prefill(slots, window, inject)
        return self._jit_decode[kp]

    def _build_decode_step(self, S, chunk, W, mode):
        """The program advancing every active slot by ``chunk`` tokens, in
        place on the state: a row whose position is still inside its
        prompt is teacher-forced from the slot's prompt buffer, past it
        the sampled token feeds back; generated tokens land in the slot's
        ``out`` row, fetched once when the request completes.

        ``W`` is the KV window rung: the step reads and writes the first
        ``W`` positions of the ``max_len`` pool through a strided view (no
        copy in or out); the scheduler keeps every active row's position
        below ``W`` for the whole chunk, and a ``max_len`` rung is the
        un-paged program. ``mode`` is the sampler variant: ``greedy``
        (argmax only; the host picks it when no active row samples),
        ``sample`` (Gumbel noise), ``filter`` (the per-row top-k/nucleus
        filter first; picked when an admitted request filters, the
        reference's ``need``)."""
        if mode not in DECODE_MODES:
            raise ValueError(f"mode must be one of {DECODE_MODES}")
        c = self.conf
        total, V = c.max_len, c.vocab_size
        W = min(W, total)
        row_step = self._make_token_step(S, W, vector_pos=True)

        def chunk_run(params, state):
            sp = self._step_params(params)
            plen, nnew = state["plen"], state["nnew"]
            prompts, temp = state["prompts"], state["temp"]
            topk, topp = state["topk"], state["topp"]
            active, pos = state["active"], state["pos"]
            last, out = state["last"], state["out"]
            kws = [b[:, :, :W] for b in state["k"]]
            vws = [b[:, :, :W] for b in state["v"]]
            for _ in range(chunk):
                ptok = torch.gather(prompts, 1,
                                    pos.clamp(0, total - 1)[:, None])[:, 0]
                cur = torch.where(pos < plen, ptok, last)
                logits = row_step(sp, cur, pos, kws, vws, write=active)
                samp = logits.argmax(-1)
                if mode != "greedy":
                    flt = (self._filter_logits_rows(logits, topk, topp)
                           if mode == "filter" else logits)
                    scaled = flt / temp.clamp(min=1e-6)[:, None]
                    noise = self._gumbel(state["rng"], state["seed"], pos, V)
                    samp = torch.where(temp > 0.0,
                                       (scaled + noise).argmax(-1), samp)
                # the token sampled after position pos is generation index
                # pos + 1 - plen; rows still prefilling (< 0) and rows past
                # their request (>= nnew) write nothing
                gi = pos + 1 - plen
                ok = active & (gi >= 0) & (gi < nnew)
                gi_c = gi.clamp(0, total - 1)[:, None]
                out.scatter_(1, gi_c, torch.where(
                    ok, samp, torch.gather(out, 1, gi_c)[:, 0])[:, None])
                last.copy_(torch.where(active, samp, last))
                pos.add_(active.to(pos.dtype))

        return chunk_run

    def _build_admit(self, S):
        """Slot (re)assignment as one program for every slot: it reads one
        int64 staging record (:func:`admit_record`: slot, plen, nnew,
        temperature bits, top_k, top_p bits, active, seed, prompt row) and
        writes the slot's fields by index. Freeing a slot is an admit
        with ``active`` 0. A freed row's KV cache is not cleared: its
        position restarts at 0 and the causal mask hides every stale
        entry past it."""
        total = self.conf.max_len
        n = _ADMIT_FIELDS

        def admit(state, stage):
            slot = stage[0:1]
            state["prompts"].index_copy_(0, slot, stage[n:n + total][None])
            for k in ("out", "pos", "last"):
                state[k].index_fill_(0, slot, 0)
            state["plen"].index_copy_(0, slot, stage[1:2].clamp(min=1))
            state["nnew"].index_copy_(0, slot, stage[2:3])
            state["temp"].index_copy_(0, slot, _f32_bits(stage[3:4]))
            state["topk"].index_copy_(0, slot, stage[4:5])
            state["topp"].index_copy_(0, slot, _f32_bits(stage[5:6]))
            state["active"].index_copy_(0, slot, stage[6:7] != 0)
            state["seed"].index_copy_(0, slot, stage[7:8])

        return admit

    def _build_prefill(self, S, W, inject):
        """Chunked prompt prefill for one slot as one program per window
        rung: ``W`` prompt tokens in one parallel forward, their K/V
        written into the slot's cache row (before attention, so causality
        inside the window reads them back at cache dtype, as the decode
        step's own writes would be read). Slot, window start, valid count
        and the final flag come from an int64 staging record
        (:func:`prefill_record`), so every window of every prompt shares
        the rung's program. The final window leaves ``pos`` at
        ``start + nvalid`` (= plen - 1: the decode chunk re-processes the
        last prompt token and samples from it) and sets ``active``.

        ``inject=True`` is the prefix-cache hit variant: the pages in
        ``ik``/``iv`` [L, kv_heads, W, hd] are written instead of computed
        (the reference's ``lax.cond``; here the host, which knows whether
        the cache hit, picks the program). The compute variant writes the
        window's pages into ``pk``/``pv`` for the cache."""
        c = self.conf
        d, L, total = c.d_model, c.n_layers, c.max_len
        hd = d // c.n_heads
        kvh, kvd = c.kv_heads, c.kv_heads * hd
        dev = self.device
        win = torch.arange(W, device=dev)
        tpos = torch.arange(total, device=dev)
        n = _PREFILL_FIELDS

        def prefill(params, state, stage, ik, iv, pk, pv):
            slot, start, nvalid, final = (stage[0:1], stage[1], stage[2],
                                          stage[3])
            pos_w = start + win
            valid = win < nvalid
            # positions past the pool's end are never valid; wrapping
            # them onto its start keeps the scatter's indices distinct
            idx = pos_w % total
            krows = [b.index_select(0, slot)[0] for b in state["k"]]
            vrows = [b.index_select(0, slot)[0] for b in state["v"]]
            if inject:
                for i in range(L):
                    _scatter_window(krows[i], ik[i], idx, valid)
                    _scatter_window(vrows[i], iv[i], idx, valid)
            else:
                raw, cp = self._step_params(params)
                toks = stage[n:n + W]
                x = raw["wte"][toks]                               # [W, d]
                if c.pos_embed == "learned":
                    x = x + raw["wpe"][pos_w.clamp(0, total - 1)]
                x = x.to(self._cache_dtype())
                keep = tpos[None, :] <= pos_w[:, None]
                if c.window is not None:
                    keep &= tpos[None, :] > (pos_w[:, None] - c.window)
                if c.pos_embed == "rope":
                    cos, sin = _rope_cos_sin(c, hd, pos_w)         # [W, hd/2]
                for i in range(L):
                    bp = cp[f"b{i}"]
                    hloc = _norm(x, bp["ln1_g"], bp["ln1_b"])
                    qkv = _linear(hloc, bp["qkv"], bp["qkv_b"])
                    q, k, v = torch.split(qkv, [d, kvd, kvd], dim=-1)
                    q = q.reshape(W, c.n_heads, hd).transpose(0, 1)
                    k = k.reshape(W, kvh, hd).transpose(0, 1)
                    v = v.reshape(W, kvh, hd).transpose(0, 1)
                    if c.pos_embed == "rope":   # the cache holds rotated keys
                        q = _apply_rope(q, cos, sin)
                        k = _apply_rope(k, cos, sin)
                    _scatter_window(krows[i], k, idx, valid)
                    _scatter_window(vrows[i], v, idx, valid)
                    qh = q.reshape(kvh, c.kv_group, W, hd)
                    o = _attend(qh, krows[i][:, None], vrows[i][:, None],
                                keep, hd)
                    o = o.permute(2, 0, 1, 3).reshape(W, d)
                    x = x + _linear(o, bp["proj"], bp["proj_b"])
                    hloc = _norm(x, bp["ln2_g"], bp["ln2_b"])
                    x = x + _linear(_gelu(_linear(hloc, bp["fc"],
                                                  bp["fc_b"])),
                                    bp["out"], bp["out_b"])
                    pk[i].copy_(k)
                    pv[i].copy_(v)
            for i in range(L):
                state["k"][i].index_copy_(0, slot, krows[i][None])
                state["v"][i].index_copy_(0, slot, vrows[i][None])
            state["pos"].index_copy_(0, slot, (start + nvalid)[None])
            state["active"].index_copy_(0, slot, (final != 0)[None])

        return prefill

    def _make_token_step(self, B, total, *, vector_pos=False):
        """One-token decode step over (rows B, cache length total): THE
        decode attention/FFN math, shared by the sampler and beam search
        (scalar ``pos``, a Python int: the batch decodes in lock-step) and,
        with ``vector_pos=True``, the continuous-batching chunk (per-row
        ``pos`` [B] int64 and the active-row ``write`` mask; a row past
        the cache end matches nothing). Caches [B, kv_heads, total, hd]
        are written in place at ``pos`` (GQA regroups q onto its kv head:
        no cache repeat). The compute-dtype body, f32 logits from the
        tied head; rope rotates q and the cached k.

        Returns ``token_step(sp, tok, pos, kcs, vcs, write=None)`` ->
        logits [B, V] f32, where ``sp`` is ``_step_params(params)``."""
        c = self.conf
        d, L = c.d_model, c.n_layers
        hd = d // c.n_heads
        kvh, kvd, g = c.kv_heads, c.kv_heads * hd, c.kv_group
        cdt = self._cache_dtype()
        ar = torch.arange(total, device=self.device)

        def block_step(bp, x, kc, vc, pos, where, keep, rope):
            hloc = _norm(x, bp["ln1_g"], bp["ln1_b"])
            qkv = _linear(hloc, bp["qkv"], bp["qkv_b"])
            q, k, v = torch.split(qkv, [d, kvd, kvd], dim=-1)
            q = q.reshape(B, 1, c.n_heads, hd).transpose(1, 2)
            k = k.reshape(B, 1, kvh, hd).transpose(1, 2)
            v = v.reshape(B, 1, kvh, hd).transpose(1, 2)
            if rope is not None:         # the cache holds rotated keys
                q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
            if vector_pos:
                _write_at(kc, k[:, :, 0], where)
                _write_at(vc, v[:, :, 0], where)
            else:
                kc[:, :, pos] = k[:, :, 0]
                vc[:, :, pos] = v[:, :, 0]
            qh = q[:, :, 0].reshape(B, kvh, g, hd)
            o = _attend(qh, kc, vc, keep, hd).reshape(B, 1, d)
            x = x + _linear(o, bp["proj"], bp["proj_b"])
            hloc = _norm(x, bp["ln2_g"], bp["ln2_b"])
            return x + _linear(_gelu(_linear(hloc, bp["fc"], bp["fc_b"])),
                               bp["out"], bp["out_b"])

        def token_step(sp, tok, pos, kcs, vcs, write=None):
            raw, cp = sp
            x = raw["wte"][tok][:, None, :]
            if c.pos_embed == "learned":
                if vector_pos:
                    x = x + raw["wpe"][pos.clamp(0, c.max_len - 1)][:, None]
                else:
                    x = x + raw["wpe"][pos][None, None]
            x = x.to(cdt)   # the compute dtype (f32 without one)
            # what every layer shares: the write positions, the causal
            # (and sliding-window) keep mask, the rotation angles
            T = kcs[0].shape[2]
            if vector_pos:
                where = _write_index(pos, write, T)
                keep = ar[None, :T] <= pos[:, None]
                if c.window is not None:
                    keep &= ar[None, :T] > (pos[:, None] - c.window)
                keep = keep[:, None, None, :]
            else:
                where = None
                keep = ar[:T] <= pos
                if c.window is not None:
                    keep &= ar[:T] > pos - c.window
                keep = keep[None, None, None, :]
            rope = None
            if c.pos_embed == "rope":
                if vector_pos:           # per-row rotation angle
                    cos, sin = _rope_cos_sin(c, hd, pos)
                    rope = cos[:, None, None, :], sin[:, None, None, :]
                else:
                    rope = _rope_cos_sin(c, hd, ar[pos:pos + 1])
            for i in range(L):
                x = block_step(cp[f"b{i}"], x, kcs[i], vcs[i], pos, where,
                               keep, rope)
            x = _norm(x, cp["lnf_g"], cp["lnf_b"])
            if x.is_cuda:
                return F.linear(x, cp["wte"]).to(torch.float32)[:, 0]
            return _mm(x, cp["wte"].T).to(torch.float32)[:, 0]

        return token_step

    def _new_caches(self, B, total):
        c = self.conf
        shape = (B, c.kv_heads, total, c.d_model // c.n_heads)
        return ([torch.zeros(shape, dtype=self._cache_dtype(),
                             device=self.device) for _ in range(c.n_layers)],
                [torch.zeros(shape, dtype=self._cache_dtype(),
                             device=self.device) for _ in range(c.n_layers)])

    def _build_generate(self, B, P, n_new, temperature, top_k=None,
                        top_p=None, rep_penalty=None):
        """The whole sampler run as one program over static tensors
        (``prompt`` [B, P], ``seed`` 0-d, ``out`` [B, P + n_new]): P
        prefill steps and n_new sampling steps through one token step,
        the KV caches and the repetition counts allocated inside it (in
        the graph's own memory on the card). Returns the program: its
        static tensors and ``graph``, a :class:`StaticGraph`."""
        c = self.conf
        V, total, dev = c.vocab_size, P + n_new, self.device
        step = self._make_token_step(B, total)
        prog = _Program(self.params,
                        prompt=torch.zeros((B, P), dtype=torch.int64,
                                           device=dev),
                        seed=torch.zeros((), dtype=torch.int64, device=dev),
                        out=torch.zeros((B, total), dtype=torch.int64,
                                        device=dev))
        pos_t = torch.arange(total, dtype=torch.int64, device=dev)
        rows = torch.arange(B, dtype=torch.int64, device=dev)

        def run():
            sp = self._step_params(prog.params)
            kcs, vcs = self._new_caches(B, total)
            prompt = prog.prompt
            prog.out[:, :P] = prompt
            for i in range(P):   # prefill through the same step
                logits = step(sp, prompt[:, i], i, kcs, vcs)
            if rep_penalty is not None:   # per-row counts of seen tokens
                seen = torch.zeros((B, V), dtype=torch.float32, device=dev)
                seen.scatter_add_(1, prompt, torch.ones_like(
                    prompt, dtype=torch.float32))
            for i in range(n_new):
                if rep_penalty is not None:
                    logits = torch.where(
                        seen > 0, torch.where(logits > 0,
                                              logits / rep_penalty,
                                              logits * rep_penalty), logits)
                if temperature == 0.0:
                    tok = logits.argmax(-1)
                else:
                    lg = self._filter_logits(logits, top_k, top_p)
                    noise = self._gumbel(prog.seed, rows,
                                         pos_t[P + i].expand(B), V)
                    tok = (lg / temperature + noise).argmax(-1)
                prog.out[:, P + i] = tok
                if rep_penalty is not None:
                    seen.scatter_add_(1, tok[:, None],
                                      torch.ones((B, 1), device=dev))
                if i + 1 < n_new:   # the last token needs no logits
                    logits = step(sp, tok, P + i, kcs, vcs)

        prog.graph = StaticGraph(run, dev)
        return prog

    # ---- beam search ---------------------------------------------------
    @whole("params")
    def beam_search(self, prompt, n_new, *, beams=4):
        """Fixed-horizon beam decoding: the ``beams`` highest joint
        log-probability continuations of length ``n_new``, returning the
        best one per batch row. One program (one captured graph on the
        card) over tiled KV caches; the parents are followed back on the
        host once, after the run.

        prompt: [B, P] int tokens; returns [B, P + n_new] int32."""
        c = self.conf
        if self.params is None:
            raise ValueError("TransformerLM has no parameters: call init() "
                             "or assign params_from_numpy(...)")
        prompt = _token_array(prompt, c.vocab_size)
        B, P = prompt.shape
        if P + n_new > c.max_len:
            raise ValueError(f"P+n_new={P + n_new} exceeds "
                             f"max_len={c.max_len}")
        if not 1 <= beams <= c.vocab_size:
            raise ValueError(f"beams must be in [1, {c.vocab_size}]")
        sig = self._gen_signature("beam", B, P, n_new, beams)
        prog = self._jit_gen.get(sig)
        if prog is None or prog.params is not self.params:
            self._jit_gen.pop(sig, None)   # parameters assigned anew
            self._evict_gen()
            prog = self._jit_gen[sig] = self._build_beam(B, P, n_new, beams)
        prog.prompt.copy_(torch.from_numpy(prompt.astype(np.int64)))
        prog.graph()
        toks_t, parents_t, scores = (prog.toks.cpu().numpy(),
                                     prog.parents.cpu().numpy(),
                                     prog.scores.cpu().numpy())
        out = np.zeros((B, n_new), np.int32)
        for b in range(B):
            w = int(scores[b].argmax())
            for t in range(n_new - 1, -1, -1):
                out[b, t] = toks_t[t, b, w]
                w = int(parents_t[t, b, w])
        return np.concatenate([prompt.astype(np.int32), out], axis=1)

    def _build_beam(self, B, P, n_new, W):
        c = self.conf
        V, total, dev = c.vocab_size, P + n_new, self.device
        prefill_step = self._make_token_step(B, total)
        beam_step = self._make_token_step(B * W, total)
        i64 = dict(dtype=torch.int64, device=dev)
        prog = _Program(self.params, prompt=torch.zeros((B, P), **i64),
                        toks=torch.zeros((n_new, B, W), **i64),
                        parents=torch.zeros((n_new, B, W), **i64),
                        scores=torch.zeros((B, W), dtype=torch.float32,
                                           device=dev))
        base_rows = torch.arange(B, **i64)[:, None] * W

        def run():
            sp = self._step_params(prog.params)
            kcs, vcs = self._new_caches(B, total)
            for i in range(P):
                logits = prefill_step(sp, prog.prompt[:, i], i, kcs, vcs)
            # tile rows B -> B*W (beam-major within each batch row)
            kcs = [k.repeat_interleave(W, 0) for k in kcs]
            vcs = [v.repeat_interleave(W, 0) for v in vcs]
            logits = logits.repeat_interleave(W, 0)               # (BW, V)
            # beam 0 live, the rest -inf, so that identical first beams
            # do not fill the whole frontier with one token
            scores = torch.full((B, W), -math.inf, device=dev)
            scores[:, 0] = 0.0
            for i in range(n_new):
                logp = torch.log_softmax(logits.to(torch.float32), -1)
                cand = scores[..., None] + logp.reshape(B, W, V)
                scores, flat = torch.topk(cand.reshape(B, W * V), W)
                parent = flat // V
                tok = flat % V
                prog.toks[i] = tok
                prog.parents[i] = parent
                if i + 1 < n_new:   # the last frontier needs no logits
                    # reorder the caches onto the surviving beams
                    rows = (base_rows + parent).reshape(-1)
                    kcs = [k[rows] for k in kcs]
                    vcs = [v[rows] for v in vcs]
                    logits = beam_step(sp, tok.reshape(-1), P + i, kcs, vcs)
            prog.scores.copy_(scores)

        prog.graph = StaticGraph(run, dev)
        return prog


class _Program:
    """A generate/beam program: its static tensors by name, ``graph``,
    the :class:`StaticGraph` of its run, and ``params``, the parameter
    tree it was built over (a graph binds that tree's storage)."""

    def __init__(self, params, **tensors):
        self.__dict__.update(tensors)
        self.params = params
        self.graph = None
