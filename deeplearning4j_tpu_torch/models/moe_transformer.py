"""Mixture-of-Experts TransformerLM: switch-routed FFN blocks, the port of
``deeplearning4j_tpu/models/moe_transformer.py``.

Every ``moe_every``-th block's dense FFN is replaced by a routed layer:
E expert MLPs, a softmax gate, each token sent to its top-k experts and
combined by the gate's weights, plus the Switch-Transformer
load-balancing term ``E * Σ_e f_e · P_e`` (f_e the share of tokens whose
first choice is e, P_e the mean gate probability of e).

Routing is computed densely, as in the reference: every expert runs
every token and the k-hot combine selects, so top-k is exact with no
capacity drops. The expert products are plain batched matrix products
(no hand kernel in the reference either); attention, AdamW, the decay
discipline, the learning-rate schedule and the fit/listener surface are
``TransformerLM``'s, the routed FFN riding ``_block_apply``'s ``ffn``
seam. With ``block_size`` set the attention takes the LM's flash route:
the three hand-written kernels on the card.

Generation is not implemented for this family (the reference's words):
``generate()``, ``beam_search()`` and a ``ContinuousLM`` over an MoE LM
raise ``NotImplementedError`` at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _block_apply, _forward_tokens,
    _fresh_opt_state, _parameter_tree, _tree_map, mask_denominator)
from deeplearning4j_tpu_torch.parallel.sharding_core import \
    current_batch_plan

__all__ = ["MoETransformerConfig", "MoETransformerLM", "moe_ffn_dense"]

_NO_GENERATION = ("KV-cache generation is not implemented for the MoE "
                  "family; use output() for scoring or the dense "
                  "TransformerLM for sampling")


@dataclass
class MoETransformerConfig(TransformerConfig):
    n_experts: int = 4
    moe_every: int = 2          # every k-th block is MoE (1 = all blocks)
    d_expert: int = 0           # expert hidden width; 0 = d_ff
    aux_weight: float = 0.01    # Switch load-balance loss weight
    router_top_k: int = 1       # 1 = Switch; 2 = GShard top-2 combine

    def __post_init__(self):
        super().__post_init__()
        if self.n_experts < 2:
            raise ValueError("need at least 2 experts")
        if self.moe_every < 1:
            raise ValueError("moe_every must be >= 1")
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k {self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]")

    def is_moe_layer(self, i: int) -> bool:
        """Blocks moe_every-1, 2*moe_every-1, ... are MoE (every other
        block for moe_every=2)."""
        return (i + 1) % self.moe_every == 0


def moe_ffn_dense(bp, h, n_experts, top_k=1):
    """Exact top-k routed FFN, computed densely: every expert runs every
    token and the weighted k-hot combine selects the routed ones. The
    gate logits are ``h @ gate`` in h's dtype, the softmax in f32. top_k
    1 is Switch (the top probability is the combine weight, the first
    index wins a tie, as ``argmax`` in both frameworks); top_k >= 2 is the
    GShard combine (the top-k probabilities renormalised to sum 1).
    Returns (output, aux loss)."""
    probs = torch.softmax((h @ bp["gate"]).float(), dim=-1)
    hid = torch.einsum("btd,edh->beth", h, bp["W1"]) \
        + bp["W1_b"][None, :, None, :]
    # jax.nn.gelu defaults to the tanh approximation
    hid = F.gelu(hid, approximate="tanh")
    out = torch.einsum("beth,ehd->betd", hid, bp["W2"]) \
        + bp["W2_b"][None, :, None, :]
    if top_k == 1:
        top, eid = probs.max(dim=-1)                       # (B, T)
        onehot = F.one_hot(eid, n_experts).to(probs.dtype)
        combine = onehot * top[..., None]
    else:
        topv, topi = torch.topk(probs, top_k, dim=-1)      # (B, T, k)
        w = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        khot = F.one_hot(topi, n_experts).to(probs.dtype)
        combine = (khot * w[..., None]).sum(-2)            # (B, T, E)
        onehot = khot[..., 0, :]                           # first choice
    y = torch.einsum("betd,bte->btd", out, combine.to(out.dtype))
    # load balance over first choices: E * sum_e f_e * P_e over the batch
    f = onehot.reshape(-1, n_experts).mean(dim=0)
    p = probs.reshape(-1, n_experts).mean(dim=0)
    plan = current_batch_plan()
    if plan is not None:
        # the global batch's means: every rank holds as many tokens
        f = plan.all_reduce_sum(f) / plan.n
        p = plan.all_reduce_sum(p) / plan.n
    return y, n_experts * torch.sum(f * p)


class MoETransformerLM(TransformerLM):
    """TransformerLM with switch-MoE FFN blocks. ``device=None`` means the
    card; pass ``device="cpu"`` to run on the CPU."""

    def init(self):
        """The dense LM's parameters, then each MoE block's ``fc``/``out``
        replaced by ``gate [d, E]``, ``W1 [E, d, h]``, ``W1_b [E, h]``,
        ``W2 [E, h, d]`` and ``W2_b [E, d]`` at the reference's scales,
        drawn from a ``torch.Generator`` seeded ``conf.seed + 101``."""
        super().init()
        c = self.conf
        d, h, E = c.d_model, c.d_expert or c.d_ff, c.n_experts
        std = 0.02
        rs = std / math.sqrt(2 * c.n_layers)
        g = torch.Generator(device=self.device).manual_seed(c.seed + 101)

        def normal(shape, scale):
            return scale * torch.randn(shape, generator=g,
                                       device=self.device)
        p = _tree_map(lambda a: a.detach(), self.params)
        for i in range(c.n_layers):
            if not c.is_moe_layer(i):
                continue
            bp = p[f"b{i}"]
            for key in ("fc", "fc_b", "out", "out_b"):
                del bp[key]
            bp["gate"] = normal((d, E), 0.1)
            bp["W1"] = normal((E, d, h), std)
            bp["W1_b"] = torch.zeros((E, h), device=self.device)
            bp["W2"] = normal((E, h, d), rs)
            bp["W2_b"] = torch.zeros((E, d), device=self.device)
        self.params = _parameter_tree(p)
        self.opt_state = _fresh_opt_state(c, self.params)
        return self

    # ---- forward with the aux term ------------------------------------
    def _logits_aux(self, params, tokens, rng=None):
        """(logits, Σ aux over the MoE blocks). Under remat a MoE block
        returns its aux as a real output of the checkpointed function, so
        the recomputed forward and the backward see the same term."""
        c = self.conf
        keeps = self._keep_masks(tokens, rng)
        drop = self._drop if keeps[0] is not None else None
        auxes = []

        def moe_block(bp, x, keep):
            cell = {}

            def ffn(bp2, hloc):
                # looked up at call time, so a caller can watch the routing
                y, cell["aux"] = moe_ffn_dense(bp2, hloc, c.n_experts,
                                               c.router_top_k)
                return y
            out = _block_apply(c, bp, x, drop, keep, ffn=ffn)
            return out, cell["aux"]

        def apply(i, bp, x):
            if not c.is_moe_layer(i):
                if c.remat:
                    return checkpoint(_block_apply, c, bp, x, drop, keeps[i],
                                      use_reentrant=False)
                return _block_apply(c, bp, x, drop, keeps[i])
            if c.remat:
                x, aux = checkpoint(moe_block, bp, x, keeps[i],
                                    use_reentrant=False)
            else:
                x, aux = moe_block(bp, x, keeps[i])
            auxes.append(aux)
            return x

        logits = _forward_tokens(c, params, tokens, apply)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        for aux in auxes:
            total = total + aux
        return logits, total

    def _logits(self, params, tokens, rng=None):
        return self._logits_aux(params, tokens, rng)[0]

    def _loss(self, params, tokens, targets, mask, rng=None):
        """Masked mean cross-entropy plus ``aux_weight`` times the aux
        term: the reference's own override (no label smoothing, no
        z-loss)."""
        logits, aux = self._logits_aux(params, tokens, rng)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        m = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        ce = (nll * m).sum() / mask_denominator(m)
        return ce + self.conf.aux_weight * aux

    def eval_loss(self, tokens):
        """Held-out mean next-token NLL without the aux term: training
        minimises the load-balance penalty too, held-out likelihood (and
        ``perplexity``) does not count it."""
        toks = self._device_tokens(tokens)
        with torch.no_grad():
            logits = self._logits(self.params, toks[:, :-1])
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, toks[:, 1:, None])[..., 0]
            return float(nll.mean())

    eval_ce = eval_loss

    # ---- no generation ---------------------------------------------------
    def _check_decodable(self):
        raise NotImplementedError(_NO_GENERATION)

    def generate(self, *a, **kw):
        raise NotImplementedError(_NO_GENERATION)

    def beam_search(self, *a, **kw):
        raise NotImplementedError(_NO_GENERATION)
