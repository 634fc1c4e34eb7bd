"""Sequence-parallel TransformerLM training (ring attention): the port of
``deeplearning4j_tpu/parallel/sp_transformer.py`` onto a grid of ranks
whose row is the ``seq`` axis (``tp_mesh(1, N, ("data", "seq"))``).

- Every rank holds the whole parameters and its [B, T/N] token shard,
  with the ``wpe`` rows from offset ``rank * T / N``; embeddings, blocks
  and the logits head run on the shard;
- attention is the exact ring (``sequence_parallel.ring_attention``
  through ``_block_apply``'s ``attend`` seam, causal): K/V shards rotate
  rank to rank while the flash recurrence accumulates, so no rank holds
  the whole sequence;
- each rank's loss covers its tokens, so its gradients are partials:
  one all-reduce over ``seq`` after the backward completes them (the
  ring's rotations are the only collectives inside the differentiated
  region), then ``/ n_tokens`` and ``transformer._adamw_apply``.

From the same parameters (``params``, else the port's ``init()``)
N-way sequence sharding reproduces single-device training: the ring is
exact, not approximate.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, _adamw_apply, _block_apply, _flatten, _layer_norm,
    _lr_at, _tree_map, _unflatten)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.tp_transformer import (
    _cast, _tokens, _whole_params)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
    ring_attention

__all__ = ["SPTransformerLM"]


class SPTransformerLM:
    """Ring-attention sequence-parallel trainer for the LM family.
    ``device`` is this rank's (the card unless ``"cpu"``)."""

    def __init__(self, mesh, config: TransformerConfig, axis="seq", *,
                 params=None, device=None):
        if config.dropout:
            raise ValueError("SP trainer runs dropout-free (eval parity)")
        if config.block_size:
            raise ValueError(
                "SP attention is the ring recurrence; block_size (single-"
                "device flash) does not apply")
        if config.window:
            raise ValueError(
                "the ring recurrence has no sliding-window support; "
                "use window on the single-device/dp paths")
        if config.pos_embed != "learned":
            raise ValueError("SP trainer slices the learned wpe per shard")
        self.mesh = mesh
        self.axis = axis
        self.N = mesh.axis_size(axis)
        self.conf = config
        self.device = multihost.rank_device(device)
        self.params = _tree_map(
            lambda a: a.detach().clone().requires_grad_(True),
            _whole_params(config, params, self.device))
        self.opt_state = {"m": _tree_map(torch.zeros_like, self.params),
                          "v": _tree_map(torch.zeros_like, self.params)}
        self.iteration = 0
        self.score_ = float("nan")

    def _block_local(self, bp, x):
        """The canonical block on a [B, T/N, d] shard, the attention
        swapped for the ring (everything else is per token)."""
        def ring(q, k, v):
            return ring_attention(q, k, v, axis_name=self.axis, causal=True)
        return _block_apply(self.conf, bp, x, attend=ring)

    def _local_logits(self, tokens):
        """This rank's [B, T/N, V] f32 logits (call inside ``with
        self.mesh``)."""
        c = self.conf
        tl = tokens.shape[1]
        off = self.mesh.axis_index(self.axis) * tl
        p = self.params
        x = p["wte"][tokens] + p["wpe"][off:off + tl]
        if c.compute_dtype:
            x = x.to(getattr(torch, c.compute_dtype))
        P = _cast(p, c.compute_dtype)
        for i in range(c.n_layers):
            if c.remat:
                x = checkpoint(self._block_local, P[f"b{i}"], x,
                               use_reentrant=False)
            else:
                x = self._block_local(P[f"b{i}"], x)
        x = _layer_norm(x, P["lnf_g"], P["lnf_b"])
        return (x @ P["wte"].T).to(torch.float32)

    def _local_loss(self, tokens, targets):
        """tokens/targets: this rank's [B, T/N] shards; the local nll
        SUM (the all-reduce over seq comes after the backward)."""
        logp = torch.log_softmax(self._local_logits(tokens), dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0].sum()

    def _shard(self, tokens):
        """This rank's columns of a [B, T] batch, after the reference's
        checks of T."""
        T = tokens.shape[1]
        if T % self.N:
            raise ValueError(
                f"sequence length {T} must be a multiple of the seq axis "
                f"({self.N})")
        if T > self.conf.max_len:
            # a shard's wpe rows past the table would be cut short
            # (or, in the reference, clamped): refuse instead
            raise ValueError(
                f"sequence length {T} exceeds max_len {self.conf.max_len}")
        return multihost.take_rows(tokens, self.mesh.axis_index(self.axis),
                                   self.N, axis=1)

    def fit_batch(self, tokens, targets=None):
        """tokens: (B, T+1) next-token setup or (B, T) with ``targets``;
        T must be a multiple of the seq axis and at most ``max_len``.
        Returns the mean loss (a device scalar, the same on every
        rank)."""
        tokens = _tokens(tokens, self.device)
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        else:
            targets = _tokens(targets, self.device)
        B, T = tokens.shape
        tokens, targets = self._shard(tokens), self._shard(targets)
        leaves = _flatten(self.params)
        with self.mesh, torch.enable_grad():
            local_sum = self._local_loss(tokens, targets)
            grads = torch.autograd.grad(local_sum, list(leaves.values()))
        # every leaf is replicated but each rank saw only its tokens: one
        # all-reduce completes the gradients (and the loss); / n_tokens
        # turns the sum's gradients into the global token mean's
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [local_sum.detach().reshape(1)])
        self.mesh.all_reduce(flat, self.axis)
        flat /= float(B * T)
        out, off = {}, 0
        for path, g in zip(leaves, grads):
            out[path] = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
        c = self.conf
        t = self.iteration + 1
        _adamw_apply(c, self.params, _unflatten(out), self.opt_state, t,
                     _lr_at(c, t))
        self.iteration = t
        self.score_ = flat[-1]
        return self.score_

    def gathered_logits(self, tokens):
        """The whole model's f32 logits on ``tokens`` [B, T] (each rank
        its T/N positions by the ring, gathered; no update)."""
        with self.mesh, torch.no_grad():
            logits = self._local_logits(
                self._shard(_tokens(tokens, self.device)))
        return self.mesh.all_gather(logits, self.axis, dim=1).cpu().numpy()

    def gathered_params(self):
        """The parameters (whole on every rank) as numpy arrays."""
        return _tree_map(lambda a: a.detach().cpu().numpy(), self.params)
