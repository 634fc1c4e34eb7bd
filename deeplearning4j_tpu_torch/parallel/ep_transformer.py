"""Expert-parallel MoE-TransformerLM training (Switch dispatch): the port
of ``deeplearning4j_tpu/parallel/ep_transformer.py`` onto an
``(expert,)`` grid of ranks (``expert_parallel.ep_mesh``).

The MoE LM's expert weights live one shard a rank along ``expert``; the
batch is split over the same axis (data parallelism for the dense
parts), and each MoE FFN sends its tokens to their routed expert with
one ``all_to_all`` and takes them back with the inverse exchange, two
collectives a MoE layer (``expert_parallel.switch_dispatch_apply``;
``topk_dispatch_apply``'s k rounds for top-k):

- the dense blocks, attention, embeddings and gates: replicated, each
  rank's batch rows, gradients completed by one all-reduce over
  ``expert`` after the backward;
- the expert leaves ``W1``, ``W1_b``, ``W2``, ``W2_b``: this rank's
  expert (a leading dim of 1), gradients rank-local;
- capacity is lossless by default (``(B / E) * T``: a rank's whole token
  set could go to one expert), so routing reproduces the dense
  ``MoETransformerLM`` exactly; ``capacity`` trades that for bounded
  buffers (dropped tokens ride the residual);
- the load-balance term is computed over a rank's tokens and averaged
  over the ranks: the local objective is ``nll.sum() + aux_weight * aux
  * n_local``, the reference's approximation of the global Switch aux
  (exact parity needs ``aux_weight=0``).

Attention is dense (the reference refuses ``block_size`` here), so this
path launches no package kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.models.moe_transformer import (
    MoETransformerConfig, MoETransformerLM)
from deeplearning4j_tpu_torch.models.transformer import (
    _adamw_apply, _block_apply, _flatten, _forward_tokens, _lr_at,
    _tree_map, _unflatten)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.expert_parallel import (
    switch_dispatch_apply, topk_dispatch_apply)
from deeplearning4j_tpu_torch.parallel.tp_transformer import (
    _tokens, _whole_params)

__all__ = ["EPTransformerLM"]

_EXPERT_LEAVES = ("W1", "W1_b", "W2", "W2_b")


def _moe_ffn_ep(bp, h, n_experts, capacity, axis, top_k=1):
    """The routed FFN on a local [B, T, d] shard: the dispatch core with
    this family's gelu + bias expert MLP. Returns (output, local aux
    loss, tokens a expert by first choice)."""
    B, T, d = h.shape

    def expert_fn(tokens):
        mid = F.gelu(tokens @ bp["W1"][0] + bp["W1_b"][0],
                     approximate="tanh")
        return mid @ bp["W2"][0] + bp["W2_b"][0]

    flat = h.reshape(-1, d)
    if top_k == 1:
        y, probs = switch_dispatch_apply(flat, bp["gate"], expert_fn,
                                         n_experts, capacity, axis)
    else:
        y, probs = topk_dispatch_apply(flat, bp["gate"], expert_fn,
                                       n_experts, capacity, axis, top_k)
    onehot = F.one_hot(probs.argmax(dim=-1), n_experts).to(torch.float32)
    aux = n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    return y.reshape(B, T, d), aux, onehot.sum(dim=0).detach()


class EPTransformerLM:
    """Expert-parallel trainer for the MoE LM family. ``params`` (a
    ``MoETransformerLM`` tree, whole: the reference's carried across, or
    the port's) sets the start, else the port's ``init()``; ``device``
    is this rank's (the card unless ``"cpu"``)."""

    def __init__(self, mesh, config: MoETransformerConfig, axis="expert",
                 capacity=0, *, params=None, device=None):
        if config.dropout:
            raise ValueError("EP trainer runs dropout-free (eval parity)")
        if config.block_size:
            raise ValueError("EP trainer uses dense attention; block_size "
                             "is not supported here")
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
        if config.n_experts != mesh.axis_size(axis):
            raise ValueError(
                f"n_experts {config.n_experts} must equal the expert axis "
                f"size ({mesh.axis_size(axis)}) — one expert shard per "
                "device")
        self.mesh = mesh
        self.axis = axis
        self.E = config.n_experts
        self.capacity = capacity        # 0 = lossless (local token count)
        self.conf = config
        self.device = multihost.rank_device(device)
        self._moe_layers = {i for i in range(config.n_layers)
                            if config.is_moe_layer(i)}
        full = _whole_params(config, params, self.device, MoETransformerLM)
        e = mesh.axis_index(axis)
        local = {path: (a[e:e + 1] if path.split(".")[-1] in _EXPERT_LEAVES
                        else a)
                 for path, a in _flatten(full).items()}
        self.params = _unflatten({
            k: v.detach().contiguous().clone().requires_grad_(True)
            for k, v in local.items()})
        self.opt_state = {"m": _tree_map(torch.zeros_like, self.params),
                          "v": _tree_map(torch.zeros_like, self.params)}
        self.iteration = 0
        self.score_ = float("nan")
        self.routed = None   # the last step's tokens a expert, a MoE layer

    def _local_logits(self, tokens, capacity):
        """(this rank's f32 logits, its aux terms, its tokens a expert),
        a MoE layer each (call inside ``with self.mesh``)."""
        c = self.conf
        auxes, routed = [], []

        def moe_block(bp, x):
            cell = {}

            def ffn(bp2, hloc):
                y, cell["aux"], cell["n"] = _moe_ffn_ep(
                    bp2, hloc, self.E, capacity, self.axis, c.router_top_k)
                return y
            return _block_apply(c, bp, x, ffn=ffn), cell["aux"], cell["n"]

        def apply(i, bp, x):
            if i not in self._moe_layers:
                if c.remat:
                    return checkpoint(_block_apply, c, bp, x,
                                      use_reentrant=False)
                return _block_apply(c, bp, x)
            if c.remat:
                x, aux, n = checkpoint(moe_block, bp, x, use_reentrant=False)
            else:
                x, aux, n = moe_block(bp, x)
            auxes.append(aux)
            routed.append(n)
            return x

        return _forward_tokens(c, self.params, tokens, apply), auxes, routed

    def _local_loss(self, tokens, targets, capacity):
        logits, auxes, self._routed_local = self._local_logits(tokens,
                                                               capacity)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        aux_total = torch.zeros((), device=logits.device)
        for a in auxes:
            aux_total = aux_total + a
        # the local objective in token units, so that the sum over the
        # ranks / n_tokens is mean ce + aux_weight * mean aux
        return nll.sum() + self.conf.aux_weight * aux_total * nll.numel()

    def _rows(self, tokens):
        """This rank's rows of a [B, T] batch, and the capacity."""
        B, T = tokens.shape
        if B % self.E:
            raise ValueError(
                f"batch {B} must be a multiple of the expert axis "
                f"({self.E})")
        cap = self.capacity or (B // self.E) * T   # lossless default
        return multihost.take_rows(tokens, self.mesh.axis_index(self.axis),
                                   self.E), cap

    def fit_batch(self, tokens, targets=None):
        """tokens: (B, T+1) next-token setup or (B, T) with ``targets``;
        B must divide by the expert axis. Returns the mean objective (a
        device scalar, the same on every rank)."""
        tokens = _tokens(tokens, self.device)
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        else:
            targets = _tokens(targets, self.device)
        B, T = tokens.shape
        tokens, cap = self._rows(tokens)
        targets, _ = self._rows(targets)
        leaves = _flatten(self.params)
        with self.mesh, torch.enable_grad():
            local_sum = self._local_loss(tokens, targets, cap)
            grads = torch.autograd.grad(local_sum, list(leaves.values()))
        shared = [i for i, p in enumerate(leaves)
                  if p.split(".")[-1] not in _EXPERT_LEAVES]
        flat = torch.cat([grads[i].reshape(-1) for i in shared]
                         + [local_sum.detach().reshape(1)]
                         + self._routed_local)
        self.mesh.all_reduce(flat, self.axis)
        n_tokens = float(B * T)
        out, off = {}, 0
        names = list(leaves)
        grads = list(grads)
        for i in shared:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i])
            off += n
        loss = flat[off] / n_tokens
        self.routed = flat[off + 1:].reshape(-1, self.E)
        for path, g in zip(names, grads):
            out[path] = g / n_tokens
        c = self.conf
        t = self.iteration + 1
        _adamw_apply(c, self.params, _unflatten(out), self.opt_state, t,
                     _lr_at(c, t))
        self.iteration = t
        self.score_ = loss
        return loss

    def gathered_logits(self, tokens):
        """The whole model's f32 logits on ``tokens`` [B, T] (each rank
        its rows, gathered; no update)."""
        toks, cap = self._rows(_tokens(tokens, self.device))
        with self.mesh, torch.no_grad():
            logits = self._local_logits(toks, cap)[0]
        return self.mesh.all_gather(logits, self.axis).cpu().numpy()

    def gathered_params(self):
        """The whole parameters in the ``MoETransformerLM`` layout, as
        numpy arrays (a collective over the expert axis)."""
        out = {}
        for path, a in _flatten(self.params).items():
            a = a.detach()
            if path.split(".")[-1] in _EXPERT_LEAVES:
                a = self.mesh.all_gather(a, self.axis)
            out[path] = a.cpu().numpy()
        return _unflatten(out)
