"""Pipeline-parallel TransformerLM training (GPipe schedule): the port of
``deeplearning4j_tpu/parallel/pp_transformer.py`` onto a ``(data,
pipe)`` grid of ranks (``pipeline_parallel.pp_mesh``).

The LM's blocks are laid out in S stages, ``n_layers / S`` a rank,
stacked on a leading ``(n_layers / S, ...)`` axis under ``blocks``; the
embeddings (the tied ``wte`` feeds stage 0's embedding and the last
stage's logits), ``wpe`` and the final LayerNorm are replicated. M
microbatches stream through the stages on ``PipelineParallelNet``'s
schedule (``pipeline_parallel.py``): stage 0 embeds microbatch m, each
stage applies its blocks (``transformer._block_apply``: with
``block_size`` set the attention takes ``_blockwise_route``, the flash
kernels on the card, forward and backward) and sends the activation on,
the last stage adds microbatch m's masked loss sum; the backward runs
the microbatches in reverse, each stage calling
``torch.autograd.backward`` on its output with the gradient the next
stage sent and sending its input's gradient back. After the backward
one all-reduce over ``pipe`` completes the replicated leaves' gradients
(each stage holds its own part) and the loss, everything is divided by
the step's token count, and ``transformer._adamw_apply`` updates each
rank's leaves with the name-keyed decay mask (the stacked layout breaks
the ndim rule).

A data axis wider than 1 repeats the pipeline on every data row with
the whole batch (the reference's tokens are replicated over the mesh).
GPipe is math-preserving: from the same parameters (``params``: a
``TransformerLM`` tree, the reference's through ``params_from_numpy``'s
carry-over, else the port's ``init()``), S-stage training reproduces
the single-device model's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, _adamw_apply, _block_apply, _flatten, _layer_norm,
    _lr_at, _tree_map, _unflatten)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.pipeline_parallel import \
    pipeline_backward
from deeplearning4j_tpu_torch.parallel.tp_transformer import (
    _cast, _tokens, _whole_params)

__all__ = ["PPTransformerLM"]

# block leaves that are matmul weight matrices (GPT-2 decay discipline);
# the stacked (n_layers / S, ...) layout breaks the ndim >= 2 rule, so the
# decay mask is keyed by name
_DECAYED_BLOCK_LEAVES = frozenset({"qkv", "proj", "fc", "out"})
_REPLICATED = ("wte", "wpe", "lnf_g", "lnf_b")


class PPTransformerLM:
    """GPipe-scheduled trainer for the TransformerLM family. ``mesh``
    from ``pp_mesh``; ``device`` is this rank's (the card unless
    ``"cpu"``)."""

    def __init__(self, mesh, config: TransformerConfig, n_micro,
                 axis="pipe", *, params=None, device=None):
        if config.dropout:
            raise ValueError("PP trainer runs dropout-free (eval parity)")
        if config.pos_embed != "learned":
            raise ValueError("PP trainer assumes the learned wpe table")
        self.mesh = mesh
        self.axis = axis
        self.S = mesh.axis_size(axis)
        self.M = int(n_micro)
        if self.M < 1:
            raise ValueError("need at least one microbatch")
        if config.n_layers % self.S:
            raise ValueError(
                f"n_layers {config.n_layers} must divide into {self.S} "
                f"stages")
        self.bps = config.n_layers // self.S
        self.conf = config
        self.stage = mesh.axis_index(axis)
        self.device = multihost.rank_device(device)
        self.params = self._shard_params(
            _whole_params(config, params, self.device))
        self.opt_state = {"m": _tree_map(torch.zeros_like, self.params),
                          "v": _tree_map(torch.zeros_like, self.params)}
        self.iteration = 0
        self.score_ = float("nan")

    # ---- parameter layout ---------------------------------------------
    def _shard_params(self, full):
        self._block_keys = sorted(full["b0"].keys())
        lo = self.stage * self.bps
        out = {k: full[k].detach().clone() for k in _REPLICATED}
        out["blocks"] = {
            key: torch.stack([full[f"b{lo + j}"][key].detach()
                              for j in range(self.bps)])
            for key in self._block_keys}
        return _tree_map(lambda a: a.contiguous().requires_grad_(True), out)

    def _decay_mask(self):
        return {"wte": 1.0, "wpe": 0.0, "lnf_g": 0.0, "lnf_b": 0.0,
                "blocks": {k: (1.0 if k in _DECAYED_BLOCK_LEAVES else 0.0)
                           for k in self._block_keys}}

    # ---- the pipelined forward and backward -----------------------------
    def _stage_fn(self, params):
        """This stage's blocks as one function of the activation (each
        block recomputed in the backward under remat)."""
        c = self.conf
        blocks = [{k: params["blocks"][k][j] for k in self._block_keys}
                  for j in range(self.bps)]

        def apply(x):
            for bp in blocks:
                if c.remat:
                    x = checkpoint(_block_apply, c, bp, x,
                                   use_reentrant=False)
                else:
                    x = _block_apply(c, bp, x)
            return x
        return apply

    def _run(self, tokens, targets, loss=True):
        """The forward of every microbatch (tokens: (M, mb, T)). Returns
        (stage inputs, stage outputs, the last stage's loss sum): an
        output is the microbatch's loss sum on the last stage (its
        logits when ``loss`` is False), the activation sent on
        elsewhere."""
        c, mesh, s = self.conf, self.mesh, self.stage
        first, last = s == 0, s == self.S - 1
        mb, T = tokens.shape[1], tokens.shape[2]
        P = _cast(self.params, c.compute_dtype)   # one cast a step
        apply = self._stage_fn(P)
        dt = getattr(torch, c.compute_dtype) if c.compute_dtype \
            else torch.float32
        ins, outs = [], []
        local_sum = torch.zeros((), device=self.device)
        for m in range(tokens.shape[0]):
            if first:
                x = (P["wte"][tokens[m]] + P["wpe"][:T]).to(dt)
            else:
                x = torch.empty(mb, T, c.d_model, dtype=dt,
                                device=self.device)
                mesh.exchange(self.axis, recvs=[(x, s - 1)])
                x.requires_grad_(torch.is_grad_enabled())
            y = apply(x)
            if last:
                h = _layer_norm(y, P["lnf_g"], P["lnf_b"])
                y = (h @ P["wte"].T).to(torch.float32)
                if loss:
                    logp = torch.log_softmax(y, dim=-1)
                    y = -torch.gather(logp, -1,
                                      targets[m][..., None])[..., 0].sum()
                    local_sum = local_sum + y.detach()
            else:
                mesh.exchange(self.axis, sends=[(y.detach(), s + 1)])
            ins.append(x)
            outs.append(y)
        return ins, outs, local_sum

    def _backward(self, ins, outs):
        pipeline_backward(self.mesh, self.axis, ins, outs,
                          list(_flatten(self.params).values()))

    # ---- training ------------------------------------------------------
    def fit_batch(self, tokens, targets=None):
        """tokens: (N, T+1) next-token setup, or (N, T) with ``targets``;
        N must be a multiple of ``n_micro``. Returns the mean loss (a
        device scalar, the same on every stage)."""
        tokens = _tokens(tokens, self.device)
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        else:
            targets = _tokens(targets, self.device)
        N, T = tokens.shape
        if N % self.M:
            raise ValueError(
                f"batch {N} must be a multiple of n_micro ({self.M})")
        mb = N // self.M
        toks = tokens.reshape(self.M, mb, T)
        tgts = targets.reshape(self.M, mb, T)
        with torch.enable_grad():
            ins, outs, local_sum = self._run(toks, tgts)
            self._backward(ins, outs)
        del ins, outs
        c = self.conf
        n_tokens = float(N * T)
        flat = _flatten(self.params)
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for k, p in flat.items()}
            for p in flat.values():
                p.grad = None
            # replicated leaves: each stage holds its own part (wte from
            # the embedding on stage 0 and the logits on the last; lnf on
            # the last only): one all-reduce over pipe completes them
            rep = torch.cat([grads[k].reshape(-1) for k in _REPLICATED]
                            + [local_sum.reshape(1)])
            self.mesh.all_reduce(rep, self.axis)
            rep /= n_tokens
            off = 0
            for k in _REPLICATED:
                n = grads[k].numel()
                grads[k] = rep[off:off + n].view_as(grads[k])
                off += n
            for k in grads:
                if k not in _REPLICATED:
                    grads[k] = grads[k] / n_tokens
        t = self.iteration + 1
        _adamw_apply(c, self.params, _unflatten(grads), self.opt_state, t,
                     _lr_at(c, t), mask=self._decay_mask())
        self.iteration = t
        self.score_ = rep[-1]
        return self.score_

    # ---- introspection -------------------------------------------------
    def shard_fraction(self):
        """This rank's share of the parameter elements: (replicated +
        blocks / S) over the whole, the PP memory claim."""
        mine = total = 0
        for path, a in _flatten(self.params).items():
            mine += a.numel()
            total += a.numel() * (self.S if path.startswith("blocks.")
                                  else 1)
        return mine / total

    def gathered_params(self):
        """The whole parameters in the ``TransformerLM`` layout (``b0``
        ... ``b{L-1}``), as numpy arrays (a collective over the pipe)."""
        out = {k: self.params[k].detach().cpu().numpy() for k in _REPLICATED}
        for key in self._block_keys:
            whole = self.mesh.all_gather(
                self.params["blocks"][key].detach(), self.axis)
            for i in range(self.conf.n_layers):
                out.setdefault(f"b{i}", {})[key] = whole[i].cpu().numpy()
        return out

    def gathered_logits(self, tokens):
        """The whole model's f32 logits on ``tokens`` (N, T), through the
        pipeline as one microbatch, on every stage (a collective over the
        pipe; no update)."""
        toks = _tokens(tokens, self.device)[None]
        with torch.no_grad():
            _, outs, _ = self._run(toks, None, loss=False)
            if self.stage == self.S - 1:
                logits = outs[0]
            else:
                logits = torch.zeros(*toks.shape[1:], self.conf.vocab_size,
                                     device=self.device)
            self.mesh.all_reduce(logits, self.axis)
        return logits.cpu().numpy()
