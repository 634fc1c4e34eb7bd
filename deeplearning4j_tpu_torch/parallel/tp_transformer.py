"""Tensor-parallel TransformerLM training (Megatron partitioning): the
port of ``deeplearning4j_tpu/parallel/tp_transformer.py`` onto a grid of
``torch.distributed`` ranks (``parallel/tensor_parallel.py``).

The transformer's matmuls split over the grid's ``model`` axis, with two
all-reduces a block:

- attention: the ``[q|k|v]`` projection cut into column shards that each
  hold ``n_heads / M`` whole heads; attention runs dense on the local
  heads (``parallel/sequence_parallel.py``'s ``dense_attention``, on the
  card too); the output projection is row-parallel and one all-reduce
  rebuilds the residual;
- MLP: the up-projection column-parallel, GELU local, the
  down-projection row-parallel and one all-reduce;
- embeddings, LayerNorms and the tied logits replicated;
- AdamW (the single-device model's ``transformer._adamw_apply``, with
  its decay mask) on each rank's shards alone: the conjugate operators
  leave every rank holding exactly its shards' gradients, so the
  optimizer state is sharded as the parameters are;
- on a 2-D grid, one gradient all-reduce over ``data`` a step.

It starts from the whole parameters of a ``TransformerLM`` of the same
configuration: the port's own (``init()``), or any tree handed in as
``params`` (the reference's, through ``params_from_numpy``'s carry-over),
so N-way training is held against the single-device model from the same
start.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _adamw_apply, _flatten, _layer_norm,
    _lr_at, _tree_map, params_from_numpy)
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
    dense_attention
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    copy_to_model, reduce_from_model)

__all__ = ["TPTransformerLM"]

# the block's column-parallel leaves (cut along their last axis), its
# row-parallel ones (along the first); every other leaf is replicated
_COL = ("wq", "wk", "wv", "bq", "bk", "bv", "fc", "fc_b")
_ROW = ("proj", "out")


def _whole_params(config, params, device, model=TransformerLM):
    """The whole parameter tree of a ``model`` (``TransformerLM`` or a
    subclass) on ``device``: ``params`` (numpy or tensors, the
    reference's carried across) copied over, else the port's
    ``init()``."""
    if params is None:
        return model(config, device=device).init().params
    return params_from_numpy(_tree_map(
        lambda a: a.detach().cpu().numpy()
        if isinstance(a, torch.Tensor) else np.asarray(a), params),
        device=device)


def _cast(tree, cd):
    """The tree in the compute dtype (bf16 compute against f32
    masters); the identity without one."""
    if not cd:
        return tree
    dt = getattr(torch, cd)
    return _tree_map(lambda a: a.to(dt) if a.is_floating_point() else a,
                     tree)


def _tokens(a, device):
    """Host or device token ids as int64 on ``device``."""
    t = torch.as_tensor(np.asarray(a), dtype=torch.long) \
        if not isinstance(a, torch.Tensor) else a.long()
    return t.to(device)


class TPTransformerLM:
    """Megatron-partitioned trainer for the TransformerLM family."""

    def __init__(self, mesh, config: TransformerConfig, axis="model",
                 data_axis="data", *, params=None, device=None):
        """``mesh`` from ``tensor_parallel.tp_mesh``: a grid whose data
        axis is 1 is pure TP; a wider one is TP x DP (parameters split
        over ``model`` and replicated over ``data``, the batch split over
        ``data``, one gradient all-reduce over ``data`` a step)."""
        if config.dropout:
            raise ValueError("TP trainer runs dropout-free (eval parity)")
        if config.block_size:
            raise ValueError(
                "TP trainer uses dense attention over local heads; "
                "block_size (flash recurrence) is not supported here")
        if config.kv_group > 1 or config.window:
            raise ValueError(
                "TP trainer re-derives the MHA qkv partitioning; GQA "
                "(kv_group > 1) and sliding window are not supported here")
        if config.pos_embed != "learned":
            raise ValueError("TP trainer assumes the learned wpe table")
        names = tuple(mesh.axis_names)
        if axis not in names:
            raise ValueError(
                f"mesh has no model axis {axis!r} (axes: {names}) — pass "
                "axis=<your name> or rename")
        extra = [a for a in names if a not in (axis, data_axis)]
        if extra:
            raise ValueError(
                f"mesh axes {extra} are neither the model axis ({axis!r}) "
                f"nor the data axis ({data_axis!r}) — the batch would be "
                f"silently replicated over them")
        self.mesh = mesh
        self.axis = axis
        self.N = mesh.shape[axis]
        self.data_axis = data_axis if data_axis in names else None
        self.n_data = mesh.shape[data_axis] if self.data_axis else 1
        self.conf = config
        if config.n_heads % self.N:
            raise ValueError(
                f"n_heads {config.n_heads} must divide the model axis "
                f"({self.N}) — column slices must be head-aligned")
        if config.d_ff % self.N:
            raise ValueError(
                f"d_ff {config.d_ff} must divide the model axis ({self.N})")
        self.device = multihost.rank_device(device)
        self.params = self._shard_params(
            _whole_params(config, params, self.device))
        self.opt_state = {
            "m": _tree_map(torch.zeros_like, self.params),
            "v": _tree_map(torch.zeros_like, self.params),
        }
        self.iteration = 0
        self.score_ = float("nan")

    # ---- parameter layout ---------------------------------------------
    def _block_layout(self, bp):
        """``(d, 3d)`` [q|k|v] -> separate Wq/Wk/Wv, then this rank's
        column shard of each (whole heads) and row shard of the output
        projections."""
        d = self.conf.d_model
        qkv, qkv_b = bp["qkv"], bp["qkv_b"]
        whole = {
            "ln1_g": bp["ln1_g"], "ln1_b": bp["ln1_b"],
            "wq": qkv[:, :d], "wk": qkv[:, d:2 * d], "wv": qkv[:, 2 * d:],
            "bq": qkv_b[:d], "bk": qkv_b[d:2 * d], "bv": qkv_b[2 * d:],
            "proj": bp["proj"], "proj_b": bp["proj_b"],
            "ln2_g": bp["ln2_g"], "ln2_b": bp["ln2_b"],
            "fc": bp["fc"], "fc_b": bp["fc_b"],
            "out": bp["out"], "out_b": bp["out_b"],
        }
        m, n = self.mesh.model_index, self.N
        out = {}
        for k, v in whole.items():
            v = v.detach()
            if k in _COL:
                c = v.shape[-1] // n
                v = v.narrow(v.ndim - 1, m * c, c)
            elif k in _ROW:
                c = v.shape[0] // n
                v = v.narrow(0, m * c, c)
            out[k] = v.contiguous().clone().requires_grad_(True)
        return out

    def _shard_params(self, full):
        out = {k: full[k].detach().clone().requires_grad_(True)
               for k in ("wte", "wpe", "lnf_g", "lnf_b")}
        for i in range(self.conf.n_layers):
            out[f"b{i}"] = self._block_layout(full[f"b{i}"])
        return out

    # ---- sharded forward ----------------------------------------------
    def _block_local(self, bp, x):
        """One block on this rank's heads and d_ff shard: two f ... g
        regions."""
        c, mesh = self.conf, self.mesh
        B, T, d = x.shape
        h_local = c.n_heads // self.N
        hd = d // c.n_heads
        # LN stays outside the f..g region: its output's gradient must be
        # the all-reduced, whole one, so the LN leaves' gradients are
        hloc = copy_to_model(_layer_norm(x, bp["ln1_g"], bp["ln1_b"]), mesh)
        q = hloc @ bp["wq"] + bp["bq"]            # (B, T, d/N) local heads
        k = hloc @ bp["wk"] + bp["bk"]
        v = hloc @ bp["wv"] + bp["bv"]

        def split(a):
            return a.reshape(B, T, h_local, hd).transpose(1, 2)
        o = dense_attention(split(q), split(k), split(v), causal=True)
        o = o.transpose(1, 2).reshape(B, T, d // self.N)
        x = x + reduce_from_model(o @ bp["proj"], mesh) + bp["proj_b"]
        hloc = copy_to_model(_layer_norm(x, bp["ln2_g"], bp["ln2_b"]), mesh)
        h1 = F.gelu(hloc @ bp["fc"] + bp["fc_b"], approximate="tanh")
        return x + reduce_from_model(h1 @ bp["out"], mesh) + bp["out_b"]

    def _forward_local(self, params, tokens):
        c = self.conf
        T = tokens.shape[1]
        x = params["wte"][tokens] + params["wpe"][:T]
        if c.compute_dtype:   # bf16 compute against f32 masters
            x = x.to(getattr(torch, c.compute_dtype))
            params = _cast(params, c.compute_dtype)
        for i in range(c.n_layers):
            x = self._block_local(params[f"b{i}"], x)
        x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
        return (x @ params["wte"].T).to(torch.float32)

    def _loss_local(self, params, tokens, targets):
        logits = self._forward_local(params, tokens)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return nll.mean()

    # ---- training ------------------------------------------------------
    def _tokens(self, a):
        return _tokens(a, self.device)

    def fit_batch(self, tokens, targets=None):
        """One AdamW step on the global batch; this rank takes its data
        shard's rows. Returns the global mean loss (a device scalar)."""
        tokens = self._tokens(tokens)
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        else:
            targets = self._tokens(targets)
        if self.data_axis and tokens.shape[0] % self.n_data:
            raise ValueError(
                f"batch {tokens.shape[0]} must be a multiple of the data "
                f"axis ({self.n_data})")
        rows = self.mesh.data_index
        tokens = multihost.take_rows(tokens, rows, self.n_data)
        targets = multihost.take_rows(targets, rows, self.n_data)
        c = self.conf
        leaves = _flatten(self.params)
        with torch.enable_grad():
            loss = self._loss_local(self.params, tokens, targets)
            flat = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
        if self.n_data > 1:
            # each data shard saw its own rows: the global batch's
            # gradient is the mean of the shards' (equal shard sizes)
            buf = torch.cat([g.reshape(-1) for g in flat]
                            + [loss.reshape(1)])
            self.mesh.all_reduce(buf, "data")
            buf /= self.n_data
            off, out = 0, []
            for g in flat:
                out.append(buf[off:off + g.numel()].view(g.shape))
                off += g.numel()
            flat, loss = out, buf[-1]
        grads = {}
        for path, g in zip(leaves, flat):
            *parents, key = path.split(".")
            node = grads
            for p in parents:
                node = node.setdefault(p, {})
            node[key] = g
        t = self.iteration + 1
        _adamw_apply(c, self.params, grads, self.opt_state, t, _lr_at(c, t))
        self.iteration = t
        self.score_ = loss
        return loss

    # ---- introspection -------------------------------------------------
    def shard_fraction(self):
        """This rank's share of the parameter elements: (replicated +
        sharded / N) over the whole, the TP memory claim."""
        total = mine = 0
        for path, a in _flatten(self.params).items():
            key = path.split(".")[-1]
            n = self.N if key in _COL or key in _ROW else 1
            mine += a.numel()
            total += a.numel() * n
        return mine / total

    def gathered_logits(self, tokens):
        """The whole model's logits on ``tokens`` (no update; a collective
        over the grid's row)."""
        with torch.no_grad():
            return self._forward_local(self.params,
                                       self._tokens(tokens)).cpu().numpy()

    def gathered_params(self):
        """The whole parameters in the ``TransformerLM`` layout (``qkv``
        concatenated), as numpy arrays (a collective over the row)."""
        mesh = self.mesh
        out = {k: self.params[k].detach().cpu().numpy()
               for k in ("wte", "wpe", "lnf_g", "lnf_b")}
        for i in range(self.conf.n_layers):
            bp = {k: v.detach() for k, v in self.params[f"b{i}"].items()}
            whole = {}
            for k, v in bp.items():
                if k in _COL:
                    v = mesh.gather_model(v, v.ndim - 1)
                elif k in _ROW:
                    v = mesh.gather_model(v, 0)
                whole[k] = v.cpu().numpy()
            out[f"b{i}"] = {
                "ln1_g": whole["ln1_g"], "ln1_b": whole["ln1_b"],
                "qkv": np.concatenate([whole["wq"], whole["wk"],
                                       whole["wv"]], axis=1),
                "qkv_b": np.concatenate([whole["bq"], whole["bk"],
                                         whole["bv"]]),
                "proj": whole["proj"], "proj_b": whole["proj_b"],
                "ln2_g": whole["ln2_g"], "ln2_b": whole["ln2_b"],
                "fc": whole["fc"], "fc_b": whole["fc_b"],
                "out": whole["out"], "out_b": whole["out_b"]}
        return out

    def param_bytes(self):
        """(bytes of this rank's parameters, bytes of the whole model's)."""
        mine = sum(a.numel() * a.element_size()
                   for a in _flatten(self.params).values())
        return mine, int(round(mine / self.shard_fraction()))
