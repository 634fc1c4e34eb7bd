"""Expert parallelism: a mixture-of-experts layer sharded over the
``expert`` axis of a grid of ranks. The port of
``deeplearning4j_tpu/parallel/expert_parallel.py``.

E expert MLPs live one a rank along ``expert`` (``ep_mesh``: a grid row
of E ranks). Each rank routes its local tokens (softmax gate, capacity
bounded), exchanges them with one ``all_to_all`` so every expert gets
the tokens routed to it from every peer, applies its expert, and
returns the outputs with the inverse ``all_to_all``
(``tensor_parallel.all_to_all``, differentiable: its backward is the
inverse exchange) — the Switch-Transformer dispatch.

Capacity (static buffers, as the reference's shapes): each rank sends at
most ``capacity`` tokens to each expert; a token past it is dropped (it
sits in slot 0 with a zero row both ways and its combine weight is zero,
so it rides the caller's residual), the Switch/GShard behaviour.

The dispatch functions name their axis as ``ring_attention`` does: the
grid is the innermost one entered with ``with mesh:`` that has it.
``ExpertParallelMoE`` is the reference's trainable residual MoE block
with a shared softmax head; ``reference_forward`` is its dense oracle.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    active_axis, all_to_all, host_f32, tp_mesh)

__all__ = ["ExpertParallelMoE", "ep_mesh", "switch_dispatch_apply",
           "topk_dispatch_apply"]


def ep_mesh(n_experts):
    """The ``(expert,)`` grid: the first ``n_experts`` ranks, one expert
    shard a rank (its data axis is 1). Every rank of the process group
    calls it; a rank outside gets None."""
    return tp_mesh(1, n_experts, axis_names=("data", "expert"))


def _slots_for(expert_id, E, capacity):
    """Send-buffer slot per token for a routing: how many earlier local
    tokens picked the same expert; keep = it fits under capacity."""
    onehot = F.one_hot(expert_id, E)
    slot = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                        expert_id[:, None])[:, 0]
    return slot, slot < capacity


def _exchange_apply(x, expert_id, expert_fn, E, capacity, axis):
    """One dispatch round for a given routing (T,) of ids: scatter into
    the (E, capacity, d) send buffer, ``all_to_all`` out, this rank's
    ``expert_fn`` on the (E * capacity, d) received slots, the inverse
    exchange, and a gather back per token. Unweighted; dropped tokens
    are clipped to slot 0 and zeroed both ways."""
    mesh = active_axis(axis)
    T, d = x.shape
    slot, keep = _slots_for(expert_id, E, capacity)
    slot = torch.where(keep, slot, torch.zeros_like(slot))
    kept = keep[:, None]
    send = torch.zeros(E, capacity, d, dtype=x.dtype, device=x.device)
    send = send.index_put((expert_id, slot),
                          torch.where(kept, x, torch.zeros_like(x)),
                          accumulate=True)
    # row p of what arrives: the tokens rank p sent to this rank's expert
    recv = all_to_all(send, mesh, axis, 0, 0)
    out = expert_fn(recv.reshape(E * capacity, d)).reshape(E, capacity, -1)
    back = all_to_all(out, mesh, axis, 0, 0)
    y = back[expert_id, slot]
    return torch.where(kept, y, torch.zeros_like(y))


def switch_dispatch_apply(x, gate_w, expert_fn, E, capacity, axis):
    """The Switch dispatch: top-1 route local tokens ``x`` (T, d) with
    the gate (d, E), exchange, this rank's expert, the inverse exchange,
    combined by the gate probability (dropped tokens contribute zero).
    Returns (output (T, d), gate probabilities (T, E))."""
    probs = torch.softmax((x @ gate_w).float(), dim=-1)
    prob, expert_id = probs.max(dim=-1)
    y = _exchange_apply(x, expert_id, expert_fn, E, capacity, axis)
    return prob[:, None].to(y.dtype) * y, probs


def topk_dispatch_apply(x, gate_w, expert_fn, E, capacity, axis, k):
    """GShard top-k: each token to its k most probable experts (k
    dispatch rounds, two exchanges each), combined by the top-k
    probabilities renormalised to sum 1. Returns (output, probs)."""
    probs = torch.softmax((x @ gate_w).float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    w = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    y = 0.0
    for r in range(k):
        yr = _exchange_apply(x, topi[:, r], expert_fn, E, capacity, axis)
        y = y + w[:, r:r + 1].to(yr.dtype) * yr
    return y, probs


class ExpertParallelMoE:
    """Residual MoE block ``y = x + combine(expert_route(x)(x))`` with a
    shared linear softmax head, trained by SGD over an ``(expert,)``
    grid: the gate (d, E) and head (d, n_out) replicated, the expert MLP
    (E, d, h), (E, h, d) one expert a rank. ``params`` (``gate``, ``W1``,
    ``W2``, ``head``: the reference's, carried across) sets the initial
    weights; without them they are drawn at the reference's scales from
    a ``torch.Generator`` seeded ``seed``. ``device`` is this rank's (the
    card unless ``"cpu"``)."""

    def __init__(self, mesh, d, hidden, n_out, capacity=0, lr=0.1, seed=0,
                 *, params=None, device=None):
        self.mesh = mesh
        self.E = E = mesh.axis_size("expert")
        self.d, self.hidden, self.n_out = d, hidden, n_out
        self.capacity = capacity            # 0 = derive from the batch
        self.lr = lr
        self.device = multihost.rank_device(device)
        if params is None:
            g = torch.Generator().manual_seed(int(seed))
            params = {
                "gate": 0.1 * torch.randn(d, E, generator=g),
                "W1": (2.0 / (d + hidden)) ** 0.5
                * torch.randn(E, d, hidden, generator=g),
                "W2": (2.0 / (hidden + d)) ** 0.5
                * torch.randn(E, hidden, d, generator=g),
                "head": (2.0 / (d + n_out)) ** 0.5
                * torch.randn(d, n_out, generator=g)}
        whole = {k: host_f32(v) for k, v in params.items()}
        e = mesh.axis_index("expert")
        local = dict(whole, W1=whole["W1"][e:e + 1], W2=whole["W2"][e:e + 1])
        self.params = {k: v.contiguous().to(self.device).requires_grad_(True)
                       for k, v in local.items()}

    def param_specs(self):
        return {"gate": (), "W1": ("expert", None, None),
                "W2": ("expert", None, None), "head": ()}

    def _moe_block(self, p, x, capacity):
        """x (T, d): this rank's tokens; the (T, d) MoE output (the
        caller adds the residual)."""
        def expert_fn(tokens):
            return torch.relu(tokens @ p["W1"][0]) @ p["W2"][0]
        with self.mesh:
            y, _ = switch_dispatch_apply(x, p["gate"], expert_fn, self.E,
                                         capacity, "expert")
        return y

    def _local(self, a):
        a = torch.as_tensor(np.asarray(a, np.float32)) \
            if not isinstance(a, torch.Tensor) else a.float()
        return multihost.take_rows(a, self.mesh.axis_index("expert"),
                                   self.E).to(self.device)

    def _capacity_for(self, tokens_per_rank):
        # default: every local token could pick the same expert: lossless
        return self.capacity or tokens_per_rank

    def fit_batch(self, x, y):
        """x: (N, d) tokens, y: (N, n_out) one-hot; N divisible by E.
        Returns the global mean loss (a device scalar)."""
        N = x.shape[0]
        if N % self.E != 0:
            raise ValueError(f"batch {N} must be a multiple of E={self.E}")
        cap = self._capacity_for(N // self.E)
        xl, yl = self._local(x), self._local(y)
        p = self.params
        names = list(p)
        with torch.enable_grad():
            out = xl + self._moe_block(p, xl, cap)
            local_sum = -(yl * torch.log_softmax(out @ p["head"], -1)).sum()
            grads = list(torch.autograd.grad(local_sum,
                                             [p[k] for k in names]))
        with torch.no_grad():
            # replicated leaves: each rank saw other tokens; the expert
            # shards' gradients are already this rank's alone
            rep = [names.index("gate"), names.index("head")]
            flat = torch.cat([grads[i].reshape(-1) for i in rep]
                             + [local_sum.detach().reshape(1)])
            self.mesh.all_reduce(flat, "expert")
            off = 0
            for i in rep:
                grads[i] = flat[off:off + grads[i].numel()].view_as(grads[i])
                off += grads[i].numel()
            for k, g in zip(names, grads):
                p[k].sub_(self.lr * g / N)
        return flat[-1] / N

    def gathered_params(self):
        """The whole parameters as numpy arrays (a collective over the
        expert axis)."""
        p = {k: v.detach() for k, v in self.params.items()}
        return {"gate": p["gate"].cpu().numpy(),
                "W1": self.mesh.all_gather(p["W1"], "expert").cpu().numpy(),
                "W2": self.mesh.all_gather(p["W2"], "expert").cpu().numpy(),
                "head": p["head"].cpu().numpy()}

    def predict(self, x, capacity=0):
        """Softmax probabilities through the sharded block: each rank its
        rows of ``x``, the whole result on every rank (a collective)."""
        xl = self._local(x)
        with torch.no_grad():
            out = xl + self._moe_block(self.params, xl,
                                       capacity or xl.shape[0])
            probs = torch.softmax(out @ self.params["head"], -1)
            return self.mesh.all_gather(probs, "expert").cpu().numpy()

    def reference_forward(self, x):
        """The dense single-device routing oracle: with capacity at least
        the local tokens nothing drops, so the sharded block matches it."""
        p = self.gathered_params()
        x = np.asarray(x, np.float32)
        logits = x @ p["gate"]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        eid = probs.argmax(-1)
        out = np.zeros_like(x)
        for i in range(x.shape[0]):
            h = np.maximum(x[i] @ p["W1"][eid[i]], 0.0)
            out[i] = probs[i, eid[i]] * (h @ p["W2"][eid[i]])
        logits = (x + out) @ p["head"]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
