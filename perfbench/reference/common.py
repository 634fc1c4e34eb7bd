"""Plain PyTorch pieces both references share: the matmul in the
precision asked for, softmax attention, AdamW, and a training step taken
in blocks of rows.

Nothing here imports the program under test. ``"f32"`` is float32 with
TF32 off; ``"fp8"`` is the control: every matmul's operands rounded to
float8 (e4m3 forward, e5m2 for gradients, one scale a tensor) and
multiplied in float32, the step a later change would be tempted to take
below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _fp8(x, dtype):
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to the format's largest, returned in x's dtype."""
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / torch.finfo(dtype).max
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, E4M3), _fp8(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, E5M2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.ndim == 2:   # a weight shared by every row
            gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1,
                                                             qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def matmul(kind):
    """``a @ b`` in precision ``kind``: ``"f32"`` or ``"fp8"``."""
    if kind == "f32":
        return torch.matmul
    if kind == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {kind!r}")


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls and convolutions with TF32 off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def attention(q, k, v, causal, mm):
    """Softmax attention over [B, H, T, hd], scores scaled by 1/sqrt(hd);
    a causal query sees the keys at or before its position."""
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        T = q.shape[-2]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def decayed(name, w):
    """The GPT-2 decay discipline: matrices decay; biases, LayerNorm
    gains and biases and the position embedding do not."""
    return w.ndim >= 2 and name.split(".")[-1] != "wpe"


def adamw(w, g, state, t, opt):
    """One bias-corrected AdamW step in place, leaf by leaf:
    ``p -= lr (m_hat / (sqrt(v_hat) + eps) + wd [decayed] p)``."""
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    with torch.no_grad():
        for n, p in w.items():
            m, v = state.setdefault(n, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g[n], alpha=1 - b1)
            v.mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
            upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
            if wd and decayed(n, p):
                upd = upd + wd * p
            p.sub_(lr * upd)


def train(w, batches, loss_sum, opt, rows):
    """Train the flat weight dict ``w`` (float32 leaves, changed in place)
    one AdamW step a batch. ``loss_sum(w, batch, lo, hi)`` returns the
    summed loss of rows ``lo:hi`` and how many terms the batch's mean
    divides by; each step runs the batch ``rows`` rows at a time and adds
    their gradients. Returns the losses and the first step's gradient."""
    for p in w.values():
        p.requires_grad_(True)
    state, losses, first = {}, [], None
    for t, batch in enumerate(batches, start=1):
        grads = {n: torch.zeros_like(p) for n, p in w.items()}
        n_rows = len(batch[0]) if isinstance(batch, tuple) else len(batch)
        total = 0.0
        for lo in range(0, n_rows, rows):
            s, count = loss_sum(w, batch, lo, min(lo + rows, n_rows))
            part = torch.autograd.grad(s / count, list(w.values()))
            for n, gp in zip(w, part):
                grads[n].add_(gp)
            total += float(s.detach()) / count
        losses.append(total)
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        adamw(w, grads, state, t, opt)
        del grads
    for p in w.values():
        p.requires_grad_(False)
    return losses, first
