"""GPT-2, written plainly from its published description (Radford et al.
2019; the layout of ``openai-community/gpt2-medium``): learned position
embeddings, pre-LN blocks of fused q|k|v, causal softmax attention and a
tanh-GELU MLP, a final LayerNorm and the head tied to the token
embedding. Weights are a flat dict of float32 tensors named as
``perfbench/families/gpt2.py`` makes them; matrices are ``[in, out]``
(the published ``Conv1D`` layout). Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import attention, matmul, train


def logits(cfg, w, tokens, precision="f32"):
    """Logits [B, T, V] in float32 of token ids [B, T]."""
    mm = matmul(precision)
    d, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    B, T = tokens.shape
    x = w["wte"][tokens] + w["wpe"][:T]
    for i in range(cfg["n_layer"]):
        p = {k.split(".", 1)[1]: v for k, v in w.items()
             if k.startswith(f"b{i}.")}
        h = F.layer_norm(x, (d,), p["ln1_g"], p["ln1_b"], eps)
        q, k, v = (a.reshape(B, T, H, d // H).transpose(1, 2)
                   for a in (mm(h, p["qkv"]) + p["qkv_b"]).split(d, dim=-1))
        o = attention(q, k, v, True, mm).transpose(1, 2).reshape(B, T, d)
        x = x + mm(o, p["proj"]) + p["proj_b"]
        h = F.layer_norm(x, (d,), p["ln2_g"], p["ln2_b"], eps)
        x = x + mm(F.gelu(mm(h, p["fc"]) + p["fc_b"], approximate="tanh"),
                   p["out"]) + p["out_b"]
    x = F.layer_norm(x, (d,), w["lnf_g"], w["lnf_b"], eps)
    return mm(x, w["wte"].t())


def train_steps(cfg, w, batches, rows, precision="f32"):
    """Next-token training of ``w`` in place, one AdamW step a batch of
    token rows [B, T + 1] (inputs ``[:, :-1]``, targets ``[:, 1:]``, the
    mean NLL over every target). Returns (losses, first gradient)."""

    def loss_sum(w, batch, lo, hi):
        rows_ = batch[lo:hi]
        lp = torch.log_softmax(logits(cfg, w, rows_[:, :-1], precision), -1)
        nll = -lp.gather(-1, rows_[:, 1:, None]).sum()
        return nll, batch.shape[0] * (batch.shape[1] - 1)

    return train(w, batches, loss_sum, cfg["optimizer"], rows)
