"""ViT-B/16, written plainly from its published description (Dosovitskiy
et al. 2020, arXiv:2010.11929): non-overlapping patches flattened in
(row, column, channel) order and embedded by one matrix, learned position
embeddings, pre-LN blocks of fused q|k|v, non-causal softmax attention
and a tanh-GELU MLP, a final LayerNorm, global mean pooling over the
patches (Beyer et al. 2022, arXiv:2205.01580, in place of the class
token) and a linear head. Images are NHWC. Imports nothing of the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import attention, matmul, train


def logits(cfg, w, images, precision="f32"):
    """Class logits [B, num_labels] in float32 of images [B, S, S, C]."""
    mm = matmul(precision)
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    eps, P, C = cfg["layer_norm_eps"], cfg["patch_size"], cfg["num_channels"]
    B, S = images.shape[0], cfg["image_size"]
    n = S // P
    x = images.reshape(B, n, P, n, P, C).permute(0, 1, 3, 2, 4, 5)
    x = mm(x.reshape(B, n * n, P * P * C), w["wpatch"]) + w["wpatch_b"] \
        + w["wpe"]
    T = n * n
    for i in range(cfg["num_hidden_layers"]):
        p = {k.split(".", 1)[1]: v for k, v in w.items()
             if k.startswith(f"b{i}.")}
        h = F.layer_norm(x, (d,), p["ln1_g"], p["ln1_b"], eps)
        q, k, v = (a.reshape(B, T, H, d // H).transpose(1, 2)
                   for a in (mm(h, p["qkv"]) + p["qkv_b"]).split(d, dim=-1))
        o = attention(q, k, v, False, mm).transpose(1, 2).reshape(B, T, d)
        x = x + mm(o, p["proj"]) + p["proj_b"]
        h = F.layer_norm(x, (d,), p["ln2_g"], p["ln2_b"], eps)
        x = x + mm(F.gelu(mm(h, p["fc"]) + p["fc_b"], approximate="tanh"),
                   p["out"]) + p["out_b"]
    x = F.layer_norm(x, (d,), w["lnf_g"], w["lnf_b"], eps)
    return mm(x.mean(dim=1), w["head"]) + w["head_b"]


def train_steps(cfg, w, batches, rows, precision="f32"):
    """Classification training of ``w`` in place, one AdamW step a batch
    ``(images, labels)`` (the mean cross-entropy over the batch). Returns
    (losses, first gradient)."""

    def loss_sum(w, batch, lo, hi):
        x, y = batch
        lp = torch.log_softmax(logits(cfg, w, x[lo:hi], precision), -1)
        return -lp.gather(-1, y[lo:hi, None]).sum(), x.shape[0]

    return train(w, batches, loss_sum, cfg["optimizer"], rows)
