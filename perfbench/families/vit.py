"""The ViT family: seeded weights, inputs, and how the program under test
(``deeplearning4j_tpu_torch``'s ``ViT``) takes them.

Weights are a flat dict of float32 tensors (matrices ``[in, out]``, q|k|v
fused, the patch embedding ``[P P C, d]`` over patches flattened in
(row, column, channel) order), made on the device from the run's seed
with the initialisation GPT-2 uses, as the port's own ``init`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import counts, seeds
from perfbench.families.tree import draw_weights, nested, parameter_tree
from perfbench.reference import vit as reference


def leaves(cfg):
    d, ff, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    P, C = cfg["patch_size"], cfg["num_channels"]
    T = (cfg["image_size"] // P) ** 2
    std, rs = 0.02, 0.02 / math.sqrt(2 * L)
    out = [("wpatch", (P * P * C, d), std), ("wpatch_b", (d,), "zeros"),
           ("wpe", (T, d), std)]
    for i in range(L):
        out += [(f"b{i}.{n}", s, init) for n, s, init in (
            ("ln1_g", (d,), "ones"), ("ln1_b", (d,), "zeros"),
            ("qkv", (d, 3 * d), std), ("qkv_b", (3 * d,), "zeros"),
            ("proj", (d, d), rs), ("proj_b", (d,), "zeros"),
            ("ln2_g", (d,), "ones"), ("ln2_b", (d,), "zeros"),
            ("fc", (d, ff), std), ("fc_b", (ff,), "zeros"),
            ("out", (ff, d), rs), ("out_b", (d,), "zeros"))]
    return out + [("lnf_g", (d,), "ones"), ("lnf_b", (d,), "zeros"),
                  ("head", (d, cfg["num_labels"]), std),
                  ("head_b", (cfg["num_labels"],), "zeros")]


def init_weights(cfg, seed, dev):
    return draw_weights(leaves(cfg), seed, "vit.weights", dev)


def port_model(cfg, w, dev):
    from deeplearning4j_tpu_torch.models.vit import ViT, ViTConfig
    o = cfg["optimizer"]
    conf = ViTConfig(
        image_size=cfg["image_size"], n_channels=cfg["num_channels"],
        patch_size=cfg["patch_size"], n_classes=cfg["num_labels"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        dropout=0.0, learning_rate=o["learning_rate"],
        weight_decay=o["weight_decay"], beta1=o["beta1"], beta2=o["beta2"],
        eps=o["eps"], compute_dtype=cfg["compute_dtype"])
    model = ViT(conf, device=dev)
    model.params = parameter_tree(nested(w))
    return model


def train_batches(cfg, traffic, seed, dev):
    """The pool of distinct batches a user's loop hands ``fit_batch``:
    (float32 NHWC images as numpy, int64 class ids as numpy). The pixels
    are standard normal (normalised images), drawn on the device a batch
    at a time and copied to the host."""
    g = seeds.device(seed, "vit.images", dev)
    rng = seeds.host(seed, "vit.labels")
    S, C, B = cfg["image_size"], cfg["num_channels"], traffic["batch"]
    out = []
    for _ in range(traffic["pool"]):
        x = torch.randn((B, S, S, C), generator=g, device=dev).cpu().numpy()
        out.append((x, rng.integers(0, cfg["num_labels"], B,
                                    dtype=np.int64)))
    return out


def fit(model, batch):
    return model.fit_batch(*batch)


def reference_batch(batch, dev):
    x, y = batch
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def reference_train(cfg, w, batches, rows, precision="f32"):
    return reference.train_steps(cfg, w, batches, rows, precision)


def train_flops(cfg, traffic):
    return counts.vit_train_flops(cfg, traffic["batch"])


def flash_calls(cfg, traffic):
    n = traffic["batch"] * cfg["num_attention_heads"]
    T = (cfg["image_size"] // cfg["patch_size"]) ** 2
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    return [(n, T, hd, False)] * cfg["num_hidden_layers"]

