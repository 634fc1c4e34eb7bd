"""The GPT-2 family: seeded weights, inputs, and how the program under
test (``deeplearning4j_tpu_torch``'s ``TransformerLM``) takes them.

Weights are a flat dict of float32 tensors in the published layout
(matrices ``[in, out]``, q|k|v fused), made on the device from the run's
seed in a few large draws with GPT-2's initialisation. The program gets
them as its parameter tree; the reference makes them again from the seed
after the program's state is freed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import counts, seeds
from perfbench.families.tree import draw_weights, nested, parameter_tree
from perfbench.reference import gpt2 as reference


def leaves(cfg):
    """(name, shape, init) of every leaf; init is a std, "ones" or
    "zeros"."""
    d, ff, L = cfg["n_embd"], cfg["n_inner"], cfg["n_layer"]
    std, rs = 0.02, 0.02 / math.sqrt(2 * L)
    out = [("wte", (cfg["vocab_size"], d), std),
           ("wpe", (cfg["n_positions"], d), std)]
    for i in range(L):
        out += [(f"b{i}.{n}", s, init) for n, s, init in (
            ("ln1_g", (d,), "ones"), ("ln1_b", (d,), "zeros"),
            ("qkv", (d, 3 * d), std), ("qkv_b", (3 * d,), "zeros"),
            ("proj", (d, d), rs), ("proj_b", (d,), "zeros"),
            ("ln2_g", (d,), "ones"), ("ln2_b", (d,), "zeros"),
            ("fc", (d, ff), std), ("fc_b", (ff,), "zeros"),
            ("out", (ff, d), rs), ("out_b", (d,), "zeros"))]
    return out + [("lnf_g", (d,), "ones"), ("lnf_b", (d,), "zeros")]


def init_weights(cfg, seed, dev):
    return draw_weights(leaves(cfg), seed, "gpt2.weights", dev)


def port_config(cfg):
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
    o = cfg["optimizer"]
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], max_len=cfg["n_positions"],
        d_model=cfg["n_embd"], n_heads=cfg["n_head"],
        n_layers=cfg["n_layer"], d_ff=cfg["n_inner"], dropout=0.0,
        learning_rate=o["learning_rate"], lr_schedule=o["schedule"],
        weight_decay=o["weight_decay"], beta1=o["beta1"], beta2=o["beta2"],
        eps=o["eps"], compute_dtype=cfg["compute_dtype"],
        block_size=cfg["block_size"])


def port_model(cfg, w, dev):
    """The program's ``TransformerLM`` holding ``w`` (its tensors, not a
    copy) as its parameters."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    lm = TransformerLM(port_config(cfg), device=dev)
    lm.params = parameter_tree(nested(w))
    return lm


def train_batches(cfg, traffic, seed, dev):
    """The pool of distinct batches a user's loop hands ``fit_batch``:
    numpy int32 token rows [batch, seq_len], uniform over the vocabulary."""
    rng = seeds.host(seed, "gpt2.tokens")
    return [rng.integers(0, cfg["vocab_size"],
                         (traffic["batch"], traffic["seq_len"]),
                         dtype=np.int32) for _ in range(traffic["pool"])]


def fit(model, batch):
    return model.fit_batch(batch)


def reference_batch(batch, dev):
    return torch.from_numpy(batch.astype(np.int64)).to(dev)


def reference_train(cfg, w, batches, rows, precision="f32"):
    return reference.train_steps(cfg, w, batches, rows, precision)


def reference_served(cfg, w, prompt, served, dev, precision="f32"):
    """The reference's logits at the positions that produced the served
    tokens (its full forward over the prompt and the served tokens but
    the last), and those tokens: ([n, V] float32, [n])."""
    served = torch.as_tensor(np.asarray(served, np.int64), device=dev)
    seq = torch.cat([torch.as_tensor(np.asarray(prompt, np.int64),
                                     device=dev), served[:-1]])
    logits = reference.logits(cfg, w, seq[None], precision)[0]
    return logits[len(prompt) - 1:], served


def train_flops(cfg, traffic):
    return counts.gpt2_train_flops(cfg, traffic["batch"],
                                   traffic["seq_len"] - 1)


def flash_calls(cfg, traffic):
    """(heads, T, head dim, causal) of each flash call of one step."""
    n = traffic["batch"] * cfg["n_head"]
    T = traffic["seq_len"] - 1
    return [(n, T, cfg["n_embd"] // cfg["n_head"], True)] * cfg["n_layer"]
