"""The yardstick's arithmetic: model FLOPs of a step, the flash kernels'
operations and bytes, and the published peaks of the card.

These count the work a step needs, whatever implements it, so a later
change to a kernel or a fusion cannot change its own yardstick. FLOPs are
2 a multiply-add. Nothing recomputed is counted, and causal attention
counts the ``T(T+1)/2`` query-key pairs it needs.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "fp8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_pairs(T, causal):
    """Query-key pairs one head of one sequence needs."""
    return T * (T + 1) // 2 if causal else T * T


def gpt2_train_flops(cfg, batch, T):
    """Model FLOPs of one GPT-2 training step over ``batch`` rows of ``T``
    inputs: forward plus a backward of twice the forward. Per token and
    layer the qkv, output and MLP matmuls; per head pair QK^T and PV; the
    tied head; the embedding is a gather and counts nothing."""
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    ff = cfg["n_inner"]
    per_token = L * (2 * d * 3 * d + 2 * d * d + 2 * 2 * d * ff) + 2 * d * V
    attn = L * 4 * d * attention_pairs(T, causal=True)   # all heads
    return 3 * (batch * T * per_token + batch * attn)


def vit_train_flops(cfg, batch):
    """Model FLOPs of one ViT training step over ``batch`` images. The
    patch embedding's input needs no gradient, so it counts forward plus
    the weight gradient (2x); everything after it 3x."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    ff, C = cfg["intermediate_size"], cfg["num_labels"]
    P, S, ch = cfg["patch_size"], cfg["image_size"], cfg["num_channels"]
    T = (S // P) ** 2
    patch = 2 * (P * P * ch) * d
    per_token = L * (2 * d * 3 * d + 2 * d * d + 2 * 2 * d * ff)
    attn = L * 4 * d * attention_pairs(T, causal=False)
    head = 2 * d * C
    return (2 * batch * T * patch
            + 3 * (batch * T * per_token + batch * attn + batch * head))


def flash_fwd_work(n, T, hd, causal, dtype="bfloat16", with_lse=True):
    """(operations, bytes) of one flash forward call over ``n`` heads of
    length ``T`` and head dim ``hd``: QK^T and PV over the pairs needed;
    q, k, v read once, O written once, and the f32 logsumexp when a
    backward will need it."""
    e = DTYPE_BYTES[dtype]
    ops = n * attention_pairs(T, causal) * 4 * hd
    nbytes = n * T * (4 * hd * e + (4 if with_lse else 0))
    return ops, nbytes


def flash_bwd_work(n, T, hd, causal, dtype="bfloat16"):
    """(operations, bytes) of the flash backward (dQ and dK/dV together):
    the four products dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q
    over the pairs needed (S's recompute is not counted); q, k, v, dO,
    the f32 logsumexp and delta read once, dQ, dK, dV written once."""
    e = DTYPE_BYTES[dtype]
    ops = n * attention_pairs(T, causal) * 8 * hd
    nbytes = n * T * (7 * hd * e + 8)
    return ops, nbytes


def least_seconds(ops, nbytes, dtype="bfloat16"):
    """The roofline: the larger of operations over the peak rate and
    bytes over the peak bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)
