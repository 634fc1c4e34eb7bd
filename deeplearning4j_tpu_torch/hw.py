"""FLOP accounting of a training step: the port's own copy of the
reference's convention (``deeplearning4j_tpu/hw.py``), so MFU on the card
counts the same work the reference counts."""

# train step FLOPs = 3x forward (forward + ~2x backward)
TRAIN_FLOPS_MULTIPLIER = 3


def transformer_fwd_flops_per_token(T, d_model, n_layers, d_ff, vocab):
    """Matmul FLOPs per token, forward pass, decoder block stack with tied
    logits (2 flop per MAC): qkv + output projections, QK^T/AV against T
    keys/values, MLP up+down, final logits."""
    per_layer = (2 * d_model * 3 * d_model     # qkv projection
                 + 2 * d_model * d_model       # attention output projection
                 + 4 * T * d_model             # QK^T + AV
                 + 2 * d_model * d_ff * 2)     # MLP up + down
    return n_layers * per_layer + 2 * d_model * vocab
