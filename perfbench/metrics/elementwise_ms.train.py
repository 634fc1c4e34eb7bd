"""Device ms a step of every kernel that is neither a GEMM nor a flash
kernel: LayerNorm, GELU, casts, the loss, AdamW."""

from perfbench.readers import is_elementwise, per_step_ms


def read(m):
    return per_step_ms(m, is_elementwise)
