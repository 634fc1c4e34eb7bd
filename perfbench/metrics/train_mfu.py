"""Model FLOPs a step (perfbench/counts.py) over the window's time a
step, against the card's published bf16 dense peak, in %."""

from perfbench import counts


def read(m):
    if not getattr(m, "step_s", None):
        return None
    return m.flops_per_step / m.step_s / counts.PEAK_FLOPS["bfloat16"] * 100
