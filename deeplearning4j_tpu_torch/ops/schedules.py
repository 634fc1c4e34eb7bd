"""Learning-rate decay policies: the port of
``deeplearning4j_tpu/ops/schedules.py`` (LayerUpdater.java:137-157).

``iteration`` may be a Python int or a 0-dim tensor (the train step keeps
it on the device, so a skipped step can revert it without a host read).
Policy ``none`` returns the base rate as a Python float; every other
policy returns an f32 tensor on the iteration's device.
"""

from __future__ import annotations

import torch

__all__ = ["learning_rate"]


def learning_rate(policy, base_lr, iteration, *, decay_rate=0.0, steps=1.0,
                  power=1.0, schedule=None, max_iterations=10000):
    """The effective lr at ``iteration`` (0-based), as LayerUpdater
    computes it."""
    policy = str(policy or "none").lower()
    if policy == "none":
        return float(base_lr)
    it = torch.as_tensor(iteration).to(torch.float32)
    # a fill, not a copy from the host: a CUDA graph can hold it
    lr = torch.full((), float(base_lr), dtype=torch.float32, device=it.device)
    if policy == "exponential":
        return lr * torch.pow(torch.tensor(decay_rate, dtype=torch.float32),
                              it)
    if policy == "inverse":
        return lr / torch.pow(1.0 + decay_rate * it, power)
    if policy == "step":
        return lr * torch.pow(torch.tensor(decay_rate, dtype=torch.float32),
                              torch.floor(it / steps))
    if policy == "torch_step":
        # reference TorchStep decays once per divisor d >= 2 of `steps`
        # that the iteration has reached
        s = int(steps)
        divisors = [d for d in range(2, s + 1) if s % d == 0] if s >= 2 \
            else []
        count = sum(((it >= d).to(torch.float32) for d in divisors),
                    torch.zeros((), device=it.device))
        return lr * torch.pow(torch.tensor(decay_rate, dtype=torch.float32),
                              count)
    if policy == "poly":
        return lr * torch.pow(torch.clamp(1.0 - it / float(max_iterations),
                                          min=0.0), power)
    if policy == "sigmoid":
        return lr / (1.0 + torch.exp(-decay_rate * (it - steps)))
    if policy == "schedule":
        # {iteration: lr}; lr takes the value of the largest key <= it
        if not schedule:
            return lr
        out = lr
        for k in sorted(int(k) for k in schedule):
            v = schedule[k] if k in schedule else schedule[str(k)]
            out = torch.where(it >= k, torch.full(
                (), float(v), dtype=torch.float32, device=it.device), out)
        return out
    raise ValueError(f"Unknown lr policy: {policy!r}")
