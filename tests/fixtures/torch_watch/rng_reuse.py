"""One generator state drawn twice, for the port's rngwatch.

``draw_twice`` puts a generator's state back after a draw and draws from
it again at another line (the defect: the mask is made of the noise's
numbers, and rngwatch reports the second draw below). ``draw_on`` keeps
drawing from the generator (the clean twin). ``two_models_one_seed``
seeds two generators alike and draws each at its own line: each seeding
is a fresh generation, so it is clean, as two models built from one seed
are. ``device`` places the generators and the draws (the card's
generators are Philox counters; the CPU's Mersenne Twisters).
"""
import torch


def draw_twice(seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    state = g.get_state()
    noise = torch.rand(8, generator=g, device=device)
    g.set_state(state)
    mask = torch.rand(8, generator=g, device=device) < 0.5   # the same state
    return noise, mask


def draw_on(seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    noise = torch.rand(8, generator=g, device=device)
    mask = torch.rand(8, generator=g, device=device) < 0.5
    return noise, mask


def two_models_one_seed(seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    first = torch.randn(8, generator=g, device=device)
    h = torch.Generator(device=device).manual_seed(seed)
    second = torch.rand(8, generator=h, device=device)
    return first, second
