"""A run with the timed path broken underneath comes out not correct,
under each cell's own limits, once for each fault the cell can have (one
card: no exchange between chips to leave out); the same run unbroken
comes out correct. The look for a card is skipped: the harness runs on
the CPU at a tiny size, in the configurations' bfloat16. The sampler's
faults are held to the serving cells' sampled limits at the cells' own
count of compared tokens."""

import time
from pathlib import Path

import pytest
import torch

from perfbench import check, faults, harness

REPO = Path(__file__).resolve().parents[2]

CASES = [("gpt2-medium.train-1k", "unchanged"),
         ("gpt2-medium.train-1k", "half_batch"),
         ("vit-b16.train-b256", "unchanged"),
         ("vit-b16.train-b256", "half_batch"),
         ("gpt2-medium.serve-chat", "altered_token"),
         ("gpt2-medium.serve-saturated", "altered_token")]


def _run(root, cell, fault=None):
    seconds = 2.0 if "serve" in cell else 0.3
    res, job = harness.run_cell(root, cell, 2 ** 32 + 9, seconds, False,
                                "cpu", time.monotonic(), fault=fault)
    return res, job


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_a_sound_run_is_correct(tiny_root, cell):
    res, _ = _run(tiny_root, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_run_is_not_correct(tiny_root, cell, fault):
    res, _ = _run(tiny_root, cell, faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


SAMPLER_CASES = [("sound", 0.8, 0.95, False),
                 ("top_p_ignored", 0.8, 1.0, True),
                 ("temperature_ignored", 1.0, 0.95, True)]


@pytest.mark.parametrize("cell", ["gpt2-medium.serve-chat",
                                  "gpt2-medium.serve-saturated"])
@pytest.mark.parametrize("name,temperature,top_p,fails", SAMPLER_CASES)
def test_a_broken_sampler_fails_the_sampled_limits(cell, name, temperature,
                                                   top_p, fails):
    """Tokens drawn in the program's place from logits spread as the
    cell's random weights spread them (a standard deviation of 0.64), as
    many as the cell compares: drawn as the sampler states they pass the
    cell's sampled limits; with top_p or the temperature left out they
    fail."""
    _, _, _, tr = harness.load_cell(REPO, cell)
    T, p = tr["sampled"]["temperature"], tr["sampled"]["top_p"]
    gen = torch.Generator().manual_seed(5)
    terms = []
    for _ in range(tr["check_sampled_tokens"] // 256):
        logits = 0.64 * torch.randn(256, 8192, generator=gen)
        drawn = check.draw(logits, temperature, top_p, gen)
        terms.append((p, check.sampled_terms(logits, drawn, T, p)))
    numbers = check.sampled_numbers(terms)
    limits = {k: tr["limits"][k] for k in numbers}
    ok, rows = check.verdict(numbers, limits)
    assert ok is not fails, (name, rows)
