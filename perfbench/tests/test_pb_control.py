"""The control (the reference computed in float8 in the program's place)
fails a cell's limits. The training cells' control runs here at a tiny
size on the CPU; the serving cells' needs the widths of the cell itself
(at a tiny size float8 and float32 pick the same greedy tokens), so it
runs on the card, at the cell's size, on three seeds."""

import time
from pathlib import Path

import pytest
import torch

from perfbench import calibrate, check, harness

REPO = Path(__file__).resolve().parents[2]


def _control(root, cell, seed, device, seconds):
    _, job = harness.run_cell(root, cell, seed, seconds, False, device,
                              time.monotonic())
    control = calibrate._control_serving if job.traffic["driver"] == "serve" \
        else calibrate._control_training
    with calibrate.strict_f32():
        numbers, _ = control(job)
    return check.verdict(numbers, job.traffic["limits"])


@pytest.mark.parametrize("cell", ["gpt2-medium.train-1k",
                                  "vit-b16.train-b256"])
def test_the_training_control_fails_at_a_tiny_size(tiny_root, cell):
    ok, rows = _control(tiny_root, cell, 2 ** 31 + 3, "cpu", 0.3)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2-medium.train-1k",
                                  "vit-b16.train-b256",
                                  "gpt2-medium.serve-chat",
                                  "gpt2-medium.serve-saturated"])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        ok, rows = _control(REPO, cell, seed, "cuda:0", 8.0)
        assert not ok, (seed, rows)
