"""Each plain reference against the program's CPU path at a tiny size in
float32: the forward, three training steps, and served greedy tokens."""

import json
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.families import gpt2, vit
from perfbench.reference import gpt2 as ref_gpt2
from perfbench.reference import vit as ref_vit


def _cfg(root, name):
    _, _, cfg, tr = harness.load_cell(root, name)
    return cfg, tr


def test_gpt2_forward_matches_the_port(tiny_root_f32):
    cfg, _ = _cfg(tiny_root_f32, "gpt2-medium.train-1k")
    dev = torch.device("cpu")
    w = gpt2.init_weights(cfg, 11, dev)
    tokens = np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 40))
    want = ref_gpt2.logits(cfg, w, torch.from_numpy(tokens))
    got = gpt2.port_model(cfg, {k: v.clone() for k, v in w.items()},
                          dev).output(tokens)
    assert np.abs(got - want.numpy()).max() <= 1e-5 * float(
        want.abs().max())


def test_vit_forward_matches_the_port(tiny_root_f32):
    cfg, _ = _cfg(tiny_root_f32, "vit-b16.train-b256")
    dev = torch.device("cpu")
    w = vit.init_weights(cfg, 12, dev)
    x = torch.randn(3, cfg["image_size"], cfg["image_size"],
                    cfg["num_channels"], generator=torch.Generator()
                    .manual_seed(1))
    want = torch.softmax(ref_vit.logits(cfg, w, x), -1).numpy()
    got = vit.port_model(cfg, {k: v.clone() for k, v in w.items()},
                         dev).output(x.numpy())
    assert np.abs(got - want).max() <= 1e-5


def _run(root, cell, seconds=0.5):
    res, job = harness.run_cell(root, cell, 2 ** 33 + 5, seconds, False,
                                "cpu", time.monotonic())
    return res, job


def test_training_steps_match_the_port(tiny_root_f32):
    for cell in ("gpt2-medium.train-1k", "vit-b16.train-b256"):
        res, job = _run(tiny_root_f32, cell)
        assert res["correct"], res
        # float32 on both sides: summation order only
        assert job.numbers["loss_gap"] <= 1e-5, (cell, job.numbers)
        assert job.numbers["grad_gap"] <= 1e-4, (cell, job.numbers)
        assert job.numbers["change_gap"] <= 1e-3, (cell, job.numbers)


def test_served_greedy_tokens_match_the_reference(tiny_root_f32):
    for cell in ("gpt2-medium.serve-chat", "gpt2-medium.serve-saturated"):
        res, job = _run(tiny_root_f32, cell, 2.0)
        assert res["correct"], res
        assert job.notes["compared_tokens"] >= 32
        assert job.numbers["greedy_gap"] <= 1e-4, job.numbers
        assert json.dumps(res)
