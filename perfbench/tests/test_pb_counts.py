"""The yardstick's counts against hand-worked ones at small shapes, and
the two published configurations' step FLOPs."""

import json
from pathlib import Path

import pytest

from perfbench import counts

REPO = Path(__file__).resolve().parents[2]


def test_attention_pairs():
    assert counts.attention_pairs(4, causal=True) == 10
    assert counts.attention_pairs(4, causal=False) == 16


def test_gpt2_train_flops_by_hand():
    cfg = dict(n_embd=4, n_inner=16, n_layer=1, vocab_size=10)
    # a token: qkv 2*4*12 + proj 2*4*4 + MLP 2*2*4*16 + head 2*4*10 = 464;
    # a sequence of 3: attention 4*d*pairs = 4*4*6 = 96; x3 for training
    assert counts.gpt2_train_flops(cfg, batch=2, T=3) \
        == 3 * (2 * 3 * 464 + 2 * 96)


def test_vit_train_flops_by_hand():
    cfg = dict(hidden_size=4, num_hidden_layers=1, intermediate_size=8,
               num_labels=5, patch_size=2, image_size=4, num_channels=1)
    # T 4 patches of 4 pixels; the patch embedding 2*4*4 a token, counted
    # forward and weight gradient (2x); a token's layer 96 + 32 + 128;
    # attention 4*4*16; the head 2*4*5 an image; batch 3
    assert counts.vit_train_flops(cfg, batch=3) \
        == 2 * 3 * 4 * 32 + 3 * (3 * 4 * 256 + 3 * 256 + 3 * 40)


def test_flash_work_by_hand():
    # n 2 heads, T 3, head dim 4: 6 causal pairs, 9 full
    assert counts.flash_fwd_work(2, 3, 4, True) == (2 * 6 * 4 * 4,
                                                    2 * 3 * (4 * 4 * 2 + 4))
    assert counts.flash_fwd_work(2, 3, 4, False, with_lse=False) \
        == (2 * 9 * 4 * 4, 2 * 3 * 4 * 4 * 2)
    assert counts.flash_bwd_work(2, 3, 4, True) == (2 * 6 * 8 * 4,
                                                    2 * 3 * (7 * 4 * 2 + 8))


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def _cfg(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def test_published_step_flops():
    assert counts.gpt2_train_flops(_cfg("gpt2-medium"), 16, 1024) \
        == pytest.approx(3.72e13, rel=5e-3)
    assert counts.vit_train_flops(_cfg("vit-b16"), 256) \
        == pytest.approx(2.68e13, rel=5e-3)


def test_gpt2_t1024_flash_forward_is_bytes_bound():
    ops, nbytes = counts.flash_fwd_work(16 * 16, 1024, 64, True)
    assert nbytes / counts.PEAK_BYTES_PER_S > ops / counts.PEAK_FLOPS[
        "bfloat16"]
    assert counts.least_seconds(ops, nbytes) == pytest.approx(40.4e-6,
                                                              rel=1e-2)
