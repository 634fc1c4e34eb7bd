"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
tiny size in a temporary root, run on the CPU through the harness (the
look for a card is the CLI's, which these tests skip)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the published widths cut to what a test can hold: depth, widths,
# vocabulary, batches and the serving load
TINY_CONFIGS = {
    "gpt2-medium": dict(n_embd=64, n_head=4, n_layer=2, n_inner=256,
                        vocab_size=256, n_positions=64, n_ctx=64,
                        block_size=16),
    "vit-b16": dict(hidden_size=64, num_attention_heads=4,
                    num_hidden_layers=2, intermediate_size=128,
                    image_size=32, patch_size=8, num_labels=10),
}
TINY_TRAIN = dict(batch=4, pool=6, reference_rows=2, trace_steps=2)
TINY_SERVE = dict(slots=4, chunk=4, warm_requests=2, rate=4.0, clients=6,
                  pool=256, check_tokens=64, check_sampled_tokens=64, trace_seconds=0.5,
                  prompt=dict(median=16, sigma=0.5, min=4, max=40),
                  output=dict(median=8, sigma=0.5, min=4, max=20))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself where "
        "torch.cuda.is_available() is False")


def make_tiny_root(dst, compute_dtype="bfloat16"):
    """A root holding BENCHMARK.json and a copy of perfbench/ whose
    configurations and cells are cut to a tiny size."""
    dst = Path(dst)
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        d = json.loads((REPO / c["file"]).read_text())
        d.update(TINY_CONFIGS[c["name"]], compute_dtype=compute_dtype)
        (dst / c["file"]).write_text(json.dumps(d))
    for w in bench["workloads"]:
        p = dst / "perfbench" / "workloads" / f"{w['name']}.json"
        d = json.loads(p.read_text())
        d.update(TINY_TRAIN if d["driver"] == "train" else TINY_SERVE)
        if "seq_len" in d:
            d["seq_len"] = 33
        p.write_text(json.dumps(d))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_root_f32(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny32"), None)
