"""The harness finds configurations, cells and metric readers by name;
BENCHMARK.json keeps to its contract; a throwaway configuration, cell
and metric added as new files run with no existing file edited; a run
with no card, or with nothing but the benchmark's own files, fails; and
nothing the benchmark loads is JAX or the JAX package."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "deeplearning4j_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    bench, entry, cfg, tr = harness.load_cell(REPO, cell)
    assert (REPO / "perfbench" / "families" / f"{cfg['family']}.py").exists()
    assert (REPO / "perfbench" / "drivers" / f"{tr['driver']}.py").exists()
    assert tr["name"] == cell and set(tr["limits"])
    e2e = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                   "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(bench, cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(REPO, metric))


def test_benchmark_json_keeps_to_its_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["perfbench"]
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).exists() and c["file"] not in files
        files.add(c["file"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_throwaway_config_cell_and_metric_run_as_new_files(tmp_path,
                                                             tiny_root):
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "perfbench/configs/gpt2-medium.json")
                     .read_text())
    cfg.update(name="gpt2-throwaway", n_layer=1)
    (root / "perfbench/configs/gpt2-throwaway.json").write_text(
        json.dumps(cfg))
    cell = json.loads((root / "perfbench/workloads/gpt2-medium.train-1k"
                       ".json").read_text())
    cell.update(name="gpt2-throwaway.train-x", batch=2)
    (root / "perfbench/workloads/gpt2-throwaway.train-x.json").write_text(
        json.dumps(cell))
    (root / "perfbench/metrics/steps_seen.throwaway.py").write_text(
        "def read(m):\n    return m.steps\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="gpt2-throwaway",
                                 file="perfbench/configs/gpt2-throwaway.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="gpt2-throwaway.train-x",
                                   config="gpt2-throwaway", traffic="train-x"))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="steps_seen.throwaway", unit="steps",
                                   workloads=["gpt2-throwaway.train-x"]))
    for m in bench["end_to_end"] + bench["per_layer"][:-1]:
        if "workloads" in m and "gpt2-medium.train-1k" in m["workloads"]:
            m["workloads"].append("gpt2-throwaway.train-x")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, job = harness.run_cell(root, "gpt2-throwaway.train-x", 3, 0.3,
                                True, "cpu", time.monotonic())
    assert res["correct"], res
    assert res["metrics"]["steps_seen.throwaway"]["value"] == job.measure.steps
    assert all(p.read_bytes() == b for p, b in before.items())
    for p in ("configs/gpt2-throwaway.json",
              "workloads/gpt2-throwaway.train-x.json",
              "metrics/steps_seen.throwaway.py"):
        (root / "perfbench" / p).unlink()
    assert {p for p in (root / "perfbench").rglob("*") if p.is_file()} \
        == set(before)


def _python(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_a_run_without_a_card_fails():
    out = _python(["perfbench/run.py", "--workload", CELLS[0], "--seed",
                   "1", "--seconds", "1", "--trace", "0"], REPO,
                  {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[0] = '.'\n"
            "from perfbench import harness\n"
            f"harness.run_cell('.', {CELLS[0]!r}, 1, 1, False, 'cpu', "
            "time.monotonic())\n")
    out = _python(["-c", code], tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert "deeplearning4j_tpu_torch" in out.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in (REPO / "perfbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.parts:
            assert "deeplearning4j_tpu_torch" not in tops, path


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program(
        tiny_root):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import perfbench.reference.gpt2, perfbench.reference.vit\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] =="
        " 'deeplearning4j_tpu_torch'))\n"
        "from perfbench import harness\n"
        "import perfbench.calibrate, perfbench.sweep\n"
        f"for c in {CELLS!r}:\n"
        f"    harness.run_cell({str(tiny_root)!r}, c, 7, 0.3, False,"
        " 'cpu', time.monotonic())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        f" & {FORBIDDEN!r}))\n")
    out = _python(["-c", code], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "[]" and lines[-1] == "[]", out.stdout
