"""The port's knob registry (``deeplearning4j_tpu_torch/config.py``).

- ``docs/CONFIG_TORCH.md`` holds ``knob_table_md()``, and ``python -m
  deeplearning4j_tpu_torch.config`` prints the table;
- every ``DL4J_TORCH_*`` name the port or ``chip_smoke.py`` reads is
  declared, and every declared knob is read: the port's counterpart of
  ``tests/test_graftlint.py``'s undeclared-knob test (an AST scan: a
  read names its knob as a whole string constant, as ``env_flag(...)``
  and ``os.environ[...]`` do);
- the four watcher knobs are flags, off by default, and each watcher's
  ``enabled()`` reads its own;
- under the pytest plugin ``testing/pytest_watch.py`` the knobs install
  the watchers, and the plugin's gates fail a test that draws a state
  twice or leaves a thread alive, at the fixture's line.
"""

import ast
import os
import re
import runpy
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                              lockwatch, rngwatch)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deeplearning4j_tpu_torch"
KNOB = re.compile(r"^DL4J_(TORCH|TPU)_[A-Z0-9_]+$")


def _reads():
    """{knob name: files that name it as a whole string constant}, over
    the package (the registry itself aside) and ``chip_smoke.py``."""
    found = {}
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        if path == PKG / "config.py" or "_build" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and KNOB.match(node.value):
                found.setdefault(node.value, set()).add(
                    str(path.relative_to(REPO)))
    return found


def test_config_doc_holds_the_table():
    doc = (REPO / "docs" / "CONFIG_TORCH.md").read_text()
    assert config.knob_table_md() in doc
    for name in config.KNOBS:
        assert f"`{name}`" in doc


def test_module_main_prints_the_table(capsys):
    """What ``python -m deeplearning4j_tpu_torch.config`` prints (run
    in this process: runpy is what ``-m`` calls) is the committed file."""
    with warnings.catch_warnings():
        # the module is imported already; running it as __main__ is fine
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module("deeplearning4j_tpu_torch.config",
                         run_name="__main__")
    assert capsys.readouterr().out == \
        (REPO / "docs" / "CONFIG_TORCH.md").read_text()


def test_every_knob_read_is_declared_and_every_declared_knob_is_read():
    reads = _reads()
    undeclared = {k: sorted(v) for k, v in reads.items()
                  if k not in config.KNOBS}
    assert not undeclared, undeclared
    unused = sorted(set(config.KNOBS) - set(reads))
    assert not unused, unused


@pytest.mark.parametrize("watcher,name", [
    (lockwatch, "DL4J_TORCH_LOCKWATCH"),
    (leakwatch, "DL4J_TORCH_LEAKWATCH"),
    (compilewatch, "DL4J_TORCH_COMPILEWATCH"),
    (rngwatch, "DL4J_TORCH_RNGWATCH")])
def test_watcher_knobs_are_flags_off_by_default(monkeypatch, watcher, name):
    knob = config.KNOBS[name]
    assert knob.kind == "flag" and knob.default is False
    assert name.replace("TORCH", "TPU") in knob.doc
    monkeypatch.delenv(name, raising=False)
    assert watcher.enabled() is False
    monkeypatch.setenv(name, "1")
    assert watcher.enabled() is True
    monkeypatch.setenv(name.replace("TORCH", "TPU"), "1")
    monkeypatch.setenv(name, "0")
    assert watcher.enabled() is False     # the reference's knob: ignored


LANE_TESTS = """
import importlib.util
import threading
from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                              lockwatch, rngwatch)


def _load(path):
    spec = importlib.util.spec_from_file_location("lane_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_knobs_installed_the_watchers():
    assert [w.installed() for w in (lockwatch, leakwatch, compilewatch,
                                    rngwatch)] == [True] * 4


def test_a_state_drawn_twice():
    _load({rng!r}).draw_twice()


def test_a_thread_left_alive():
    _load({leak!r}).start_waiter(threading.Event())
"""


def test_watcher_knobs_install_the_watchers_under_the_plugin(tmp_path):
    """The knobs at work: ``pytest -p
    deeplearning4j_tpu_torch.testing.pytest_watch`` with the four knobs
    set installs the four watchers, and its per-test gates fail the test
    that draws one state twice (rngwatch) and the one that leaves a
    thread alive (leakwatch), each at the fixture's line."""
    rng = REPO / "tests" / "fixtures" / "torch_watch" / "rng_reuse.py"
    leak = REPO / "tests" / "fixtures" / "leakwatch" / "leaky.py"
    (tmp_path / "test_lane.py").write_text(
        LANE_TESTS.format(rng=str(rng), leak=str(leak)))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               **{name: "1" for name in config.KNOBS
                  if name.endswith("WATCH")})
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist",
         "-p", "deeplearning4j_tpu_torch.testing.pytest_watch",
         "test_lane.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    text = out.stdout + out.stderr
    assert out.returncode == 1, text
    # a gate fails in the teardown: the body passed, the test errs
    assert "3 passed, 2 errors" in text, text
    line = rng.read_text().splitlines().index(
        "    mask = torch.rand(8, generator=g, device=device) < 0.5"
        "   # the same state") + 1
    assert f"rng_reuse.py:{line}" in text, text
    line = leak.read_text().splitlines().index(
        "    t = threading.Thread(target=evt.wait, daemon=True)") + 1
    assert f"leaky.py:{line}" in text, text
