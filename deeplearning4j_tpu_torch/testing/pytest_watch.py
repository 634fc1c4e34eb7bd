"""pytest plugin: the port's runtime watchers, switched on by their knobs.

``tests/conftest.py`` installs the JAX package's watchers under its
``DL4J_TPU_*WATCH`` knobs. This plugin is the port's counterpart: loaded
with ``-p``, it installs each of the port's watchers whose knob is set
and gates the run as that conftest does::

    DL4J_TORCH_LOCKWATCH=1 DL4J_TORCH_LEAKWATCH=1 \\
    DL4J_TORCH_COMPILEWATCH=1 DL4J_TORCH_RNGWATCH=1 \\
    JAX_PLATFORMS=cpu python -m pytest \\
        -p deeplearning4j_tpu_torch.testing.pytest_watch \\
        tests/test_torch_router.py

- ``DL4J_TORCH_LOCKWATCH``: the whole session runs watched (installed
  when the plugin is imported, before the test modules, so that the
  locks they and the port make are watched); any inversion fails the run;
- ``DL4J_TORCH_LEAKWATCH``: a test that leaves a watched thread, socket,
  file or temp dir live fails;
- ``DL4J_TORCH_COMPILEWATCH``: a test that captures or builds inside a
  ``compilewatch.steady()`` region fails;
- ``DL4J_TORCH_RNGWATCH``: a test that draws one generator state or
  counter key at two sites fails.

Each per-test gate has a session twin, so a violation that a test
swallowed still fails the run. Test files that install and uninstall
the watchers themselves (``tests/test_torch_watch.py``,
``tests/test_torch_config.py``) take the session's watchers away and
are not run under the plugin.
"""

import pytest

from deeplearning4j_tpu_torch.testing import (compilewatch, leakwatch,
                                              lockwatch, rngwatch)

for _watcher in (lockwatch, leakwatch, compilewatch, rngwatch):
    if _watcher.enabled():
        _watcher.install()


@pytest.fixture(scope="session", autouse=True)
def _torch_lockwatch_gate():
    yield
    if lockwatch.installed():
        lockwatch.assert_clean()


@pytest.fixture(autouse=True)
def _torch_per_test_gates():
    """Leaks, steady-state captures and reused draws of this test."""
    snaps = {w: w.snapshot() for w in (leakwatch, compilewatch, rngwatch)
             if w.installed()}
    yield
    for w, snap in snaps.items():
        w.assert_clean(since=snap)


@pytest.fixture(scope="session", autouse=True)
def _torch_session_gates():
    yield
    for w in (leakwatch, compilewatch, rngwatch):
        if w.installed() and w.violations():
            raise AssertionError(
                f"{w.__name__}: violations were recorded during this "
                f"session:\n{w.report()}")
