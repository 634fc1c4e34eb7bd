"""Test support: deterministic fault injection (``faults``) and the
runtime watchers (``lockwatch``, ``leakwatch``, ``compilewatch``,
``rngwatch``), each imported by name where it is used
(``from deeplearning4j_tpu_torch.testing import lockwatch``), so that
importing ``faults`` loads no watcher. ``pytest_watch`` is the pytest
plugin that installs the watchers whose knobs are set. Nothing here runs
unless explicitly armed or installed."""

__all__ = ["compilewatch", "faults", "leakwatch", "lockwatch", "rngwatch"]
