"""How ``fit()`` wraps its iterator for the fused loop: the port of
``fuse_wrap_config`` in ``deeplearning4j_tpu/tuning/autotuner.py``.

The reference's first-compile autotuner (probe each K of a ladder with
zero-weight timed dispatches, keep the winner per bucket shape, re-chunk
in-flight groups) is not ported yet (ROADMAP.md, queue 1): asking for it
(``DL4J_TORCH_FUSE_AUTOTUNE=1`` with ``DL4J_TORCH_FUSE_STEPS`` unset)
raises ``NotImplementedError``.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.config import env_flag, env_is_set
from deeplearning4j_tpu_torch.datasets.async_iterator import default_fuse
from deeplearning4j_tpu_torch.models._device_state import fuse_allowed

__all__ = ["autotune_active", "fuse_wrap_config"]


def autotune_active():
    """The tuner engages only when asked AND no explicit K is set: an
    operator's ``DL4J_TORCH_FUSE_STEPS`` always wins."""
    return env_flag("DL4J_TORCH_FUSE_AUTOTUNE") and \
        not env_is_set("DL4J_TORCH_FUSE_STEPS")


def fuse_wrap_config(model):
    """``(fuse, k_resolver, bucket_pad, autotune_armed)`` for a model's
    ``fit()``: a model that may not fuse (``fuse_allowed``) gets the plain
    per-batch contract; otherwise groups of ``DL4J_TORCH_FUSE_STEPS`` and
    bucket padding, so that even a per-batch run (K 1) trains every
    maskless batch through the example-weight path."""
    if not fuse_allowed(model.conf, model.layers):
        return 1, None, False, False
    if autotune_active():
        raise NotImplementedError(
            "DL4J_TORCH_FUSE_AUTOTUNE: the fusion autotuner (probe and "
            "chunk planner) is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1); set DL4J_TORCH_FUSE_STEPS instead")
    return default_fuse(), None, True, False
