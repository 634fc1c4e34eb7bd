"""Convolutional activation capture for the UI: the port of
``deeplearning4j_tpu/ui/conv_listener.py``
(``ui/weights/ConvolutionalIterationListener.java`` and the play server's
``ConvolutionalListenerModule.java``).

The listener owns a small probe batch and, every ``frequency``
iterations, runs the model's ``feed_forward`` on it and rasterises the
first convolutional activation's maps into a grayscale PNG (the port's
``utils/pngio.py``). ``feed_forward`` hands back host numpy in NHWC, the
input first for a MultiLayerNetwork and by vertex name for a
ComputationGraph, as the reference's does, so the selection below is the
reference's.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.ui.storage import Persistable
from deeplearning4j_tpu_torch.utils.pngio import encode_png_gray  # noqa: F401
# (re-exported: the UI server and tests import encode_png_gray from here)

TYPE_ID = "ConvolutionalListener"


def activations_to_grid(acts: np.ndarray, max_maps: int = 16,
                        pad: int = 1) -> np.ndarray:
    """(H, W, C) or (C, H, W)-agnostic NHWC activation tensor for ONE example
    → tiled uint8 grid, one tile per channel (reference renders each
    feature-map side by side)."""
    a = np.asarray(acts, np.float32)
    if a.ndim != 3:
        raise ValueError(f"expected one example's (H, W, C) maps, got {a.shape}")
    h, w, c = a.shape
    c = min(c, max_maps)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad),
                    np.float32)
    for i in range(c):
        m = a[..., i]
        lo, hi = float(m.min()), float(m.max())
        norm = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
        r, col = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = norm
    return (grid * 255.0).astype(np.uint8)


class ConvolutionalIterationListener:
    """Stores a PNG of the first conv layer's activation maps on the probe
    batch every ``frequency`` iterations (served at /train/activations)."""

    def __init__(self, router, probe_input, frequency: int = 10,
                 session_id: Optional[str] = None, worker_id: str = "worker_0",
                 max_maps: int = 16):
        self.router = router
        self.probe = np.asarray(probe_input)
        if self.probe.ndim == 3:
            self.probe = self.probe[None]
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"conv_{int(time.time() * 1000)}"
        self.worker_id = worker_id
        self.max_maps = max_maps
        self._count = 0

    def _conv_activation(self, model) -> Optional[np.ndarray]:
        """First 4-D activation from the model's feed-forward on the probe."""
        if hasattr(model, "feed_forward"):
            try:
                acts = model.feed_forward(self.probe)
            except TypeError:
                acts = model.feed_forward(self.probe, train=False)
        else:
            return None
        if isinstance(acts, dict):
            # graph model: skip the network-input activations by name
            inputs = set(getattr(model.conf, "network_inputs", ()))
            values = [v for k, v in acts.items() if k not in inputs]
        else:
            values = acts[1:]   # sequential model: acts[0] IS the input
        for a in values:
            arr = np.asarray(a)
            if arr.ndim == 4 and arr.shape[1] > 1 and arr.shape[2] > 1:
                return arr[0]
        return None

    def iteration_done(self, model, iteration):
        self._count += 1
        if (self._count - 1) % self.frequency != 0:
            return
        maps = self._conv_activation(model)
        if maps is None:
            return
        png = encode_png_gray(activations_to_grid(maps, self.max_maps))
        self.router.put_update(Persistable(
            self.session_id, TYPE_ID, self.worker_id,
            int(time.time() * 1000),
            {"iteration": int(iteration), "png": png}))
