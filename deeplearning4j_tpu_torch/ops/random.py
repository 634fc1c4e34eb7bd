"""Counter-based random draws: integer hash rounds over int64 tensors.

A draw is a pure function of its key and the element's index, so it
needs no generator state: it runs the same eagerly and inside a captured
CUDA graph, a recomputation (remat) draws the same values again, and a
step that is reverted on the device draws the same values when it is
retried. Two users share the one hash: the sampler's Gumbel noise
(``models/transformer.py`` :func:`gumbel_noise`) and the layers' dropout
masks (:func:`dropout_keep`).

JAX's threefry draws cannot be reproduced in torch: the values differ
from the reference's; the distributions and the contracts are the same.
"""

from __future__ import annotations

import torch

__all__ = ["DropoutKey", "M32", "dropout_keep", "mix32", "mul32",
           "uniform_bits"]

M32 = 0xFFFFFFFF


def mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in two 16-bit halves so that no product overflows int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    """A 32-bit integer finaliser: xorshift-multiply rounds."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class DropoutKey:
    """What one layer's dropout mask in one update is a function of:
    the configuration's ``seed``, the model's draw ``counter`` (a 0-d
    int64 device tensor, read where the mask is made, so that a captured
    graph reads its current value) and the layer's index ``stream``."""

    __slots__ = ("seed", "counter", "stream")

    def __init__(self, seed, counter, stream):
        self.seed = int(seed)
        self.counter = counter
        self.stream = int(stream)


def uniform_bits(key, n, device):
    """[n] int64 values in [0, 2**23), uniform, element ``e`` a pure
    function of (``key.seed``, ``key.counter``, ``key.stream``, e)."""
    c = key.counter
    h = mix32(torch.full((), (key.seed & M32) ^ 0x3C6EF372,
                         dtype=torch.int64, device=device))
    h = mix32(h ^ (c & M32))
    h = mix32(h ^ ((c >> 32) & M32))
    h = mix32(h ^ ((key.stream * 0x61C88647) & M32))
    e = torch.arange(n, device=device, dtype=torch.int64)
    x = mix32(h ^ mul32(e, 0x9E3779B9))
    x = mix32(x ^ 0x85EBCA6B)
    return x >> 9


def dropout_keep(key, shape, p, device):
    """The keep-mask of inverted dropout with RETAIN probability ``p``:
    ``u < p`` for ``u = (k + 0.5) / 2**23``, ``k`` the element's
    :func:`uniform_bits` (exact in f32, in (0, 1))."""
    n = 1
    for s in shape:
        n *= int(s)
    u = (uniform_bits(key, n, device).to(torch.float32) + 0.5) \
        * (1.0 / 8388608.0)
    return (u < p).view(tuple(shape))
