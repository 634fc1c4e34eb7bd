"""Streams of random numbers derived from a run's ``--seed``.

Every input and weight of a run comes from one of these, named by what
it makes, so the same seed gives the same inputs and two streams never
share draws. Seeds are any whole number, negative or past 64 bits.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _entropy(seed, stream):
    s = int(seed)
    words = [abs(s) >> (32 * i) & 0xFFFFFFFF
             for i in range(max(1, (abs(s).bit_length() + 31) // 32))]
    return words + [int(s < 0), zlib.crc32(stream.encode())]


def host(seed, stream):
    """A numpy generator for ``stream`` of run ``seed``."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed,
                                                                 stream)))


def device(seed, stream, dev):
    """A ``torch.Generator`` on ``dev`` for ``stream`` of run ``seed``."""
    state = np.random.SeedSequence(_entropy(seed, stream)).generate_state(
        2, np.uint32)
    g = torch.Generator(device=dev)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g
