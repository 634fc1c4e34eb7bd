"""The one generator of serving traffic: request shapes, samplers, tokens
and arrival times from a cell's parameters and the run's seed.

The shapes (prompt and output lengths, sampler) and the arrival gaps are
fixed by the cell's ``shape_seed``, order included: lengths are the
quantiles of their lognormal at evenly spaced points, clipped, and gaps
the quantiles of the exponential, each shuffled by ``shape_seed``. The
run's seed draws the token ids and the samplers' seeds (and the
weights), so every seed serves the same work on the same schedule: where
the seed ordered the arrivals too, the p95 of time to first token moved
three times as much between seeds as between two runs of one seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

from perfbench import seeds


@dataclass(eq=False)
class Request:
    prompt: np.ndarray
    n_new: int
    temperature: float
    top_p: float | None
    seed: int
    due: float = 0.0            # seconds after the window opens
    submitted: float | None = None
    arrivals: list = field(default_factory=list)   # (time, n tokens)
    tokens: list = field(default_factory=list)
    error: str | None = None
    future: object = None

    @property
    def greedy(self):
        return self.temperature <= 0.0

    @property
    def received(self):
        return sum(n for _, n in self.arrivals)


def _quantiles(spec, n):
    """n lengths: the lognormal (median, sigma) at the points (i + 0.5)/n,
    rounded and clipped to [min, max]."""
    nd = NormalDist()
    mu, s = math.log(spec["median"]), spec["sigma"]
    return [int(min(max(round(math.exp(mu + s * nd.inv_cdf((i + 0.5) / n))),
                        spec["min"]), spec["max"])) for i in range(n)]


def shapes(tr, n):
    """The cell's n (prompt length, output length, greedy), in its order."""
    rng = np.random.default_rng(tr["shape_seed"])
    prompts = _quantiles(tr["prompt"], n)
    outputs = _quantiles(tr["output"], n)
    rng.shuffle(outputs)
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:round(n * tr["greedy_share"])]] = True
    order = rng.permutation(n)
    return [(prompts[i], outputs[i], bool(greedy[i])) for i in order]


def requests(tr, vocab, seed, n, stream="requests"):
    """n requests of the cell's shapes in the cell's order, with uniform
    token ids and sampler seeds drawn from run ``seed``."""
    rng = seeds.host(seed, stream)
    sampled = tr["sampled"]
    out = []
    for plen, n_new, greedy in shapes(tr, n):
        out.append(Request(
            rng.integers(0, vocab, plen, dtype=np.int32), n_new,
            0.0 if greedy else sampled["temperature"],
            None if greedy else sampled["top_p"],
            int(rng.integers(0, 2 ** 31))))
    return out


def arrivals(tr, n, seconds):
    """Due times of n open-loop requests: the exponential's quantiles as
    gaps, in the cell's order, scaled so that n arrive in the window at
    the cell's rate and the last is due half a gap before it closes."""
    gaps = np.array([-math.log(1 - (i + 0.5) / n) for i in range(n)])
    gaps = gaps[np.random.default_rng([tr["shape_seed"], 1]).permutation(n)]
    t = np.cumsum(gaps)
    return (t * seconds * (1 - 0.5 / n) / t[-1]).tolist()
