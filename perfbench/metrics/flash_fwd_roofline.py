"""The flash forward kernel's share of its roofline over a step's calls."""

from perfbench.counts import flash_fwd_work
from perfbench.readers import roofline_share


def read(m):
    return roofline_share(m, ("flash_fwd",), flash_fwd_work)
