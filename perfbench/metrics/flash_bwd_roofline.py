"""The flash backward's (dQ and dK/dV kernels together) share of its
roofline over a step's calls."""

from perfbench.counts import flash_bwd_work
from perfbench.readers import roofline_share


def read(m):
    return roofline_share(m, ("flash_dq", "flash_dkv"), flash_bwd_work)
