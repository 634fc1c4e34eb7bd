"""The share of the traced window in which no kernel or copy ran on the
device, in %."""

from perfbench.readers import idle_share as read  # noqa: F401
