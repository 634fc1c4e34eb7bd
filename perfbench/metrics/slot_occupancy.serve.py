"""Mean of the program's ``serve.batch_occupancy`` (active slots over
slots, one observation a decode dispatch) over the window, in %."""

from perfbench.readers import occupancy as read  # noqa: F401
