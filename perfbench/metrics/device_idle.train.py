"""Percent of the profiled window in which no operation ran on the device:
1 - (union of the device's operation intervals) / (the window)."""

from perfbench.lib import readers


def read(ctx):
    return readers.device_idle(ctx)
