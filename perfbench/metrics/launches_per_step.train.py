"""Host launch calls per train step: runtime and driver calls that enqueue
device work (kernels, async copies and sets), over the profiled steps."""

from perfbench.lib import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
