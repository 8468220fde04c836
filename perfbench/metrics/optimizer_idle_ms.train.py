"""Device-idle ms per train step inside fvta.optimizer (Optimizer.update: the
global-norm clip and Adam over every parameter)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.OPTIMIZER)
