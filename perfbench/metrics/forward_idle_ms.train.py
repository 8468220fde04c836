"""Device-idle ms per train step inside fvta.forward (loss_and_metrics: the
batch's assembly on the device, the model's forward and the loss)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.FORWARD)
