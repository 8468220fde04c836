"""Device-idle ms per train step inside fvta.backward (torch.autograd.grad,
whose kernels autograd's device thread launches while the main thread waits,
the zero fill of unused gradients, the stack of the sums)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.BACKWARD)
