"""Device-idle ms per train step inside the loader's spans: fvta.loader.batch
(one batch's host assembly) and fvta.loader.h2d (its copies to the device)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.LOADER)
