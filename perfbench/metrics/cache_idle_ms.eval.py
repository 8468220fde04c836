"""Device-idle ms per checkpoint evaluation inside fvta.eval.tables (the
per-checkpoint vocabulary and photo tables) and fvta.eval.cache (the encode
of every album row)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.CACHE)
