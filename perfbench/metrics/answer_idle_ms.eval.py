"""Device-idle ms per checkpoint evaluation inside fvta.eval.answer (each
batch's gather of cache rows, answer and metric sums), less the loader's
fvta.loader.h2d inside it."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, spans.ANSWER, minus=spans.LOADER)
