"""Device-idle ms per video train step inside fvta.video.frames (the frame
encode's forward: the frame projection, its dropout, the frame bi-LSTM's
launches)."""

from perfbench.lib import spans

FRAMES = ("fvta.video.frames",)


def read(ctx):
    return spans.idle_ms_per_unit(ctx, FRAMES)
