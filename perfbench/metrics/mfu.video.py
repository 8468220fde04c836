"""The video train step's share of the card's float32 peak: the frozen step
count (video_costs.step_cost: the vocabulary table, the frame projection, the
frame, question and choice bi-LSTMs, the attention, the scorer, their backward
and Adam, at the expected valid lengths) times the window's steps, over the
profiler-off window's time."""

import math

from perfbench.lib import readers, video_costs
from perfbench.reference import video


def read(ctx):
    d, m = ctx.run.d, ctx.run.m
    params = sum(math.prod(s) for _, s, _ in video.param_spec(d, m))
    step = video_costs.step_cost(d, m, ctx.run.cfg["video"], ctx.run.params["batch_size"],
                                 params)
    return readers.mfu(ctx, step["flops"])
