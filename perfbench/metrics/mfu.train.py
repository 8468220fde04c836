"""The MemexQA train step's share of the card's float32 peak: the frozen
step count (costs.step_cost(train=True): forward, backward, Adam) times the
window's steps, over the profiler-off window's time."""

import math

from perfbench.lib import costs, readers
from perfbench.reference import memexqa


def read(ctx):
    d, m = ctx.run.d, ctx.run.m
    params = sum(math.prod(s) for _, s, _ in memexqa.param_spec(d, m))
    step = costs.step_cost(d, m, ctx.run.params["batch_size"], params, train=True)
    return readers.mfu(ctx, step["flops"])
