"""A checkpoint evaluation's share of the card's float32 peak: the frozen count
(costs.eval_cost: the tables, the album cache of every album row, the answers)
times the window's evaluations, over the profiler-off window's time."""

from perfbench.lib import costs, readers


def read(ctx):
    d, m, corpus = ctx.run.d, ctx.run.m, ctx.run.cfg["corpus"]
    cost = costs.eval_cost(d, m, ctx.run.params["questions"], corpus["num_albums"] + 1,
                           corpus["num_photos"] + 1)
    return readers.mfu(ctx, cost["flops"])
