"""K2 (k2_cluster_kernel) in the video train step: the least time of its one
forward call (S = 1, the expected valid frames and question words) over the
kernel's profiled device time. Its backward recomputes the plain version and
launches no K2."""

from perfbench.lib import readers, video_costs

KERNELS = ("k2_cluster_kernel",)
COUNTERS = ("fvta_memexqa_torch.ops.fvta_fused:fvta_fwd",)


def read(ctx):
    d, m, v = ctx.run.d, ctx.run.m, ctx.run.cfg["video"]
    call = video_costs.k2_work(d, m, v, ctx.run.params["batch_size"])
    return readers.roofline(ctx, "fvta_roofline.video", KERNELS, [call], {COUNTERS[0]: 1})
