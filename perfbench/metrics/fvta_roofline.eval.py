"""K2 (k2_cluster_kernel) in a checkpoint evaluation: the least time of its
calls (one an eval batch, over A x 6 sequences of T context steps, of which
the photo sequences' P are valid, and J question words) over the kernel's
profiled device time."""

from perfbench.lib import costs, readers

KERNELS = ("k2_cluster_kernel",)
COUNTERS = ("fvta_memexqa_torch.ops.fvta_fused:fvta_fwd",)


def read(ctx):
    d, m, p = ctx.run.d, ctx.run.m, ctx.run.params
    n = p["eval_batch_size"]
    batches = -(-p["questions"] // n)
    valid = d.max_albums * (2 * d.max_photos + costs.NUM_TEXTS * d.max_album_text_len)
    call = costs.k2(n, d.max_albums * costs.NUM_MODALITIES, costs.max_context_time(d),
                    d.max_question_len, 2 * m.hidden_dim, valid)
    return readers.roofline(ctx, "fvta_roofline.eval", KERNELS, [call] * batches,
                            {COUNTERS[0]: batches})
