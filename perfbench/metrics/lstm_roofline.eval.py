"""K1 (lstm_proj, lstm_rec) in a checkpoint evaluation: the least time of its
bi-LSTM calls (the album cache in blocks of 64 rows, the answers in eval
batches) over the kernels' profiled device time."""

from perfbench.lib import costs, readers

KERNELS = ("lstm_proj_kernel", "lstm_rec_kernel")
LSTM = "fvta_memexqa_torch.ops.lstm_fused"
COUNTERS = (f"{LSTM}:lstm_proj", f"{LSTM}:lstm_rec")
CACHE_BLOCK = 64   # eval_cache.precompute_album_cache's rows per encode


def read(ctx):
    d, m, p, corpus = ctx.run.d, ctx.run.m, ctx.run.params, ctx.run.cfg["corpus"]
    h = m.hidden_dim
    calls = costs.eval_lstm_calls(d, m, p["questions"], corpus["num_albums"] + 1, CACHE_BLOCK,
                                  p["eval_batch_size"])
    work = []
    for n, t, d_in, out_used, _ in calls:
        work += [costs.k1_proj(n, t, d_in, h), costs.k1_rec(n, t, h, out_used, False)]
    return readers.roofline(ctx, "lstm_roofline.eval", KERNELS, work,
                            {k: len(calls) for k in COUNTERS})
