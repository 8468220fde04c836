"""K1 (lstm_proj, lstm_rec) and K1b (lstm_rec_bwd) in the MemexQA train step:
the least time of the step's 9 bi-LSTM calls forward and backward over the
kernels' profiled device time."""

from perfbench.lib import costs, readers

KERNELS = ("lstm_proj_kernel", "lstm_rec_kernel", "lstm_rec_bwd_kernel")
LSTM = "fvta_memexqa_torch.ops.lstm_fused"
COUNTERS = (f"{LSTM}:lstm_proj", f"{LSTM}:lstm_rec", f"{LSTM}:lstm_rec_bwd")


def read(ctx):
    d, m = ctx.run.d, ctx.run.m
    h = m.hidden_dim
    calls = costs.memexqa_lstm_calls(d, m, ctx.run.params["batch_size"], d.max_albums)
    work = []
    for n, t, d_in, out_used, _ in calls:
        work += [costs.k1_proj(n, t, d_in, h), costs.k1_rec(n, t, h, True, True),
                 costs.k1b(n, t, h, out_used)]
    return readers.roofline(ctx, "lstm_roofline.train", KERNELS, work,
                            {k: len(calls) for k in COUNTERS})
