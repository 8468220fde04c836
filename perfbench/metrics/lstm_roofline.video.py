"""K1 (lstm_proj, lstm_rec) and K1b (lstm_rec_bwd) in the video train step:
the least time of the step's 3 bi-LSTM calls (frames, question, choices)
forward and backward at their expected valid lengths over the kernels'
profiled device time."""

from perfbench.lib import readers, video_costs

KERNELS = ("lstm_proj_kernel", "lstm_rec_kernel", "lstm_rec_bwd_kernel")
LSTM = "fvta_memexqa_torch.ops.lstm_fused"
COUNTERS = (f"{LSTM}:lstm_proj", f"{LSTM}:lstm_rec", f"{LSTM}:lstm_rec_bwd")


def read(ctx):
    d, m, v = ctx.run.d, ctx.run.m, ctx.run.cfg["video"]
    n = ctx.run.params["batch_size"]
    calls = len(video_costs.lstm_calls(d, m, v, n))
    return readers.roofline(ctx, "lstm_roofline.video", KERNELS,
                            video_costs.lstm_work(d, m, v, n), {k: calls for k in COUNTERS})
