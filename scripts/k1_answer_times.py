#!/usr/bin/env python3
"""The main path's bi-LSTM kernels and answer step, for the checkout at ROOT:

- K1 (`lstm_k1`: lstm_proj + lstm_rec) at the 9 serving calls (chip_smoke's
  K1_SHAPES, the inputs of its k1_times), the projection and the recurrence
  alone beside it;
- K1b (`lstm_rec_bwd`) at the 9 calls of a batch-64 train step (K1B_SHAPES,
  the inputs of k1b_times);
- the L2-streaming lstm_fwd / lstm_bwd (the route past the largest cluster)
  at three of the repo's shapes (D = 200, H = 100);
- the in-process answer step at dp = 1 (QAEngine.answer_batch, 8 questions a
  step, phase 4's 32 serving questions) on a seeded full-width model;
- the ptxas register / spill lines of the bi-LSTM kernels' build;
- a SHA-256 of the bits K1, K1b, lstm_fwd and lstm_bwd return at those
  shapes (out, fin, cell, dgates; at the valid positions): equal digests
  across two checkouts are bitwise equal outputs.

    python3 scripts/k1_answer_times.py ROOT WORKDIR    # on a CUDA machine

Kernel times are sums over the shapes, under CUDA events (50 back-to-back
calls) and replayed from a CUDA graph (chip_smoke.cuda_ms / graph_ms). The
answer step reads asks/s over 10 passes of the 32 questions, three times.
Prints one line "ROOT {json}". To compare two checkouts, unpack one beside the
other and run them in turns in one call (A, B, B, A) with one WORKDIR: the
first run writes the pack and the run directory there, the others reuse them.
The script imports chip_smoke and the package from ROOT.
"""

import hashlib
import json
import os
import sys
import time


def kernel_times(cs, lstm_fused, dev) -> dict:
    import torch

    bits = hashlib.sha256()

    def feed(valid, *ts):
        """Hash each tensor's bits, [N, T, ...] ones at the valid positions only
        (what a kernel leaves past a row's length is not its result)."""
        for a in ts:
            if a is not None:
                if a.dim() > 2:
                    a = torch.where(valid[..., None], a, torch.zeros((), device=a.device))
                bits.update(a.cpu().numpy().tobytes())

    out = {"k1_ms": 0.0, "k1_graph_ms": 0.0, "proj_ms": 0.0, "rec_ms": 0.0,
           "k1b_ms": 0.0, "k1b_graph_ms": 0.0}
    for i, (_, n, t, d, emit) in enumerate(cs.K1_SHAPES):
        x, mask, p_fw, p_bw = cs.lstm_case(n, t, d, cs.H, 200 + i, dev)
        lens = mask.sum(1).to(torch.int32)
        with torch.no_grad():
            xg = lstm_fused.lstm_proj(x, lens, p_fw, p_bw)
            k1 = lambda: lstm_fused.lstm_k1(x, lens, p_fw, p_bw, 1.0, emit)
            feed(mask, *k1()[1:])
            out["k1_ms"] += cs.cuda_ms(k1)
            out["k1_graph_ms"] += cs.graph_ms(k1)
            out["proj_ms"] += cs.cuda_ms(lambda: lstm_fused.lstm_proj(x, lens, p_fw, p_bw))
            out["rec_ms"] += cs.cuda_ms(
                lambda: lstm_fused.lstm_rec(xg, lens, p_fw, p_bw, 1.0, emit))
    for i, (_, n, t, d, fin_only) in enumerate(cs.K1B_SHAPES):
        x, mask, p_fw, p_bw, g_out, g_fin = cs.k1b_case(n, t, d, 800 + i, fin_only, dev,
                                                        cs.COTANGENT_SCALE)
        lens = mask.sum(1, dtype=torch.int32)
        with torch.no_grad():
            pre = lstm_fused.lstm_proj(x, lens, p_fw, p_bw)
            _, _, cell = lstm_fused.lstm_rec(pre, lens, p_fw, p_bw, 1.0, True, emit_cell=True,
                                             write_preact=True)
            k1b = lambda: lstm_fused.lstm_rec_bwd(pre, lens, p_fw, p_bw, cell, g_out, g_fin, 1.0)
            feed(mask, cell, k1b())
            out["k1b_ms"] += cs.cuda_ms(k1b)
            out["k1b_graph_ms"] += cs.graph_ms(k1b)
    for n, t in ((64, 24), (256, 24), (768, 10)):
        x, mask, p_fw, p_bw, g_out, g_fin = cs.k1b_case(n, t, 200, 7, False, dev,
                                                        cs.COTANGENT_SCALE)
        lens = mask.sum(1, dtype=torch.int32)
        with torch.no_grad():
            o, f, c = lstm_fused.lstm_fwd(x, lens, p_fw, p_bw, 1.0, True, True)
            feed(mask, o, f, c,
                 lstm_fused.lstm_bwd(x, lens, p_fw, p_bw, o, c, g_out, g_fin, 1.0))
            out[f"lstm_fwd {n}x{t}"] = cs.cuda_ms(
                lambda: lstm_fused.lstm_fwd(x, lens, p_fw, p_bw, 1.0, True))
            out[f"lstm_bwd {n}x{t}"] = cs.cuda_ms(
                lambda: lstm_fused.lstm_bwd(x, lens, p_fw, p_bw, o, c, g_out, g_fin, 1.0))
    out["bits_sha256"] = bits.hexdigest()
    return out


def answer_rates(cs, workdir: str) -> list:
    import torch

    from fvta_memexqa_torch.config import Config, DataConfig
    from fvta_memexqa_torch.convert import save_rundir
    from fvta_memexqa_torch.data import make_synthetic, pack
    from fvta_memexqa_torch.models import FVTAModel
    from fvta_memexqa_torch.serve import build_engine

    packdir, rundir = os.path.join(workdir, "pack"), os.path.join(workdir, "run")
    if not os.path.isdir(rundir):
        meta = pack(*make_synthetic(**cs.SLICE_CORPUS), packdir, DataConfig(), seed=0)
        cfg = Config(data=DataConfig(**meta["data_config"]))
        save_rundir(rundir, cfg, FVTAModel(cfg, generator=torch.Generator().manual_seed(0)))
    asks = cs.serving_asks(packdir)
    engine, _, _ = build_engine(packdir, rundir, device="cuda", batch_size=8)
    try:
        answer = lambda: [engine.answer_batch(asks[i:i + 8]) for i in range(0, len(asks), 8)]
        answer()
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                answer()
            torch.cuda.synchronize()
            rates.append(len(asks) * 10 / (time.perf_counter() - t0))
    finally:
        engine.close()
    return rates


def main() -> None:
    root, workdir = os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from fvta_memexqa_torch.ops import build, lstm_fused

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(workdir, exist_ok=True)
    build.build_all()
    out = kernel_times(cs, lstm_fused, torch.device("cuda"))
    out["answer_dp1_asks_per_s"] = answer_rates(cs, workdir)
    print(root, json.dumps(out), flush=True)
    for stem in ("lstm_rec", "lstm_rec_bwd", "lstm_fwd", "lstm_bwd"):
        for line in build.build_log.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(root, stem, line.strip())


if __name__ == "__main__":
    main()
