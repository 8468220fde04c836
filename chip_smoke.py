#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fvta_memexqa_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout, on a CUDA machine

Phases, each fatal on failure (exit code 1, no result line):

1. print the card (nvidia-smi name, power limit) and build every kernel of the
   serving path from csrc/ with nvcc (ptxas register/shared-memory report shown);
2. K1 vs its plain version on the card, at the slice's shapes (D=200, H=100;
   T=10/12/24/30/8; rows of length 0 and T), with and without per-step
   outputs, and at the video bilstm encoder's frames (8 x 1024 at D=200, 16 x
   1024 at D=116: clusters of 8 over 1024 steps): at these widths
   ops/lstm_fused.lstm_route sends K1 to the Hopper kernels,
   csrc/lstm_proj.cuh (the input projection of both directions) then
   csrc/lstm_rec.cu (the recurrence, Wh resident, clusters split over hidden
   units), one launch each per call and none of csrc/lstm_fwd.cu; the
   projection alone vs the plain product; the route (cluster, tile rows, lane
   split, threads, shared memory per CTA, the sources' sizes equal to the
   route's) printed per shape; and at H=300, past the largest cluster, lstm_fwd
   alone;
3. K2 (csrc/fvta_fwd.cu: one thread-block cluster per example) vs its plain
   version on the card at S=T=24, J=30, D=200 and N=1, 8 (serving), 64 (the
   train step, under grad) and 128 (an evaluation batch), plus a long T=512,
   the masked edge cases (a dead sequence, an all-masked question, an example
   with no valid context) and S=1 at T=1024 and 4096 (K2 called directly:
   fvta_attention_fused streams there), one launch of K2 per call; and on
   unbounded inputs at N=1, 8, 64,
   128 and both video lengths, K2 and the float32 plain version both against
   the float64 plain version (a rounding witness);
4. the slice: synthetic MemexQA corpus at F=2537 (64 albums x 12 photos) packed
   at the default DataConfig, a full-width model from a seeded torch.Generator
   saved to a run directory, build_engine (batched pack ingestion) + one raw
   ingest, 32 questions through concurrent QAEngine.ask calls. Both kernels'
   launch counters are zeroed just before and read just after, K2's first two
   calls (warm-up, first batch) and every call's N recorded; the answers must
   match the same engine built on the CPU (plain versions);
5. times from CUDA events after warm-up: each kernel, its plain version, its
   bound (max of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s FP32, from this run's
   inputs) and, for K1, cuDNN's torch.nn.LSTM on the same function (a yardstick
   only: the port never calls it); and the per-request latency of ask. K1 and
   K1b are timed at the serving and train shapes, the grouped scans' routing
   edges and the video frames (T=1024): the Hopper kernels and the L2-streaming ones
   on the same inputs, each also replayed from a CUDA graph (device time
   without the host's launch work); and lstm_rec / lstm_rec_bwd under every
   cluster size and tile height at a few shapes (the route sweep), each held
   against the routed run. K2's times (taken right after phase 3): K2 at N =
   1, 8, 64, 128 (S = T = 24) under CUDA events (two readings), from a CUDA
   graph, and as the mean of its profiler events (at most 1.10x the graph
   time); and the answer step's device time (phase 4's profile).

The training slice (kernel K1b — csrc/lstm_rec_bwd.cu on the Hopper route,
csrc/lstm_bwd.cu past the largest cluster — and autograd through K1/K2):

6. the cotangents that reach K1b: one plain and one dedup train step on the
   slice's pack, reading max and mean |g_out|, |g_fin| at every K1b call;
   then K1b vs its plain version (torch.autograd.grad through bilstm_ref) on
   the card at the train step's nine bi-LSTM shapes, the dedup photo-title
   shape (batch 64, A = 4; rows of length 0 and T; with and without per-step
   cotangents) and the video bilstm's two frame shapes (T=1024): K1's out and fin under grad at 1e-5 / 1e-6, and dx, dwx, dwh,
   db of both directions at rtol 1e-4 / atol 1e-5 with N(0, 1) / 64
   cotangents (fatal if the train step gave any shape a larger |cotangent|),
   one launch of lstm_proj, lstm_rec and lstm_rec_bwd each per forward +
   backward; the same at H=300 through lstm_fwd and lstm_bwd; a float64
   witness at unit-scale N(0, 1) cotangents at all twelve shapes (the binding
   check of the long dW sums); K1's cell output against the plain scan's
   carried c and lstm_rec's saved pre-activations against the plain gates
   (train and video shapes);
7. the train slice: `cli train` for 24 steps on the slice's pack (val every 12
   steps) and `cli predict` on the trained run directory; the launch counters
   are zeroed just before and read just after (every command phase must
   launch lstm_proj, lstm_rec — and lstm_rec_bwd where it trains — and never
   lstm_fwd or lstm_bwd), losses must be finite
   and the last epoch's mean below the first's; the same with
   --dedup-albums true; K2's first call of the plain run and every call's N are
   recorded;
8. the card vs the CPU from the same weights and batch at keep_prob 1: the
   step-1 gradients of every parameter tensor, the losses of 3 steps, and on
   the card the dedup step against the plain step;
9. exact resume on the card: 6 steps straight vs 3 steps, stop, resume to 6 —
   every parameter and optimizer tensor torch.equal;
10. times: K1b (the nine calls of one step) beside its bound, the plain
   backward and cuDNN's nn.LSTM backward; and a `training` line (step time,
   qa_pairs/s, peak device memory, dedup vs plain, torch.profiler breakdown
   of one step).

The video slice (kernels K4, csrc/fvta_stats.cu, and K5/K6, csrc/fvta_bwd.cu; K4
and K5 walk runs of chunks, one CTA per run, csrc/fvta_corr.cuh; the streaming
form of the attention from STREAM_MIN_T frames on):

0. at the start, a CPU child process writes a synthetic raw corpus (`cli
   synth-video`, 48 videos of 512-2047 frames x 2537 features) and packs it
   at 1024 frames (`cli video-prepro`) while the phases above run;
11. the arguments the full-width T=4096 train step (bench_lib's realistic
   config, dilated-conv encoder, batch 8, keep_prob 0.9) gives K4 and K6, read
   by wrapping them; K4 vs stats_fwd_ref, K5 vs qcnt_ref (exactly equal, and
   >= 1 for every (n, j)), K6 vs stats_bwd_ref on those arguments and on
   synthetic cases (the main shapes, S=T=24, S=8 x T=16384 x J=512; each also
   with a dead half sequence, an empty example and an all-masked question);
   K4 at 1e-5 / 1e-5, K6 at 1e-4 / 1e-5, a field beyond it passing only on
   the float64 witness (at most 2x the float32 plain version's distance from
   float64, plus 4 ulps); K6's float64 witness at unit-scale cotangents; K6 with de = gv = 0 and
   unit geq on the step's own h and q (dC from eq's tie shares alone: dh and
   dq at 1e-4 / 1e-5 of plain, no witness); two launches each of K4, K5 and
   K6 on the step's arguments bitwise equal;
12. the streaming form vs K2 + recompute at T=1024, forward and gradients;
13. this slice's main path: `cli video --data --out` (24 steps, T=1024,
   H=100, val every 12) and `cli video-test` on the run directory, with
   every kernel counter zeroed just before and read just after (K5 and K6
   must launch once per step; the loss must fall); K6's first call there
   recorded, and K4/K5/K6 held against plain on its arguments as in phase
   11, with the bitwise repeats;
14. the full-width T=4096 step: card vs CPU step-1 gradients at keep_prob 1;
   p50 over 10 steps, peak memory and a torch.profiler breakdown; the
   `--encoder bilstm` step at T=1024 (p50 over 10 steps, peak memory, profile;
   the Hopper bi-LSTM kernels only); bitwise resume of train_video; and the
   crossover of K2 + recompute vs K4 + K5 + K6 at T = 256, 1024, 4096 (time,
   device time and peak memory of one forward + backward); then K4, K5 and
   K6 at both main-path calls (the T=4096 step's and `cli video`'s), timed
   under CUDA events (two readings) and replayed from a CUDA graph (device
   time), each split by kernel under torch.profiler.

The grouped scans (kernels K7, csrc/lstm_grouped.cu, and K8, csrc/lstm_stream.cu,
both K1's Hopper recurrence over G groups, csrc/lstm_gscan.cuh: the counterpart of
the JAX package's round-1 lstm_pallas API, which no command reaches) and the
evaluation path (`cli prepro | test | ablate`, on K1 and K2):

15. the grouped-scan API at D=200, H=100 on the batch-64 train step's bi-LSTM
   shapes (photo titles 3072 x 10, which routes to K8; the six encoders at 256
   rows; the question 64 x 30; the choices 256 x 8) and the routing edge
   (n=1024, t=2 → K8; n=1023 → K7), rows of length 0 and T: with the counters
   zeroed before and read after, bilstm_grouped (G=2) and lstm_scan_grouped
   (G=1) launch the kernel the routing names once per call; outputs vs the
   plain references and vs K1 (bilstm_fused) at 1e-5 / 1e-6; gradients under
   autograd (backward by recompute through the plain reference) vs plain
   autograd at 1e-4 / 1e-5; then K7 and K8 directly at every shape, G=2 and
   G=1, vs the plain grouped scan, K7 == K8 and each == its repeat bit for bit,
   and at G=2 K7 and K8 fed K1's own projection == K1's out and fin bit for
   bit. K7's and K8's counters are also zeroed before phase 3 and read before
   phase 15, and zeroed and read around phase 16: no command may launch them;
16. the evaluation path on phase 7's run directories and phase 4's pack, the
   K1 and K2 counters zeroed before and read after (both must launch; K2's
   first call and every call's N recorded): `cli
   test` cached and --no-album-cache (accuracy equal, loss to 1e-5), then
   --by-category (counts sum to the split), --dump-attention and --ensemble
   over the plain and dedup runs; `cli prepro` on the raw files
   write_raw_files writes for phase 4's corpus (the pack equals phase 4's
   array for array, word_emb_init to glove.txt's 5 decimals); `cli ablate
   --num-steps 6` over fvta,flat,none; predict_cached's probabilities on the
   card vs the CPU's from the same weights at 1e-4;
    Then K2 on the arguments recorded on the serving, train and evaluation
    paths, against its plain version at 1e-5 / 1e-5, the
    float64 witness on unbounded inputs at the same shapes, and the histogram
    of the N that K2 saw on each path;
17. the grouped scans' times: the scan alone on the precomputed x_proj at each
   phase-15 shape, K7 and K8 under CUDA events (two readings each) and
   replayed from a CUDA graph, beside its plain version and its own bound;
   the API's projection + scan as routed, by events and graph, with this host
   path and the stacked one it replaced, forced through K7 and K8, through the
   plain scan,
   beside K1, cuDNN's nn.LSTM and the encode's bound; the API's host trace
   (host ms per op, both forms) at two shapes; and `cli test`'s wall times
   (phase 16);
18. every width the JAX package takes. Each routed kernel's launches on its
   global route (h and q, or Wh, read from device memory past the shared
   memory's limit) over phases 2-17 must read 0. K4/K5 and K6 vs plain at the
   last staged and the first global D of each (J = 30 and 512, found from the
   library's geometry) and at D = 2048; forced global vs staged bit for bit
   at the T=4096 step's shape (K4's fields, K5's counts, K6's outputs, K6 on
   either route's K4/K5, every global kernel repeating); K6's geq-only case at
   J = 30, D = 560 (K4/K5 staged, K6 global); K2 vs plain at both sides of
   its limit at three shapes and at D = 2048, forced global vs staged; K7/K8
   vs plain at H = 315, 316, 512 and 1024 (K7 == K8 == repeats), forced Wh
   global == resident bit for bit at H = 100 and 315; `cli video
   --hidden-dim 279 / 300 --num-frames 1024` (3 steps, finite losses, the
   global counters); each global route timed past its limit and forced at
   the repo's width beside the staged route; the staged routes' graph times
   of phases 3-17 beside PERF.md's;
19. bench_lib at realistic_config (the `bench` line): train and dedup train at
   batch 64, cached inference (f32 and bf16 cache), inference at 8, 64 and
   256, video at T = 1024 and 4096, step costs with each layer's FLOP and byte
   share, and a profile of one train step;
20. capacity_probe.probe_largest_t at batch 8, J = 512, D = 200, S = 8,
   forward and with grad, T from 16384 up to 1048576 (the `capacity` line);
21. the serving front end (run inside the block of phases 4-16, whose pack,
   trained run directory and raw files it reads): `python -m
   fvta_memexqa_torch.cli serve` in subprocesses on the card (SERVER_BOOT:
   the CLI's entry point plus signal handlers that write each process's
   kernel counters, which start at 0, and its answer steps' CUDA-event span);
   K1 and K2 must launch in every process, the L2-streaming bi-LSTM kernels
   and every global route never. An f32 server with
   --auth-token, --max-pending, --max-rps-per-client, --cache-dir and the raw
   albums: 32 concurrent /ask calls within 1e-5 of the in-process card engine
   (answers equal), POST /albums of a new album and the wall time to its first
   answer, 401 / 429 / 404, /stats; --max-cache-mb 1 (evictions, re-encodes,
   answers within 1e-5 of the f32 server's, lstm_rec's launches equal to the
   answer steps' and re-encodes' own counts); --cache-dtype bfloat16 and int8
   (exact cache bytes, top-1 equal to f32 but for near-ties, probabilities
   within 0.05; _quant_h on the card bitwise its CPU result); a restart on the
   saved cache (restored N, answers within 1e-5); `--dp` past the cards there
   are exiting non-zero with make_mesh's ValueError (and `--shard-cache`
   without `--dp` with the store's); TLS with a
   self-signed cert where openssl exists; open-loop Poisson load at 50-800
   asks/s (p50, p99, errors, shed, achieved rate, the answer steps' span
   share) and the highest rate whose p99 stays under 100 ms (the
   `serving_http` line);
22. the loader and the focality workflow (run inside the same block, on copies
   of phase 4's pack), K1, K1b and K2's counters zeroed before each part and
   read after (all three must launch; the L2-streaming bi-LSTM kernels,
   K4-K8 and every global route never, read as deltas): phase 7's `cli
   train` again with --prefetch 2, its final parameters, optimizer state and
   dropout generator torch.equal to phase 7's (qa/s of both from
   metrics.jsonl); `cli train --stream-shard-size 64
   --prefetch 2 --profile` (the shard index exists and a second
   ensure_split_shards rewrites nothing, finite losses, the profile event at
   step 15, a chrome trace holding lstm_rec, lstm_rec_bwd and K2's cluster
   kernel: the window's device busy share, each one's share of device time,
   launch calls per step; the `train_loader` line); then `cli synth --focal`
   (32 albums x 8 photos, 320 questions, F = 2537), `prepro --val-ids`,
   `train` (48 steps at the flagship's widths), `test --dump-attention`,
   `attention-report --json` and `report --json`, every command exiting 0,
   report's steps and best val equal to metrics.jsonl's, the attention
   records within the pack's albums and modalities, and test accuracy overall
   and per question kind (the `focal` line);
23. data and context parallelism (run inside the same block, on phase 4's
   pack and phase 7's and 16's results), the ranks sharing the one card
   (parallel/mesh.run_ranks over make_mesh(devices=["cuda:0"] * n), gloo;
   every kernel counter zeroed in each rank and read per rank): DP-2 — the
   batch-64 step's gradient at keep_prob 1 vs the single-rank step on the
   card (rtol 1e-4 / atol 1e-6) and vs the CPU (STEP_TOL), two 24-step DP-2
   `train` runs with val bitwise equal (parameters and dropout generator),
   `test` at DP-2 with and without --shard-cache equal to phase 16's
   accuracy, predict_cached's probabilities vs one rank's (ENGINE_TOL) and
   sharded vs replicated bitwise; K1, K1b and K2 launched on each rank, the
   L2-streaming kernels never. CP-2 and CP-4 — the
   full-width T=4096 video step (batch 8, D = 200, J = 30, keep_prob 1) vs
   cp = 1 on the card at the JAX package's flagship-CP tolerances (logits
   2e-5, loss 1e-5, gradients rtol 5e-4 / atol 1e-5); K4, K5 and K6 launched
   on every rank and K2 on none. Per-rank step ms and the collectives' share
   of it (CUDA events around mesh.all_gather), DP-2 qa/s beside phase 7's
   one-rank qa/s (the `parallel` line, labelled as ranks sharing one card).
24. the grouped bi-LSTM, serving over a mesh and the CP memory table (run
   inside the same block, on phase 4's pack and phase 7's run):
   ops/lstm_fused.bilstm_fused_grouped at K = 6 over the flagship's six time
   encoders (256 album slots, T = 12 / 24, D = 200) at H = 100 (lstm_proj +
   lstm_rec forward, lstm_rec_bwd backward, G = 12 groups per launch) and at
   H = 300 (lstm_fwd / lstm_bwd): forward vs the plain version (LSTM_TOL) and
   every gradient vs autograd through it (GRAD_TOL), exactly one launch of
   each kernel of the route per forward and per backward, each group vs a
   lone bilstm_fused call (the maximum difference) and K = 1 bitwise equal to
   bilstm_fused; the grouped call's time beside the six separate calls (CUDA
   events and CUDA graphs) and its K1b alone beside six; serve.build_engine at
   dp = 2 over ["cuda:0", "cuda:0"], replicated and with shard_cache, answering
   phase 4's 32 questions as dp = 1 does (same answer_index, probs and
   seq_attention within SERVE_TOL), K1 and K2 launched, the sharded cache's
   slot bytes summing to cache_bytes and a save / load round trip on the same
   hash homes, asks/s of the answer steps at dp = 1 and 2 in turns; and
   capacity_probe.cp_memory_table at T = 65536 over one rank (the whole context)
   and over 2 and 4 ranks sharing the card, forward and with grad, its counted
   bytes equal to counted_mb's (the
   `grouped_mesh` line; the two grouped launches join the kernels line).
25. TF checkpoints, the bf16 variant and the native tokenizer (run inside the
   same block, on phase 4's pack, phase 7's run and phase 16's raw files):
   phase 7's run exported through the port's TF writer (`cli
   export-tf-checkpoint`), read back with every CRC32C checked, re-imported
   with `cli import-tf-checkpoint` and evaluated with `cli test` on the card
   (accuracy and loss bitwise the run's, K1 and K2 launched); `cli train
   --dtype bfloat16` for 6 steps (the BF16 instantiations of lstm_proj,
   lstm_rec and lstm_rec_bwd launch, the float32 ones and the L2-streaming
   kernels do not); the BF16 K1 at the serving shapes and K1b + products at
   the train step's vs the plain bf16 version (BF16_ATOL, BF16_GRAD_REL), each
   timed beside the float32 instantiation on the same inputs (CUDA events and
   graphs); the video model in bf16 vs float32 (dilated conv and bi-LSTM, T =
   1024); `cli prepro` through the native tokenizer and under FVTA_NO_NATIVE=1
   (every pack file byte-identical) with the encoder's texts/s both ways (the
   `port_complete` line; the two BF16 launches join the kernels line).
26. the train step from its CUDA graph (train.StepGraph) vs eagerly
   (train.eager_step) at realistic_config, batch 64 and 256: wall ms a step
   of each over the same batches from the same state, their parameters and
   moments bitwise equal, and train_step's eager_steps / graph_captures /
   graph_replays counters (one eager step and one capture on the graphed
   side; the `graph_step` line).
27. a batch's move to the card alone, at tvqa-frames-train-b128's VideoInputs
   and memexqa-train-b256's Batch: the plain per-field .to (blocking copies
   from pageable memory) against VideoInputs.to / Batch.to (data.device_prepro
   .stage_to: a pinned staging ring and copies that do not block), in turns
   over three seeded host batches; host ms of the call, ms until the copies
   have landed, CUDA-event ms around the call, and ms a batch back to back
   without a synchronise; every moved batch equal to the plain one bit for bit
   (the `staging` line).

Prints the `train_loader`, `focal`, `parallel`, `grouped_mesh`, `port_complete`,
`graph_step` and `staging` lines, a {"kernels": [...]} line, then the card line,
then as the last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
import os
import subprocess
import sys
import tempfile
import threading
import time

# deterministic cuBLAS for the training phases' bitwise resume (read when
# cuBLAS first starts, so set before torch is imported)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOPS = 67e12          # H100 SXM FP32 outside the tensor cores
# Kernel vs plain version on the card, both float32. The plain version sums in
# another order (cuBLAS tiles vs per-column FMA chains / warp shuffles), the
# recurrence carries rounding over up to 30 steps, and K2's softmax is online.
LSTM_TOL = dict(rtol=1e-5, atol=1e-6)
FVTA_TOL = dict(rtol=1e-5, atol=1e-5)
# K2 on unbounded inputs vs the float64 plain version: at most this many times
# the float32 plain version's own error (both round in float32, in other orders).
K2_VS_F64_FACTOR = 2.0
# The engine on the card vs the engine on the CPU: every matmul of the model
# runs in another library (cuBLAS vs the CPU BLAS) besides the two kernels.
ENGINE_TOL = 1e-4
# K1b vs plain autograd on the card: the JAX suite's gradient tolerance
# (tests/test_lstm_fused.py), with N(0, 1) cotangents times COTANGENT_SCALE.
# The cotangents that really reach K1b in a train step are read in this run
# (cotangent_probe), which fails if any exceeds COTANGENT_SCALE: the check then
# runs at a scale at least the main path's (a larger cotangent only makes a
# fixed atol stricter).
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
COTANGENT_SCALE = 1.0 / 64
# a kernel split read from torch.profiler must sum to this share of the CUDA-graph
# time of the same call (the graph also holds the gaps between launches; the two
# readings of K6 differed by -6% to +3.4% on the H100)
SPLIT_SHARE = (0.85, 1.10)
# The float64 witness: at unit-scale N(0, 1) cotangents the dW sums of K1b run
# over N*T = 30720 rows (K6's over 32768 frames), and both the kernel and the
# float32 plain version are ~3e-5 from float64 there: the kernel may be at most
# F64_FACTOR x as far from the float64 plain version as the float32 one, plus
# F64_ULPS float32 ulps of the largest entry. This witness is the binding check
# of the long sums: at the train step's cotangent scale the errors sit far
# below atol.
F64_FACTOR = 2.0
F64_ULPS = 4.0
F32_EPS = 2.0 ** -23
# The train step on the card vs the CPU (same weights, same batch): per
# parameter tensor max|dg| <= 1e-4 * max|g_cpu|; losses to 1e-4 relative.
STEP_TOL = 1e-4
# The scorer's bias adds the same number to all four logits, which the softmax
# ignores: its exact gradient is 0, so both devices return rounding noise
# there, and it is held to |g| <= ZERO_GRAD_ATOL on each instead.
EXACT_ZERO_GRADS = ("scorer.bias",)
ZERO_GRAD_ATOL = 1e-6
TRAIN_STEPS = 24


def fail(msg: str) -> None:
    print(f"chip_smoke FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20) -> float:
    """Device time per call of fn with the host's launch work out of the way:
    `calls` calls captured once in a CUDA graph, the graph replayed under CUDA
    events (cuda_ms of back-to-back calls is bound by the host where a call's
    kernels take less time than its Python and launch work)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    ms = cuda_ms(g.replay, iters=10, warmup=2) / calls
    del g
    return ms


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(a, b, rtol: float, atol: float) -> bool:
    import torch

    return bool(torch.allclose(a, b, rtol=rtol, atol=atol))


def f64_witness(got, plain, exact) -> tuple[float, str]:
    """(share of its limit that `got` uses, note): the kernel's distance from
    the float64 plain version over F64_FACTOR x the float32 plain version's,
    plus F64_ULPS ulps of the largest entry; a share <= 1 passes."""
    e_k, e_p = max_err(got, exact), max_err(plain, exact)
    limit = F64_FACTOR * e_p + F64_ULPS * F32_EPS * float(exact.abs().max())
    return (e_k / limit if limit > 0 else 0.0), f"{e_k:.2e}/{e_p:.2e}"


# the host-side calls that each put one item on the device's timeline
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
MEASURED_RANGE = "chip_smoke.measured"   # the host range of a trace's measured calls


def profile_kernels(fn, reps: int) -> tuple[dict, dict, float]:
    """({kernel name: device ms per call}, {kernel name: events per call},
    launch calls per call) of fn over `reps` calls, read from torch.profiler's
    device events one by one. The trace also holds `reps` calls before and
    after the measured ones, each group closed by a synchronize, and only the
    events inside the measured calls' host range are read: a trace on the
    H100 can lose ~6 device events at its edges late in a long run. It can
    still miss events, so the host's launch calls are counted beside them and
    the callers retry."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls()
        with record_function(MEASURED_RANGE):
            calls()
        calls()
    events = prof.events()
    window = next(e.time_range for e in events if e.name == MEASURED_RANGE)
    ms: dict[str, float] = {}
    count: dict[str, float] = {}
    launched = 0.0
    for e in events:
        if not window.start <= e.time_range.start <= e.time_range.end <= window.end:
            continue
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
            count[e.name] = count.get(e.name, 0) + 1 / reps
        elif e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            launched += 1 / reps
    return ms, count, launched


def device_breakdown(fn, reps: int = 1, tries: int = 3) -> dict:
    """Wall and device-busy ms per call of fn under torch.profiler: the sum of
    the device events seen, from the most complete of up to `tries` traces
    (another is taken while fewer events are seen than launch calls made);
    `device_events_seen` and `launch_calls` say how complete it is."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    best = None
    for _ in range(tries):
        kernels, count, launched = profile_kernels(fn, reps)
        if best is None or sum(count.values()) > sum(best[1].values()):
            best = (kernels, count, launched)
        if sum(count.values()) >= launched:
            break
    kernels, count, launched = best
    busy = sum(kernels.values()) if kernels else None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall),
            "device_events_seen": sum(count.values()), "launch_calls": launched,
            "top_device_ms": {k[:60]: v for k, v in top}}


class Recorder:
    """Replaces module.name by a wrapper that keeps the arguments of the first
    `keep` calls (all with keep=None; tensors detached) and the shape of every
    call's first argument, and calls the real function; the wrapper carries the
    launch counters the real function increments (it counts the module's current
    name)."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.calls, self.keep = module, name, [], keep
        self.shapes = []
        self.real = getattr(module, name)

    def __enter__(self):
        import torch

        def wrapper(*args, **kwargs):
            if self.keep is None or len(self.calls) < self.keep:
                # detached: an argument that kept its step's autograd graph alive would
                # keep that graph's AccumulateGrad nodes, and their stream, into the next
                # step, whose CUDA-graph capture then fails (train.StepGraph)
                self.calls.append(tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                        for a in args))
            self.shapes.append(tuple(args[0].shape))
            return self.real(*args, **kwargs)

        wrapper.launches = wrapper.global_launches = wrapper.bf16_launches = 0
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


# ---- K1 -------------------------------------------------------------------------

# (name, rows, T, D, emit_out): the K1 launches of one 64-album ingest batch
# (photo titles, then the six time encoders) and of one 8-question answer batch
K1_SHAPES = [
    ("photo_title_words", 64 * 12, 10, 200, False),
    ("enc_photo", 64, 12, 200, True),
    ("enc_photo_title", 64, 12, 200, True),
    ("enc_album_title", 64, 24, 200, True),
    ("enc_album_desc", 64, 24, 200, True),
    ("enc_when", 64, 24, 200, True),
    ("enc_where", 64, 24, 200, True),
    ("question", 8, 30, 200, True),
    ("choices", 8 * 4, 8, 200, False),
]
H = 100
# the serving slice's synthetic corpus (phase 4), written to raw files again
# for `cli prepro` in phase 16
SLICE_CORPUS = dict(num_albums=64, photos_per_album=12, num_questions=320, feat_dim=2537,
                    seed=0)


def lstm_case(n, t, d, h, seed, device):
    import torch

    from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, t, d, generator=g)
    lens = torch.randint(0, t + 1, (n,), generator=g)
    lens[0], lens[min(1, n - 1)] = t, 0
    mask = torch.arange(t)[None, :] < lens[:, None]
    lim = (6.0 / (d + 5 * h)) ** 0.5
    params = []
    for _ in range(2):
        k = (torch.rand(d + h, 4 * h, generator=g) * 2 - 1) * lim
        b = torch.randn(4 * h, generator=g) * 0.1
        params.append(LSTMParams(k[:d].to(device), k[d:].to(device), b.to(device)))
    return x.to(device), mask.to(device), params[0], params[1]


# a hidden width past the shared memory of the largest cluster: lstm_route sends
# it to the L2-streaming kernels (lstm_fwd, lstm_bwd), which stay for it
OLD_H = 300
OLD_SHAPES = [("past_limit_64x24", 64, 24, 200), ("past_limit_8x30", 8, 30, 200)]
NEW_KERNELS = ("lstm_proj", "lstm_rec", "lstm_rec_bwd")
OLD_KERNELS = ("lstm_fwd", "lstm_bwd")
# (name, rows, T, D): the video bilstm encoder's frames at T=1024 (the full-width
# step's 8 x 1024 at D=200, `cli video`'s 16 x 1024 at D=116), routed to clusters
# of 8 CTAs: K1 and K1b are held against plain over 1024 serial steps here, where
# a fault that builds up over a long scan would show
LONG_SHAPES = [("video_frames_T1024", 8, 1024, 200), ("cli_video_frames_T1024", 16, 1024, 116)]


def lstm_counters() -> dict:
    """The launch counts of the five bi-LSTM kernel wrappers."""
    from fvta_memexqa_torch.ops import lstm_fused

    return {k: getattr(lstm_fused, k).launches for k in NEW_KERNELS + OLD_KERNELS}


def zero_lstm_counters() -> None:
    from fvta_memexqa_torch.ops import lstm_fused

    for k in NEW_KERNELS + OLD_KERNELS:
        getattr(lstm_fused, k).launches = 0


def lstm_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in lstm_counters().items()}


def check_lstm_launches(phase: str, launches: dict, backward: bool) -> None:
    """At the repo's widths a command reaches the Hopper kernels (lstm_proj and
    lstm_rec; lstm_rec_bwd too where it trains) and never the L2-streaming kernels."""
    need = NEW_KERNELS if backward else NEW_KERNELS[:2]
    if any(launches[k] for k in OLD_KERNELS) or min(launches[k] for k in need) == 0:
        fail(f"{phase}: the bi-LSTM must launch {need} and never {OLD_KERNELS}: {launches}")


def route_info(n, t, d, h=H) -> dict:
    """lstm_route's choice for a shape, with the CUDA sources' own shared-memory
    sizes per CTA (which must equal the route's)."""
    from fvta_memexqa_torch.ops import lstm_fused

    r = lstm_fused.lstm_route(n, t, d, h)
    if r.kernels != lstm_fused.REC_KERNELS:
        return {"kernels": "+".join(r.kernels)}
    threads, fwd, bwd = lstm_fused.rec_geometry(h, r.cluster, r.rows, r.split)
    smem = {stem: getattr(lstm_fused._rec_lib(stem), f"{stem}_smem_bytes")(
        h, r.cluster, r.rows, r.split) for stem in ("lstm_rec", "lstm_rec_bwd")}
    if (smem["lstm_rec"], smem["lstm_rec_bwd"]) != (fwd, bwd):
        fail(f"lstm_route's shared memory {fwd, bwd} differs from the sources' {smem}")
    return {"kernels": "+".join(r.kernels), "cluster": r.cluster, "rows": r.rows,
            "split": r.split, "threads": threads, "smem_fwd": fwd, "smem_bwd": bwd}


def k1_check(device) -> dict:
    """K1 vs its plain version at K1_SHAPES (the Hopper route: lstm_proj +
    lstm_rec, one launch each per call, none of lstm_fwd) and at OLD_SHAPES
    (H = OLD_H: lstm_fwd alone). Returns the worst errors per kernel."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

    worst = {"lstm_proj": 0.0, "lstm_rec": 0.0, "lstm_fwd": 0.0}
    bad = []
    cases = [(name, n, t, d, H) for name, n, t, d, _ in K1_SHAPES]
    cases += [(name, n, t, d, H) for name, n, t, d in LONG_SHAPES]
    cases += [(name, n, t, d, OLD_H) for name, n, t, d in OLD_SHAPES]
    for i, (name, n, t, d, h) in enumerate(cases):
        x, mask, p_fw, p_bw = lstm_case(n, t, d, h, 100 + i, device)
        route = route_info(n, t, d, h)
        old = h == OLD_H
        before = lstm_counters()
        with torch.no_grad():
            out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
            out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
            fin_only = lstm_fused.bilstm_fused_final(p_fw, p_bw, x, mask)
        torch.cuda.synchronize()
        launched = lstm_delta(before)
        want = {k: 0 for k in launched}
        want.update({"lstm_fwd": 2} if old else {"lstm_proj": 2, "lstm_rec": 2})
        errs = [max_err(out, out_r), max_err(fin, fin_r), max_err(fin_only, fin_r)]
        ok = (close(out, out_r, **LSTM_TOL) and close(fin, fin_r, **LSTM_TOL)
              and close(fin_only, fin_r, **LSTM_TOL))
        ok = ok and bool(torch.isfinite(out).all()) and not fin[mask.sum(1) == 0].any()
        ok = ok and launched == want and (route["kernels"] == "+".join(
            lstm_fused.OLD_KERNELS if old else lstm_fused.REC_KERNELS))
        proj_err = 0.0
        if not old:   # the projection alone vs the plain product, at the valid positions
            with torch.no_grad():
                xg = lstm_fused.lstm_proj(x, mask.sum(1, dtype=torch.int32), p_fw, p_bw)
                proj_r = torch.cat([x @ p.wx + p.b for p in (p_fw, p_bw)], dim=-1)
            proj_err = max_err(xg[mask], proj_r[mask])
            ok = ok and close(xg[mask], proj_r[mask], **LSTM_TOL)
            worst["lstm_proj"] = max(worst["lstm_proj"], proj_err)
        log(f"K1 vs plain  {name:22s} N={n:4d} T={t:4d} D={d} H={h}: {json.dumps(route)}; "
            f"launches {json.dumps({k: v for k, v in launched.items() if v})}; max|err| out "
            f"{errs[0]:.3e} fin {errs[1]:.3e} fin-only {errs[2]:.3e} projection "
            f"{proj_err:.3e}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
        key = "lstm_fwd" if old else "lstm_rec"
        worst[key] = max(worst[key], *errs)
    if bad:
        fail(f"K1 disagrees with its plain version at {bad} beyond {LSTM_TOL} (or a "
             "non-finite output / nonzero fin of a length-0 row / another route or launch "
             "count than lstm_route names)")
    return worst


def cudnn_lstm(p_fw, p_bw, forget_bias, d, h, device):
    """torch.nn.LSTM (cuDNN) holding the same function: TF1 gates (i, j, f, o)
    permuted to torch's (i, f, g, o), forget_bias folded into the f bias."""
    import torch

    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True).to(device)
    perm = lambda w: torch.cat([w[..., :h], w[..., 2 * h:3 * h], w[..., h:2 * h],
                                w[..., 3 * h:]], dim=-1)
    with torch.no_grad():
        for sfx, p in (("", p_fw), ("_reverse", p_bw)):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(perm(p.wx).T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(perm(p.wh).T)
            b = perm(p.b).clone()
            b[h:2 * h] += forget_bias
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm.flatten_parameters()
    return lstm


# (set, name, rows, T, D, emit_out): the shapes K1 and K1b are timed at — the 9
# serving calls (K1_SHAPES; the kernels line's K1 totals), the 9 calls of a
# batch-64 train step (K1B_SHAPES, filled in below), the grouped scans' routing
# edges, and the video bilstm encoder's frames (the full-width T=1024 step's
# 8 x 1024 at D=200; `cli video`'s 16 x 1024 at D=116)
def timed_shapes() -> list:
    return ([("serving", name, n, t, d, emit) for name, n, t, d, emit in K1_SHAPES]
            + [("train", name, n, t, d, not fin_only) for name, n, t, d, fin_only in K1B_SHAPES]
            + [("grouped_edge", name, n, t, GROUPED_D, True) for name, n, t in GROUPED_SHAPES
               if name.startswith("edge")]
            + [("video", "frames_T1024", VIDEO_N, CLI_FRAMES, 200, True),
               ("video", "cli_frames_T1024", 16, CLI_FRAMES, 116, True)])


def rec_plain(xg, mask, p_fw, p_bw):
    """The recurrence alone, in plain PyTorch, from the projection xg [N, T, 8H]:
    lstm_rec's plain version (the grouped scans' reference over both directions)."""
    import torch

    from fvta_memexqa_torch.ops.lstm_grouped import grouped_scan_ref
    from fvta_memexqa_torch.ops.lstm_ref import _flip_to_front

    lengths = mask.sum(1)
    h = p_fw.wh.shape[0]
    xp = torch.stack([xg[..., :4 * h], _flip_to_front(xg[..., 4 * h:], lengths)])
    out, fin = grouped_scan_ref(xp, lengths[None].expand(2, -1), torch.stack([p_fw.wh, p_bw.wh]),
                                1.0)
    return torch.cat([out[0], _flip_to_front(out[1], lengths)], dim=-1), torch.cat([*fin], -1)


def k1_bounds(n, t, d, h, steps, emit) -> dict:
    """(bytes ms, operations ms) of the whole K1 function (x, weights → out, fin;
    the projection's work included), of the projection alone (x, wx, b → xg)
    and of the recurrence alone (xg, wh → out, fin), over `steps` valid positions."""
    outs = (n * t * 2 * h if emit else 0) + n * 2 * h
    work = {"fn": (steps * d + n + 2 * (d * 4 * h + h * 4 * h + 4 * h) + outs,
                   2 * steps * (2 * (d + h) * 4 * h + 12 * h)),
            "proj": (steps * d + 2 * (d * 4 * h + 4 * h) + steps * 8 * h, 2 * steps * d * 8 * h),
            "rec": (steps * 8 * h + n + 2 * h * 4 * h + outs, 2 * steps * (2 * h * 4 * h + 12 * h))}
    return {k: (4 * b / HBM_BYTES_PER_S * 1e3, f / FP32_FLOPS * 1e3) for k, (b, f) in work.items()}


def k1_times(device, launches: dict, worst: dict, old_launches: dict) -> tuple[list, list]:
    """Per timed shape: the Hopper route's K1 (bilstm_fused: lstm_proj +
    lstm_rec), each of its kernels alone, the L2-streaming lstm_fwd on the same inputs,
    the plain version, cuDNN's nn.LSTM and the bounds. The kernels-line entries
    (lstm_proj, lstm_rec, lstm_fwd) sum the 9 serving calls."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

    rows = []
    keys = ("new_ms", "proj_ms", "rec_ms", "old_ms", "new_graph_ms",
            "old_graph_ms", "plain_ms", "proj_plain_ms", "proj_library_ms", "rec_plain_ms",
            "library_ms")
    tot = {k: 0.0 for k in keys}
    btot = {k: [0.0, 0.0] for k in ("fn", "proj", "rec")}
    for i, (group, name, n, t, d, emit) in enumerate(timed_shapes()):
        x, mask, p_fw, p_bw = lstm_case(n, t, d, H, 200 + i, device)
        lens = mask.sum(1)
        l32 = lens.to(torch.int32)
        wcat = torch.cat([p_fw.wx, p_bw.wx], dim=1)
        bcat = torch.cat([p_fw.b, p_bw.b])
        with torch.no_grad():
            xg = lstm_fused.lstm_proj(x, l32, p_fw, p_bw)
            row = {"set": group, "name": name, "rows": n, "T": t, "D": d, "emit_out": emit,
                   "route": route_info(n, t, d)}
            k1_new = lambda: lstm_fused.lstm_k1(x, l32, p_fw, p_bw, 1.0, emit)
            k1_old = lambda: lstm_fused.lstm_fwd(x, l32, p_fw, p_bw, 1.0, emit)
            row["new_ms"] = cuda_ms(k1_new)
            row["old_ms"] = cuda_ms(k1_old)
            row["new_graph_ms"] = graph_ms(k1_new)
            row["old_graph_ms"] = graph_ms(k1_old)
            row["proj_ms"] = cuda_ms(lambda: lstm_fused.lstm_proj(x, l32, p_fw, p_bw))
            row["rec_ms"] = cuda_ms(lambda: lstm_fused.lstm_rec(xg, l32, p_fw, p_bw, 1.0, emit))
            row["plain_ms"] = cuda_ms(lambda: lstm_ref.bilstm_ref(p_fw, p_bw, x, mask), iters=5,
                                      warmup=1)
            row["proj_plain_ms"] = cuda_ms(lambda: torch.cat([x @ p.wx + p.b
                                                              for p in (p_fw, p_bw)], -1))
            x2 = x.reshape(n * t, d)
            row["proj_library_ms"] = cuda_ms(lambda: torch.addmm(bcat, x2, wcat))
            row["rec_plain_ms"] = cuda_ms(lambda: rec_plain(xg, mask, p_fw, p_bw), iters=5,
                                          warmup=1)
            lstm = cudnn_lstm(p_fw, p_bw, 1.0, d, H, device)
            live = lens > 0   # packed sequences cannot hold a length-0 row
            packed = pack_padded_sequence(x[live], lens[live].cpu(), batch_first=True,
                                          enforce_sorted=False)
            _, (h_n, _) = lstm(packed)
            fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)[1][live]
            lib_err = max_err(torch.cat([h_n[0], h_n[1]], dim=-1), fin_r)
            if lib_err > 1e-4:
                fail(f"cuDNN LSTM yardstick is not the same function at {name}: {lib_err}")
            row["library_ms"] = cuda_ms(lambda: lstm(packed))
        steps = int(lens.sum())
        bounds = k1_bounds(n, t, d, H, steps, emit)
        row.update(valid_steps=steps, **{f"{k}_bound_ms": max(v) for k, v in bounds.items()})
        row["bound_ms"] = row.pop("fn_bound_ms")
        rows.append(row)
        log(f"K1 times     {group:12s} {name:20s} N={n:4d} T={t:4d} D={d}: new {row['new_ms']:.3f} "
            f"(proj {row['proj_ms']:.3f} + rec {row['rec_ms']:.3f} alone), old "
            f"{row['old_ms']:.3f}; from a CUDA graph new "
            f"{row['new_graph_ms']:.3f} old {row['old_graph_ms']:.3f}; "
            f"cuDNN {row['library_ms']:.3f}, plain {row['plain_ms']:.3f}, bound "
            f"{row['bound_ms']:.4f} ms; route {json.dumps(row['route'])}")
        if group == "serving":
            for k in keys:
                tot[k] += row[k]
            for k, v in bounds.items():
                btot[k][0] += v[0]
                btot[k][1] += v[1]
    work = "the 9 K1 calls of one 64-album ingest batch + one 8-question answer batch (sum)"
    by = lambda k: "bytes" if btot[k][0] >= btot[k][1] else "operations"
    fn_bound = max(btot["fn"])
    entries = [
        {"name": "lstm_proj", "route": "cuda", "source": "fvta_memexqa_torch/csrc/lstm_proj.cuh",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:75", "launches": launches["lstm_proj"],
         "max_abs_err": worst["lstm_proj"], "ms": tot["proj_ms"], "kernel_ms": tot["proj_ms"],
         "plain_ms": tot["proj_plain_ms"], "bound_ms": max(btot["proj"]), "bound_by": by("proj"),
         "library_ms": tot["proj_library_ms"],
         "timed_work": work + "; the projection alone (library: torch.addmm)"},
        {"name": "lstm_rec", "route": "cuda", "source": "fvta_memexqa_torch/csrc/lstm_rec.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:75", "launches": launches["lstm_rec"],
         "max_abs_err": worst["lstm_rec"], "ms": tot["rec_ms"], "kernel_ms": tot["rec_ms"],
         "plain_ms": tot["rec_plain_ms"], "bound_ms": max(btot["rec"]), "bound_by": by("rec"),
         "library_ms": None, "k1_ms": tot["new_ms"], "k1_graph_ms": tot["new_graph_ms"],
         "k1_plain_ms": tot["plain_ms"], "k1_bound_ms": fn_bound,
         "k1_cudnn_ms": tot["library_ms"], "k1_old_ms": tot["old_ms"],
         "k1_old_graph_ms": tot["old_graph_ms"],
         "timed_work": work + "; the recurrence alone on lstm_proj's output; k1_* are the "
                       "whole K1 (lstm_k1: lstm_proj's and lstm_rec's kernels from one call) "
                       "and its yardsticks (max_abs_err too); *_graph_ms: per call replayed "
                       "from a CUDA "
                       "graph (device time without the host's launch work)"},
        {"name": "lstm_fwd", "route": "cuda", "source": "fvta_memexqa_torch/csrc/lstm_fwd.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:75", "launches": 0,
         "launches_past_limit": old_launches["lstm_fwd"], "max_abs_err": worst["lstm_fwd"],
         "ms": tot["old_ms"], "kernel_ms": tot["old_ms"], "graph_ms": tot["old_graph_ms"],
         "plain_ms": tot["plain_ms"], "bound_ms": fn_bound, "bound_by": by("fn"),
         "library_ms": tot["library_ms"],
         "timed_work": work + "; the L2-streaming kernel, which lstm_route sends only H "
                       f"past the largest cluster (max_abs_err at H={OLD_H})"},
    ]
    return entries, rows


# (rows, T): shapes at which route_sweep times every (cluster, rows per tile)
SWEEP_SHAPES = [(3072, 10), (768, 10), (1024, 2), (256, 24), (64, 30), (8, 1024)]


def route_sweep(device) -> list:
    """lstm_rec and lstm_rec_bwd at SWEEP_SHAPES (D=200, H=100) under every
    cluster size and tile height the sources take (the lane split as lstm_route
    would pick it for that pair), launched through the C interface with the
    route forced: what lstm_route's choice is worth against the others. Each
    forced run must give the routed run's results within LSTM_TOL / GRAD_TOL."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused

    f_lib, b_lib = lstm_fused._rec_lib("lstm_rec"), lstm_fused._rec_lib("lstm_rec_bwd")
    out_rows = []
    for i, (n, t) in enumerate(SWEEP_SHAPES):
        x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, 200, 1100 + i, False, device,
                                                     COTANGENT_SCALE)
        lens = mask.sum(1, dtype=torch.int32)
        with torch.no_grad():
            pre, out_r, fin_r, cell = lstm_fused.lstm_k1(x, lens, p_fw, p_bw, 1.0, True,
                                                         emit_cell=True, write_preact=True)
            dg_r = lstm_fused.lstm_rec_bwd(pre, lens, p_fw, p_bw, cell, g_out, g_fin, 1.0)
            xg = lstm_fused.lstm_proj(x, lens, p_fw, p_bw)
        routed = lstm_fused.lstm_route(n, t, 200, H)
        row = {"rows": n, "T": t, "routed": [routed.cluster, routed.rows], "configs": []}
        for c, rows in ((1, 8), (1, 16), (2, 8), (4, 8), (8, 8)):
            split = lstm_fused._split(H, c, rows)
            if split is None:
                continue
            out = torch.empty_like(out_r)
            fin = torch.empty_like(fin_r)
            dg = torch.empty_like(dg_r)
            stream = torch.cuda.current_stream().cuda_stream

            def fwd():
                err = f_lib.lstm_rec(xg.data_ptr(), lens.data_ptr(), p_fw.wh.data_ptr(),
                                     p_bw.wh.data_ptr(), out.data_ptr(), None, fin.data_ptr(),
                                     n, t, H, c, rows, split, 1.0, 0, 1, 0, stream)
                if err:
                    fail(f"forced lstm_rec (C={c}, rows={rows}): error {err}")

            def bwd():
                err = b_lib.lstm_rec_bwd(pre.data_ptr(), lens.data_ptr(), p_fw.wh.data_ptr(),
                                         p_bw.wh.data_ptr(), cell.data_ptr(), g_out.data_ptr(),
                                         g_fin.data_ptr(), dg.data_ptr(), n, t, H, c, rows,
                                         split, 1.0, 1, 0, 0, stream)
                if err:
                    fail(f"forced lstm_rec_bwd (C={c}, rows={rows}): error {err}")

            fwd()
            bwd()
            torch.cuda.synchronize()
            if not (close(out, out_r, **LSTM_TOL) and close(fin, fin_r, **LSTM_TOL)
                    and close(dg, dg_r, **GRAD_TOL)):
                fail(f"route sweep: C={c}, rows={rows} disagrees with the routed kernels at "
                     f"{n} x {t}: out {max_err(out, out_r):.2e} dgates {max_err(dg, dg_r):.2e}")
            row["configs"].append({"cluster": c, "rows": rows, "split": split,
                                   "rec_ms": cuda_ms(fwd), "rec_bwd_ms": cuda_ms(bwd)})
        log("route sweep  " + json.dumps(row))
        out_rows.append(row)
    return out_rows


# ---- K2 -------------------------------------------------------------------------

# (name, (n, s, t, j, d), masked): an answer batch of 8 requests and of one, the
# batch-64 train step, an evaluation batch of 128, a long T, the masked edge
# cases (a dead sequence, an all-masked question, an example with no valid
# context), and S = 1 at the video lengths, which fvta_attention_fused sends to
# the streaming form but the crossover and the streaming-vs-K2 check run on K2
K2_CASES = [("serving", (8, 24, 24, 30, 200), False), ("one_request", (1, 24, 24, 30, 200), False),
            ("train", (64, 24, 24, 30, 200), False), ("evaluation", (128, 24, 24, 30, 200), False),
            ("long_t", (2, 6, 512, 30, 200), False), ("masked", (8, 24, 24, 30, 200), True),
            ("frames_1024", (8, 1, 1024, 30, 200), True),
            ("frames_4096", (8, 1, 4096, 30, 200), True)]
K2_TIMED_N = (1, 8, 64, 128)   # S = T = 24, J = 30, D = 200
# K2's first calls on each command path (phases 4, 7, 16) and the N of every call
K2_PATH_CALLS: dict = {}
K2_PATH_N: dict = {}


def fvta_case(shape, seed, device, masked=False, unbounded=False):
    import torch

    n, s, t, j, d = shape
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, s, t, d, generator=g)
    q = torch.randn(n, j, d, generator=g)
    if not unbounded:
        # context and question states are bi-LSTM outputs on the main path: |h| < 1
        h, q = torch.tanh(h), torch.tanh(q)
    t_len = torch.randint(1, t + 1, (n, s), generator=g)
    j_len = torch.randint(1, j + 1, (n,), generator=g)
    cm = torch.arange(t)[None, None, :] < t_len[..., None]
    qm = torch.arange(j)[None, :] < j_len[:, None]
    if masked:
        if s > 1:
            cm[:, min(3, s - 1), :] = False   # a dead sequence in every example
        qm[min(1, n - 1), :] = False          # an all-masked question row
        cm[min(2, n - 1)] = False             # an example with no valid context at all
    h, q = h * cm[..., None], q * qm[..., None]
    params = {k: torch.randn(d, generator=g).to(device) for k in ("w_x", "w_y", "w_xy")}
    return h.to(device), cm.to(device), q.to(device), qm.to(device), params


def k2_args(h, cm, q, qm, kind, p):
    """fvta_fwd's arguments for one attention call (dot: w_x = w_y = 0, w_xy = 1)."""
    import torch

    d = h.shape[-1]
    if kind == "trilinear":
        w = (p["w_x"], p["w_y"], p["w_xy"])
    else:
        w = (torch.zeros(d, device=h.device), torch.zeros(d, device=h.device),
             torch.ones(d, device=h.device))
    return (h.contiguous(), cm.float(), q.contiguous(), qm.float(), *w)


def k2_run(h, cm, q, qm, kind, p, grad=False):
    """K2 on one call: through fvta_attention_fused below STREAM_MIN_T (under
    grad through its autograd Function, as the train step calls it), directly
    at the long T that fvta_attention_fused sends to the streaming form."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused

    if h.shape[2] >= fvta_fused.STREAM_MIN_T:
        with torch.no_grad():
            return list(fvta_fused.fvta_fwd(*k2_args(h, cm, q, qm, kind, p)))
    with torch.set_grad_enabled(grad):
        hh = h.clone().requires_grad_(grad)
        return [a.detach() for a in fvta_fused.fvta_attention_fused(hh, cm, q, qm, kind, p)]


def k2_plain(h, cm, q, qm, kind, p):
    import torch

    from fvta_memexqa_torch.ops import fvta_ref

    with torch.no_grad():
        return fvta_ref.fvta_attention(h, cm, q, qm, fvta_ref.similarity_tensor(h, q, kind, p))


def k2_check(device) -> float:
    """K2 vs its plain version on K2_CASES, trilinear and dot, one launch of K2
    per call; then the float64 witness at the timed shapes and the video
    lengths."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused

    worst, bad = 0.0, []
    for i, (name, shape, masked) in enumerate(K2_CASES):
        for kind in ("trilinear", "dot"):
            h, cm, q, qm, p = fvta_case(shape, 300 + i, device, masked=masked)
            p = p if kind == "trilinear" else {}
            ref = k2_plain(h, cm, q, qm, kind, p)
            before = fvta_fused.fvta_fwd.launches
            out = k2_run(h, cm, q, qm, kind, p, grad=name == "train")
            torch.cuda.synchronize()
            launched = fvta_fused.fvta_fwd.launches - before
            errs = [max_err(a, b) for a, b in zip(out, ref)]
            ok = (all(close(a, b, **FVTA_TOL) for a, b in zip(out, ref)) and launched == 1
                  and all(bool(torch.isfinite(a).all()) for a in out))
            log(f"K2 vs plain  {name:12s} {kind:9s} N={h.shape[0]} S={h.shape[1]} "
                f"T={h.shape[2]}: max|err| ctx {errs[0]:.3e} q {errs[1]:.3e} "
                f"time {errs[2]:.3e} seq {errs[3]:.3e}; launches {launched}  "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name}/{kind}")
            worst = max(worst, *errs)
    if bad:
        fail(f"K2 disagrees with its plain version at {bad} beyond {FVTA_TOL} (or launched "
             f"other than once)")
    shapes = [(n, 24, 24, 30, 200) for n in K2_TIMED_N] + [c[1] for c in K2_CASES[-2:]]
    return max([worst] + [k2_rounding_witness(f"N={sh[0]} T={sh[2]}", sh, device)
                          for sh in shapes])


def k2_rounding_witness(label, shape, device, seed=300) -> float:
    """K2 on unbounded inputs (h, q ~ N(0, 1), so |C| reaches ~40 and the
    softmaxes are sharp), with the masked edge cases from N = 3: both K2 and the float32
    plain version are held against the float64 plain version. Float32
    rounding moves both by about as much; a kernel fault would put K2 orders
    of magnitude farther. Returns the worst K2 vs float32-plain error."""
    import torch

    worst, bad = 0.0, []
    for kind in ("trilinear", "dot"):
        # the masked edge cases where they leave live examples (N >= 3)
        h, cm, q, qm, p = fvta_case(shape, seed, device, masked=shape[0] >= 3, unbounded=True)
        p = p if kind == "trilinear" else {}
        p64 = {k: v.double() for k, v in p.items()}
        out = k2_run(h, cm, q, qm, kind, p)
        ref = k2_plain(h, cm, q, qm, kind, p)
        ref64 = k2_plain(h.double(), cm, q.double(), qm, kind, p64)
        torch.cuda.synchronize()
        e_k = max(max_err(a, b) for a, b in zip(out, ref64))
        e_p = max(max_err(a, b) for a, b in zip(ref, ref64))
        e_kp = max(max_err(a, b) for a, b in zip(out, ref))
        ok = e_k <= K2_VS_F64_FACTOR * e_p and all(bool(torch.isfinite(a).all()) for a in out)
        log(f"K2 rounding  {label} unbounded {kind:9s} N={h.shape[0]} S={h.shape[1]} "
            f"T={h.shape[2]}: max|err| vs float64 plain: K2 {e_k:.3e}, float32 plain "
            f"{e_p:.3e}; K2 vs float32 plain {e_kp:.3e}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(kind)
        worst = max(worst, e_kp)
    if bad:
        fail(f"K2 is farther from the float64 plain version than "
             f"{K2_VS_F64_FACTOR}x the float32 plain version at {label} {bad}")
    return worst


def k2_path_checks(device) -> dict:
    """K2 on the arguments its first calls got on the serving, train and
    evaluation paths: against the plain version at FVTA_TOL, then unbounded
    N(0, 1) inputs at the same shapes against the float64 witness; and the
    histogram of N over every call of each path."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused, fvta_ref

    out, bad = {}, []
    for path, calls in K2_PATH_CALLS.items():
        hist = K2_PATH_N[path]
        log(f"K2 on the {path} path: {sum(hist.values())} calls, N histogram "
            f"{json.dumps(dict(sorted(hist.items())))}")
        for i, args in enumerate(calls):
            args = [a.detach() for a in args]
            h, cm_f, q, qm_f, wx, wy, wxy = args
            with torch.no_grad():
                ref = fvta_ref.fvta_attention(
                    h, cm_f > 0.5, q, qm_f > 0.5,
                    fvta_ref.similarity_tensor(h, q, "trilinear",
                                               {"w_x": wx, "w_y": wy, "w_xy": wxy}))
                new = fvta_fused.fvta_fwd(*args)
            torch.cuda.synchronize()
            e_ref = [max_err(a, b) for a, b in zip(new, ref)]
            ok = all(close(a, b, **FVTA_TOL) for a, b in zip(new, ref))
            n, s, t, d = h.shape
            label = f"{path} call {i} N={n} S={s} T={t} J={q.shape[1]} D={d}"
            log(f"K2 at the {label}: max|err| vs plain {['%.2e' % e for e in e_ref]}; valid "
                f"context {int((cm_f > 0.5).sum())} of {cm_f.numel()}  "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(label)
            w = k2_rounding_witness(label, (n, s, t, q.shape[1], d), device, seed=310 + i)
            out[f"{path}_{i}"] = {"shape": [n, s, t, q.shape[1], d],
                                  "max_abs_err_vs_plain": max(e_ref),
                                  "witness_k2_vs_f32_plain": w}
        out[f"{path}_n_histogram"] = dict(sorted(hist.items()))
    if bad:
        fail(f"K2 disagrees with plain on recorded path calls: {bad}")
    return out


def k2_bound_ms(h, cm, q, qm) -> tuple[float, float]:
    """(bytes bound, operations bound) in ms of K2 on these inputs: each input
    read once and each output written once over 3.35 TB/s; the FLOPs of the
    valid positions over 67 TFLOP/s FP32."""
    n, s, t, d = h.shape
    j = q.shape[1]
    nbytes = 4 * (h.numel() + cm.numel() + q.numel() + qm.numel() + 3 * d
                  + 2 * n * d + n * s * t + n * s)
    n_ct = cm.sum(dim=(1, 2)).double()     # valid context positions per example
    n_j = qm.sum(dim=1).double()           # valid question words per example
    flops = float((n_ct * n_j * 2 * d + n_ct * 6 * d + n_ct * j * 4).sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def kernel_event_ms(fn, name: str, calls: int = 10, tries: int = 3) -> tuple[float, float]:
    """(device ms of one launch, events seen per call) of the kernel of fn whose
    name contains `name`: the mean duration of its torch.profiler events, from
    the first of up to `tries` traces that saw any."""
    for _ in range(tries):
        kernels, count, _ = profile_kernels(fn, calls)
        hits = [k for k in kernels if name in k]
        if hits:
            return (sum(kernels[k] for k in hits) / sum(count[k] for k in hits),
                    sum(count[k] for k in hits))
    fail(f"torch.profiler saw no {name} event in {tries} traces")


def k2_timing(device) -> dict:
    """K2 at N = 1, 8, 64, 128 (S = T = 24, J = 30, D = 200): times from CUDA
    events (two readings), replayed from a CUDA graph (device time, no host
    work), the kernel's mean event time under torch.profiler (one kernel a
    call: held to at most 1.10x the graph time, which also holds the gaps
    between launches), the plain
    version's time and the bound of each N. Run early in the process: late in
    it the profiler can miss every event of a call."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused

    rows = {}
    for n in K2_TIMED_N:
        h, cm, q, qm, p = fvta_case((n, 24, 24, 30, 200), 400, device)
        args = k2_args(h, cm, q, qm, "trilinear", p)
        new = lambda: fvta_fused.fvta_fwd(*args)
        with torch.no_grad():
            n1, n2 = cuda_ms(new), cuda_ms(new)
            g_new = graph_ms(new)
            e_new, seen_new = kernel_event_ms(new, "k2_cluster_kernel")
            plain = cuda_ms(lambda: k2_plain(h, cm, q, qm, "trilinear", p), iters=10)
        b_ms, o_ms = k2_bound_ms(h, cm, q, qm)
        if e_new > SPLIT_SHARE[1] * g_new:
            fail(f"K2 at N={n}: profiler event time {e_new:.4f} ms exceeds "
                 f"{SPLIT_SHARE[1]}x the CUDA-graph time {g_new:.4f} ms")
        rows[n] = {"new_ms": (n1 + n2) / 2, "new_ms_pair": (n1, n2), "new_graph_ms": g_new,
                   "new_event_ms": e_new, "new_events_per_call": seen_new, "plain_ms": plain,
                   "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else
                   "operations", "geometry": fvta_fused.geometry(n, 24, 24, 30, 200)}
        log(f"K2 at N={n}: {n1:.4f} / {n2:.4f} ms (graph {g_new:.4f}, event {e_new:.4f}), "
            f"plain {plain:.3f} ms, bound {max(b_ms, o_ms):.5f} ms; geometry "
            f"{json.dumps(rows[n]['geometry'])}")
    return rows


def k2_times(rows: dict, launches: dict, worst: float, paths: dict, answer: dict) -> list:
    """The kernels-line entry of K2, from k2_timing's rows (N = 8, an answer
    batch, as the entry's own numbers; every N in per_n)."""
    main = rows[8]
    common = {"route": "cuda", "source": "fvta_memexqa_torch/csrc/fvta_fwd.cu",
              "replaces": "fvta_memexqa_tpu/ops/fvta_pallas.py:57", "plain_ms": main["plain_ms"],
              "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
              "timed_work": "one answer batch: N=8 S=24 T=24 J=30 D=200, trilinear; per_n at "
                            "N = 1, 8, 64, 128"}
    return [
        {"name": "fvta_fwd", **common, "launches": launches["serving"]["fvta_fwd"],
         "launches_by_path": {k: v["fvta_fwd"] for k, v in launches.items()},
         "max_abs_err": worst, "ms": main["new_ms"], "kernel_ms": main["new_ms"],
         "graph_ms": main["new_graph_ms"], "recorded_calls": paths,
         "answer_step_device_ms": answer, "per_n": rows},
    ]


# ---- the slice ------------------------------------------------------------------

class Swapped:
    """module.name replaced by fn inside the block."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn
        self.real = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def profile_serving(engine, store, packed, asks, reps: int = 5) -> dict:
    """Wall time (host clock, synchronized) and device busy time (torch.profiler,
    sum of kernel time) per call of the answer step (QAEngine.answer_batch) for
    one request and for a full micro-batch of 8, and of ingest_pack of the
    64-album pack into a fresh store."""
    from fvta_memexqa_torch.serve import AlbumStore

    def fresh_store():
        fresh = AlbumStore(store.cfg, store.model, store.shared, store.vocab)
        fresh.attach_pack(packed)
        return fresh

    # device_breakdown's calls: a warm-up, `reps` timed, then per trace (at most
    # 3) `reps` before, `reps` measured and `reps` after
    stores = iter([fresh_store() for _ in range(1 + reps + 3 * 3 * reps)])
    work = {
        "answer_1_request": lambda: engine.answer_batch(asks[:1]),
        "answer_8_requests": lambda: engine.answer_batch(asks[:8]),
        "ingest_64_albums": lambda: next(stores).ingest_pack(batch_size=64),
    }
    return {name: device_breakdown(fn, reps) for name, fn in work.items()}


def record_k2_path(path: str, rec: Recorder) -> None:
    """Keep a path's recorded K2 calls and the histogram of their N."""
    K2_PATH_CALLS[path] = rec.calls
    hist = K2_PATH_N.setdefault(path, {})
    for shape in rec.shapes:
        hist[shape[0]] = hist.get(shape[0], 0) + 1


def run_slice(workdir: str) -> dict:
    import numpy as np
    import torch

    from fvta_memexqa_torch.config import Config, DataConfig
    from fvta_memexqa_torch.convert import save_rundir
    from fvta_memexqa_torch.data import make_synthetic, pack
    from fvta_memexqa_torch.models import FVTAModel
    from fvta_memexqa_torch.ops import fvta_fused
    from fvta_memexqa_torch.serve import QAEngine, build_engine

    packdir, rundir = os.path.join(workdir, "pack"), os.path.join(workdir, "run")
    t0 = time.perf_counter()
    qas, albums, feats, test_ids, glove = make_synthetic(**SLICE_CORPUS)
    meta = pack(qas, albums, feats, test_ids, glove, packdir, DataConfig(), seed=0)
    cfg = Config(data=DataConfig(**meta["data_config"]))
    model = FVTAModel(cfg, generator=torch.Generator().manual_seed(0))
    save_rundir(rundir, cfg, model)
    log(f"slice: packed {meta['num_albums']} albums / {len(qas)} questions at "
        f"F={cfg.data.image_feat_dim}, model H={cfg.model.hidden_dim} "
        f"({sum(p.numel() for p in model.parameters())} parameters) in "
        f"{time.perf_counter() - t0:.1f} s")

    # one raw album (not in the pack), ingested through the host packer path
    _, raw_albums, raw_feats, _, _ = make_synthetic(
        num_albums=3, photos_per_album=12, num_questions=3, feat_dim=2537, seed=7)
    raw = dataclasses.replace(next(iter(raw_albums.values())), album_id="raw_album")
    rng = np.random.default_rng(0)
    ids = meta["album_ids"]
    asks = []
    for i, qa in enumerate([q for q in qas if q.question_id in test_ids][:32]):
        extra = [ids[int(k)] for k in rng.choice(len(ids), 3, replace=False)]
        album_ids = list(qa.album_ids) + (["raw_album"] if i % 4 == 0 else []) + extra
        asks.append((qa.question, list(qa.choices), album_ids[:4]))

    zero_lstm_counters()
    t0 = time.perf_counter()
    # K2's first two calls (the warm-up's and the first served batch's) and
    # every call's N are kept
    with Recorder(fvta_fused, "fvta_fwd", keep=2) as k2_calls:
        engine, store, packed = build_engine(packdir, rundir, device="cuda", batch_size=8)
        try:
            store.ingest(raw, raw_feats)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
            results = [None] * len(asks)
            errors = []
            barrier = threading.Barrier(len(asks))

            def worker(i):
                barrier.wait()
                try:
                    results[i] = engine.ask(*asks[i], timeout=300)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(asks))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            concurrent_s = time.perf_counter() - t0
            launches = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches}
        except BaseException:
            engine.close()
            raise
    record_k2_path("serving", k2_calls)
    try:
        stats = dict(engine.stats)
        conc_lat = engine.latency_stats()
        seq_engine = QAEngine(store, batch_size=8)
        try:
            for a in asks[:16]:       # one request at a time: per-request latency
                seq_engine.ask(*a)
            seq_lat = seq_engine.latency_stats()
        finally:
            seq_engine.close()
        breakdown = profile_serving(engine, store, packed, asks)
    finally:
        engine.close()
    if errors:
        fail(f"ask failed on the card: {errors[0]}")
    log(f"slice: launches during the served run {json.dumps(launches)}; "
        f"{stats['questions']} questions in {stats['batches']} micro-batches")
    if launches["fvta_fwd"] == 0:
        fail(f"a kernel of the path never launched on the main path: {launches}")
    check_lstm_launches("serving", launches, backward=False)
    if stats["batches"] >= stats["questions"]:
        fail("no micro-batch formed from the concurrent asks")
    for r in results:
        p = np.asarray(r["probs"])
        if not np.isfinite(p).all() or abs(p.sum() - 1.0) > 1e-5:
            fail(f"bad probs {p}")

    engine_cpu, store_cpu, _ = build_engine(packdir, rundir, device="cpu", batch_size=8)
    try:
        store_cpu.ingest(raw, raw_feats)
        ref = [engine_cpu.ask(*a) for a in asks]
    finally:
        engine_cpu.close()
    d_probs = max(float(np.abs(np.subtract(r["probs"], c["probs"])).max())
                  for r, c in zip(results, ref))
    d_seq = max(float(np.abs(np.subtract(r["seq_attention"], c["seq_attention"])).max())
                for r, c in zip(results, ref))
    flips = 0
    for r, c in zip(results, ref):
        if r["answer_index"] != c["answer_index"]:
            top2 = np.sort(c["probs"])[-2:]
            if top2[1] - top2[0] > ENGINE_TOL:
                fail(f"answer differs from the CPU engine: {r} vs {c}")
            flips += 1
    log(f"slice: card vs CPU engine over {len(asks)} questions: max|d probs| "
        f"{d_probs:.3e}, max|d seq_attention| {d_seq:.3e}, answers equal "
        f"{len(asks) - flips}/{len(asks)} (near-ties {flips})")
    if d_probs > ENGINE_TOL or d_seq > ENGINE_TOL:
        fail(f"card engine disagrees with the CPU engine beyond {ENGINE_TOL}")
    return {"launches": launches, "ingest_and_warmup_s": ingest_s,
            "concurrent_32_asks_s": concurrent_s, "concurrent_latency_ms": conc_lat,
            "sequential_latency_ms": seq_lat, "micro_batches": stats["batches"],
            "breakdown": breakdown,
            "max_abs_d_probs_vs_cpu": d_probs, "max_abs_d_seq_attention_vs_cpu": d_seq}


# ---- K1b --------------------------------------------------------------------------

# (name, rows, T, D, fin_only): the nine bi-LSTM calls of one batch-64 train
# step (A = 4): photo titles (256·12 rows, 2688 under dedup), the six time
# encoders over 256 album slots, the question, the choices
K1B_SHAPES = [
    ("photo_title_words", 256 * 12, 10, 200, True),
    ("enc_photo", 256, 12, 200, False),
    ("enc_photo_title", 256, 12, 200, False),
    ("enc_album_title", 256, 24, 200, False),
    ("enc_album_desc", 256, 24, 200, False),
    ("enc_when", 256, 24, 200, False),
    ("enc_where", 256, 24, 200, False),
    ("question", 64, 30, 200, False),
    ("choices", 64 * 4, 8, 200, True),
]
K1B_EXTRA = [("photo_title_words_dedup", 2688, 10, 200, True)]
GRAD_NAMES = ("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw")


def cotangent_probe(packdir: str) -> dict:
    """The cotangents that really reach K1b: one plain and one dedup train step
    (the default config, dropout on) on the slice's pack, with every K1b call
    recording max and mean |g_out| over valid positions and |g_fin| over rows of
    length > 0. Keyed by "rows x T" (calls of one shape pooled). These launches
    come before the main path's run and are not counted."""
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.config import Config
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.ops import lstm_fused

    packed = load_pack(packdir)
    cfg = Config(data=packed.cfg)
    shared = SharedTables.from_packed(packed.shared, "cuda")
    state = tr.init_state(cfg, "cuda")
    batch = next(Dataset(packed, "train").get_batches(64, shuffle=True, seed=0, epoch=0))
    dd = tr.dedup_album_batch(batch.album_idx.numpy(), tr.dedup_u_cap(cfg))
    if dd is None:
        fail("the probe batch has more distinct albums than the dedup buffer")
    uniq, inv = (torch.from_numpy(a).cuda() for a in dd)
    b = batch.to("cuda")
    params = list(state.params.values())
    with Recorder(lstm_fused, "lstm_rec_bwd") as rec:
        loss, _ = tr.loss_and_metrics(state.model, shared, b, True, state.generator)
        torch.autograd.grad(loss, params)
        loss, _ = tr.loss_and_metrics(state.model, shared, b, True, state.generator,
                                      dd=(uniq, inv))
        torch.autograd.grad(loss, params)
    seen: dict[str, dict] = {}
    for pre, lengths, _, _, _, g_out, g_fin, _ in rec.calls:
        n, t = pre.shape[:2]
        live = torch.arange(t, device=pre.device)[None, :] < lengths[:, None]
        r = seen.setdefault(f"{n}x{t}", {"calls": 0, "g_out_max": 0.0, "g_out_sum": 0.0,
                                         "g_out_n": 0, "g_fin_max": 0.0, "g_fin_sum": 0.0,
                                         "g_fin_n": 0})
        r["calls"] += 1
        for key, g, valid in (("g_out", g_out, live), ("g_fin", g_fin, live.any(1))):
            if g is not None and valid.any():
                a = g[valid].abs()
                r[f"{key}_max"] = max(r[f"{key}_max"], float(a.max()))
                r[f"{key}_sum"] += float(a.sum())
                r[f"{key}_n"] += a.numel()
    out = {}
    for key, r in seen.items():
        out[key] = {"calls": r["calls"], "g_out_max": r["g_out_max"],
                    "g_out_mean": r["g_out_sum"] / max(r["g_out_n"], 1),
                    "g_fin_max": r["g_fin_max"],
                    "g_fin_mean": r["g_fin_sum"] / max(r["g_fin_n"], 1)}
        log(f"cotangents at K1b {key:8s} ({r['calls']} calls): |g_out| max "
            f"{out[key]['g_out_max']:.3e} mean {out[key]['g_out_mean']:.3e}; |g_fin| max "
            f"{out[key]['g_fin_max']:.3e} mean {out[key]['g_fin_mean']:.3e}")
    missing = [f"{n}x{t}" for _, n, t, _, _ in K1B_SHAPES + K1B_EXTRA if f"{n}x{t}" not in out]
    if missing:
        fail(f"no K1b call of the train step at the checked shapes {missing}")
    largest = max(max(r["g_out_max"], r["g_fin_max"]) for r in out.values())
    if not 0 < largest <= COTANGENT_SCALE:
        fail(f"the train step's largest cotangent at K1b, {largest}, is not within "
             f"(0, {COTANGENT_SCALE}], the scale of the K1b check")
    return out


def k1b_case(n, t, d, seed, fin_only, device, scale, h=H):
    import torch

    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    g_fin = (torch.randn(n, 2 * h, generator=g) * scale).to(device)
    g_out = None if fin_only else (torch.randn(n, t, 2 * h, generator=g) * scale).to(device)
    return x, mask, p_fw, p_bw, g_out, g_fin


def lstm_grads(fn, x, p_fw, p_bw, g_out, g_fin):
    """fn(p_fw, p_bw, x) → (out or None, fin) under grad; returns (out or None,
    fin) and the gradients of <out, g_out> + <fin, g_fin> w.r.t. x and both
    directions' weights."""
    import torch

    from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

    leaves = [a.detach().clone().requires_grad_() for a in (x, *p_fw, *p_bw)]
    out, fin = fn(LSTMParams(*leaves[1:4]), LSTMParams(*leaves[4:]), leaves[0])
    loss = (fin * g_fin).sum() + (0 if g_out is None else (out * g_out).sum())
    grads = torch.autograd.grad(loss, leaves)
    return (None if out is None else out.detach()), fin.detach(), grads


def fused_fn(mask, fin_only):
    from fvta_memexqa_torch.ops import lstm_fused

    if fin_only:
        return lambda pf, pb, x: (None, lstm_fused.bilstm_fused_final(pf, pb, x, mask))
    return lambda pf, pb, x: lstm_fused.bilstm_fused(pf, pb, x, mask)


def k1b_check(device) -> dict:
    """K1b vs plain autograd at K1B_SHAPES + K1B_EXTRA + LONG_SHAPES (the Hopper
    route: one launch each of lstm_proj, lstm_rec, lstm_rec_bwd per forward +
    backward) and at OLD_SHAPES (H = OLD_H: lstm_fwd and lstm_bwd); then the float64 witness
    and the cell / pre-activation check. Returns the worst gradient errors."""
    import torch

    from fvta_memexqa_torch.ops import lstm_ref

    worst, bad = {"lstm_rec_bwd": 0.0, "lstm_bwd": 0.0}, []
    cases = [(name, n, t, d, fo, H) for name, n, t, d, fo in K1B_SHAPES + K1B_EXTRA]
    cases += [(name, n, t, d, False, H) for name, n, t, d in LONG_SHAPES]
    cases += [(name, n, t, d, False, OLD_H) for name, n, t, d in OLD_SHAPES]
    for i, (name, n, t, d, fin_only, h) in enumerate(cases):
        old = h == OLD_H
        for label, fo in (("fin", True), ("out+fin", False)) if not fin_only else (("fin", True),):
            x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, 500 + i, fo, device,
                                                         COTANGENT_SCALE, h)
            plain = lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask)
            out_r, fin_r, ref = lstm_grads(plain, x, p_fw, p_bw, g_out, g_fin)
            before = lstm_counters()
            out_k, fin_k, got = lstm_grads(fused_fn(mask, fin_only), x, p_fw, p_bw, g_out, g_fin)
            torch.cuda.synchronize()
            launched = lstm_delta(before)
            want = {k: int(k in (OLD_KERNELS if old else NEW_KERNELS)) for k in launched}
            # K1 under grad (with cells; pre-activations on the Hopper route) at this shape
            fwd_ok = close(fin_k, fin_r, **LSTM_TOL) and (
                out_k is None or close(out_k, out_r, **LSTM_TOL))
            fwd_err = max(max_err(fin_k, fin_r), 0.0 if out_k is None else max_err(out_k, out_r))
            errs = [max_err(a, b) for a, b in zip(got, ref)]
            ok = fwd_ok and all(close(a, b, **GRAD_TOL) for a, b in zip(got, ref))
            ok = ok and all(bool(torch.isfinite(a).all()) for a in got)
            ok = ok and not got[0][~mask].any() and launched == want
            log(f"K1b vs plain {name:23s} {label:7s} N={n:4d} T={t:4d} H={h}: launches "
                f"{json.dumps({k: v for k, v in launched.items() if v})}; "
                f"K1 out/fin {fwd_err:.2e}; max|err| "
                + " ".join(f"{nm} {e:.2e}" for nm, e in zip(GRAD_NAMES, errs))
                + f"  {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name}/{label}")
            key = "lstm_bwd" if old else "lstm_rec_bwd"
            worst[key] = max(worst[key], *errs)
    if bad:
        fail(f"K1b (or K1's out/fin under grad) disagrees with plain autograd at {bad} "
             f"beyond {GRAD_TOL} (grads) / {LSTM_TOL} (out, fin), or another route launched")
    k1b_rounding_witness(device)
    k1_cell_check(device)
    return worst


def k1b_rounding_witness(device) -> None:
    """Unit-scale N(0, 1) cotangents at the ten train shapes and the two video
    frame shapes: K1b and the float32 plain version both against the float64
    plain version."""
    import torch

    from fvta_memexqa_torch.ops import lstm_ref

    bad = []
    cases = K1B_SHAPES + K1B_EXTRA + [(name, n, t, d, False) for name, n, t, d in LONG_SHAPES]
    for i, (name, n, t, d, fin_only) in enumerate(cases):
        x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, 600 + i, fin_only, device, 1.0)
        plain = lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask)
        ref = lstm_grads(plain, x, p_fw, p_bw, g_out, g_fin)[2]
        d64 = lambda p: lstm_ref.LSTMParams(*(a.double() for a in p))
        ref64 = lstm_grads(plain, x.double(), d64(p_fw), d64(p_bw),
                           None if g_out is None else g_out.double(), g_fin.double())[2]
        got = lstm_grads(fused_fn(mask, fin_only), x, p_fw, p_bw, g_out, g_fin)[2]
        torch.cuda.synchronize()
        worst_ratio, line = 0.0, []
        for nm, a, b, c in zip(GRAD_NAMES, got, ref, ref64):
            share, note = f64_witness(a, b, c)
            worst_ratio = max(worst_ratio, share)
            line.append(f"{nm} {note}")
        ok = worst_ratio <= 1.0
        log(f"K1b rounding {name:23s} unit-scale N={n:4d} T={t:4d}: max|err| vs float64, "
            f"K1b/float32 plain: {' '.join(line)}; worst share of limit {worst_ratio:.2f}  "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
    if bad:
        fail(f"K1b is farther from the float64 plain version than "
             f"{F64_FACTOR}x the float32 plain version (+{F64_ULPS} ulps) at {bad}")


def k1_cell_check(device) -> None:
    """K1's training outputs at K1B_SHAPES and LONG_SHAPES: lstm_rec's cells
    against the plain scan's carried c and its saved pre-activations against
    the plain gates (valid positions); and lstm_fwd's cells at OLD_SHAPES."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

    bad = []
    cases = [(name, n, t, d, H) for name, n, t, d, _ in K1B_SHAPES]
    cases += [(name, n, t, d, H) for name, n, t, d in LONG_SHAPES]
    cases += [(name, n, t, d, OLD_H) for name, n, t, d in OLD_SHAPES]
    worst = {"cell": 0.0, "preact": 0.0}
    for i, (name, n, t, d, h) in enumerate(cases):
        x, mask, p_fw, p_bw = lstm_case(n, t, d, h, 700 + i, device)
        lens = mask.sum(1, dtype=torch.int32)
        with torch.no_grad():
            ref = lstm_ref.bilstm_cells_ref(p_fw, p_bw, x, mask)
            if h == OLD_H:
                cell = lstm_fused.lstm_fwd(x, lens, p_fw, p_bw, 1.0, False, emit_cell=True)[2]
            else:
                pre = lstm_fused.lstm_proj(x, lens, p_fw, p_bw)
                cell = lstm_fused.lstm_rec(pre, lens, p_fw, p_bw, 1.0, False, emit_cell=True,
                                           write_preact=True)[2]
                gates = lstm_ref.bilstm_gates_ref(p_fw, p_bw, x, mask)
                worst["preact"] = max(worst["preact"], max_err(pre[mask], gates[mask]))
                if not close(pre[mask], gates[mask], **LSTM_TOL):
                    bad.append(f"{name} pre-activations ({max_err(pre[mask], gates[mask]):.2e})")
        torch.cuda.synchronize()
        worst["cell"] = max(worst["cell"], max_err(cell, ref))
        if not close(cell, ref, **LSTM_TOL):
            bad.append(f"{name} cells ({max_err(cell, ref):.2e})")
    log(f"K1 cell output vs the plain scan's carried c, and lstm_rec's saved pre-activations "
        f"vs the plain gates, at {len(cases)} shapes: max|err| {json.dumps(worst)}  "
        f"{'ok' if not bad else 'MISMATCH ' + str(bad)}")
    if bad:
        fail(f"K1's cells or pre-activations disagree with the plain version at {bad}")


def k1b_times(device, launches: dict, worst: dict, old_launches: dict) -> tuple[list, list]:
    """Per train-step shape (K1B_SHAPES), routing edge and the video frames:
    the Hopper route's K1b (lstm_rec_bwd on lstm_rec's saved pre-activations),
    the L2-streaming lstm_bwd (on lstm_fwd's out and cells) on the same inputs, the whole
    backward through `_BiLSTMFn` (K1b + the four products), the plain backward,
    cuDNN's backward, the Hopper forward under grad against lstm_fwd's, and the
    bounds. The kernels-line entries sum the 9 calls of a batch-64 train step."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

    shapes = [("train", name, n, t, d, fo) for name, n, t, d, fo in K1B_SHAPES]
    shapes += [(group, name, n, t, d, not emit) for group, name, n, t, d, emit in timed_shapes()
               if group in ("grouped_edge", "video")]
    rows, tot = [], {k: 0.0 for k in ("new_ms", "old_ms", "new_graph_ms", "old_graph_ms",
                                       "fwd_grad_new_ms", "fwd_grad_old_ms",
                                       "fn_ms", "plain_ms", "library_ms", "bound_ms",
                                       "old_bound_ms", "bytes_ms", "ops_ms", "old_bytes_ms",
                                       "old_ops_ms")}
    for i, (group, name, n, t, d, fin_only) in enumerate(shapes):
        x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, 800 + i, fin_only, device,
                                                     COTANGENT_SCALE)
        lens = mask.sum(1, dtype=torch.int32)
        with torch.no_grad():
            fwd_new = lambda: lstm_fused.lstm_k1(x, lens, p_fw, p_bw, 1.0, True, emit_cell=True,
                                                 write_preact=True)
            fwd_old = lambda: lstm_fused.lstm_fwd(x, lens, p_fw, p_bw, 1.0, True, emit_cell=True)
            pre = lstm_fused.lstm_proj(x, lens, p_fw, p_bw)
            _, _, cell = lstm_fused.lstm_rec(pre, lens, p_fw, p_bw, 1.0, True, emit_cell=True,
                                             write_preact=True)
            out_o, _, cell_o = fwd_old()
            row = {"set": group, "name": name, "rows": n, "T": t, "D": d, "fin_only": fin_only,
                   "route": route_info(n, t, d)}
            k1b_new = lambda: lstm_fused.lstm_rec_bwd(pre, lens, p_fw, p_bw, cell, g_out, g_fin,
                                                      1.0)
            k1b_old = lambda: lstm_fused.lstm_bwd(x, lens, p_fw, p_bw, out_o, cell_o, g_out,
                                                  g_fin, 1.0)
            row["new_ms"] = cuda_ms(k1b_new)
            row["old_ms"] = cuda_ms(k1b_old)
            row["new_graph_ms"] = graph_ms(k1b_new)
            row["old_graph_ms"] = graph_ms(k1b_old)
            row["fwd_grad_new_ms"] = cuda_ms(fwd_new)
            row["fwd_grad_old_ms"] = cuda_ms(fwd_old)
        # K1b and the four products: the whole backward of the autograd Function
        leaves = [a.detach().clone().requires_grad_() for a in (x, *p_fw, *p_bw)]
        o_k, f_k = lstm_fused._BiLSTMFn.apply(leaves[0], lens, 1.0, *leaves[1:])
        loss_k = (f_k * g_fin).sum() + (0 if g_out is None else (o_k * g_out).sum())
        row["fn_ms"] = cuda_ms(lambda: torch.autograd.grad(loss_k, leaves, retain_graph=True))
        o_r, f_r = lstm_ref.bilstm_ref(lstm_ref.LSTMParams(*leaves[1:4]),
                                       lstm_ref.LSTMParams(*leaves[4:]), leaves[0], mask)
        loss_r = (f_r * g_fin).sum() + (0 if g_out is None else (o_r * g_out).sum())
        row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(loss_r, leaves, retain_graph=True),
                                  iters=5, warmup=1)
        # cuDNN: forward + backward minus forward, on packed sequences (no
        # length-0 rows), the same function (cudnn_lstm), a yardstick only
        lstm = cudnn_lstm(p_fw, p_bw, 1.0, d, H, device)
        live = lens > 0
        xl = x[live].detach().clone().requires_grad_()
        gf = g_fin[live].reshape(-1, 2, H).transpose(0, 1)
        go = None if g_out is None else g_out[live]

        def cudnn_fwd():
            packed = pack_padded_sequence(xl, lens[live].cpu(), batch_first=True,
                                          enforce_sorted=False)
            o, (h_n, _) = lstm(packed)
            loss = (h_n * gf).sum()
            if go is not None:
                loss = loss + (pad_packed_sequence(o, batch_first=True,
                                                   total_length=t)[0] * go).sum()
            return loss

        def cudnn_fwd_bwd():
            torch.autograd.grad(cudnn_fwd(), [xl, *lstm.parameters()])

        row["library_ms"] = max(cuda_ms(cudnn_fwd_bwd) - cuda_ms(cudnn_fwd), 0.0)
        steps = int(lens.sum())
        g_bytes = 2 * steps * H if g_out is not None else 0
        # the Hopper K1b: pre-activations, cells, cotangents and wh in, dgates out
        nbytes = 4 * (steps * 8 * H + n + 2 * H * 4 * H + 2 * steps * H + g_bytes + n * 2 * H
                      + n * t * 8 * H)
        flops = 2 * steps * (2 * 4 * H * H + 30 * H)
        # lstm_bwd: x, the weights, out and cells in; recomputes the pre-activations
        old_bytes = 4 * (steps * d + n + 2 * (d * 4 * H + 2 * H * 4 * H + 4 * H)
                         + 2 * 2 * steps * H + g_bytes + n * 2 * H + n * t * 8 * H)
        old_flops = 2 * steps * (2 * (d + H) * 4 * H + 2 * 4 * H * H + 30 * H)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        ob_ms, oo_ms = old_bytes / HBM_BYTES_PER_S * 1e3, old_flops / FP32_FLOPS * 1e3
        row.update(valid_steps=steps, bound_ms=max(b_ms, o_ms), old_bound_ms=max(ob_ms, oo_ms),
                   bound_by="bytes" if b_ms >= o_ms else "operations")
        rows.append(row)
        log(f"K1b times    {group:12s} {name:23s} N={n:4d} T={t:4d}: new {row['new_ms']:.3f}, "
            f"old {row['old_ms']:.3f}; from a CUDA graph new {row['new_graph_ms']:.3f} old "
            f"{row['old_graph_ms']:.3f}; whole backward {row['fn_ms']:.3f}, cuDNN backward "
            f"{row['library_ms']:.3f}, plain {row['plain_ms']:.3f}, bound {row['bound_ms']:.4f} "
            f"(old {row['old_bound_ms']:.4f}); forward under grad new "
            f"{row['fwd_grad_new_ms']:.3f} old {row['fwd_grad_old_ms']:.3f} ms")
        if group == "train":
            for k in ("new_ms", "old_ms", "new_graph_ms", "old_graph_ms", "fwd_grad_new_ms",
                      "fwd_grad_old_ms", "fn_ms",
                      "plain_ms", "library_ms", "bound_ms", "old_bound_ms"):
                tot[k] += row[k]
            tot["bytes_ms"] += b_ms
            tot["ops_ms"] += o_ms
            tot["old_bytes_ms"] += ob_ms
            tot["old_ops_ms"] += oo_ms
    work = ("the 9 K1b calls of one batch-64 train step (sum); plain_ms and library_ms are "
            "whole backwards (dW products included), as is backward_fn_ms (K1b + the four "
            "products, Hopper route)")
    entries = [
        {"name": "lstm_rec_bwd", "route": "cuda",
         "source": "fvta_memexqa_torch/csrc/lstm_rec_bwd.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:121",
         "launches": launches["lstm_rec_bwd"], "max_abs_err": worst["lstm_rec_bwd"],
         "ms": tot["new_ms"], "kernel_ms": tot["new_ms"], "graph_ms": tot["new_graph_ms"],
         "backward_fn_ms": tot["fn_ms"],
         "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
         "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
         "library_ms": tot["library_ms"], "forward_under_grad_ms": tot["fwd_grad_new_ms"],
         "timed_work": work},
        {"name": "lstm_bwd", "route": "cuda", "source": "fvta_memexqa_torch/csrc/lstm_bwd.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:121", "launches": 0,
         "launches_past_limit": old_launches["lstm_bwd"], "max_abs_err": worst["lstm_bwd"],
         "ms": tot["old_ms"], "kernel_ms": tot["old_ms"], "graph_ms": tot["old_graph_ms"],
         "plain_ms": tot["plain_ms"], "bound_ms": tot["old_bound_ms"],
         "bound_by": "bytes" if tot["old_bytes_ms"] >= tot["old_ops_ms"] else "operations",
         "library_ms": tot["library_ms"], "forward_under_grad_ms": tot["fwd_grad_old_ms"],
         "timed_work": work + "; the L2-streaming kernel, which lstm_route sends only H "
                       f"past the largest cluster (max_abs_err at H={OLD_H})"},
    ]
    return entries, rows


# ---- the train slice --------------------------------------------------------------

def read_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_run(packdir: str, rundir: str, dedup: bool) -> dict:
    """`cli train` on the card for TRAIN_STEPS steps (log every step, val every
    12), the launch counters zeroed just before and read just after."""
    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch.ops import fvta_fused

    zero_lstm_counters()
    t0 = time.perf_counter()
    with Recorder(fvta_fused, "fvta_fwd", keep=0 if dedup else 1) as k2_calls:
        cli.main(["train", packdir, rundir, "--num-steps", str(TRAIN_STEPS), "--val-period",
                  "12", "--log-period", "1", "--save-period", "1000", "--device", "cuda",
                  "--dedup-albums", "true" if dedup else "false"])
        wall = time.perf_counter() - t0
        launches = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches}
    record_k2_path("train_dedup" if dedup else "train", k2_calls)
    recs = read_metrics(os.path.join(rundir, "metrics.jsonl"))
    train_recs = [r for r in recs if r["event"] == "train"]
    losses = [r["loss"] for r in train_recs]
    by_epoch: dict[int, list[float]] = {}
    for r in train_recs:
        by_epoch.setdefault(r["epoch"], []).append(r["loss"])
    epochs = sorted(by_epoch)
    first, last = (sum(by_epoch[e]) / len(by_epoch[e]) for e in (epochs[0], epochs[-1]))
    vals = [r for r in recs if r["event"] == "val"]
    tag = "dedup" if dedup else "plain"
    log(f"train ({tag}): {len(losses)} steps in {wall:.1f} s over epochs {epochs}; "
        f"launches {json.dumps(launches)}; mean loss first epoch {first:.4f}, last "
        f"{last:.4f}; val {[(v['step'], round(v['acc'], 4)) for v in vals]}")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train ({tag}): losses not finite or steps missing: {losses}")
    if launches["fvta_fwd"] == 0:
        fail(f"train ({tag}): a kernel of the path never launched: {launches}")
    check_lstm_launches(f"train ({tag})", launches, backward=True)
    if len(epochs) < 2 or not last < first:
        fail(f"train ({tag}): the last epoch's mean loss {last} is not below the "
             f"first's {first}")
    if not vals:
        fail(f"train ({tag}): no validation ran")
    return {"steps": len(losses), "wall_s": wall, "launches": launches,
            "loss_first_epoch": first, "loss_last_epoch": last, "epochs": len(epochs),
            "val": [(v["step"], v["acc"]) for v in vals]}


def predict_check(packdir: str, rundir: str) -> dict:
    import contextlib
    import io

    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch.data.pack import load_pack

    meta = load_pack(packdir, load_splits=False).meta
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", packdir, rundir, "--question", "what year was the trip ?",
                  "--choices", "2007|2009|2011|2013", "--album-ids", meta["album_ids"][0],
                  "--device", "cuda"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"predict on the trained run directory: {json.dumps(res)[:160]}")
    if not (math.isfinite(sum(res["probs"])) and abs(sum(res["probs"]) - 1.0) < 1e-5
            and res["albums_found"] == 1):
        fail(f"cli predict on the trained run directory: {res}")
    return res


def step_parity(packdir: str) -> dict:
    """The card vs the CPU from the same weights and batch at keep_prob 1:
    step-1 gradients per parameter tensor, the losses of 3 steps; and on the
    card the dedup step vs the plain step."""
    import numpy as np
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.config import Config, ModelConfig
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.optim import Optimizer

    packed = load_pack(packdir)
    cfg = Config(data=packed.cfg, model=ModelConfig(keep_prob=1.0))
    ds = Dataset(packed, "train")
    batches = list(itertools.islice(ds.get_batches(64, shuffle=True, seed=0, epoch=0), 3))
    runs = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_state(cfg, dev)
        shared = SharedTables.from_packed(packed.shared, dev)
        loss = tr.loss_and_metrics(state.model, shared, batches[0].to(dev), True,
                                   state.generator)[0]
        names = list(state.params)
        grads = dict(zip(names, (g.cpu() for g in torch.autograd.grad(
            loss, list(state.params.values())))))
        # loss's graph holds the parameters' AccumulateGrad nodes; alive, they would
        # meet train_step's CUDA-graph capture below
        del loss
        opt = Optimizer(cfg.train)
        losses = [float(tr.train_step(state, opt, shared, b.to(dev))["loss"])
                  for b in batches]
        runs[dev] = (grads, losses, state, shared)
    g_cpu, l_cpu = runs["cpu"][:2]
    g_gpu, l_gpu = runs["cuda"][:2]
    rel = {k: float((g_gpu[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()),
                                                              1e-30)
           for k in g_cpu if k not in EXACT_ZERO_GRADS}
    worst_name = max(rel, key=rel.get)
    worst = rel[worst_name]
    zero = {k: max(float(g_cpu[k].abs().max()), float(g_gpu[k].abs().max()))
            for k in EXACT_ZERO_GRADS}
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    log(f"card vs CPU, step 1 of {len(rel)} parameter tensors: worst "
        f"max|dg|/max|g_cpu| {worst:.2e} ({worst_name}); exact-zero gradients "
        f"{ {k: f'{v:.1e}' for k, v in zero.items()} }; losses of 3 steps card "
        f"{l_gpu} CPU {l_cpu}, worst relative difference {d_loss:.2e}")
    if worst > STEP_TOL or d_loss > STEP_TOL or max(zero.values()) > ZERO_GRAD_ATOL:
        fail(f"the card's train step disagrees with the CPU's beyond {STEP_TOL}")

    # dedup vs plain on the card, same weights, same batch
    state = tr.init_state(cfg, "cuda")
    shared = runs["cuda"][3]
    b = batches[0].to("cuda")
    dd = tr.dedup_album_batch(batches[0].album_idx.numpy(), tr.dedup_u_cap(cfg))
    if dd is None:
        fail("the parity batch has more distinct albums than the dedup buffer")
    uniq, inv = (torch.from_numpy(a).cuda() for a in dd)
    params = list(state.params.values())
    lp, _ = tr.loss_and_metrics(state.model, shared, b, True, state.generator)
    gp = torch.autograd.grad(lp, params)
    ld, _ = tr.loss_and_metrics(state.model, shared, b, True, state.generator,
                                dd=(uniq, inv))
    gd = torch.autograd.grad(ld, params)
    names = list(state.params)
    worst_dd = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                   for n, a, c in zip(names, gd, gp) if n not in EXACT_ZERO_GRADS)
    worst_dd_zero = max(float(a.abs().max()) for n, a in zip(names, gd)
                        if n in EXACT_ZERO_GRADS)
    ld, lp = float(ld.detach()), float(lp.detach())
    d_loss_dd = abs(ld - lp) / abs(lp)
    log(f"dedup vs plain step on the card ({int(np.count_nonzero(dd[0]))} distinct "
        f"albums of {dd[1].size} slots): loss {ld:.6f} vs {lp:.6f}, "
        f"worst max|dg|/max|g| {worst_dd:.2e}")
    if worst_dd > STEP_TOL or d_loss_dd > STEP_TOL or worst_dd_zero > ZERO_GRAD_ATOL:
        fail(f"the dedup step disagrees with the plain step beyond {STEP_TOL}")
    return {"grad_rel_err_vs_cpu": worst, "loss_rel_err_vs_cpu": d_loss,
            "dedup_vs_plain_grad_rel_err": worst_dd}


def checkpoint_leaves(ck: dict) -> dict:
    """A checkpoint's parameter and optimizer tensors by dotted name."""
    import torch

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        elif isinstance(tree, torch.Tensor):
            yield prefix[:-1], tree

    return dict(leaves({"params": ck["params"], "opt": ck["opt_state"]}))


def resume_check(packdir: str, workdir: str) -> dict:
    """6 steps straight vs 3 steps + resume to 6 (dropout on): every parameter
    and optimizer tensor of step 6 torch.equal."""
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.checkpoint import CheckpointManager
    from fvta_memexqa_torch.data.pack import load_pack

    from fvta_memexqa_torch.config import Config

    packed = load_pack(packdir)
    cfg = Config(data=packed.cfg)
    straight, resumed = os.path.join(workdir, "straight"), os.path.join(workdir, "resumed")
    tr.train(cfg, packed, straight, num_steps=6, echo=False, device="cuda")
    tr.train(cfg, packed, resumed, num_steps=3, echo=False, device="cuda")
    tr.train(cfg, packed, resumed, num_steps=6, echo=False, device="cuda")
    a = CheckpointManager(straight).load(step=6)
    b = CheckpointManager(resumed).load(step=6)

    la, lb = checkpoint_leaves(a), checkpoint_leaves(b)
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    log(f"resume on the card: 6 steps straight vs 3 + resume to 6: {len(la)} tensors, "
        f"{len(differ)} differ; rng state equal {torch.equal(a['rng'], b['rng'])}")
    if differ or set(la) != set(lb) or not torch.equal(a["rng"], b["rng"]):
        fail(f"resume is not bitwise: {differ[:5]}")
    return {"tensors": len(la), "bitwise": True}


def profile_train(packdir: str) -> dict:
    """Plain and dedup step times (host clock over synchronized runs of 10
    steps, after 3 warm-up steps), and torch.profiler over one plain step."""
    import numpy as np
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.config import Config
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.optim import Optimizer

    packed = load_pack(packdir)
    cfg = Config(data=packed.cfg)
    shared = SharedTables.from_packed(packed.shared, "cuda")
    state = tr.init_state(cfg, "cuda")
    opt = Optimizer(cfg.train)
    ds = Dataset(packed, "train")
    host = list(itertools.islice(itertools.cycle(ds.get_batches(64, shuffle=True)), 13))
    u_cap = tr.dedup_u_cap(cfg)
    plain = lambda b: tr.train_step(state, opt, shared, b.to("cuda"))

    def dedup(b):
        dd = tr.dedup_album_batch(b.album_idx.numpy(), u_cap)
        if dd is None:
            return plain(b)
        return tr.train_step(state, opt, shared, b.to("cuda"),
                             tuple(torch.from_numpy(a).cuda() for a in dd))

    times = {}
    with tr.deterministic_algorithms(torch.device("cuda")):
        for name, fn in (("plain", plain), ("dedup", dedup), ("plain_again", plain)):
            for b in host[:3]:
                fn(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            per = []
            for b in host[3:]:
                t0 = time.perf_counter()
                fn(b)
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3)
            times[name] = {"p50_step_ms": float(np.median(per)), "mean_step_ms":
                           float(np.mean(per)), "qa_pairs_per_s": 64e3 / float(np.mean(per)),
                           "peak_device_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            log(f"train step ({name}), batch 64: p50 {times[name]['p50_step_ms']:.2f} ms, peak "
                f"{times[name]['peak_device_gib']:.3f} GiB")
        prof = device_breakdown(lambda: plain(host[0]))
    return {"steps_timed": len(host) - 3, "step_times": times, "profiled_step": prof}


def run_train_slice(workdir: str) -> dict:
    packdir = os.path.join(workdir, "pack")
    plain = train_run(packdir, os.path.join(workdir, "train_plain"), dedup=False)
    pred = predict_check(packdir, os.path.join(workdir, "train_plain"))
    dedup = train_run(packdir, os.path.join(workdir, "train_dedup"), dedup=True)
    parity = step_parity(packdir)
    resume = resume_check(packdir, workdir)
    prof = profile_train(packdir)
    return {"plain_run": plain, "dedup_run": dedup, "predict_answer": pred["answer"],
            "parity": parity, "resume": resume, **prof}


# ---- the video slice: K4 (csrc/fvta_stats.cu), K5 and K6 (csrc/fvta_bwd.cu) -------

VIDEO_T, VIDEO_N = 4096, 8          # bench.py's long video length, batch 8
CLI_FRAMES, CLI_VIDEOS, CLI_STEPS = 1024, 48, 24
# K4 and the streaming attention vs their plain versions: the JAX suite's
# stats/attention tolerance; K6 vs the plain backward: its gradient tolerance.
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def video_realistic_config(keep_prob: float = 0.9):
    """bench_lib.realistic_config(): H=100, char-CNN 100 filters of width 5,
    char emb 20, word emb 100, J=30, Ja=8, W=16, F=2537, vocab 12000 with
    10000 GloVe rows, trilinear similarity."""
    from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig

    return Config(data=DataConfig(max_albums=4, max_photos=12, max_question_len=30,
                                  max_answer_len=8, max_sent_len=10, max_album_text_len=24,
                                  max_word_len=16, image_feat_dim=2537, word_emb_dim=100,
                                  word_vocab_size=12000, char_vocab_size=70,
                                  num_glove_words=10000),
                  model=ModelConfig(hidden_dim=100, keep_prob=keep_prob))


def video_setup(t_frames: int, encoder: str = "dilated_conv", keep_prob: float = 0.9,
                batch: int = VIDEO_N, seed: int = 0):
    """(cfg, run record, shared tables on the CPU, one batch on the CPU) of the
    full-width video model (VideoFVTAModel(num_choices=5, task="mc")), with a
    synthetic batch of `batch` videos x t_frames frames and random tables."""
    import numpy as np

    from fvta_memexqa_torch.data.video_pack import video_shared_tables
    from fvta_memexqa_torch.models.video import make_synthetic_video

    cfg = video_realistic_config(keep_prob)
    d = cfg.data
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, d.max_word_len + 1, d.word_vocab_size)
    chars = rng.integers(2, d.char_vocab_size, (d.word_vocab_size, d.max_word_len))
    chars = (chars * (np.arange(d.max_word_len)[None, :] < lens[:, None])).astype(np.int32)
    chars[:2] = 0
    shared = video_shared_tables(d, {
        "word_emb_init": rng.normal(0, 0.3, (d.word_vocab_size, d.word_emb_dim)).astype(
            np.float32), "vocab_chars": chars})
    vi, _ = make_synthetic_video(cfg, num_videos=batch, num_frames=t_frames, seed=seed)
    run = {"task": "mc", "encoder": encoder, "num_choices": 5, "num_answers": 0,
           "max_frames": t_frames}
    return cfg, run, shared, vi


def video_main_path_args():
    """The arguments the full-width T=4096 train step gives K4 and K6 (one
    forward + backward with dropout on, batch 8)."""
    import torch

    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.ops import fvta_stats

    cfg, run, shared, vi = video_setup(VIDEO_T)
    state = tv.init_video_state(cfg, run, "cuda")
    with Recorder(fvta_stats, "stats_fwd") as fwd, Recorder(fvta_stats, "stats_bwd") as bwd:
        loss, _ = tv.video_loss(state.model, video_shared_to(shared), vi.to("cuda"), True,
                                state.generator)
        torch.autograd.grad(loss, list(state.model.parameters()), allow_unused=True)
    if len(fwd.calls) != 1 or len(bwd.calls) != 1:
        fail(f"the T={VIDEO_T} train step called K4 {len(fwd.calls)} and K6 "
             f"{len(bwd.calls)} times, not once each")
    return fwd.calls[0], bwd.calls[0]


def video_shared_to(shared, device="cuda"):
    import dataclasses as dc

    return dc.replace(shared, **{f.name: getattr(shared, f.name).to(device)
                                 for f in dc.fields(shared)})


def stats_case(n, s, t, j, d, seed, device, masked=False):
    """Synthetic stats inputs: bounded states (the encoders' outputs are
    masked, tanh-like in scale), similarity weights at the model's N(0, 0.1)
    initial scale; masked=True adds a sequence with a dead first half, an
    example with no valid frame and an all-masked question."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h = torch.tanh(torch.randn(n, s, t, d, generator=g))
    q = torch.tanh(torch.randn(n, j, d, generator=g))
    cm = torch.arange(t)[None, None, :] < torch.randint(1, t + 1, (n, s, 1), generator=g)
    qm = torch.arange(j)[None, :] < torch.randint(1, j + 1, (n, 1), generator=g)
    if masked:
        cm[:, 0, : t // 2] = False
        cm[0] = False
        qm[min(1, n - 1)] = False
    w = [0.1 * torch.randn(d, generator=g) for _ in range(3)]
    h, q = h * cm[..., None], q * qm[..., None]
    return [a.to(device) for a in (h, cm.float(), q, qm.float(), *w)]


# (name, n, s, t, j, d, masked): the main paths' shapes (synthetic twins of the
# T=4096 step's call and of `cli video`'s), MemexQA's S = T = 24, and the
# long-question shape of the JAX package's capacity table
K4_SYNTH = [("video_main_synthetic", 8, 1, 4096, 30, 200, False),
            ("video_main_masked", 8, 1, 4096, 30, 200, True),
            ("cli_video_synthetic", 16, 1, 1024, 30, 200, False),
            ("cli_video_masked", 16, 1, 1024, 30, 200, True),
            ("memexqa_s24_t24", 8, 24, 24, 30, 200, False),
            ("memexqa_s24_t24_masked", 8, 24, 24, 30, 200, True),
            ("long_question", 2, 8, 16384, 512, 200, False),
            ("long_question_masked", 2, 8, 16384, 512, 200, True)]
STATS_NAMES = ("m", "den", "v", "eq", "e")
BWD_NAMES = ("dh", "dq", "dwx", "dwy", "dwxy")


def field_ok(a, b, c, tol):
    """(ok, note): a kernel output, b the float32 plain one, c float64. A field
    beyond `tol` passes only on the float64 witness: at most 2x as far from the
    float64 plain version as the float32 plain version is, plus 4 ulps of the
    largest entry. (Sums over 16 384 frames, or an all-masked question's uniform
    weights over every frame, put near-zero entries of v and dwx ~1e-4 from
    float64 in both float32 versions: rounding, which no tolerance against the
    float32 plain version can tell from a fault.)"""
    if close(a, b, **tol):
        return True, ""
    share, note = f64_witness(a, b, c)
    return share <= 1.0, f"(f64: {note})"


def stats_check_case(name, args, cot=None):
    """K4 vs stats_fwd_ref, K5 vs qcnt_ref (exactly, and >= 1 for every (n, j):
    each max is reached somewhere), K6 vs stats_bwd_ref, each field at its
    tolerance or on the float64 witness, on one case: args = (h, cm, q, qm,
    wx, wy, wxy), cot = (de, geq, gv) (default N(0, 1)). Fatal on a mismatch;
    returns the max |err| of K4 and K6."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = args
    w = (wx, wy, wxy)
    with torch.no_grad():
        got = fs.stats_fwd(*args)
        ref = fs.stats_fwd_ref(*args)
        cnt = fs.qcnt(h, cm, q, *w, got[3])
        cnt_r = fs.qcnt_ref(h, cm, q, *w, ref[3])
        if cot is None:
            g = torch.Generator().manual_seed(7)
            n, s, t, d = h.shape
            cot = [torch.randn(sh, generator=g).to(h.device)
                   for sh in ((n, s, t), tuple(qm.shape), (n, s, d))]
        de, geq, gv = cot
        dk = fs.stats_bwd(h, cm, q, qm, *w, de, geq, got[3], cnt, got[4], got[0], gv)
        dr = fs.stats_bwd_ref(h, cm, q, qm, *w, de, geq, ref[3], cnt_r, ref[4], ref[0], gv)
        a64 = [a.double() for a in args]
        r64 = fs.stats_fwd_ref(*a64)
        d64 = fs.stats_bwd_ref(*a64, de.double(), geq.double(), r64[3],
                               fs.qcnt_ref(*a64[:3], *a64[4:], r64[3]), r64[4], r64[0],
                               gv.double())
    torch.cuda.synchronize()
    e4 = [max_err(a, b) for a, b in zip(got, ref)]
    e6 = [max_err(a, b) for a, b in zip(dk, dr)]
    res4 = [field_ok(a, b, c, STATS_TOL) for a, b, c in zip(got, ref, r64)]
    res6 = [field_ok(a, b, c, GRAD_TOL) for a, b, c in zip(dk, dr, d64)]
    ok4, ok6 = all(r[0] for r in res4), all(r[0] for r in res6)
    ok5 = bool(torch.equal(cnt, cnt_r)) and bool((cnt >= 1).all())
    finite = all(bool(torch.isfinite(a).all()) for a in (*dk, got[1], got[2]))
    log(f"K4/K5/K6 vs plain {name:24s} N={h.shape[0]} S={h.shape[1]} "
        f"T={h.shape[2]} J={q.shape[1]} D={h.shape[3]}: K4 "
        + " ".join(f"{k} {e:.2e}{r[1]}" for k, e, r in zip(STATS_NAMES, e4, res4))
        + f"; K5 {'equal' if torch.equal(cnt, cnt_r) else 'DIFFERENT'}, min "
        f"{float(cnt.min()):.0f}; K6 " + " ".join(f"{k} {e:.2e}{r[1]}" for k, e, r in
                                                   zip(BWD_NAMES, e6, res6))
        + f"  {'ok' if ok4 and ok5 and ok6 and finite else 'MISMATCH'}")
    if not (ok4 and ok5 and ok6 and finite):
        fail(f"{name}: K4 ({ok4}, {STATS_TOL}), K5 ({ok5}, exact and >= 1) or K6 ({ok6}, "
             f"{GRAD_TOL}) disagrees with its plain version (finite {finite})")
    return {"k4": max(e4), "k6": max(e6)}


def k456_check(fwd_args, bwd_args) -> dict:
    """stats_check_case on the main path's own arguments (the T=4096 step) and
    on the synthetic cases; K6's float64 witness at unit-scale cotangents; the
    geq-only case and the bitwise repeats. Returns the worst errors."""
    h, cm, q, qm, wx, wy, wxy, de, geq, eq, qcnt, e, m, gv = bwd_args
    scale = {"de": float(de.abs().max()), "geq": float(geq.abs().max()),
             "gv": float(gv.abs().max())}
    log(f"cotangents at K6 in the T={VIDEO_T} train step: max |de| {scale['de']:.3e}, "
        f"|geq| {scale['geq']:.3e}, |gv| {scale['gv']:.3e}")
    worst = stats_check_case("video_main_path", list(fwd_args), [de, geq, gv])
    for name, n, s, t, j, d, masked in K4_SYNTH:
        errs = stats_check_case(name, stats_case(n, s, t, j, d, 900 + len(name), "cuda", masked))
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    witness = k6_rounding_witness(8, VIDEO_T, 30, 200)
    geq_only = k6_geq_only_check("the T=4096 step's call", fwd_args)
    stats_repeat_check("the T=4096 step's call", bwd_args)
    return {"k4_max_abs_err": worst["k4"], "k6_max_abs_err": worst["k6"], "k6_cotangent_max": scale,
            "k6_witness_worst_share": witness, "k6_geq_only_max_abs_err": geq_only}


def k6_geq_only_check(what: str, fwd_args) -> float:
    """K6 with de = 0 and gv = 0 on a main-path call's own h, q and weights, and
    unit-scale N(0, 1) geq: every entry of dC is a share of eq's cotangent,
    routed to the positions whose recomputed C equals K4's eq bit for bit. A C
    that differed in its last bit would drop a share (max(qcnt, 1) hides the
    lost tie) far outside GRAD_TOL. dh and dq must equal plain at GRAD_TOL
    (no witness), and the shares must reach dq."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = fwd_args
    w = (wx, wy, wxy)
    n, s, t, d = h.shape
    geq = torch.randn(tuple(qm.shape), generator=torch.Generator().manual_seed(953)).cuda()
    de, gv = torch.zeros(n, s, t, device="cuda"), torch.zeros(n, s, d, device="cuda")
    with torch.no_grad():
        got, ref = fs.stats_fwd(*fwd_args), fs.stats_fwd_ref(*fwd_args)
        dk = fs.stats_bwd(h, cm, q, qm, *w, de, geq, got[3], fs.qcnt(h, cm, q, *w, got[3]),
                          got[4], got[0], gv)
        dr = fs.stats_bwd_ref(h, cm, q, qm, *w, de, geq, ref[3],
                              fs.qcnt_ref(h, cm, q, *w, ref[3]), ref[4], ref[0], gv)
    torch.cuda.synchronize()
    errs = [max_err(a, b) for a, b in zip(dk, dr)]
    reach = float(dr[1].abs().max())
    ok = close(dk[0], dr[0], **GRAD_TOL) and close(dk[1], dr[1], **GRAD_TOL) and reach > 1e-3
    log(f"K6 geq-only (de = gv = 0, unit geq) at {what}, N={n} S={s} T={t}: max|err| "
        + " ".join(f"{k} {e:.2e}" for k, e in zip(BWD_NAMES, errs))
        + f"; max|dq| plain {reach:.3e}  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"K6 with dC from geq alone at {what}: dh or dq beyond {GRAD_TOL} of plain "
             f"(a dropped tie share), or no share reached dq")
    return max(errs)


def stats_repeat_check(what: str, bwd_args) -> None:
    """Two launches each of K4, K5 and K6 on the same inputs must give
    identical outputs."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = bwd_args[:7]
    eq = bwd_args[9]
    runs = {"K4": (lambda: fs.stats_fwd(*bwd_args[:7]), STATS_NAMES),
            "K5": (lambda: (fs.qcnt(h, cm, q, wx, wy, wxy, eq),), ("qcnt",)),
            "K6": (lambda: fs.stats_bwd(*bwd_args), BWD_NAMES)}
    differ = []
    with torch.no_grad():
        for kernel, (fn, names) in runs.items():
            a, b = fn(), fn()
            differ += [f"{kernel} {k}" for k, x, y in zip(names, a, b) if not torch.equal(x, y)]
    torch.cuda.synchronize()
    log(f"K4, K5, K6 bitwise repeats at {what}: "
        f"{'equal' if not differ else 'DIFFERENT ' + str(differ)}")
    if differ:
        fail(f"two launches on the same inputs differ in {differ} at {what}")


def k6_rounding_witness(n: int, t: int, j: int, d: int) -> float:
    """Unit-scale N(0, 1) cotangents at a main path's shape (N, S=1, T, J, D):
    K6 and the float32 plain backward both against the float64
    plain backward; K6 may be at most 2x as far as the float32 plain version,
    plus 4 ulps of the largest entry. Returns the worst share of that limit."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = stats_case(n, 1, t, j, d, 950, "cuda")
    w = (wx, wy, wxy)
    g = torch.Generator().manual_seed(951)
    de, geq, gv = (torch.randn(sh, generator=g).cuda()
                   for sh in ((n, 1, t), (n, j), (n, 1, d)))
    dbl = lambda xs: [x.double() for x in xs]
    with torch.no_grad():
        got4 = fs.stats_fwd(h, cm, q, qm, *w)
        got = fs.stats_bwd(h, cm, q, qm, *w, de, geq, got4[3],
                           fs.qcnt(h, cm, q, *w, got4[3]), got4[4], got4[0], gv)
        ref4 = fs.stats_fwd_ref(h, cm, q, qm, *w)
        ref = fs.stats_bwd_ref(h, cm, q, qm, *w, de, geq, ref4[3],
                               fs.qcnt_ref(h, cm, q, *w, ref4[3]), ref4[4], ref4[0], gv)
        a64 = dbl((h, cm, q, qm, *w))
        r64 = fs.stats_fwd_ref(*a64)
        ref64 = fs.stats_bwd_ref(*a64, *dbl((de, geq)), r64[3],
                                 fs.qcnt_ref(*a64[:3], *a64[4:], r64[3]), r64[4], r64[0],
                                 gv.double())
    worst, line = 0.0, []
    for nm, a, b, c in zip(BWD_NAMES, got, ref, ref64):
        share, note = f64_witness(a, b, c)
        worst = max(worst, share)
        line.append(f"{nm} {note}")
    log(f"K6 rounding at unit-scale cotangents N={n} T={t} J={j} D={d}: max|err| vs float64, "
        f"K6/float32 plain: {' '.join(line)}; worst share of limit {worst:.2f}  "
        f"{'ok' if worst <= 1.0 else 'MISMATCH'}")
    if worst > 1.0:
        fail(f"K6 is farther from the float64 plain backward than {F64_FACTOR}x the "
             f"float32 plain version (+{F64_ULPS} ulps)")
    return worst


def attention_loss_grads(fn, h, cm, q, qm, w, cot):
    import torch

    leaves = [a.detach().clone().requires_grad_() for a in (h, q, *w)]
    out = fn(leaves[0], cm, leaves[1], qm, dict(zip(("w_x", "w_y", "w_xy"), leaves[2:])))
    loss = sum((o * g).sum() for o, g in zip(out, cot))
    return [o.detach() for o in out], torch.autograd.grad(loss, leaves)


def streaming_vs_k2(t: int = 1024) -> dict:
    """The streaming form (K4, then K5 + K6 under grad) against K2 with its
    recompute backward, at N=8, S=1, T=1024, J=30, D=200 (ragged frame counts,
    one all-masked question): outputs at 1e-5 / 1e-5, gradients at 1e-4 /
    1e-5. An example with no valid frame is left out: there the two forms
    differ in the JAX package too (fvta_attention sends a uniform gradient
    into the masked states, focal_finalize none); packs hold no such video."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused as ff
    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = stats_case(8, 1, t, 30, 200, 960, "cuda")
    qm[1] = 0.0
    q[1] = 0.0
    cmb, qmb = cm > 0.5, qm > 0.5
    g = torch.Generator().manual_seed(961)
    cot = [torch.randn(sh, generator=g).cuda() for sh in ((8, 200), (8, 200), (8, 1, t), (8, 1))]
    k2 = lambda hh, c, qq, m, p: ff._FVTAFn.apply(hh, cm, qq, qm, p["w_x"], p["w_y"], p["w_xy"])
    before = (ff.fvta_fwd.launches, fs.stats_fwd.launches, fs.stats_bwd.launches)
    out_s, g_s = attention_loss_grads(
        lambda hh, c, qq, m, p: ff.fvta_attention_fused(hh, c, qq, m, "trilinear", p),
        h, cmb, q, qmb, (wx, wy, wxy), cot)
    out_k, g_k = attention_loss_grads(k2, h, cmb, q, qmb, (wx, wy, wxy), cot)
    torch.cuda.synchronize()
    after = (ff.fvta_fwd.launches, fs.stats_fwd.launches, fs.stats_bwd.launches)
    e_out = [max_err(a, b) for a, b in zip(out_s, out_k)]
    e_g = [max_err(a, b) for a, b in zip(g_s, g_k)]
    ok = (all(close(a, b, **FVTA_TOL) for a, b in zip(out_s, out_k))
          and all(close(a, b, **GRAD_TOL) for a, b in zip(g_s, g_k))
          and tuple(b - a for a, b in zip(before, after)) == (1, 1, 1))
    log(f"streaming (K4+K5+K6) vs K2 + recompute at N=8 S=1 T={t}: outputs max|err| "
        + " ".join(f"{e:.2e}" for e in e_out) + "; grads h q wx wy wxy "
        + " ".join(f"{e:.2e}" for e in e_g) + f"  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the streaming attention disagrees with K2 + recompute")
    return {"outputs_max_abs_err": max(e_out), "grads_max_abs_err": max(e_g)}


def prepare_video_pack(workdir: str) -> subprocess.Popen:
    """`cli synth-video` (48 videos, 1024 frames on average x 2537 features)
    then `cli video-prepro` at max_frames 1024, in a CPU-only child process
    started early, so the card's phases overlap it."""
    raw, pack = os.path.join(workdir, "video_raw"), os.path.join(workdir, "video_pack")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from fvta_memexqa_torch import cli; "
            f"cli.main(['synth-video', {raw!r}, '--num-videos', '{CLI_VIDEOS}', "
            f"'--num-frames', '{CLI_FRAMES}', '--feat-dim', '2537']); "
            f"cli.main(['video-prepro', {os.path.join(raw, 'qas.jsonl')!r}, "
            f"{os.path.join(raw, 'frame_feats.npz')!r}, {pack!r}, '--test-ids', "
            f"{os.path.join(raw, 'test_qa.ids')!r}, '--max-frames', '{CLI_FRAMES}'])")
    log_f = open(os.path.join(workdir, "video_prep.log"), "w")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen([sys.executable, "-c", code, os.path.dirname(os.path.abspath(
        __file__))], stdout=log_f, stderr=subprocess.STDOUT, env=env)


def video_cli_run(workdir: str, prep: subprocess.Popen) -> dict:
    """This slice's main path: `cli video --data --out` (24 steps, val every 12)
    then `cli video-test` on the run directory, with every kernel counter
    zeroed just before and read just after."""
    import contextlib
    import io

    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats, lstm_fused

    t0 = time.perf_counter()
    if prep.wait(timeout=600) != 0:
        fail("synth-video / video-prepro failed: "
             + open(os.path.join(workdir, "video_prep.log")).read()[-2000:])
    prep_lines = open(os.path.join(workdir, "video_prep.log")).read().strip().splitlines()
    log(f"video pack ready (waited {time.perf_counter() - t0:.1f} s more): {prep_lines[-1]}")
    pack, run = os.path.join(workdir, "video_pack"), os.path.join(workdir, "video_run")
    with Recorder(fvta_stats, "stats_bwd", keep=1) as k6_call:   # K6's first call
        counters = {**{k: getattr(lstm_fused, k) for k in NEW_KERNELS + OLD_KERNELS},
                    "fvta_fwd": fvta_fused.fvta_fwd, "stats_fwd": fvta_stats.stats_fwd,
                    "qcnt": fvta_stats.qcnt, "stats_bwd": fvta_stats.stats_bwd}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["video", "--data", pack, "--out", run, "--hidden-dim", "100",
                           "--steps", str(CLI_STEPS), "--val-period", "12", "--log-period",
                           "1", "--device", "cuda"])
        wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli video returned {rc}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = {k: fn.launches for k, fn in counters.items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["video-test", run, "--split", "test", "--device", "cuda",
                  "--dump-attention", os.path.join(workdir, "video_attn.npz")])
    test = json.loads(buf.getvalue().strip().splitlines()[-1])
    recs = read_metrics(os.path.join(run, "metrics.jsonl"))
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    first, last = sum(losses[:6]) / 6, sum(losses[-6:]) / 6
    log(f"video (cli video --data --out, T={CLI_FRAMES}, H=100): {len(losses)} steps in "
        f"{wall:.1f} s; launches {json.dumps(launches)}; mean loss of the first 6 steps "
        f"{first:.4f}, last 6 {last:.4f}; {json.dumps(res)}; video-test {json.dumps(test)}")
    on_path = ("stats_fwd", "qcnt", "stats_bwd")
    if min(launches[k] for k in on_path) == 0:
        fail(f"video: a kernel of the path never launched: {launches}")
    check_lstm_launches("video", launches, backward=True)
    if launches["qcnt"] != CLI_STEPS or launches["stats_bwd"] != CLI_STEPS:
        fail(f"video: K5 and K6 must launch once per train step ({CLI_STEPS}): {launches}")
    if len(losses) != CLI_STEPS or not all(map(math.isfinite, losses)) or not last < first:
        fail(f"video: losses not finite, steps missing or not falling: {losses}")
    if test["count"] != res["test_count"] or not 0.0 <= test["acc"] <= 1.0:
        fail(f"video-test on the card-trained run directory: {test}")
    h, _, q = k6_call.calls[0][:3]
    log(f"K6's call in cli video: N={h.shape[0]} S={h.shape[1]} T={h.shape[2]} "
        f"J={q.shape[1]} D={h.shape[3]}")
    return {"steps": len(losses), "wall_s": wall, "launches": launches,
            "loss_first_6": first, "loss_last_6": last, "result": res, "video_test": test,
            "pack": pack, "k6_args": k6_call.calls[0]}


def video_step_parity() -> dict:
    """The full-width T=4096 train step's gradients on the card vs the CPU, from
    the same weights and batch at keep_prob 1 (per parameter tensor)."""
    import torch

    from fvta_memexqa_torch import train_video as tv

    cfg, run, shared, vi = video_setup(VIDEO_T, keep_prob=1.0)
    grads = {}
    for dev in ("cpu", "cuda"):
        state = tv.init_video_state(cfg, run, dev)
        loss, _ = tv.video_loss(state.model, video_shared_to(shared, dev), vi.to(dev), True,
                                state.generator)
        names = [n for n, _ in state.model.named_parameters()]
        gs = torch.autograd.grad(loss, list(state.model.parameters()), allow_unused=True)
        grads[dev] = (float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g).cpu()
                                    for (n, p), g in zip(state.model.named_parameters(), gs)})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads["cuda"]
    rel = {k: float((g_gpu[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30)
           for k in g_cpu if k not in EXACT_ZERO_GRADS}
    zero = {k: max(float(g_cpu[k].abs().max()), float(g_gpu[k].abs().max()))
            for k in EXACT_ZERO_GRADS}
    worst_name = max(rel, key=rel.get)
    d_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"video step, card vs CPU at T={VIDEO_T} full width: {len(rel)} parameter tensors, "
        f"worst max|dg|/max|g_cpu| {rel[worst_name]:.2e} ({worst_name}); loss {l_gpu:.6f} vs "
        f"{l_cpu:.6f}; exact-zero gradients {zero}")
    if rel[worst_name] > STEP_TOL or d_loss > STEP_TOL or max(zero.values()) > ZERO_GRAD_ATOL:
        fail(f"the card's video train step disagrees with the CPU's beyond {STEP_TOL}")
    return {"grad_rel_err_vs_cpu": rel[worst_name], "worst_tensor": worst_name,
            "loss_rel_err_vs_cpu": d_loss}


def video_step_times(encoder: str = "dilated_conv", t_frames: int = VIDEO_T,
                     steps: int = 10) -> dict:
    """Train steps of the full-width video model on the card (dropout on):
    p50 over `steps` synchronized steps after 3 warm-up steps, peak device
    memory, and a torch.profiler breakdown of one step."""
    import numpy as np
    import torch

    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.optim import Optimizer
    from fvta_memexqa_torch.train import deterministic_algorithms

    cfg, run, shared, vi = video_setup(t_frames, encoder=encoder)
    shared = video_shared_to(shared)
    state = tv.init_video_state(cfg, run, "cuda")
    opt = Optimizer(cfg.train)
    vi = vi.to("cuda")
    step = lambda: tv.video_train_step(state, opt, shared, vi)
    with deterministic_algorithms(torch.device("cuda")):
        for _ in range(3):
            m = step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per = []
        for _ in range(steps):
            t0 = time.perf_counter()
            m = step()
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = device_breakdown(step)
    loss = float(m["loss"])
    if not math.isfinite(loss):
        fail(f"video train step ({encoder}, T={t_frames}): loss {loss}")
    return {"encoder": encoder, "T": t_frames, "batch": VIDEO_N, "steps_timed": steps,
            "p50_step_ms": float(np.median(per)), "mean_step_ms": float(np.mean(per)),
            "frames_per_s": VIDEO_N * t_frames * 1e3 / float(np.median(per)),
            "peak_device_gib": peak, "loss": loss, "profiled_step": prof}


def video_bilstm_step() -> dict:
    """One train step with --encoder bilstm at T=1024 (K1/K1b over the frames)."""
    from fvta_memexqa_torch.ops import fvta_stats

    before, k6 = lstm_counters(), fvta_stats.stats_bwd.launches
    res = video_step_times("bilstm", CLI_FRAMES, steps=10)
    res["launches"] = {**lstm_delta(before), "stats_bwd": fvta_stats.stats_bwd.launches - k6}
    log(f"video bilstm step at T={CLI_FRAMES}: p50 {res['p50_step_ms']:.2f} ms, peak "
        f"{res['peak_device_gib']:.3f} GiB, loss {res['loss']:.4f}, launches {res['launches']}; "
        f"profiled step {json.dumps(res['profiled_step'])}")
    if res["launches"]["stats_bwd"] == 0:
        fail(f"the bilstm video step did not launch K6: {res['launches']}")
    check_lstm_launches("video bilstm step", res["launches"], backward=True)
    return res


def video_resume_check(pack: str, workdir: str) -> dict:
    """train_video on the card (dropout on): 6 steps straight vs 3 + resume to 6,
    every parameter and optimizer tensor and the generator state equal."""
    import torch

    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.checkpoint import CheckpointManager
    from fvta_memexqa_torch.config import Config, ModelConfig, TrainConfig

    cfg = Config(model=ModelConfig(hidden_dim=100, char_emb_dim=8, char_cnn_filters=16,
                                   keep_prob=0.9),
                 train=TrainConfig(batch_size=16, eval_batch_size=16, learning_rate=2e-3,
                                   save_period=1, val_period=1000, log_period=100))
    a_dir, b_dir = os.path.join(workdir, "vstraight"), os.path.join(workdir, "vresumed")
    tv.train_video(cfg, pack, a_dir, 6, echo=False, device="cuda")
    tv.train_video(cfg, pack, b_dir, 3, echo=False, device="cuda")
    tv.train_video(cfg, pack, b_dir, 6, echo=False, device="cuda")
    a, b = CheckpointManager(a_dir).load(step=6), CheckpointManager(b_dir).load(step=6)
    flat = lambda ck: {**{f"p.{k}": v for k, v in ck["params"].items()},
                       **{f"o.{f}.{k}": t for f, v in ck["opt_state"].items()
                          for k, t in (v.items() if isinstance(v, dict) else [("", v)])}}
    la, lb = flat(a), flat(b)
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    log(f"video resume on the card: 6 steps straight vs 3 + resume to 6: {len(la)} tensors, "
        f"{len(differ)} differ; rng equal {torch.equal(a['rng'], b['rng'])}")
    if differ or set(la) != set(lb) or not torch.equal(a["rng"], b["rng"]):
        fail(f"video resume is not bitwise: {differ[:5]}")
    return {"tensors": len(la), "bitwise": True}


def crossover(ts=(256, 1024, 4096)) -> list:
    """K2 + recompute vs K4 + K5 + K6: time (CUDA events) and peak device memory
    of one forward + backward of the attention at N=8, S=1, J=30, D=200."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused as ff
    from fvta_memexqa_torch.ops import fvta_ref, fvta_stats as fs

    rows = []
    for t in ts:
        h, cm, q, qm, wx, wy, wxy = stats_case(8, 1, t, 30, 200, 970, "cuda")
        leaves = [a.clone().requires_grad_() for a in (h, q, wx, wy, wxy)]
        g = [torch.ones(8, 200, device="cuda"), torch.ones(8, 200, device="cuda")]

        def k2():
            out = ff._FVTAFn.apply(leaves[0], cm, leaves[1], qm, *leaves[2:])
            torch.autograd.grad((out[0] * g[0]).sum() + (out[1] * g[1]).sum(), leaves)

        def streaming():
            st = fs._StatsFn.apply(leaves[0], cm, leaves[1], qm, *leaves[2:])
            out = fvta_ref.focal_finalize(*st, leaves[1], qm > 0.5, (cm > 0.5).any(-1))
            torch.autograd.grad((out[0] * g[0]).sum() + (out[1] * g[1]).sum(), leaves)

        row = {"T": t}
        for name, fn in (("k2_recompute", k2), ("streaming", streaming),
                         ("streaming_again", streaming), ("k2_recompute_again", k2)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            row[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            row[f"{name}_ms"] = cuda_ms(fn, iters=10, warmup=2)
        for name, fn in (("k2_recompute", k2), ("streaming", streaming)):
            prof = device_breakdown(fn, reps=3)
            row[f"{name}_device_busy_ms"] = prof["device_busy_ms"]
            row[f"{name}_device_events_seen"] = prof["device_events_seen"]
            row[f"{name}_top_device_ms"] = dict(list(prof["top_device_ms"].items())[:4])
        rows.append(row)
        log(f"crossover T={t}: K2 + recompute {row['k2_recompute_ms']:.3f} / "
            f"{row['k2_recompute_again_ms']:.3f} ms, {row['k2_recompute_peak_mib']:.1f} MiB; "
            f"K4 + K5 + K6 {row['streaming_ms']:.3f} / {row['streaming_again_ms']:.3f} ms, "
            f"{row['streaming_peak_mib']:.1f} MiB; device busy {row['k2_recompute_device_busy_ms']}"
            f" vs {row['streaming_device_busy_ms']} ms")
    return rows


def stats_bound_ms(name: str, h, cm, q) -> tuple[float, float]:
    """(bytes bound, operations bound) in ms of K4, K5 or K6 on these inputs:
    each input read once and each output written once, over 3.35 TB/s; the
    FLOPs of the valid (n, s, t) positions over 67 TFLOP/s FP32."""
    n, s, t, d = h.shape
    j = q.shape[1]
    n_ct = float(cm.sum())                  # valid (n, s, t) positions
    el = 4  # bytes per float32
    nbytes = {   # K6: h, cm, de, e, q, qm, wx/wy/wxy, geq/eq/qcnt, m, gv in; dh, dq, dw* out
        "stats_fwd": el * (h.numel() + cm.numel() + q.numel() + n * j + 3 * d
                           + 2 * n * s + n * s * d + n * j + n * s * t),
        "qcnt": el * (h.numel() + cm.numel() + q.numel() + 3 * d + 2 * n * j),
        "stats_bwd": el * (2 * h.numel() + 3 * cm.numel() + 2 * q.numel() + n * j
                           + 3 * d + 3 * n * j + n * s + n * s * d + 3 * n * d),
    }[name]
    flops = {"stats_fwd": n_ct * j * 2 * d + n_ct * 4 * d + n * j * 2 * d,
             "qcnt": n_ct * j * 2 * d + n * j * 2 * d,
             "stats_bwd": n_ct * j * 6 * d + n_ct * 6 * d}[name]
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def kernel_split_ms(fn, names, graph: float, calls: int = 10, tries: int = 3) -> dict:
    """Device ms of one launch of each kernel of fn whose name contains one of
    `names`: the mean duration of its kernel events under torch.profiler over
    `calls` calls, from the first of up to `tries` traces that saw every one
    and whose events come to SPLIT_SHARE of `graph`, the CUDA-graph time of
    the same call (which also holds the gaps between launches). A trace can
    come back without the device's events, or, on the H100, with every event
    seen and durations that sum to 0.47 or 1.13 of the same call's graph time
    (two runs of this script, at calls where every other trace read
    0.98-1.01); such a trace is taken again. Fatal
    unless every kernel of the call is named, each was seen, and one trace
    agrees with the graph time. Returns the split, the events seen per call,
    the share of `graph` and the shares of the traces taken again."""
    retaken = []
    for _ in range(tries):
        kernels, count, _ = profile_kernels(fn, calls)
        seen = {k: sum(c for name, c in count.items() if k in name) for k in names}
        per = {name: kernels[name] / count[name] for name in kernels}
        split = {k: sum(v for name, v in per.items() if k in name) for k in names}
        share = sum(split.values()) / graph
        stray = [name[:60] for name in per if not any(k in name for k in names)]
        if stray or (min(seen.values()) > 0 and SPLIT_SHARE[0] <= share <= SPLIT_SHARE[1]):
            break
        retaken.append(share)
    if stray or min(seen.values()) == 0 or not SPLIT_SHARE[0] <= share <= SPLIT_SHARE[1]:
        fail(f"profiled kernels {seen} (events per call; others {stray}) sum to "
             f"{share:.3f} of the CUDA-graph time {graph:.4f} ms, outside {SPLIT_SHARE} "
             f"(earlier traces {retaken}): the split cannot be read")
    return {**split, "events_per_call": seen, "share_of_graph": share,
            "traces_retaken": retaken}


# (kernel, its kernel names in a profile, the TPU kernel's line in
# fvta_pallas.py, source): K5's call also zeroes its int32 counts and converts
# them to float32 (torch's elementwise kernels)
STATS_KERNELS = [
    ("stats_fwd", ("stats_run_kernel", "stats_merge_kernel"), 141, "fvta_stats.cu"),
    ("qcnt", ("qcnt_run_kernel", "elementwise_kernel"), 197, "fvta_bwd.cu"),
    ("stats_bwd", ("bwd_fused_kernel", "bwd_combine_kernel"), 231, "fvta_bwd.cu"),
]


def stats_call(name: str, args):
    """A call of K4, K5 or K6 (or of a plain version of theirs) on the
    arguments a K6 call was given: (h, cm, q, qm, wx, wy, wxy, de, geq, eq,
    qcnt, e, m, gv)."""
    from fvta_memexqa_torch.ops import fvta_stats as fs

    fn = getattr(fs, name)
    if name.startswith("stats_fwd"):
        return lambda: fn(*args[:7])
    if name.startswith("qcnt"):
        return lambda: fn(*args[:3], *args[4:7], args[9])
    return lambda: fn(*args)


def stats_kernel_times(calls: dict, launches: dict, errs: dict) -> tuple[list, dict]:
    """The kernels-line entries of K4, K5 and K6 at both main-path calls
    (`calls`: label -> a K6 call's arguments; the T=4096 step's and `cli
    video`'s): times from CUDA events (two readings), the CUDA-graph time of
    each, each one's time split by kernel (mean profiler events, fatal unless
    0.85-1.10 of the graph time), the plain versions' times, bounds from these
    inputs (valid positions only). Returns (entries, splits)."""
    import torch

    rows, splits = {}, {}
    with torch.no_grad():
        for label, a in calls.items():
            splits[label] = {}
            for name, names, _, _ in STATS_KERNELS:
                new = stats_call(name, a)
                n1, n2 = cuda_ms(new), cuda_ms(new)
                g_new = graph_ms(new)   # device time, no host work
                plain = cuda_ms(stats_call(name + "_ref", a), iters=10)
                splits[label][name] = kernel_split_ms(new, names, g_new)
                rows[(name, label)] = ((n1 + n2) / 2, plain, (n1, n2), g_new)
                log(f"{name} at {label}: {n1:.4f} / {n2:.4f} ms (graph {g_new:.4f}), plain "
                    f"{plain:.3f} ms; split {json.dumps(splits[label][name])}")
    out = []
    main = "the T=4096 train step's call"
    for label, a in calls.items():
        at = "main" if label == main else "cli"
        suffix = "" if label == main else " (cli video call)"
        for name, _, line, src in STATS_KERNELS:
            k_ms, p_ms, pair, g_ms = rows[(name, label)]
            b_ms, o_ms = stats_bound_ms(name, *a[:3])
            err = {"stats_fwd": errs[f"k4_{at}"],
                   "stats_bwd": errs[f"k6_{at}"]}.get(name, 0.0)   # K5's counts: exactly equal
            n, s, t, d = a[0].shape
            out.append({
                "name": name + suffix, "route": "cuda",
                "source": f"fvta_memexqa_torch/csrc/{src}",
                "replaces": f"fvta_memexqa_tpu/ops/fvta_pallas.py:{line}",
                "launches": launches[name], "max_abs_err": err, "ms": k_ms,
                "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations", "library_ms": None,
                "timed_work": f"{label}: N={n} S={s} T={t} J={a[2].shape[1]} D={d}",
                "ms_pair": pair, "graph_ms": g_ms, "split_ms": splits[label][name]})
    return out, splits


def run_video_slice(workdir: str, prep: subprocess.Popen) -> tuple[dict, list]:
    fwd_args, bwd_args = video_main_path_args()
    checks = k456_check(fwd_args, bwd_args)
    checks["streaming_vs_k2"] = streaming_vs_k2()
    cli_run = video_cli_run(workdir, prep)
    cli_args = cli_run.pop("k6_args")
    cli_errs = stats_check_case("cli_video_call", list(cli_args[:7]),
                                [cli_args[7], cli_args[8], cli_args[13]])
    checks.update({f"{k}_cli_max_abs_err": v for k, v in cli_errs.items()})
    stats_repeat_check("cli video's call", cli_args)
    checks["k6_cli_geq_only_max_abs_err"] = k6_geq_only_check("cli video's call",
                                                              list(cli_args[:7]))
    checks["k6_cli_witness_worst_share"] = k6_rounding_witness(
        cli_args[0].shape[0], cli_args[0].shape[2], cli_args[2].shape[1], cli_args[0].shape[3])
    parity = video_step_parity()
    step = video_step_times()
    prof = step["profiled_step"]
    log(f"video train step, full width T={VIDEO_T} batch {VIDEO_N}: p50 "
        f"{step['p50_step_ms']:.2f} ms ({step['frames_per_s']:.0f} frames/s), peak "
        f"{step['peak_device_gib']:.2f} GiB; device {prof['device_busy_ms']} ms with "
        f"{prof['device_events_seen']:.0f} device events seen for "
        f"{prof['launch_calls']:.0f} launch calls; profiled step {json.dumps(prof)}")
    bilstm = video_bilstm_step()
    resume = video_resume_check(cli_run.pop("pack"), workdir)
    cross = crossover()
    errs = {"k4_main": checks["k4_max_abs_err"], "k6_main": checks["k6_max_abs_err"],
            "k4_cli": cli_errs["k4"], "k6_cli": cli_errs["k6"]}
    entries, splits = stats_kernel_times(
        {"the T=4096 train step's call": bwd_args, "cli video's call": cli_args},
        cli_run["launches"], errs)
    return ({"checks": checks, "cli_run": cli_run, "parity": parity, "train_step": step,
             "bilstm_step": bilstm, "resume": resume, "crossover": cross,
             "stats_split_ms": splits}, entries)


# ---- the grouped scans: K7 (csrc/lstm_grouped.cu), K8 (csrc/lstm_stream.cu) --------

# (name, rows, T): the bi-LSTM calls of one batch-64 train step (A = 4, D = 200,
# H = 100) as G = 2 groups, then the routing edge: n = 1024, t = 2 goes to K8
# and n = 1023 to K7 (lstm_grouped.uses_stream, the JAX package's rule).
GROUPED_SHAPES = [
    ("photo_title_words", 256 * 12, 10),
    ("enc_photo", 256, 12),
    ("enc_photo_title", 256, 12),
    ("enc_album_title", 256, 24),
    ("enc_album_desc", 256, 24),
    ("enc_when", 256, 24),
    ("enc_where", 256, 24),
    ("question", 64, 30),
    ("choices", 64 * 4, 8),
    ("edge_k8", 1024, 2),
    ("edge_k7", 1023, 2),
]
GROUPED_D = 200


class forced_scan:
    """Route every grouped scan to `kernel` (both kernels or the plain version)
    while the context is open: lstm_grouped._kernels is swapped for the time."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __enter__(self):
        from fvta_memexqa_torch.ops import lstm_grouped

        self.real = lstm_grouped._kernels
        lstm_grouped._kernels = lambda device: (self.kernel, self.kernel)
        return self

    def __exit__(self, *exc):
        from fvta_memexqa_torch.ops import lstm_grouped

        lstm_grouped._kernels = self.real
        return False


def grouped_counters() -> dict:
    """K7's and K8's launch counts."""
    from fvta_memexqa_torch.ops import lstm_grouped

    return {"lstm_grouped": lstm_grouped.scan_grouped.launches,
            "lstm_stream": lstm_grouped.scan_stream.launches}


def zero_grouped_counters() -> None:
    from fvta_memexqa_torch.ops import lstm_grouped

    lstm_grouped.scan_grouped.launches = lstm_grouped.scan_stream.launches = 0


def grouped_x_proj(x, mask, p_fw, p_bw):
    """The G = 2 scan inputs bilstm_grouped builds: (x_proj [2, N, T, 4H], int32
    lengths [2, N], wh [2, H, 4H])."""
    import torch

    from fvta_memexqa_torch.ops.lstm_ref import _flip_to_front

    lengths = mask.sum(1, dtype=torch.int32)
    xp = torch.stack([x @ p_fw.wx + p_fw.b, _flip_to_front(x, lengths) @ p_bw.wx + p_bw.b])
    return (xp.contiguous(), lengths[None].expand(2, -1).contiguous(),
            torch.stack([p_fw.wh, p_bw.wh]).contiguous())


def k1_fed_scan(x, mask, p_fw, p_bw, kernels):
    """K1 (lstm_proj then lstm_rec) and each of `kernels` fed K1's projection as
    two groups (the backward half flipped to the front, its output flipped
    back): (K1's (out, fin), [each kernel's (out, fin)] in K1's layout)."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused
    from fvta_memexqa_torch.ops.lstm_ref import _flip_to_front

    l32 = mask.sum(1, dtype=torch.int32)
    h = p_fw.wh.shape[0]
    xg = lstm_fused.lstm_proj(x, l32, p_fw, p_bw)
    out_k1, fin_k1, _ = lstm_fused.lstm_rec(xg, l32, p_fw, p_bw, 1.0, emit_out=True)
    xp = torch.stack([xg[..., :4 * h], _flip_to_front(xg[..., 4 * h:], l32)]).contiguous()
    got = []
    for k in kernels:
        out, fin = k(xp, l32[None].expand(2, -1), (p_fw.wh, p_bw.wh), 1.0)
        got.append((torch.cat([out[0], _flip_to_front(out[1], l32)], -1),
                    torch.cat([fin[0], fin[1]], -1)))
    return (out_k1, fin_k1), got


def grouped_check(device) -> dict:
    """Phase 15. The grouped-scan API (this slice's path: no command reaches
    K7 or K8) with the counters zeroed before and read after: at every shape
    bilstm_grouped (G = 2) and lstm_scan_grouped (G = 1) launch the kernel the
    routing names once per call; outputs vs the plain references and vs K1 at
    LSTM_TOL; gradients under autograd vs plain autograd at GRAD_TOL. Then both
    kernels directly at every shape, G = 2 and G = 1: against the plain grouped
    scan at LSTM_TOL, K7 and K8 bit for bit equal and each equal to its own
    repeat; and, at G = 2, K7 and K8 fed K1's own projection equal to K1's out and fin
    bit for bit (the routes share K1's lane split at these shapes)."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused, lstm_grouped, lstm_ref

    k7, k8 = lstm_grouped.scan_grouped, lstm_grouped.scan_stream
    k7.launches = k8.launches = 0
    expected = {"lstm_grouped": 0, "lstm_stream": 0}
    api = {"lstm_grouped": 0.0, "lstm_stream": 0.0}     # through the API vs the references
    vs_k1 = {"lstm_grouped": 0.0, "lstm_stream": 0.0}   # through the API vs K1
    bad = []
    for i, (name, n, t) in enumerate(GROUPED_SHAPES):
        x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, GROUPED_D, 900 + i, False, device,
                                                     COTANGENT_SCALE)
        route = "lstm_stream" if lstm_grouped.uses_stream(n, t) else "lstm_grouped"
        before = (k7.launches, k8.launches)
        with torch.no_grad():
            out, fin = lstm_grouped.bilstm_grouped(p_fw, p_bw, x, mask)
            out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
            out_k1, fin_k1 = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
            out1, fin1 = lstm_grouped.lstm_scan_grouped(p_fw, x, mask.float())
            out1_r, fin1_r = lstm_ref.lstm_scan_ref(p_fw, x, mask)
        out_g, fin_g, got = lstm_grads(
            lambda pf, pb, xx: lstm_grouped.bilstm_grouped(pf, pb, xx, mask), x, p_fw, p_bw,
            g_out, g_fin)
        ref = lstm_grads(lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask), x, p_fw,
                         p_bw, g_out, g_fin)[2]
        torch.cuda.synchronize()
        expected[route] += 3
        launched = (k7.launches - before[0], k8.launches - before[1])
        pairs = [(out, out_r), (fin, fin_r), (out, out_k1), (fin, fin_k1), (out1, out1_r),
                 (fin1, fin1_r), (out_g, out_r), (fin_g, fin_r)]
        errs = [max_err(a, b) for a, b in pairs]
        gerrs = [max_err(a, b) for a, b in zip(got, ref)]
        ok = (all(close(a, b, **LSTM_TOL) for a, b in pairs)
              and all(close(a, b, **GRAD_TOL) for a, b in zip(got, ref))
              and launched == ((0, 3) if route == "lstm_stream" else (3, 0))
              and not out[~mask].any() and not fin[mask.sum(1) == 0].any())
        log(f"K7/K8 API    {name:18s} N={n:4d} T={t:2d} -> {route}: launches K7/K8 "
            f"{launched}; max|err| vs plain out {errs[0]:.2e} fin {errs[1]:.2e}, vs K1 "
            f"{max(errs[2:4]):.2e}, G=1 {max(errs[4:6]):.2e}; grads "
            + " ".join(f"{nm} {e:.1e}" for nm, e in zip(GRAD_NAMES, gerrs))
            + f"  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
        api[route] = max(api[route], *errs[:2], *errs[4:])
        vs_k1[route] = max(vs_k1[route], *errs[2:4])
    launches = {"lstm_grouped": k7.launches, "lstm_stream": k8.launches}
    log(f"K7/K8 API run: launches {json.dumps(launches)} (expected {json.dumps(expected)})")
    if bad or launches != expected or min(launches.values()) == 0:
        fail(f"the grouped-scan API disagrees with the plain versions or K1 beyond "
             f"{LSTM_TOL} / {GRAD_TOL}, or launched other kernels than the routing names, "
             f"at {bad}: launches {launches}, expected {expected}")
    # both kernels directly at every shape, G = 2 and G = 1 (comparison launches)
    kernels = {"lstm_grouped": k7, "lstm_stream": k8}
    direct = dict.fromkeys(kernels, 0.0)
    for i, (name, n, t) in enumerate(GROUPED_SHAPES):
        x, mask, p_fw, p_bw = lstm_case(n, t, GROUPED_D, H, 950 + i, device)
        xp, lens, wh = grouped_x_proj(x, mask, p_fw, p_bw)
        route = lstm_grouped.grouped_route(2, n, t, H)
        with torch.no_grad():
            for g in (2, 1):
                args = (xp[:g].contiguous(), lens[:g].contiguous(), wh[:g].contiguous(), 1.0)
                ref = lstm_grouped.grouped_scan_ref(*args)
                res = {stem: k(*args) for stem, k in kernels.items()}
                repeats = [k7(*args), k8(*args)]
                torch.cuda.synchronize()
                for stem, got in res.items():
                    e = max(max_err(a, b) for a, b in zip(got, ref))
                    direct[stem] = max(direct[stem], e)
                    if not all(close(a, b, **LSTM_TOL) for a, b in zip(got, ref)):
                        bad.append(f"{stem}/{name}/G={g} ({e:.2e})")
                same = (all(torch.equal(a, b) for a, b in zip(res["lstm_grouped"],
                                                               res["lstm_stream"]))
                        and all(torch.equal(a, b) for a, b in zip(res["lstm_grouped"],
                                                                   repeats[0]))
                        and all(torch.equal(a, b) for a, b in zip(res["lstm_stream"],
                                                                   repeats[1])))
                if not same:
                    bad.append(f"K7 / K8 / their repeats not bitwise equal at {name}/G={g}")
            if route.split != lstm_fused.lstm_route(n, t, GROUPED_D, H).split:
                fail(f"grouped_route {route} and lstm_route split {name} differently")
            k1_res, fed = k1_fed_scan(x, mask, p_fw, p_bw, (k7, k8))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for got in fed for a, b in zip(got, k1_res)):
                e = max(max_err(a, b) for got in fed for a, b in zip(got, k1_res))
                bad.append(f"K7/K8 fed K1's projection differ from K1 at {name} ({e:.2e})")
    log(f"K7, K8 directly vs the plain grouped scan at {len(GROUPED_SHAPES)} shapes, G=2 and "
        f"G=1: max|err| " + ", ".join(f"{k} {v:.2e}" for k, v in direct.items())
        + "; K7 == K8 == repeats bitwise; K7, K8 fed K1's projection == K1 bitwise  "
        + ("ok" if not bad else "MISMATCH " + str(bad)))
    if bad:
        fail(f"K7 or K8 disagrees with the plain grouped scan, each other or K1 at {bad}")
    return {"launches": launches, "max_abs_err": direct, "api_max_abs_err": api,
            "max_abs_err_vs_k1": vs_k1}


@contextlib.contextmanager
def stacked_api_form():
    """bilstm_grouped's former host path, swapped in for
    lstm_grouped._bi_forward: x_proj stacked from two products and their bias
    adds, lengths and both directions' Wh copied into new stacked tensors at
    every call. The "before" of the host-work repairs; it launches whatever
    kernel the routing (or forced_scan) gives it."""
    import torch

    from fvta_memexqa_torch.ops import lstm_grouped
    from fvta_memexqa_torch.ops.lstm_ref import _flip_to_front

    def bi_forward(x, mask, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
        lengths = mask.sum(1, dtype=torch.int32)
        xp = torch.stack([x @ wx_f + b_f, _flip_to_front(x, lengths) @ wx_b + b_b])
        n, t = x.shape[:2]
        k7, k8 = lstm_grouped._kernels(x.device)
        out, fin = (k8 if lstm_grouped.uses_stream(n, t) else k7)(
            xp.contiguous(), lengths[None].expand(2, -1).contiguous(),
            torch.stack([wh_f, wh_b]).contiguous(), forget_bias)
        return (torch.cat([out[0], _flip_to_front(out[1], lengths)], dim=-1),
                torch.cat([fin[0], fin[1]], dim=-1))

    real = lstm_grouped._bi_forward
    lstm_grouped._bi_forward = bi_forward
    try:
        yield
    finally:
        lstm_grouped._bi_forward = real


def host_trace(fn, reps: int = 5) -> dict:
    """Host work of one call of fn: its wall time with nothing waited on
    (host_ms: Python, the ops' dispatch and the launches), and torch.profiler's
    CPU-only trace of the same calls: each op's self host ms per call, largest
    first, and their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: e.self_cpu_time_total / 1e3 / reps for e in prof.key_averages()
           if e.key != "cudaDeviceSynchronize"}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    calls = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")) / reps
    # where the three largest ops are called from: self ms per call by caller chain
    callers: dict[str, dict[str, float]] = {name: {} for name, _ in top[:3]}
    for e in prof.events():
        if e.name in callers:
            chain, p = [], e.cpu_parent
            while p is not None and len(chain) < 3:
                chain.append(p.name)
                p = p.cpu_parent
            key = " < ".join(chain) or "(top level)"
            ms = e.self_cpu_time_total / 1e3 / reps
            callers[e.name][key] = callers[e.name].get(key, 0.0) + ms
    return {"host_ms": host, "ops_self_ms_sum": sum(ops.values()), "aten_ops_per_call": calls,
            "top_ops_self_ms": dict(top), "top_ops_callers": callers}


GROUPED_TRACED = ("photo_title_words", "enc_album_title")   # host traces of the API


def grouped_times(device, grouped: dict, from_cli: dict) -> tuple[list, list, dict]:
    """Phase 17. Per phase-15 shape (G = 2): the scan alone on the precomputed
    x_proj — K7 and K8 under CUDA events (two readings each) and replayed
    from a CUDA graph — and its plain version; the API's projection + scan (the
    bi-LSTM encode from x) as routed, by events and graph, with its host path
    and with the stacked one it replaced (stacked_api_form), forced through K7
    and K8, through the plain scan, beside K1 (bilstm_fused:
    the same function) and cuDNN's nn.LSTM. Bounds over the valid positions:
    the scan's own (x_proj, Wh → out, fin: k1_bounds' "rec") and the encode's
    (x and the weights → out, fin: k1_bounds' "fn"). At GROUPED_TRACED, the
    API's host trace in both forms. `grouped` is grouped_check's result;
    `from_cli` the K7/K8 launches counted over every command this script ran
    (each 0: no command reaches them)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    from fvta_memexqa_torch.ops import lstm_fused, lstm_grouped

    k7, k8 = lstm_grouped.scan_grouped, lstm_grouped.scan_stream
    rows, tot, traces = [], {}, {}
    for i, (name, n, t) in enumerate(GROUPED_SHAPES):
        d = GROUPED_D
        x, mask, p_fw, p_bw = lstm_case(n, t, d, H, 1000 + i, device)
        lens = mask.sum(1)
        args = grouped_x_proj(x, mask, p_fw, p_bw) + (1.0,)
        scans = {"k7": lambda: k7(*args), "k8": lambda: k8(*args)}
        api = lambda: lstm_grouped.bilstm_grouped(p_fw, p_bw, x, mask)
        with torch.no_grad():
            row = {"name": name, "rows": n, "T": t, "D": d,
                   "kernel": "lstm_stream" if lstm_grouped.uses_stream(n, t) else "lstm_grouped",
                   "route": lstm_grouped.grouped_route(2, n, t, H)._asdict()}
            for k, fn in scans.items():
                n1, n2 = cuda_ms(fn), cuda_ms(fn)
                row[f"{k}_ms"], row[f"{k}_events_ms"] = (n1 + n2) / 2, [n1, n2]
                row[f"{k}_graph_ms"] = graph_ms(fn)
            row["plain_ms"] = cuda_ms(lambda: lstm_grouped.grouped_scan_ref(*args), iters=5,
                                      warmup=1)
            row["api_ms"], row["api_graph_ms"] = cuda_ms(api), graph_ms(api)
            with stacked_api_form():
                row["api_stacked_ms"] = cuda_ms(api)
                row["api_stacked_graph_ms"] = graph_ms(api)
            for key, kernel in (("api_k7", k7), ("api_k8", k8)):
                with forced_scan(kernel):
                    row[f"{key}_ms"] = cuda_ms(api)
            with forced_scan(lstm_grouped.grouped_scan_ref):
                row["api_plain_ms"] = cuda_ms(api, iters=10)
            k1 = lambda: lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
            row["k1_ms"], row["k1_graph_ms"] = cuda_ms(k1), graph_ms(k1)
            lstm = cudnn_lstm(p_fw, p_bw, 1.0, d, H, device)
            live = lens > 0
            packed = pack_padded_sequence(x[live], lens[live].cpu(), batch_first=True,
                                          enforce_sorted=False)
            row["library_ms"] = cuda_ms(lambda: lstm(packed))
            if name in GROUPED_TRACED:
                traces[name] = {"api": host_trace(api)}
                with stacked_api_form():
                    traces[name]["api_stacked"] = host_trace(api)
        steps = int(lens.sum())
        bounds = k1_bounds(n, t, d, H, steps, True)
        row.update(valid_steps=steps, bound_ms=max(bounds["rec"]),
                   bound_by="bytes" if bounds["rec"][0] >= bounds["rec"][1] else "operations",
                   encode_bound_ms=max(bounds["fn"]))
        rows.append(row)
        for k, v in row.items():
            if k.endswith("_ms") and isinstance(v, float):
                tot[k] = tot.get(k, 0.0) + v
        for k, (b_ms, o_ms) in (("scan", bounds["rec"]), ("encode", bounds["fn"])):
            tot[f"{k}_bytes"] = tot.get(f"{k}_bytes", 0.0) + b_ms
            tot[f"{k}_ops"] = tot.get(f"{k}_ops", 0.0) + o_ms
        log(f"K7/K8 times  {name:18s} N={n:4d} T={t:2d} {json.dumps(row['route'])}: scan K7 "
            f"{row['k7_ms']:.4f} (graph {row['k7_graph_ms']:.4f}), K8 {row['k8_ms']:.4f} "
            f"({row['k8_graph_ms']:.4f}); scan bound {row['bound_ms']:.4f}; API "
            f"{row['api_ms']:.3f} (graph {row['api_graph_ms']:.3f}), stacked form "
            f"{row['api_stacked_ms']:.3f} ({row['api_stacked_graph_ms']:.3f}); K1 "
            f"{row['k1_ms']:.3f} ({row['k1_graph_ms']:.3f}), cuDNN {row['library_ms']:.3f}, "
            f"encode bound {row['encode_bound_ms']:.4f} ms")
    by = "bytes" if tot["scan_bytes"] >= tot["scan_ops"] else "operations"
    work = (f"the scan alone on the precomputed x_proj (G = 2) at the {len(rows)} shapes of "
            "phase 15 (the 9 bi-LSTM calls of a batch-64 train step and the two routing "
            "edges), sum; ms: CUDA events, the mean of two runs; graph_ms: replayed from a "
            "CUDA graph; api_*: the API's projection + scan (the bi-LSTM encode from x) "
            "forced through this kernel (api_ms, events) and as routed (api_routed_*); "
            "encode_*: the encode's bound, cuDNN's nn.LSTM and K1 on the same function")
    entries = []
    for stem, key, line, launches in (
            ("lstm_grouped", "k7", 35, grouped["launches"]["lstm_grouped"]),
            ("lstm_stream", "k8", 123, grouped["launches"]["lstm_stream"])):
        entries.append({
            "name": stem, "route": "cuda",
            "source": f"fvta_memexqa_torch/csrc/{stem}.cu",
            "replaces": f"fvta_memexqa_tpu/ops/lstm_pallas.py:{line}",
            "launches": launches, "launches_from_cli": from_cli.get(stem),
            "max_abs_err": grouped["max_abs_err"][stem],
            "ms": tot[f"{key}_ms"], "kernel_ms": tot[f"{key}_ms"],
            "graph_ms": tot[f"{key}_graph_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["scan_bytes"], tot["scan_ops"]), "bound_by": by,
            "library_ms": None,
            "encode_bound_ms": max(tot["encode_bytes"], tot["encode_ops"]),
            "encode_library_ms": tot["library_ms"], "encode_k1_ms": tot["k1_ms"],
            "encode_k1_graph_ms": tot["k1_graph_ms"], "encode_plain_ms": tot["api_plain_ms"],
            "timed_work": work, "api_max_abs_err": grouped["api_max_abs_err"][stem],
            "max_abs_err_vs_k1": grouped["max_abs_err_vs_k1"][stem],
            "api_ms": tot[f"api_{key}_ms"], "api_routed_ms": tot["api_ms"],
            "api_routed_graph_ms": tot["api_graph_ms"],
            "api_routed_stacked_ms": tot["api_stacked_ms"],
            "api_routed_stacked_graph_ms": tot["api_stacked_graph_ms"]})
    return entries, rows, traces


# ---- the evaluation path: cli prepro | test | ablate -------------------------------

EVAL_TOL = 1e-5          # cached vs uncached `cli test` loss (relative)
GLOVE_TEXT_ATOL = 5.5e-6  # glove.txt keeps 5 decimals of each GloVe value


def cli_text(argv) -> tuple[int, str]:
    """(return code, stdout) of an in-process `cli.main(argv)`."""
    import contextlib
    import io

    from fvta_memexqa_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc or 0, buf.getvalue()


def cli_json(argv) -> tuple[dict, float]:
    """(the last stdout line of `cli.main(argv)` as JSON, host seconds)."""
    t0 = time.perf_counter()
    _, text = cli_text(argv)
    wall = time.perf_counter() - t0
    return json.loads(text.strip().splitlines()[-1]), wall


def prepro_check(workdir: str) -> dict:
    """`cli prepro` on the raw files write_raw_files writes for phase 4's corpus
    objects: the pack must equal phase 4's, array for array (word_emb_init to
    the 5 decimals glove.txt keeps, every other array and the metadata exactly)."""
    import numpy as np

    from fvta_memexqa_torch.data import load_pack, make_synthetic, write_raw_files

    raw, pack = os.path.join(workdir, "raw"), os.path.join(workdir, "pack_prepro")
    write_raw_files(raw, *make_synthetic(**SLICE_CORPUS))
    files = [os.path.join(raw, f) for f in ("qas.json", "album_info.json",
                                            "test_question.ids", "glove.txt",
                                            "photo_feats.npz")]
    res, wall = cli_json(["prepro", *files, pack, "--seed", "0", "--image-feat-dim",
                          str(SLICE_CORPUS["feat_dim"])])
    mine, ref = load_pack(pack), load_pack(os.path.join(workdir, "pack"))
    bad = [] if mine.meta == ref.meta else ["meta.json"]
    glove_err = 0.0
    for k, v in ref.shared.__dict__.items():
        a = getattr(mine.shared, k)
        if k == "word_emb_init":
            glove_err = float(np.abs(a - v).max()) if v.size else 0.0
            if a.shape != v.shape or glove_err > GLOVE_TEXT_ATOL:
                bad.append(k)
        elif not np.array_equal(a, v):
            bad.append(k)
    for split, arrays in ref.splits.items():
        for k, v in arrays.items():
            if not np.array_equal(mine.splits.get(split, {}).get(k), v):
                bad.append(f"{split}.{k}")
    log(f"cli prepro on write_raw_files' files ({wall:.1f} s): {json.dumps(res)}; vs phase "
        f"4's pack: word_emb_init max|d| {glove_err:.2e} (glove.txt rounding), "
        f"{'every other array equal' if not bad else 'DIFFERS ' + str(bad)}")
    if bad:
        fail(f"cli prepro's pack differs from phase 4's at {bad}")
    return {"wall_s": wall, "result": res, "word_emb_init_max_abs_d": glove_err}


def eval_check(workdir: str, device: str = "cuda") -> dict:
    """Phase 16. The evaluation path on the card over phase 7's run directories
    and phase 4's pack, with the K1 and K2 counters zeroed before and read
    after: `cli test` cached, --no-album-cache, --by-category, --dump-attention
    and --ensemble over both runs; `cli prepro` (prepro_check); `cli ablate
    --num-steps 6` over fvta,flat,none. Cached and uncached agree (accuracy
    exactly, loss to EVAL_TOL), the by-category counts sum to the split, and
    predict_cached's probabilities on the card match the CPU's at ENGINE_TOL."""
    import numpy as np

    from fvta_memexqa_torch import eval_cache
    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.config import load_config
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.ops import fvta_fused

    zero_grouped_counters()
    pack = os.path.join(workdir, "pack")
    plain, dedup = (os.path.join(workdir, d) for d in ("train_plain", "train_dedup"))
    attn = os.path.join(workdir, "eval_attention.npz")
    zero_lstm_counters()
    out, walls = {}, {}
    with Recorder(fvta_fused, "fvta_fwd", keep=1) as k2_calls:
        for key, extra in (("cached", []), ("uncached", ["--no-album-cache"]),
                           ("cached_again", []), ("uncached_again", ["--no-album-cache"]),
                           ("by_category", ["--by-category", "--no-album-cache"]),
                           ("dump_attention", ["--dump-attention", attn]),
                           ("ensemble", ["--ensemble", dedup, "--by-category"])):
            out[key], walls[key] = cli_json(["test", pack, plain, "--device", device, *extra])
            log(f"cli test {key:15s} {walls[key]:6.2f} s: {json.dumps(out[key])[:200]}")
        prepro = prepro_check(workdir)
        ablate, walls["ablate"] = cli_json(["ablate", pack, os.path.join(workdir, "ablate"),
                                            "--num-steps", "6", "--device", device])
        launches = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches}
    record_k2_path("evaluation", k2_calls)
    grouped = grouped_counters()
    log(f"cli ablate --num-steps 6 ({walls['ablate']:.1f} s): {json.dumps(ablate)}; "
        f"evaluation phase launches {json.dumps(launches)}, K7/K8 {json.dumps(grouped)}")
    c, u = out["cached"], out["uncached"]
    n_test = len(load_pack(pack).splits["test"]["label"])
    bc = out["by_category"]["by_category"]
    z = np.load(attn)
    problems = []
    if launches["fvta_fwd"] == 0:
        problems.append(f"a kernel never launched: {launches}")
    check_lstm_launches("evaluation", launches, backward=True)
    if c["accuracy"] != u["accuracy"] or abs(c["loss"] - u["loss"]) > EVAL_TOL * abs(u["loss"]):
        problems.append(f"cached {c} vs uncached {u}")
    if c["count"] != n_test or sum(v["count"] for v in bc.values()) != n_test:
        problems.append(f"counts: test {c['count']}, by category {bc}, split {n_test}")
    if z["probs"].shape != (n_test, 4) or not np.isfinite(z["time_attn"]).all():
        problems.append(f"attention dump {[(k, z[k].shape) for k in z.files]}")
    if len(out["ensemble"]["members"]) != 2 or set(ablate) != {"fvta", "flat", "none"}:
        problems.append("ensemble members or ablate variants missing")
    if not all(math.isfinite(v["test_acc"]) and v["steps"] == 6 for v in ablate.values()):
        problems.append(f"ablate {ablate}")

    # predict_cached on the card vs the CPU from the same weights
    packed = load_pack(pack)
    cfg = load_config(os.path.join(plain, "config.json")).replace(data=packed.cfg)
    probs = {}
    for dev in ("cpu", device):
        model = tr.restore_model(cfg, plain, True, dev)
        shared = SharedTables.from_packed(packed.shared, dev)
        probs[dev] = eval_cache.predict_cached(cfg, model, shared, Dataset(packed, "test"),
                                               128)["probs"]
    d_probs = float(np.abs(probs[device] - probs["cpu"]).max())
    log(f"predict_cached card vs CPU over {n_test} questions: max|d probs| {d_probs:.3e}")
    if d_probs > ENGINE_TOL:
        problems.append(f"predict_cached on the card vs the CPU: {d_probs}")
    if problems:
        fail("evaluation path: " + "; ".join(problems))
    return {"launches": launches, "grouped_launches": grouped, "test": out, "wall_s": walls,
            "prepro": prepro,
            "ablate": ablate, "predict_cached_max_abs_d_probs_vs_cpu": d_probs}


# ---- phase 18: every width the JAX package takes (the global routes) -------------

# PERF.md section 6's CUDA-graph ms of the routes the repo's widths take (K7/K8
# summed over the phase-15 shapes; NVIDIA H100 80GB HBM3, 700 W). The global
# routes leave these routes' code as it was: this run's times are printed
# beside them.
PERF_MD_GRAPH_MS = {
    "fvta_fwd N=1": 0.0210, "fvta_fwd N=8": 0.0265, "fvta_fwd N=64": 0.0711,
    "fvta_fwd N=128": 0.0969, "stats_fwd": 0.0460, "qcnt": 0.0389, "stats_bwd": 0.1545,
    "stats_fwd (cli video call)": 0.0280, "qcnt (cli video call)": 0.0250,
    "stats_bwd (cli video call)": 0.0823, "lstm_grouped": 0.8975, "lstm_stream": 0.9945}
K2_FIELDS = ("context", "question", "time_attn", "seq_attn")
WIDTH_VIDEO_STEPS = 3


def global_wrappers() -> dict:
    """The kernels with a global route, by their launch counters' names."""
    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats, lstm_grouped

    return {"fvta_fwd": fvta_fused.fvta_fwd, "stats_fwd": fvta_stats.stats_fwd,
            "qcnt": fvta_stats.qcnt, "stats_bwd": fvta_stats.stats_bwd,
            "scan_grouped": lstm_grouped.scan_grouped, "scan_stream": lstm_grouped.scan_stream}


def global_counters() -> dict:
    """Each routed kernel's launches on its global route so far."""
    return {k: fn.global_launches for k, fn in global_wrappers().items()}


def zero_global_counters() -> None:
    for fn in global_wrappers().values():
        fn.global_launches = 0


def last_staged(route_of, lo: int, hi: int) -> int:
    """The largest width in [lo, hi) whose geometry stages: route_of(lo) is
    "staged", route_of(hi) "global", and the routes stage up to one limit."""
    if route_of(lo) != "staged" or route_of(hi) != "global":
        fail(f"widths: the routes at {lo} and {hi} are {route_of(lo)} and {route_of(hi)}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if route_of(mid) == "staged" else (lo, mid)
    return lo


def width_stats_case(label: str, args, force_global: bool = False) -> dict:
    """K4, K5 (from K4's eq) and K6 (N(0, 1) cotangents) on the routes the
    shape takes, or forced global, vs their plain versions: K4's and K6's
    fields at their tolerances or on the float64 witness, K5's counts exactly
    and >= 1. Fatal on a mismatch; returns the routes, the errors, the outputs
    and the cotangents."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = args
    n, s, t, d = h.shape
    j = q.shape[1]
    k4, k5, k6 = ((fs.stats_fwd_global, fs.qcnt_global, fs.stats_bwd_global) if force_global
                  else (fs.stats_fwd, fs.qcnt, fs.stats_bwd))
    g = torch.Generator().manual_seed(71)
    cot = [torch.randn(sh, generator=g).to(h.device) for sh in ((n, s, t), (n, j), (n, s, d))]
    de, geq, gv = cot
    with torch.no_grad():
        st = k4(*args)
        cnt = k5(h, cm, q, wx, wy, wxy, st[3])
        dk = k6(*args, de, geq, st[3], cnt, st[4], st[0], gv)
        ref = fs.stats_fwd_ref(*args)
        cnt_r = fs.qcnt_ref(h, cm, q, wx, wy, wxy, ref[3])
        dr = fs.stats_bwd_ref(*args, de, geq, ref[3], cnt_r, ref[4], ref[0], gv)
        a64 = [a.double() for a in args]
        r64 = fs.stats_fwd_ref(*a64)
        d64 = fs.stats_bwd_ref(*a64, de.double(), geq.double(), r64[3],
                               fs.qcnt_ref(*a64[:3], *a64[4:], r64[3]), r64[4], r64[0],
                               gv.double())
    torch.cuda.synchronize()
    res4 = [field_ok(a, b, c, STATS_TOL) for a, b, c in zip(st, ref, r64)]
    res6 = [field_ok(a, b, c, GRAD_TOL) for a, b, c in zip(dk, dr, d64)]
    ok5 = bool(torch.equal(cnt, cnt_r)) and bool((cnt >= 1).all())
    finite = all(bool(torch.isfinite(a).all()) for a in (*st[:3], *dk))
    routes = (fs.run_geometry(n, s, t, j, d, force_global)["route"],
              fs.bwd_geometry(n, s, t, j, d, force_global)["route"])
    e4 = [max_err(a, b) for a, b in zip(st, ref)]
    e6 = [max_err(a, b) for a, b in zip(dk, dr)]
    ok = all(r[0] for r in res4 + res6) and ok5 and finite
    log(f"widths: K4/K5/K6 {label:28s} N={n} S={s} T={t} J={j} D={d} routes K4/K5 "
        f"{routes[0]}, K6 {routes[1]}: K4 " + " ".join(
            f"{k} {e:.2e}{r[1]}" for k, e, r in zip(STATS_NAMES, e4, res4))
        + f"; K5 {'equal' if ok5 else 'DIFFERENT'}; K6 " + " ".join(
            f"{k} {e:.2e}{r[1]}" for k, e, r in zip(BWD_NAMES, e6, res6))
        + f"  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"widths: K4/K5/K6 at {label} ({routes}) disagree with their plain versions")
    return {"routes": routes, "k4_max_abs_err": max(e4), "k6_max_abs_err": max(e6),
            "out": (st, cnt, dk), "cot": cot}


def same_bits(what: str, a, b) -> None:
    import torch

    if not all(bool(torch.equal(x, y)) for x, y in zip(a, b)):
        fail(f"widths: {what} differ in their bits")


def width_stats_checks() -> dict:
    """K4/K5 and K6 vs plain at both sides of each of their limits (J = 30 and
    512) and at D = 2048; the forced global route against the staged one bit
    for bit at the T=4096 step's shape (K4's fields, K5's counts, K6's outputs;
    K6 fed either route's K4/K5; two launches of each global kernel); K6's
    geq-only case at J = 30, D = 560, where K4/K5 stage and K6 does not."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    out = {"limits": {}, "cases": {}}
    for j, t in ((30, 100), (512, 70)):
        d45 = last_staged(lambda d: fs.run_geometry(1, 1, t, j, d)["route"], 100, 2048)
        d6 = last_staged(lambda d: fs.bwd_geometry(1, 1, t, j, d)["route"], 100, 2048)
        out["limits"][f"J={j}"] = {"k45_last_staged_d": d45, "k6_last_staged_d": d6}
        for d in (d45, d45 + 1, d6, d6 + 1) + ((2048,) if j == 30 else ()):
            r = width_stats_case(f"J={j} D={d}", stats_case(2, 1, t, j, d, 500 + d, "cuda", True))
            want = ("staged" if d <= d45 else "global", "staged" if d <= d6 else "global")
            if r["routes"] != want:
                fail(f"widths: J={j} D={d} took {r['routes']}, expected {want}")
            out["cases"][f"J={j} D={d}"] = {k: r[k] for k in ("routes", "k4_max_abs_err",
                                                               "k6_max_abs_err")}
    args = stats_case(8, 1, VIDEO_T, 30, 200, 501, "cuda", True)
    staged = width_stats_case("staged, the T=4096 shape", args)
    forced = width_stats_case("forced global, T=4096 shape", args, force_global=True)
    if staged["routes"] != ("staged", "staged") or forced["routes"] != ("global", "global"):
        fail(f"widths: routes {staged['routes']} / {forced['routes']}")
    same_bits("K4's fields on the two routes", staged["out"][0], forced["out"][0])
    same_bits("K5's counts on the two routes", staged["out"][1:2], forced["out"][1:2])
    same_bits("K6's outputs on the two routes", staged["out"][2], forced["out"][2])
    st_g, cnt_g, _ = forced["out"]
    de, geq, gv = forced["cot"]
    h, cm, q, qm, wx, wy, wxy = args
    with torch.no_grad():
        k6_on_global = fs.stats_bwd(*args, de, geq, st_g[3], cnt_g, st_g[4], st_g[0], gv)
        again = (fs.stats_fwd_global(*args), fs.qcnt_global(h, cm, q, wx, wy, wxy, st_g[3]),
                 fs.stats_bwd_global(*args, de, geq, st_g[3], cnt_g, st_g[4], st_g[0], gv))
        torch.cuda.synchronize()
    same_bits("K6 fed the global and the staged K4/K5", k6_on_global, staged["out"][2])
    same_bits("two launches of the global K4", again[0], st_g)
    same_bits("two launches of the global K5", again[1:2], [cnt_g])
    same_bits("two launches of the global K6", again[2], forced["out"][2])
    log("widths: at N=8 S=1 T=4096 J=30 D=200 the forced global K4, K5 and K6 equal the "
        "staged ones bit for bit, K6 on either route's K4/K5 too, and each global kernel "
        "repeats its bits")
    geq_args = stats_case(2, 1, 1024, 30, 560, 502, "cuda")
    routes = (fs.run_geometry(2, 1, 1024, 30, 560)["route"],
              fs.bwd_geometry(2, 1, 1024, 30, 560)["route"])
    if routes != ("staged", "global"):
        fail(f"widths: at J=30 D=560 K4/K5 and K6 took {routes}, expected staged / global")
    out["k6_geq_only_d560_max_abs_err"] = k6_geq_only_check("J=30 D=560 (K4/K5 staged, "
                                                            "K6 global)", geq_args)
    out["forced_global_bitwise_at_d200"] = True
    return out


def width_k2_checks() -> dict:
    """K2 vs plain at both sides of its limit at three shapes (MemexQA's S = T
    = 24, one long sequence, the long question) and at D = 2048 (similarity
    weights at the models' N(0, 0.1) scale); the forced global route at the
    answer batch's D = 200 within FVTA_TOL of the staged one, and repeating
    its bits."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused

    out = {}
    for n, s, t, j in ((2, 24, 24, 30), (2, 1, 512, 30), (2, 8, 64, 512)):
        d_last = last_staged(lambda d: fvta_fused.geometry(n, s, t, j, d)["route"], 200, 2048)
        for d in (d_last, d_last + 1, 2048):
            h, cm, q, qm, p = fvta_case((n, s, t, j, d), 510 + d, "cuda", masked=True)
            p = {k: 0.1 * v for k, v in p.items()}
            before = fvta_fused.fvta_fwd.global_launches
            with torch.no_grad():
                got = fvta_fused.fvta_fwd(*k2_args(h, cm, q, qm, "trilinear", p))
            ref = k2_plain(h, cm, q, qm, "trilinear", p)
            torch.cuda.synchronize()
            route = fvta_fused.geometry(n, s, t, j, d)["route"]
            errs = [max_err(a, b) for a, b in zip(got, ref)]
            ok = (all(close(a, b, **FVTA_TOL) for a, b in zip(got, ref))
                  and route == ("staged" if d <= d_last else "global")
                  and fvta_fused.fvta_fwd.global_launches == before + (route == "global"))
            log(f"widths: K2 N={n} S={s} T={t} J={j} D={d} ({route}) vs plain: "
                + " ".join(f"{k} {e:.2e}" for k, e in zip(K2_FIELDS, errs))
                + f"  {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"widths: K2 at N={n} S={s} T={t} J={j} D={d} ({route})")
            out[f"S={s} T={t} J={j} D={d}"] = {"route": route, "max_abs_err": max(errs)}
        out[f"S={s} T={t} J={j} last staged D"] = d_last
    h, cm, q, qm, p = fvta_case((8, 24, 24, 30, 200), 520, "cuda", masked=True)
    args = k2_args(h, cm, q, qm, "trilinear", p)
    with torch.no_grad():
        a, b = fvta_fused.fvta_fwd_global(*args), fvta_fused.fvta_fwd_global(*args)
        staged = fvta_fused.fvta_fwd(*args)
    torch.cuda.synchronize()
    same_bits("two launches of the global K2", a, b)
    if not all(close(x, y, **FVTA_TOL) for x, y in zip(a, staged)):
        fail("widths: the forced global K2 is beyond FVTA_TOL of the staged one")
    out["forced_global_vs_staged_d200_max_abs_err"] = max(max_err(x, y)
                                                          for x, y in zip(a, staged))
    return out


def width_scan_case(g: int, n: int, t: int, h: int, seed: int):
    """G groups' scan inputs (x_proj [G, N, T, 4H], lengths, Wh [G, H, 4H]) of
    a bi-LSTM at width h over x of width 200."""
    x, mask, p_fw, p_bw = lstm_case(n, t, 200, h, seed, "cuda")
    xp, lens, wh = grouped_x_proj(x, mask, p_fw, p_bw)
    return xp[:g].contiguous(), lens[:g].contiguous(), wh[:g].contiguous()


def width_scan_checks() -> dict:
    """K7 and K8 vs plain at H = 315 (the last width whose Wh slices a cluster
    holds), 316, 512 and 1024: K7 == K8 and repeats bitwise, the global
    launches counted; with Wh forced global at the resident route's (C, rows,
    S), the resident kernels' bits (H = 100 at clusters of 2 and of 1 with
    16-row tiles, H = 315 at clusters of 8)."""
    import torch

    from fvta_memexqa_torch.ops import lstm_grouped as lg

    out = {}
    for g, n, t, h in ((2, 64, 6, 315), (2, 64, 6, 316), (2, 256, 8, 512), (1, 17, 3, 1024)):
        xp, lens, wh = width_scan_case(g, n, t, h, 530 + h)
        route = lg.grouped_route(g, n, t, h)
        g7, g8 = lg.scan_grouped.global_launches, lg.scan_stream.global_launches
        with torch.no_grad():
            k7, k8 = lg.scan_grouped(xp, lens, wh, 1.0), lg.scan_stream(xp, lens, wh, 1.0)
            k7b, k8b = lg.scan_grouped(xp, lens, wh, 1.0), lg.scan_stream(xp, lens, wh, 1.0)
            ref = lg.grouped_scan_ref(xp, lens, wh, 1.0)
        torch.cuda.synchronize()
        same_bits(f"K7 and K8 at H={h}", k7, k8)
        same_bits(f"two launches of K7 at H={h}", k7, k7b)
        same_bits(f"two launches of K8 at H={h}", k8, k8b)
        errs = [max_err(a, b) for a, b in zip(k7, ref)]
        glob = lg.takes_wh_global(g, n, t, h)
        counted = (lg.scan_grouped.global_launches - g7, lg.scan_stream.global_launches - g8)
        ok = (all(close(a, b, **LSTM_TOL) for a, b in zip(k7, ref)) and glob == (h > 315)
              and counted == ((2, 2) if glob else (0, 0)))
        log(f"widths: K7/K8 G={g} N={n} T={t} H={h} route {tuple(route)} Wh "
            f"{'global' if glob else 'resident'}: vs plain out {errs[0]:.2e} fin {errs[1]:.2e}, "
            f"K7 == K8 == repeats bitwise, global launches {counted}  "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"widths: K7/K8 at H={h}")
        out[f"H={h}"] = {"route": tuple(route), "wh_global": glob, "max_abs_err": max(errs)}
    for g, n, t, h in ((2, 256, 12, 100), (2, 3072, 4, 100), (2, 64, 6, 315)):
        xp, lens, wh = width_scan_case(g, n, t, h, 540 + n)
        route = lg.grouped_route(g, n, t, h)
        with torch.no_grad():
            for res, forced in ((lg.scan_grouped, lg.scan_grouped_wh_global),
                                (lg.scan_stream, lg.scan_stream_wh_global)):
                same_bits(f"{forced.__name__} and {res.__name__} at {tuple(route)}, H={h}",
                          res(xp, lens, wh, 1.0), forced(xp, lens, wh, 1.0, route))
        out[f"forced_wh_global_bitwise H={h} route {tuple(route)}"] = True
    log("widths: K7 and K8 with Wh forced global equal the resident kernels bit for bit at "
        "H = 100 (routes (2, 8, 8), (1, 16, 4)) and H = 315 ((8, 8, 4))")
    return out


def width_video_runs() -> dict:
    """The synthetic `cli video` demo at T = 1024 and H = 279 (D = 558: K4/K5
    stage, K6 takes the global route; before the global routes it raised) and H = 300
    (D = 600: all three global), WIDTH_VIDEO_STEPS steps each: finite losses,
    and the counters of K4, K5 and K6 and of their global routes."""
    import contextlib
    import io

    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch import train_video as video_mod   # the plain loop's module
    from fvta_memexqa_torch.ops import fvta_stats as fs

    out = {}
    for hid, want in ((279, ("staged", "global")), (300, ("global", "global"))):
        losses = []
        real = video_mod.video_loss

        def recorded(*a, **k):
            loss, m = real(*a, **k)
            losses.append(float(loss.detach()))
            return loss, m

        kernels = (fs.stats_fwd, fs.qcnt, fs.stats_bwd)
        before = [(k.launches, k.global_launches) for k in kernels]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with Swapped(video_mod, "video_loss", recorded), contextlib.redirect_stdout(buf):
            rc = cli.main(["video", "--hidden-dim", str(hid), "--num-frames", "1024",
                           "--num-videos", "16", "--steps", str(WIDTH_VIDEO_STEPS),
                           "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = {k.__name__: (k.launches - b[0], k.global_launches - b[1])
                  for k, b in zip(kernels, before)}
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        glob = {"stats_fwd": want[0], "qcnt": want[0], "stats_bwd": want[1]}
        ok = (rc == 0 and len(losses) >= WIDTH_VIDEO_STEPS
              and all(map(math.isfinite, losses))
              and counts["qcnt"][0] == counts["stats_bwd"][0] == WIDTH_VIDEO_STEPS
              and all(counts[k][1] == (counts[k][0] if glob[k] == "global" else 0)
                      for k in counts))
        log(f"widths: cli video --hidden-dim {hid} --num-frames 1024 ({WIDTH_VIDEO_STEPS} "
            f"steps, {wall:.1f} s): rc {rc}, losses {losses}, launches (all, global) "
            f"{json.dumps(counts)}; {json.dumps(res)}  {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"widths: cli video --hidden-dim {hid} --num-frames 1024")
        out[f"hidden_dim_{hid}"] = {"rc": rc, "losses": losses, "launches": counts,
                                    "wall_s": wall, "result": res}
    return out


def width_times() -> dict:
    """Each global route timed at a width past its limit and, forced, at the
    repo's width beside the staged route (CUDA events of back-to-back calls,
    CUDA-graph replays, the plain version, the bound from these inputs): K2 at
    N=8 S=T=24 J=30 D=1024 (H = 512) and D=200; K4/K5/K6 at `cli video`'s
    N=16 S=1 T=1024 J=30, D=600 and D=200; K7/K8 at G=2 N=256 T=24 (an album
    encoder) H=512 and H=100."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats as fs, lstm_grouped as lg

    out = {}

    def timed(fn, plain=None):
        with torch.no_grad():
            r = {"ms": cuda_ms(fn, iters=20), "graph_ms": graph_ms(fn)}
            if plain is not None:
                r["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        return r

    for d in (1024, 200):
        h, cm, q, qm, p = fvta_case((8, 24, 24, 30, d), 550 + d, "cuda")
        p = {k: 0.1 * v for k, v in p.items()}
        args = k2_args(h, cm, q, qm, "trilinear", p)
        b_ms, o_ms = k2_bound_ms(h, cm, q, qm)
        row = {"global": timed(lambda: fvta_fused.fvta_fwd_global(*args),
                               lambda: k2_plain(h, cm, q, qm, "trilinear", p)),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else
               "operations", "route_by_shape": fvta_fused.geometry(8, 24, 24, 30, d)["route"]}
        if d == 200:
            row["staged"] = timed(lambda: fvta_fused.fvta_fwd(*args))
        out[f"fvta_fwd D={d}"] = row
    for d in (600, 200):
        a = stats_case(16, 1, 1024, 30, d, 560 + d, "cuda")
        h, cm, q, qm, wx, wy, wxy = a
        with torch.no_grad():
            st = fs.stats_fwd_global(*a)
            cnt = fs.qcnt_global(h, cm, q, wx, wy, wxy, st[3])
        g = torch.Generator().manual_seed(73)
        de, geq, gv = (torch.randn(sh, generator=g).cuda() for sh in ((16, 1, 1024), (16, 30),
                                                                      (16, 1, d)))
        bwd = (*a, de, geq, st[3], cnt, st[4], st[0], gv)
        for name in ("stats_fwd", "qcnt", "stats_bwd"):
            call = lambda k: stats_call(k, bwd)
            b_ms, o_ms = stats_bound_ms(name, h, cm, q)
            row = {"global": timed(call(name + "_global"), call(name + "_ref")),
                   "bound_ms": max(b_ms, o_ms),
                   "bound_by": "bytes" if b_ms >= o_ms else "operations",
                   "route_by_shape": (fs.run_geometry(16, 1, 1024, 30, d) if name != "stats_bwd"
                                      else fs.bwd_geometry(16, 1, 1024, 30, d))["route"]}
            if d == 200:
                row["staged"] = timed(call(name))
            out[f"{name} D={d}"] = row
    for h_dim in (512, 100):
        xp, lens, wh = width_scan_case(2, 256, 24, h_dim, 570 + h_dim)
        route = lg.grouped_route(2, 256, 24, h_dim)
        steps = int(lens[0].sum())
        b_ms, o_ms = k1_bounds(256, 24, 200, h_dim, steps, True)["rec"]
        for name, stem in (("scan_grouped", "lstm_grouped"), ("scan_stream", "lstm_stream")):
            forced = getattr(lg, f"{name}_wh_global")
            row = {"global": timed(lambda: forced(xp, lens, wh, 1.0, route),
                                   lambda: lg.grouped_scan_ref(xp, lens, wh, 1.0)),
                   "bound_ms": max(b_ms, o_ms),
                   "bound_by": "bytes" if b_ms >= o_ms else "operations",
                   "route": tuple(route),
                   "wh_global_by_shape": lg.takes_wh_global(2, 256, 24, h_dim)}
            if h_dim == 100:
                row["staged"] = timed(lambda: getattr(lg, name)(xp, lens, wh, 1.0))
            out[f"{stem} H={h_dim}"] = row
    for k, v in out.items():
        log(f"widths: time {k}: {json.dumps(v)}")
    return out


def staged_vs_perf_md(entries: list) -> dict:
    """This run's CUDA-graph ms of the routes the repo's widths take, from the
    kernels line's entries, beside PERF.md section 6's."""
    got = {}
    for e in entries:
        if e["name"] == "fvta_fwd":
            got.update({f"fvta_fwd N={n}": r["new_graph_ms"] for n, r in e["per_n"].items()})
        elif e["name"] in PERF_MD_GRAPH_MS:
            got[e["name"]] = e["graph_ms"]
    return {k: {"graph_ms": got[k], "perf_md_graph_ms": v, "ratio": got[k] / v}
            for k, v in PERF_MD_GRAPH_MS.items() if k in got}


def widths_phase() -> dict:
    """Phase 18: every width the JAX package takes (the checks above and the
    global routes' times), with each routed kernel's global launches on the
    main path (every earlier phase) read first: 0 at the repo's widths."""
    main_path = global_counters()
    log(f"widths: global-route launches over every earlier phase: {json.dumps(main_path)}")
    if any(main_path.values()):
        fail(f"widths: a global route launched at the repo's widths: {main_path}")
    zero_global_counters()
    out = {"main_path_global_launches": main_path, "stats": width_stats_checks(),
           "k2": width_k2_checks(), "scans": width_scan_checks(),
           "cli_video": width_video_runs(), "times": width_times()}
    out["phase_global_launches"] = global_counters()
    return out


def add_global_routes(entries: list, widths: dict) -> None:
    """Each routed kernel's kernels-line entry gains its global route: the
    times of widths_phase, its launches on the main path (0) and in the
    widths phase."""
    keys = {"fvta_fwd": ("fvta_fwd", "fvta_fwd D=1024", "fvta_fwd D=200"),
            "stats_fwd": ("stats_fwd", "stats_fwd D=600", "stats_fwd D=200"),
            "qcnt": ("qcnt", "qcnt D=600", "qcnt D=200"),
            "stats_bwd": ("stats_bwd", "stats_bwd D=600", "stats_bwd D=200"),
            "lstm_grouped": ("scan_grouped", "lstm_grouped H=512", "lstm_grouped H=100"),
            "lstm_stream": ("scan_stream", "lstm_stream H=512", "lstm_stream H=100")}
    for e in entries:
        if e["name"] in keys:
            counter, past, forced = keys[e["name"]]
            e["global_route"] = {
                "launches": widths["main_path_global_launches"][counter],
                "launches_in_widths_phase": widths["phase_global_launches"][counter],
                "past_the_limit": widths["times"][past],
                "forced_at_the_repo_width": widths["times"][forced]}


# ---- phase 19: the benchmark functions at realistic size -----------------------------

BENCH_K = dict(k_small=10, k_large=60, reps=5)   # the train steps (the JAX bench's K)
BENCH_K_FAST = dict(k_small=25, k_large=250, reps=5)   # inference steps (the JAX bench's K)
BENCH_VIDEO = dict(reps=5, min_signal_s=0.6, k_small=5, k_large=60)   # bench_video's defaults
PROFILED_TRAIN_STEPS = 10   # the train step's breakdown: wall and device time over 10 steps


class SlopeRecorder:
    """bench_lib._median_slope called through a wrapper that times each of its
    run(k) calls, so that every reading carries the spread of its reps: the
    library's median is returned unchanged, and `spread()` gives the last
    call's rep slopes (each rep: run(k_small), then run(k_small) and
    run(k_large) timed, as _median_slope times them)."""

    def __init__(self, bl):
        self.bl, self.real, self.calls = bl, bl._median_slope, []

    def __enter__(self):
        def recording(run, k_small, k_large, reps):
            durations = []

            def timed(k):
                t0 = time.perf_counter()
                run(k)
                durations.append(time.perf_counter() - t0)

            per = self.real(timed, k_small, k_large, reps)
            # the two warm-up calls, then (drain, k_small, k_large) per rep
            self.calls.append([(durations[3 * r + 4] - durations[3 * r + 3])
                               / (k_large - k_small) for r in range(reps)])
            return per

        self.bl._median_slope = recording
        return self

    def __exit__(self, *exc):
        self.bl._median_slope = self.real
        return False

    def spread(self, call: int = -1) -> dict:
        """A call's rep slopes (default the last call's): min, median, max (ms
        per step) and (max - min) / median."""
        slopes = sorted(self.calls[call])
        med = slopes[len(slopes) // 2]
        return {"reps": len(slopes), "rel_spread": (slopes[-1] - slopes[0]) / med,
                "min_step_ms": slopes[0] * 1e3, "median_step_ms": med * 1e3,
                "max_step_ms": slopes[-1] * 1e3}


def bench_phase(smi: str) -> dict:
    """Phase 19: bench_lib at realistic_config (12000 words, 630 albums, 5090
    photos, F = 2537, H = 100) on this card: train and dedup train at batch
    64, cached inference at batch 64 (f32 and bf16 cache, with the cache's
    seconds), full inference at 8, 64 and 256, video at T = 1024 and 4096
    (frames/s, the MFU guard against device_peaks), step_cost of the serving
    forward and the train step with each layer's FLOP and byte share, and a
    torch.profiler breakdown of the train step over PROFILED_TRAIN_STEPS steps
    (the index backward's share). Every reading is the median of its reps
    with their spread (`spread`); K's and reps are the JAX bench's defaults
    (BENCH_K, BENCH_K_FAST, BENCH_VIDEO), reps raised to 5."""
    import torch

    from fvta_memexqa_torch import bench_lib as bl
    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.optim import Optimizer

    cfg = bl.realistic_config()
    peaks = bl.device_peaks()
    out = {"card": smi, "peaks": peaks, "k": {"train": BENCH_K, "inference": BENCH_K_FAST,
                                             "video": BENCH_VIDEO}}
    spread = {}
    t0 = time.perf_counter()
    with SlopeRecorder(bl) as rec:
        out["train_qa_pairs_per_s"] = bl.bench_train(cfg, 64, **BENCH_K)
        spread["train"] = rec.spread()
        out["train_dedup_qa_pairs_per_s"], out["dedup_unique_frac"] = bl.bench_train_dedup(
            cfg, 64, **BENCH_K)
        spread["train_dedup"] = rec.spread()
        qps, cache_s, pre = bl.bench_cached_inference(cfg, 64, **BENCH_K_FAST)
        spread["cached_inference"] = rec.spread()
        qps16, _, _ = bl.bench_cached_inference(cfg, 64, prebuilt=pre,
                                                cache_dtype="bfloat16", **BENCH_K_FAST)
        spread["cached_inference_bf16"] = rec.spread()
        out["cached_inference"] = {"qa_pairs_per_s": qps, "cache_s": cache_s,
                                   "bf16_cache_qa_pairs_per_s": qps16}
        out["inference"] = [dataclasses.asdict(r) for r in
                            bl.bench_inference(cfg, (8, 64, 256), **BENCH_K_FAST)]
        for i, r in enumerate(out["inference"]):
            spread[f"inference_b{r['batch_size']}"] = rec.spread(i - 3)
        out["video"] = {}
        for t in (1024, 4096):
            cost = bl.video_step_cost(t)
            fps = bl.bench_video(t, True, 8, flops_per_step=cost["flops"],
                                 peak_flops=peaks[0] if peaks else None, **BENCH_VIDEO)
            spread[f"video_T{t}"] = rec.spread()
            out["video"][f"T={t}"] = {"frames_per_s": fps, "flops_per_step": cost["flops"],
                                      "bytes_per_step": cost["bytes"],
                                      "mfu": None if fps is None or not peaks else
                                      cost["flops"] * fps / (8 * t) / peaks[0]}
    out["spread"] = spread
    costs = {"serving_forward_b64": bl.step_cost(cfg, 64),
             "train_step_b64": bl.step_cost(cfg, 64, train=True)}
    for name, c in costs.items():
        c["flop_share"] = {k: v["flops"] / c["flops"] for k, v in c["layers"].items()}
        c["byte_share"] = {k: v["bytes"] / c["bytes"] for k, v in c["layers"].items()}
    out["step_cost"] = costs
    step_s = 64 / out["train_qa_pairs_per_s"]
    out["train_step_implied"] = {
        "step_ms": step_s * 1e3, "flop_per_s": costs["train_step_b64"]["flops"] / step_s,
        "mfu": None if not peaks else costs["train_step_b64"]["flops"] / step_s / peaks[0],
        "hbm_share": None if not peaks else costs["train_step_b64"]["bytes"] / step_s / peaks[1]}
    # the train step under torch.profiler, as bench_train runs it
    shared = bl.synth_shared(cfg)
    batch = bl.synth_batch(cfg, 64)
    state, opt = tr.init_state(cfg, "cuda"), Optimizer(cfg.train)
    with tr.deterministic_algorithms(torch.device("cuda")):
        prof = device_breakdown(lambda: tr.train_step(state, opt, shared, batch),
                                reps=PROFILED_TRAIN_STEPS)
    index_bwd = sum(v for k, v in prof["top_device_ms"].items() if "indexing_backward" in k)
    prof["index_backward_ms"] = index_bwd
    prof["index_backward_share_of_device"] = (index_bwd / prof["device_busy_ms"]
                                              if prof["device_busy_ms"] else None)
    out["train_step_profile"] = prof
    out["wall_s"] = time.perf_counter() - t0
    log("bench " + json.dumps(out))
    return out


# ---- phase 20: the capacity probe ---------------------------------------------------

CAPACITY_T_CAP = 1 << 20   # 1048576 frames: the doubling stops there (the time budget)


def capacity_phase() -> dict:
    """Phase 20: capacity_probe.probe_largest_t at batch 8, J = 512, D = 200,
    S = 8 from T = 16384, forward and with grad, both paths (the plain one
    materialises C [N, S, T, J]; the kernel path streams through K4/K5/K6),
    up to CAPACITY_T_CAP."""
    import torch

    from fvta_memexqa_torch import capacity_probe as cp

    t0 = time.perf_counter()
    out = {}
    for grad in (False, True):
        out["grad" if grad else "forward"] = cp.probe_largest_t(
            batch=8, j=512, d=200, s=8, t_start=1 << 14, t_cap=CAPACITY_T_CAP, grad=grad)
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    out["device_gib"] = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    log("capacity " + json.dumps(out))
    return out


# ---- phase 21: the serving front end over HTTP (`cli serve` in subprocesses) -----

# Each `cli serve` process runs this boot: the CLI's own entry point (runpy, as
# `python -m fvta_memexqa_torch.cli`), with signal handlers that write the
# process's kernel launch counters and the summed CUDA-event span of its answer
# steps to $SMOKE_COUNTS (SIGUSR1: on request; SIGTERM: at the end, then exit).
SERVER_BOOT = r"""
import json, os, runpy, signal, threading
import torch
from fvta_memexqa_torch import serve
from fvta_memexqa_torch.ops import fvta_fused, fvta_stats, lstm_fused, lstm_grouped

span = {"answer_steps": 0, "answer_span_ms": 0.0}
lock = threading.Lock()
run_batch = serve.QAEngine._run_batch


def timed(self, pending):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run_batch(self, pending)
    end.record()
    end.synchronize()
    with lock:
        span["answer_steps"] += 1
        span["answer_span_ms"] += start.elapsed_time(end)


serve.QAEngine._run_batch = timed
GLOBAL = {"fvta_fwd": fvta_fused.fvta_fwd, "stats_fwd": fvta_stats.stats_fwd,
          "qcnt": fvta_stats.qcnt, "stats_bwd": fvta_stats.stats_bwd,
          "scan_grouped": lstm_grouped.scan_grouped, "scan_stream": lstm_grouped.scan_stream}


def dump(*_):
    out = {k: getattr(lstm_fused, k).launches
           for k in ("lstm_proj", "lstm_rec", "lstm_rec_bwd", "lstm_fwd", "lstm_bwd")}
    out.update({k: getattr(fvta_fused, k).launches
                for k in ("fvta_fwd", "fvta_fwd_global")})
    out["global_launches"] = {k: f.global_launches for k, f in GLOBAL.items()}
    with lock:
        out.update(span)
    path = os.environ["SMOKE_COUNTS"]
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def stop(*_):
    dump()
    os._exit(0)


signal.signal(signal.SIGUSR1, dump)
signal.signal(signal.SIGTERM, stop)
runpy.run_module("fvta_memexqa_torch.cli", run_name="__main__", alter_sys=True)
"""
SERVE_TOL = 1e-5         # a server's probabilities vs the in-process engine's (same
                         # card, same weights; micro-batches change K2's plan)
DTYPE_PROB_ATOL = 0.05   # a bf16 / int8 cache vs float32: the JAX suite's bound
                         # (tests/test_serve.py TestCacheDtype, TestCacheDtypeInt8)
DTYPE_NEAR_TIE = 1e-2    # a bf16 / int8 answer may differ from float32's only where
                         # float32's top two probabilities lie closer than this
OPEN_LOOP_RATES = (50, 100, 200, 400, 800)   # asks per second, Poisson arrivals
OPEN_LOOP_S = 4.0
OPEN_LOOP_GIVE_UP_S = 10.0   # a request not sent this long after its arrival is an error
P99_LIMIT_MS = 100.0         # provisional: the highest rate whose p99 stays under it
STATS_KEYS = {"albums", "cache_bytes", "cache_bytes_per_device", "evictions",
              "evictions_unrecoverable", "reencodes", "shed", "questions", "batches",
              "p50_ms", "p95_ms"}
FRONT_END_KERNELS = ("lstm_proj", "lstm_rec", "fvta_fwd")
FRONT_END_NEVER = ("lstm_rec_bwd", "lstm_fwd", "lstm_bwd", "fvta_fwd_global")


class ServeProc:
    """One `cli serve <args> --port P` process on the card (SERVER_BOOT), its
    output collected line by line."""

    def __init__(self, workdir: str, name: str, args: list, scheme: str = "http"):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        s.close()
        self.name, self.lines, self.ready_s = name, [], None
        self.counts_path = os.path.join(workdir, f"serve_{name}.counts.json")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVER_BOOT, "serve", *args, "--port", str(self.port)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env={**os.environ,
                                                       "SMOKE_COUNTS": self.counts_path})
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.base = f"{scheme}://127.0.0.1:{self.port}"

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("serving on"):
                self.ready_s = time.perf_counter() - self.t0
            self.lines.append(line.rstrip())

    def ready(self, timeout: float = 240.0) -> "ServeProc":
        """Wait for the "serving on" line; `ready_s`: the seconds from the start."""
        while self.ready_s is None:
            if self.proc.poll() is not None or time.perf_counter() - self.t0 > timeout:
                fail(f"serving_http: `cli serve` ({self.name}) did not start "
                     f"(exit {self.proc.poll()}): {self.lines[-20:]}")
            time.sleep(0.05)
        return self

    def counts(self) -> dict:
        import signal

        if os.path.exists(self.counts_path):
            os.remove(self.counts_path)
        self.proc.send_signal(signal.SIGUSR1)
        for _ in range(200):
            if os.path.exists(self.counts_path):
                with open(self.counts_path) as f:
                    return json.load(f)
            time.sleep(0.05)
        fail(f"serving_http: {self.name} wrote no counters")

    def stop(self) -> dict | None:
        """SIGTERM (the boot writes its counters, then exits); the counters."""
        if self.proc.poll() is None:
            if os.path.exists(self.counts_path):
                os.remove(self.counts_path)
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=5)
        if not os.path.exists(self.counts_path):
            return None
        with open(self.counts_path) as f:
            return json.load(f)


def http_call(base: str, method: str, path: str, body=None, token=None, ctx=None,
              timeout: float = 60.0) -> tuple[int, dict]:
    """(status, JSON body) of one request on a fresh connection."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(base)
    conn = (http.client.HTTPSConnection(u.hostname, u.port, timeout=timeout, context=ctx)
            if u.scheme == "https" else
            http.client.HTTPConnection(u.hostname, u.port, timeout=timeout))
    try:
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers=headers)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def ask_body(a) -> dict:
    return {"question": a[0], "choices": a[1], "album_ids": a[2]}


def concurrent_asks(base: str, asks: list, tokens=(None,)) -> list:
    """Every ask at once, one thread each (tokens in turn); the JSON answers."""
    out, errors = [None] * len(asks), []
    barrier = threading.Barrier(len(asks))

    def worker(i):
        barrier.wait()
        try:
            code, res = http_call(base, "POST", "/ask", ask_body(asks[i]),
                                  tokens[i % len(tokens)])
            if code != 200 or "error" in res:
                errors.append(f"{code} {res}")
            out[i] = res
        except OSError as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(asks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        fail(f"serving_http: concurrent /ask failed on {base}: {errors[:3]}")
    return out


def compare_answers(what: str, got: list, ref: list, tol: float, near_tie: float) -> dict:
    """max |d probs|; an answer may differ only where ref's top two probabilities
    lie within near_tie."""
    import numpy as np

    d = max(float(np.abs(np.subtract(g["probs"], r["probs"])).max()) for g, r in zip(got, ref))
    flips = 0
    for g, r in zip(got, ref):
        if g["answer_index"] != r["answer_index"]:
            top2 = np.sort(r["probs"])[-2:]
            if top2[1] - top2[0] > near_tie:
                fail(f"serving_http: {what}: answer {g} differs from {r}")
            flips += 1
        if g["albums_found"] != r["albums_found"]:
            fail(f"serving_http: {what}: albums_found {g} vs {r}")
    if d > tol:
        fail(f"serving_http: {what}: max|d probs| {d:.3e} beyond {tol}")
    return {"max_abs_d_probs": d, "answers_equal": len(got) - flips, "near_tie_flips": flips}


def serving_asks(pack: str) -> list:
    """The 32 questions of phase 4's serving run (the corpus's first test
    questions, each with its own album and extra pack albums, at most 4)."""
    import numpy as np

    from fvta_memexqa_torch.data import load_pack, make_synthetic

    qas, _, _, test_ids, _ = make_synthetic(**SLICE_CORPUS)
    ids = load_pack(pack).meta["album_ids"]
    rng = np.random.default_rng(0)
    asks = []
    for qa in [q for q in qas if q.question_id in test_ids][:32]:
        extra = [ids[int(k)] for k in rng.choice(len(ids), 3, replace=False)]
        asks.append((qa.question, list(qa.choices), (list(qa.album_ids) + extra)[:4]))
    return asks


def new_album_request():
    """A 12-photo album outside the pack (as phase 4's raw album), as the body
    of POST /albums with its photo features, and a question about it."""
    import numpy as np

    from fvta_memexqa_torch.data import make_synthetic

    _, albums, feats, _, _ = make_synthetic(num_albums=3, photos_per_album=12,
                                            num_questions=3, feat_dim=2537, seed=7)
    a = next(iter(albums.values()))
    body = {"album": {"album_id": "http_album", "album_title": a.title,
                      "album_description": a.description, "album_where": a.where,
                      "album_when": a.when, "photo_ids": list(a.photo_ids),
                      "photo_titles": list(a.photo_titles)},
            "photo_feats": {p: np.asarray(feats[p], np.float32).tolist() for p in a.photo_ids}}
    ask = (f"where did we go on {a.title} ?", [a.where, "tokyo", "space", "atlantis"],
           ["http_album"])
    return body, ask, a, feats


def open_loop(base: str, asks: list, srv: ServeProc, seed: int = 21) -> list:
    """Poisson arrivals at each of OPEN_LOOP_RATES for OPEN_LOOP_S: latency from
    the scheduled arrival to the answer (so a client-side wait counts), p50 and
    p99 over answered requests, errors, shed (from /stats), achieved rate, and
    the answer steps' summed CUDA-event span over the window."""
    import concurrent.futures

    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=256) as pool:
        for rate in OPEN_LOOP_RATES:
            gaps = rng.exponential(1.0 / rate, int(rate * OPEN_LOOP_S * 1.5) + 16)
            arrivals = np.cumsum(gaps)
            arrivals = arrivals[arrivals < OPEN_LOOP_S]
            _, s0 = http_call(base, "GET", "/stats")
            c0 = srv.counts()

            def one(i, due):
                if time.perf_counter() - due > OPEN_LOOP_GIVE_UP_S:
                    return None, "gave up"
                try:
                    code, res = http_call(base, "POST", "/ask", ask_body(asks[i % len(asks)]),
                                          timeout=30.0)
                except OSError as e:
                    return None, repr(e)
                done = time.perf_counter()
                if code != 200 or "error" in res:
                    return None, f"{code} {res}"
                return (done - due) * 1e3, done

            t0 = time.perf_counter() + 0.05
            futs = []
            for i, a in enumerate(arrivals):
                wait = t0 + a - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                futs.append(pool.submit(one, i, t0 + a))
            results = [f.result() for f in futs]
            lat = np.array([ms for ms, _ in results if ms is not None])
            errs = [why for ms, why in results if ms is None]
            last = max((d for ms, d in results if ms is not None), default=t0)
            window = max(last - t0, OPEN_LOOP_S)
            c1 = srv.counts()
            _, s1 = http_call(base, "GET", "/stats")
            steps = c1["answer_steps"] - c0["answer_steps"]
            span = c1["answer_span_ms"] - c0["answer_span_ms"]
            rows.append({
                "rate_per_s": rate, "sent": len(arrivals), "answered": int(lat.size),
                "errors": len(errs), "error_kinds": sorted(set(errs))[:3],
                "shed": s1["shed"] - s0["shed"],
                "achieved_per_s": lat.size / window, "window_s": window,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
                "max_ms": float(lat.max()) if lat.size else None,
                "answer_steps": steps, "mean_batch": (s1["questions"] - s0["questions"])
                / max(s1["batches"] - s0["batches"], 1),
                "answer_span_ms_per_step": span / max(steps, 1),
                "answer_span_share": span / (window * 1e3)})
            log(f"serving_http open loop {rate}/s: {json.dumps(rows[-1])}")
            time.sleep(0.5)
    return rows


def launch_checks(name: str, counts: dict) -> None:
    if (min(counts[k] for k in FRONT_END_KERNELS) == 0 or any(counts[k] for k in FRONT_END_NEVER)
            or any(counts["global_launches"].values())):
        fail(f"serving_http: {name}: K1 and K2 must launch, never the L2-streaming "
             f"bi-LSTM kernels or a global route: {counts}")


def serving_http_phase(pack: str, rundir: str, raw: str, workdir: str, smi: str) -> dict:
    """Phase 21: `cli serve` on the card as users start it, in subprocesses (each
    one's kernel counters start at 0 and are read at its end): an f32 server
    with auth, limits and a cache dir; a 1 MiB byte budget; bfloat16 and int8
    caches; a restart on the saved cache; the refusals of --dp past the
    cards there are and of --shard-cache without --dp; TLS; open-loop
    Poisson load."""
    import http.client
    import shutil
    import ssl

    import numpy as np
    import torch

    from fvta_memexqa_torch.config import MODALITIES
    from fvta_memexqa_torch.data import parse_album_info
    from fvta_memexqa_torch.ops import lstm_fused
    from fvta_memexqa_torch.serve import _quant_h, build_engine

    t_phase = time.perf_counter()
    album_info, photo_npz = (os.path.join(raw, f) for f in ("album_info.json",
                                                            "photo_feats.npz"))
    cache = os.path.join(workdir, "serve_cache")
    raw_flags = ["--raw-albums", album_info, "--raw-photo-npz", photo_npz]
    base = [pack, rundir, "--batch-size", "8"]
    tls = shutil.which("openssl") is not None
    if tls:
        cert, key = (os.path.join(workdir, f) for f in ("serve_cert.pem", "serve_key.pem"))
        subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                        key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1"],
                       check=True, capture_output=True, timeout=60)
    procs = {}
    refusals = {}
    try:
        procs["f32"] = ServeProc(workdir, "f32", [
            *base, "--auth-token", "alice,bob", "--max-pending", "64",
            "--max-rps-per-client", "40", "--cache-dir", cache, *raw_flags])
        procs["budget"] = ServeProc(workdir, "budget", [*base, "--max-cache-mb", "1",
                                                        *raw_flags])
        for mode in ("bfloat16", "int8"):
            procs[mode] = ServeProc(workdir, mode, [*base, "--cache-dtype", mode])
        if tls:
            procs["tls"] = ServeProc(workdir, "tls", [*base, "--no-preingest", "--tls-cert",
                                                      cert, "--tls-key", key], scheme="https")
        cards = torch.cuda.device_count()
        refusal_text = {"--dp": f"mesh needs {cards + 1} devices, have {cards}",
                        "--shard-cache": "shard_cache requires a device mesh"}
        for flag in (["--dp", str(cards + 1)], ["--shard-cache"]):
            refusals[flag[0]] = subprocess.Popen(
                [sys.executable, "-m", "fvta_memexqa_torch.cli", "serve", *base, *flag],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

        # the in-process reference: the same engine on the card, same raw albums
        asks = serving_asks(pack)
        album_body, new_ask, new_album, new_feats = new_album_request()
        engine, store, _ = build_engine(pack, rundir, device="cuda", batch_size=8)
        try:
            albums, _ = parse_album_info(album_info)
            feats = dict(np.load(photo_npz))
            for a in albums.values():
                store.ingest(a, feats)
            ref = [r for i in range(0, len(asks), 8) for r in engine.answer_batch(asks[i:i + 8])]
            before = lstm_fused.lstm_rec.launches
            engine.answer_batch(asks[:3])
            k1_per_answer_step = lstm_fused.lstm_rec.launches - before
            before = lstm_fused.lstm_rec.launches
            store.ingest(next(iter(albums.values())), feats)
            k1_per_album_encode = lstm_fused.lstm_rec.launches - before
            store.ingest(dataclasses.replace(new_album, album_id="http_album"), new_feats)
            ref_new = engine.answer_batch([new_ask])[0]
            h = torch.stack([store._store[a][0] for a in list(albums)[:8]])
            quant_bitwise = {}
            for mode in ("int8", "bfloat16"):
                got, want = _quant_h(h, mode), _quant_h(h.cpu(), mode)
                pairs = ([(got["q"], want["q"]), (got["s"], want["s"])] if mode == "int8"
                         else [(got, want)])
                quant_bitwise[mode] = all(torch.equal(g.cpu(), w) for g, w in pairs)
            entry_f32 = store._entry_bytes(*store._store[asks[0][2][0]])
        finally:
            engine.close()
        if not all(quant_bitwise.values()):
            fail(f"serving_http: _quant_h on the card differs from the CPU's: {quant_bitwise}")
        n_pack = len(store._pack_rows)
        d = store.cfg.data
        t, h2 = d.max_context_time, 2 * store.cfg.model.hidden_dim
        n_mod = len(MODALITIES)
        if entry_f32 != n_mod * t * (h2 * 4 + 1):
            fail(f"serving_http: an f32 entry is {entry_f32} bytes, not 6 x T x (2H x 4 + 1)")
        for p in procs.values():
            p.ready()
        out = {"card": smi, "ready_s": {k: p.ready_s for k, p in procs.items()},
               "k1_per_answer_step": k1_per_answer_step,
               "k1_per_album_encode": k1_per_album_encode, "quant_bitwise_card_vs_cpu":
               quant_bitwise, "f32_entry_bytes": entry_f32}

        # 1. the f32 server: auth, limits, a cache, POST /albums
        s1 = procs["f32"]
        got1 = concurrent_asks(s1.base, asks, tokens=("alice", "bob"))
        step1 = compare_answers("f32 server vs the in-process engine", got1, ref, SERVE_TOL,
                                2 * SERVE_TOL)
        t0 = time.perf_counter()
        code, res = http_call(s1.base, "POST", "/albums", album_body, "alice")
        t_post = time.perf_counter()
        code_ask, res_new = http_call(s1.base, "POST", "/ask", ask_body(new_ask), "alice")
        t_first = time.perf_counter()
        if code != 200 or res.get("ingested") != "http_album" or code_ask != 200 \
                or res_new.get("albums_found") != 1:
            fail(f"serving_http: POST /albums then /ask: {code} {res}, {code_ask} {res_new}")
        step1["new_album"] = compare_answers("the POSTed album vs the in-process engine",
                                             [res_new], [ref_new], SERVE_TOL, 2 * SERVE_TOL)
        step1["post_album_ms"] = (t_post - t0) * 1e3
        step1["post_album_to_first_answer_ms"] = (t_first - t0) * 1e3
        codes = {"no_token": http_call(s1.base, "GET", "/stats")[0],
                 "wrong_token": http_call(s1.base, "GET", "/stats", token="eve")[0],
                 "unknown_path": http_call(s1.base, "GET", "/nope", token="alice")[0],
                 "healthz": http_call(s1.base, "GET", "/healthz")[0]}
        burst = [http_call(s1.base, "GET", "/stats", token="bob")[0] for _ in range(45)]
        codes["bob_45_stats"] = {c: burst.count(c) for c in sorted(set(burst))}
        step1["codes"] = codes
        if (codes["no_token"], codes["wrong_token"], codes["unknown_path"],
                codes["healthz"]) != (401, 401, 404, 200) or burst.count(429) < 5 \
                or burst.count(200) > 40:
            fail(f"serving_http: status codes {codes}")
        _, stats1 = http_call(s1.base, "GET", "/stats", token="alice")
        if set(stats1) != STATS_KEYS or stats1["cache_bytes_per_device"] is not None \
                or stats1["albums"] != len(albums) + 1 \
                or stats1["cache_bytes"] != stats1["albums"] * entry_f32:
            fail(f"serving_http: /stats {stats1}")
        step1["stats"] = stats1
        counts = {"f32": s1.stop()}
        if not any(line.startswith("saved album cache to") for line in s1.lines):
            fail(f"serving_http: the f32 server saved no cache: {s1.lines}")
        procs["restart"] = ServeProc(workdir, "restart", [*base, "--cache-dir", cache,
                                                          "--no-preingest"])
        out["f32"] = step1

        # 2. a 1 MiB byte budget: evictions, re-encodes, K1's launches
        s2 = procs["budget"]
        _, sb = http_call(s2.base, "GET", "/stats")
        cb = s2.counts()
        got2 = concurrent_asks(s2.base, asks)
        _, sa = http_call(s2.base, "GET", "/stats")
        ca = s2.counts()
        step2 = compare_answers("1 MiB budget vs the f32 server", got2, got1, SERVE_TOL,
                                2 * SERVE_TOL)
        grew = ca["lstm_rec"] - cb["lstm_rec"]
        want = (k1_per_answer_step * (sa["batches"] - sb["batches"])
                + k1_per_album_encode * (sa["reencodes"] - sb["reencodes"]))
        step2.update(stats_before=sb, stats_after=sa, lstm_rec_launches_in_asks=grew,
                     lstm_rec_launches_expected=want)
        if sb["evictions"] == 0 or sa["reencodes"] == sb["reencodes"] or grew != want:
            fail(f"serving_http: budget: {json.dumps(step2)}")
        out["budget"] = step2

        # 3. bfloat16 and int8 caches
        out["dtypes"] = {"float32": {"cache_bytes": n_pack * entry_f32, "ratio": 1.0}}
        for mode, per in (("bfloat16", n_mod * t * (h2 * 2 + 1)),
                          ("int8", n_mod * t * (h2 + 4 + 1))):
            s = procs[mode]
            _, st = http_call(s.base, "GET", "/stats")
            got = concurrent_asks(s.base, asks)
            row = compare_answers(f"{mode} cache vs the f32 server", got, got1,
                                  DTYPE_PROB_ATOL, DTYPE_NEAR_TIE)
            row.update(cache_bytes=st["cache_bytes"],
                       ratio=st["cache_bytes"] / (n_pack * entry_f32))
            if st["albums"] != n_pack or st["cache_bytes"] != n_pack * per:
                fail(f"serving_http: {mode} cache: {st}, expected {n_pack * per} bytes")
            out["dtypes"][mode] = row

        # 5. TLS, and the refusals
        if tls:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE   # the self-signed cert made above
            code, res = http_call(procs["tls"].base, "GET", "/healthz", ctx=ctx)
            try:
                http_call(procs["tls"].base.replace("https", "http"), "GET", "/healthz",
                          timeout=10)
                plain_refused = False
            except (OSError, http.client.HTTPException):
                plain_refused = True
            out["tls"] = {"ran": True, "https_healthz": [code, res],
                          "plain_http_refused": plain_refused}
            if (code, res) != (200, {"ok": True}) or not plain_refused:
                fail(f"serving_http: TLS {out['tls']}")
        else:
            out["tls"] = {"ran": False, "why": "no openssl on PATH"}
        out["refusals"] = {}
        for flag, p in refusals.items():
            text, _ = p.communicate(timeout=120)
            out["refusals"][flag] = {"exit": p.returncode, "names_why": refusal_text[flag] in text}
            if p.returncode == 0 or refusal_text[flag] not in text:
                fail(f"serving_http: `cli serve {flag}` exit {p.returncode}: {text[-500:]}")
        for k in ("budget", "bfloat16", "int8", "tls"):
            if k in procs:
                counts[k] = procs[k].stop()

        # 4. the restart on the saved cache, then 6. open-loop load on it
        s5 = procs["restart"].ready()
        want_line = f"restored {len(albums)} cached album encodings from {cache}"
        if want_line not in s5.lines:
            fail(f"serving_http: the restart did not restore the cache: {s5.lines}")
        got5 = concurrent_asks(s5.base, asks)
        out["restart"] = {"line": want_line, "ready_s": s5.ready_s, **compare_answers(
            "the restart vs the f32 server", got5, got1, SERVE_TOL, 2 * SERVE_TOL)}
        rows = open_loop(s5.base, asks, s5)
        if rows[0]["errors"]:
            fail(f"serving_http: errors at {rows[0]['rate_per_s']}/s: {rows[0]}")
        out["open_loop"] = rows
        under = [r["rate_per_s"] for r in rows
                 if r["p99_ms"] is not None and r["p99_ms"] < P99_LIMIT_MS and not r["errors"]]
        out["highest_rate_p99_under_100ms"] = max(under) if under else None
        counts["restart"] = s5.stop()
    finally:
        for p in procs.values():
            p.stop()
        for p in refusals.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, c in counts.items():
        if c is None:
            fail(f"serving_http: {name} left no counters")
        launch_checks(name, c)
    total = {k: sum(c[k] for c in counts.values()) for k in (*FRONT_END_KERNELS,
                                                             *FRONT_END_NEVER)}
    out["launches"] = {"total": total, **counts}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 22: the loader and the focal workflow (`cli train` flags, reports) -------

# every kernel counter phase 22 reads: K1, K1b and K2 must launch, the rest never
LOADER_KERNELS = ("lstm_proj", "lstm_rec", "lstm_rec_bwd", "fvta_fwd")
LOADER_NEVER = ("lstm_fwd", "lstm_bwd", "stats_fwd", "qcnt", "stats_bwd", "lstm_grouped",
                "lstm_stream")
# the kernels phase 22's trace must hold (csrc/lstm_rec.cu, lstm_rec_bwd.cu, fvta_fwd.cu)
TRACE_KERNELS = ("lstm_rec_kernel", "lstm_rec_bwd_kernel", "k2_cluster_kernel")
FOCAL_CORPUS = ["--num-albums", "32", "--photos-per-album", "8", "--num-questions", "320",
                "--feat-dim", "2537"]
FOCAL_STEPS = 48
FOCAL_KINDS = {0: "focal_what", 1: "focal_what", 2: "album_say", 3: "where", 4: "year"}


def loader_counts() -> dict:
    """Every counter of LOADER_KERNELS and LOADER_NEVER, and each routed
    kernel's global-route launches (summed)."""
    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats

    out = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches,
           **{k: getattr(fvta_stats, k).launches for k in ("stats_fwd", "qcnt", "stats_bwd")},
           **grouped_counters()}
    out["global_routes"] = sum(global_counters().values())
    return out


def zero_loader_counts() -> dict:
    """Zeroes the counters of the kernels the phase must launch (K1, K1b, K2)
    and returns every counter's value, so that the others are read as deltas
    (later checks read their totals)."""
    from fvta_memexqa_torch.ops import fvta_fused

    zero_lstm_counters()
    fvta_fused.fvta_fwd.launches = 0
    return loader_counts()


def loader_launches(part: str, before: dict) -> dict:
    got = {k: v - before[k] for k, v in loader_counts().items()}
    if min(got[k] for k in LOADER_KERNELS) == 0 or any(
            got[k] for k in (*LOADER_NEVER, "global_routes")):
        fail(f"{part}: K1, K1b and K2 must launch, and never the L2-streaming bi-LSTM "
             f"kernels, K4-K8 or a global route: {got}")
    return got


def checkpoint_tensors(rundir: str, step: int) -> dict:
    """checkpoint_leaves of a run's checkpoint `step`, and its dropout generator."""
    from fvta_memexqa_torch.checkpoint import CheckpointManager

    ck = CheckpointManager(rundir).load(step=step)
    return {**checkpoint_leaves(ck), "rng": ck["rng"]}


def qa_per_s(rundir: str) -> dict:
    """The median, min and max of the train rows' qa_pairs_per_sec after the
    first (warm-up) step, and the steps they cover."""
    import numpy as np

    rows = [r["qa_pairs_per_sec"] for r in read_metrics(os.path.join(rundir, "metrics.jsonl"))
            if r["event"] == "train" and r["step"] > 1]
    return {"median": float(np.median(rows)), "min": min(rows), "max": max(rows),
            "rows": len(rows)}


def trace_readings(path: str, steps: int) -> dict:
    """From torch.profiler's chrome trace of the profile window: the device's
    busy share of the window (the union of its kernel, copy and set intervals
    over the span of every event), each TRACE_KERNELS kernel's share of the
    device time, and the host's launch calls per step."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e.get("dur", 0) for e in events)
    busy, end = 0.0, lo
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), e["ts"] + e.get("dur", 0)
        if stop > start:
            busy += stop - start
            end = stop
    dev_total = sum(e.get("dur", 0) for e in device)
    shares, counts = {}, {}
    for k in TRACE_KERNELS:
        mine = [e for e in device if e.get("cat") == "kernel"
                and re.search(rf"\b{k}\b", e["name"])]
        counts[k] = len(mine)
        shares[k] = sum(e.get("dur", 0) for e in mine) / max(dev_total, 1e-9)
    launches = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e["name"].startswith(LAUNCH_CALLS))
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / max(hi - lo, 1e-9), "device_events": len(device),
            "kernel_share_of_device_time": shares, "kernel_events": counts,
            "launch_calls_per_step": launches / steps}


def train_loader_phase(workdir: str, smi: str) -> dict:
    """Phase 22, parts 1 and 2, on a copy of phase 4's pack (the shard files
    land in the pack directory). 1: phase 7's `cli train` again with
    --prefetch 2: its final checkpoint (parameters, optimizer state, dropout
    generator) torch.equal to phase 7's run's. 2: `cli train --stream-shard-size
    64 --prefetch 2 --profile` (a second ensure_split_shards rewrites nothing;
    finite losses; the profile event at step 15; a trace holding lstm_rec,
    lstm_rec_bwd and K2's cluster kernel)."""
    import shutil

    import torch

    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.stream import ensure_split_shards

    t_phase = time.perf_counter()
    pack = os.path.join(workdir, "pack_loader")
    shutil.copytree(os.path.join(workdir, "pack"), pack, copy_function=shutil.copy2)
    phase7 = os.path.join(workdir, "train_plain")
    flags = ["--num-steps", str(TRAIN_STEPS), "--val-period", "12", "--log-period", "1",
             "--save-period", "1000", "--device", "cuda"]
    out = {"card": smi}

    before = zero_loader_counts()
    run = os.path.join(workdir, "train_prefetch")
    t0 = time.perf_counter()
    if cli.main(["train", pack, run, *flags, "--dedup-albums", "false", "--prefetch", "2"]):
        fail("cli train --prefetch 2 exited non-zero")
    wall = time.perf_counter() - t0
    launches = loader_launches("train --prefetch 2", before)
    a, b = checkpoint_tensors(phase7, TRAIN_STEPS), checkpoint_tensors(run, TRAIN_STEPS)
    differ = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    out["prefetch"] = {"wall_s": wall, "tensors": len(a), "differ": len(differ),
                       "launches": launches, "qa_pairs_per_sec_prefetch_2": qa_per_s(run),
                       "qa_pairs_per_sec_inline_phase_7": qa_per_s(phase7)}
    log(f"train --prefetch 2 vs phase 7's inline run: {len(a)} tensors, {len(differ)} "
        f"differ; qa/s {json.dumps(out['prefetch']['qa_pairs_per_sec_prefetch_2'])} vs "
        f"{json.dumps(out['prefetch']['qa_pairs_per_sec_inline_phase_7'])} ({smi})")
    if differ or set(a) != set(b):
        fail(f"--prefetch 2 changed the run: {differ[:5]}")

    before = zero_loader_counts()
    run = os.path.join(workdir, "train_stream")
    t0 = time.perf_counter()
    if cli.main(["train", pack, run, *flags, "--stream-shard-size", "64", "--prefetch", "2",
                 "--profile"]):
        fail("cli train --stream-shard-size 64 --prefetch 2 --profile exited non-zero")
    wall = time.perf_counter() - t0
    launches = loader_launches("train --stream-shard-size 64 --prefetch 2 --profile", before)
    splits = [s for s in ("train", "val") if load_pack(pack, load_splits=False)
              .meta["split_sizes"].get(s, 0) > 0]
    shard_files = sorted(f for f in os.listdir(pack) if ".shard" in f)
    stamps = {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files}
    for s in splits:
        if not os.path.exists(os.path.join(pack, f"data_{s}.shards.json")):
            fail(f"no shard index for the {s} split")
        ensure_split_shards(pack, s, 64)
    rewritten = [f for f in shard_files
                 if os.stat(os.path.join(pack, f)).st_mtime_ns != stamps[f]]
    recs = read_metrics(os.path.join(run, "metrics.jsonl"))
    losses = [r["loss"] for r in recs if r["event"] == "train"]
    profiled = [r for r in recs if r["event"] == "profile"]
    trace = os.path.join(run, "profile", "trace.json")
    if not os.path.exists(trace):
        fail(f"--profile left no trace under {run}/profile")
    readings = trace_readings(trace, steps=5)
    out["stream"] = {"wall_s": wall, "splits": splits, "shard_files": len(shard_files),
                     "rewritten_by_a_second_ensure": rewritten, "launches": launches,
                     "qa_pairs_per_sec": qa_per_s(run),
                     "profile_events": [(r["step"], r["dir"]) for r in profiled],
                     "trace": readings}
    log(f"train --stream-shard-size 64 --prefetch 2 --profile ({wall:.1f} s): "
        f"{len(shard_files)} shard files, rewritten by a second ensure {rewritten}; profile "
        f"window {json.dumps(readings)} ({smi})")
    problems = []
    if rewritten:
        problems.append(f"a second ensure_split_shards rewrote {rewritten}")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    if [r["step"] for r in profiled] != [15]:
        problems.append(f"profile events {profiled}")
    if min(readings["kernel_events"].values()) == 0:
        problems.append(f"the trace lacks a kernel: {readings['kernel_events']}")
    if problems:
        fail("train_loader: " + "; ".join(problems))
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def focal_phase(workdir: str, smi: str) -> dict:
    """Phase 22, part 3: the focality workflow at the flagship's widths: `cli
    synth --focal` (32 albums x 8 photos, 320 questions, F = 2537), `prepro
    --val-ids`, `train` (FOCAL_STEPS steps, batch 64, H = 100), `test
    --dump-attention`, `attention-report --json` and `report --json`; every
    command exits 0, report's steps and best_val_acc agree with metrics.jsonl,
    attention-report prints min(--limit, count) records of --top cells within
    the pack's albums and MODALITIES. Test accuracy overall and per kind."""
    import numpy as np

    from fvta_memexqa_torch.config import MODALITIES
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.synthetic import focal_kind

    t_phase = time.perf_counter()
    raw, pack, run = (os.path.join(workdir, d) for d in ("focal_raw", "focal_pack",
                                                          "focal_run"))
    attn = os.path.join(workdir, "focal_attention.npz")
    raw_files = [os.path.join(raw, f) for f in ("qas.json", "album_info.json",
                                                "test_question.ids", "glove.txt",
                                                "photo_feats.npz")]
    steps = [
        ("synth", ["synth", raw, "--focal", *FOCAL_CORPUS]),
        ("prepro", ["prepro", *raw_files, pack, "--val-ids",
                    os.path.join(raw, "val_question.ids")]),
        ("train", ["train", pack, run, "--num-steps", str(FOCAL_STEPS), "--val-period", "24",
                   "--log-period", "8", "--device", "cuda"]),
        ("test", ["test", pack, run, "--dump-attention", attn, "--device", "cuda"]),
        ("attention_report", ["attention-report", attn, "--json", "--top", "3",
                              "--limit", "10"]),
        ("report", ["report", run, "--json"]),
    ]
    out, walls, printed = {"card": smi}, {}, {}
    before = zero_loader_counts()
    for name, argv in steps:
        t0 = time.perf_counter()
        rc, text = cli_text(argv)
        walls[name] = time.perf_counter() - t0
        if rc:
            fail(f"focal: cli {name} exited {rc}")
        printed[name] = text
        log(f"focal: cli {name} ({walls[name]:.1f} s): {text.strip().splitlines()[-1][:200]}")
    launches = loader_launches("focal", before)
    packed = load_pack(pack, load_splits=False)
    n_albums, n_mod = packed.cfg.max_albums, len(MODALITIES)
    recs = read_metrics(os.path.join(run, "metrics.jsonl"))
    trains = [r for r in recs if r["event"] == "train"]
    vals = [r["acc"] for r in recs if r["event"] == "val"]
    report = json.loads(printed["report"].strip().splitlines()[-1])
    cells = [json.loads(line) for line in printed["attention_report"].splitlines() if line]
    z = np.load(attn)
    count = len(z["qid"])
    problems = []
    if report["steps"] != trains[-1]["step"] or report["best_val_acc"] != max(vals):
        problems.append(f"report {report} vs metrics.jsonl (steps {trains[-1]['step']}, "
                        f"best val {max(vals)})")
    if len(cells) != min(10, count) or any(
            len(c["focus"]) != min(3, z["time_attn"][0].size)
            or not all(0 <= f["album"] < n_albums and f["modality"] in MODALITIES
                       for f in c["focus"]) for c in cells):
        problems.append(f"attention-report records {cells[:2]}")
    if not all(math.isfinite(r["loss"]) for r in trains):
        problems.append("non-finite training loss")
    n_focal = int(json.loads(printed["synth"])["albums"])
    kinds = np.array([focal_kind(int(str(q)[1:]), n_focal) for q in z["qid"]])
    correct = z["pred"] == z["label"]
    by_kind = {}
    for k in sorted(set(FOCAL_KINDS.values())):
        sel = np.isin(kinds, [i for i, v in FOCAL_KINDS.items() if v == k])
        by_kind[k] = {"acc": float(correct[sel].mean()) if sel.any() else None,
                      "count": int(sel.sum())}
    out.update(wall_s=walls, launches=launches, steps=report["steps"],
               best_val_acc=report["best_val_acc"], test_count=count,
               test_acc=float(correct.mean()), test_acc_by_kind=by_kind,
               train_qa_pairs_per_sec=report["train_qa_pairs_per_sec"],
               attention_records=len(cells), albums=n_albums, modalities=n_mod,
               prepro=json.loads(printed["prepro"].strip().splitlines()[-1]))
    if problems:
        fail("focal: " + "; ".join(problems))
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 23: data and context parallelism (ranks sharing the card) ------------------

SHARED_CARD = ["cuda:0"]      # repeated per rank: the ranks share the one card (gloo)
DP_TOL = dict(rtol=1e-4, atol=1e-6)        # DP-2 vs the single-rank step on the card
CP_LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)   # JAX's flagship-CP tolerances
CP_GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
CP_LOSS_RTOL = 1e-5
NEAR_TIE = 1e-4      # a DP prediction may differ from one rank's only at such a top-2 gap
PARALLEL_STEPS = 24
PARALLEL_REPS = 5
DP_KERNELS = ("lstm_proj", "lstm_rec", "lstm_rec_bwd", "fvta_fwd")
CP_KERNELS = ("stats_fwd", "qcnt", "stats_bwd")


def parallel_counts() -> dict:
    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats, lstm_fused

    return {**{k: getattr(lstm_fused, k).launches for k in NEW_KERNELS + OLD_KERNELS},
            "fvta_fwd": fvta_fused.fvta_fwd.launches,
            **{k: getattr(fvta_stats, k).launches for k in CP_KERNELS}}


def zero_parallel_counts() -> None:
    from fvta_memexqa_torch.ops import fvta_fused, fvta_stats, lstm_fused

    for k in NEW_KERNELS + OLD_KERNELS:
        getattr(lstm_fused, k).launches = 0
    fvta_fused.fvta_fwd.launches = 0
    for k in CP_KERNELS:
        getattr(fvta_stats, k).launches = 0


class CommTimer:
    """Wraps mesh.all_gather (every collective of the parallel paths goes
    through it) with CUDA events; `ms()` sums the recorded spans, `sent` the
    bytes this rank contributed to them."""

    def __init__(self):
        from fvta_memexqa_torch.parallel import mesh

        self.mesh, self.real, self.spans, self.on, self.sent = (
            mesh, mesh.all_gather, [], False, 0)

        def timed(x, group=None):
            import torch

            if not self.on:
                return self.real(x, group)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.real(x, group)
            b.record()
            self.spans.append((a, b))
            self.sent += x.numel() * x.element_size()
            return out

        mesh.all_gather = timed

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def timed_steps(fn, comm: CommTimer, reps: int = PARALLEL_REPS) -> dict:
    """fn() after one warm-up call, `reps` times under CUDA events: the mean
    step ms and the share of it inside the collectives."""
    import torch

    fn()
    torch.cuda.synchronize()
    comm.spans, comm.on, comm.sent = [], True, 0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    comm.on = False
    step = a.elapsed_time(b) / reps
    return {"step_ms": step, "collectives_ms": comm.ms() / reps,
            "collectives_share": comm.ms() / reps / step,
            "collectives_calls": len(comm.spans) // reps, "bytes_sent": comm.sent // reps}


def dp_rank(packdir: str, rundir: str, workdir: str) -> dict:
    """Phase 23's data-parallel part on one of 2 ranks sharing the card: the
    batch-64 step's DP gradient at keep_prob 1, plain and through the DP
    dedup encode (mesh.GatherShards), its timing, two PARALLEL_STEPS DP-2
    `train` runs, and `test` with and without the row-sharded cache plus
    predict_cached's probabilities; every rank's kernel counts."""
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.config import (Config, MeshConfig, ModelConfig, TrainConfig,
                                           load_config)
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.eval_cache import (_sharded_cache_setup, precompute_album_cache,
                                               predict_cached)
    from fvta_memexqa_torch.optim import Optimizer
    from fvta_memexqa_torch.parallel import mesh

    dp2 = MeshConfig(data_parallel=2)
    devices = SHARED_CARD * 2
    packed = load_pack(packdir)
    cfg = Config(data=packed.cfg, model=ModelConfig(keep_prob=1.0), mesh=dp2)
    rank = mesh.current_rank(dp2, devices)
    comm = CommTimer()
    zero_parallel_counts()
    state = tr.init_state(cfg, "cuda")
    shared = SharedTables.from_packed(packed.shared, "cuda")
    batch = next(iter(Dataset(packed, "train").get_batches(64, shuffle=True, seed=0,
                                                          epoch=0))).to("cuda")
    grads, _ = tr.step_grads(state.model, shared, batch, None, rank, train=False)
    grads = {k: v.cpu() for k, v in grads.items()}
    dd = tr.dedup_album_batch(batch.album_idx.cpu().numpy(), tr.dp_u_cap(cfg))
    if dd is None:
        raise RuntimeError("the batch-64 batch has more unique albums than dp_u_cap")
    dd = tuple(torch.from_numpy(a) for a in dd)
    dedup_grads, _ = tr.step_grads(state.model, shared, batch, tuple(a.cuda() for a in dd),
                                   rank, train=False)
    dedup_grads = {k: v.cpu() for k, v in dedup_grads.items()}
    step_counts = parallel_counts()
    opt = Optimizer(cfg.train)
    timing = timed_steps(lambda: tr.train_step(state, opt, shared, batch, None, rank), comm)

    runs = []
    for i in range(2):
        run_cfg = cfg.replace(model=ModelConfig(), train=TrainConfig(
            val_period=12, log_period=1, save_period=1000))
        out = os.path.join(workdir, f"dp2_run{i}")
        res = tr.train(run_cfg, packed, out, num_steps=PARALLEL_STEPS, echo=False,
                       metrics_path=os.path.join(out, "metrics.jsonl") if i == 0 else None,
                       devices=devices)
        runs.append({k: v.detach().cpu().clone() for k, v in res["state"].params.items()})
        runs.append(res["state"].generator.get_state().cpu())
    test_cfg = load_config(os.path.join(rundir, "config.json")).replace(
        data=packed.cfg, mesh=dp2)
    tests = {name: tr.test(test_cfg, packed, rundir, echo=False, shard_cache=sc,
                           devices=devices)
             for name, sc in (("dp2", False), ("dp2_shard_cache", True))}
    model = tr.restore_model(test_cfg, rundir, True, "cuda")
    ds = Dataset(packed, "test")
    bs = test_cfg.train.eval_batch_size
    tables = tr.make_eval_tables(model, shared)
    probs = predict_cached(test_cfg, model, shared, ds, bs, tables=tables, rank=rank)
    sharded = _sharded_cache_setup(rank, precompute_album_cache(
        test_cfg, model, shared, vocab_table=tables[0], photo_table=tables[1]), bs)
    probs_sharded = predict_cached(test_cfg, model, shared, ds, bs, tables=tables,
                                   rank=rank, sharded=sharded)
    comm.mesh.all_gather = comm.real
    return {"grads": grads, "dedup_grads": dedup_grads, "dd": dd,
            "timing": mesh.gather_objects(timing),
            "step_counts": mesh.gather_objects(step_counts),
            "counts": mesh.gather_objects(parallel_counts()),
            "runs": runs, "tests": tests, "probs": probs["probs"],
            "probs_sharded": probs_sharded["probs"], "label": probs["label"]}


def cp_rank(cp: int) -> dict:
    """Phase 23's context-parallel part on one of cp ranks sharing the card:
    the full-width T=VIDEO_T video step (batch VIDEO_N, keep_prob 1) with its
    attention's frame axis split over the ranks: logits, loss, every
    gradient, the timing of forward + backward, every rank's kernel counts."""
    import torch

    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.models.video import video_metrics
    from fvta_memexqa_torch.parallel import mesh
    from fvta_memexqa_torch.parallel.cp import make_cp_attention

    cfg, run, shared, vi = video_setup(VIDEO_T, keep_prob=1.0)
    shared, vi = video_shared_to(shared), vi.to("cuda")
    comm = CommTimer()
    zero_parallel_counts()
    state = tv.init_video_state(cfg, run, "cuda")
    attn = make_cp_attention(cfg.model.similarity)
    params = list(state.model.parameters())

    def step():
        out = state.model(shared, vi, train=True, generator=state.generator,
                          cp_attention=attn)
        s = video_metrics("mc", out.logits, vi)
        loss = s["loss_sum"] / torch.clamp(s["count"], min=1.0)
        return out.logits, loss, torch.autograd.grad(loss, params, allow_unused=True)

    with tv.exact_float32():
        logits, loss, grads = step()
        counts = parallel_counts()
        timing = timed_steps(step, comm)
    comm.mesh.all_gather = comm.real
    names = [n for n, _ in state.model.named_parameters()]
    return {"logits": logits.detach().cpu(), "loss": float(loss.detach()),
            "grads": {n: g.cpu() for n, g in zip(names, grads) if g is not None},
            "counts": mesh.gather_objects(counts),
            "timing": mesh.gather_objects(timing)}


def parallel_phase(workdir: str, evaluation: dict, smi: str) -> dict:
    """Phase 23: data and context parallelism with the ranks sharing the one
    card (make_mesh(devices=["cuda:0"] * n), gloo; no multi-card figure).
    DP-2 at the flagship widths on phase 4's pack: the batch-64 step's gradient
    vs the single-rank step on the card (DP_TOL) and vs the CPU's (STEP_TOL),
    the DP dedup step's vs the single-rank dedup step's (DP_TOL), K1, K1b and
    K2 launched on each rank; two PARALLEL_STEPS-step DP-2 runs bitwise
    equal; `test` at DP-2 with and without the sharded cache, each with phase
    16's count and its correct count within the near-tie predictions of
    phase 16's, the two equal (predict_cached: a prediction may differ only
    at a NEAR_TIE, probabilities within ENGINE_TOL). CP-2 and CP-4 at T=VIDEO_T,
    batch VIDEO_N, D = 200, J = 30 vs cp = 1 on the card at the JAX package's
    flagship-CP tolerances, K4, K5 and K6 launched on every rank and K2 on
    none. Readings: per-rank step ms, the collectives' share (CUDA events),
    DP-2 qa/s beside phase 7's single-rank qa/s (the `parallel` line)."""
    import numpy as np
    import torch

    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.config import Config, MeshConfig, ModelConfig, load_config
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.eval_cache import predict_cached
    from fvta_memexqa_torch.models.video import video_metrics
    from fvta_memexqa_torch.parallel import mesh

    t0 = time.perf_counter()
    pack, plain = os.path.join(workdir, "pack"), os.path.join(workdir, "train_plain")
    problems = []

    # data parallelism
    dp = mesh.run_ranks(dp_rank, mesh.make_mesh(MeshConfig(data_parallel=2),
                                                 SHARED_CARD * 2), pack, plain, workdir)
    t_dp = time.perf_counter() - t0
    packed = load_pack(pack)
    cfg = Config(data=packed.cfg, model=ModelConfig(keep_prob=1.0))
    batch = next(iter(Dataset(packed, "train").get_batches(64, shuffle=True, seed=0,
                                                          epoch=0)))
    single = {}
    for dev, dd in (("cuda", None), ("cpu", None), ("dedup", dp["dd"])):
        card = "cpu" if dev == "cpu" else "cuda"
        state = tr.init_state(cfg, card)
        shared = SharedTables.from_packed(packed.shared, card)
        loss, _ = tr.loss_and_metrics(state.model, shared, batch.to(card), False, dd=(
            None if dd is None else tuple(a.to(card) for a in dd)))
        single[dev] = dict(zip(state.params, (g.cpu() for g in torch.autograd.grad(
            loss, list(state.params.values())))))
    dp_vs_card = {k: float((dp["grads"][k] - g).abs().max())
                  for k, g in single["cuda"].items()}
    bad = [k for k, g in single["cuda"].items()
           if not torch.allclose(dp["grads"][k], g, **DP_TOL)]
    rel_cpu = {k: float((dp["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
               for k, g in single["cpu"].items() if k not in EXACT_ZERO_GRADS}
    worst_cpu = max(rel_cpu, key=rel_cpu.get)
    log(f"parallel DP-2 (2 ranks sharing the card): batch-64 gradient vs one rank on the "
        f"card max|dg| {max(dp_vs_card.values()):.2e}, tensors beyond rtol "
        f"{DP_TOL['rtol']} / atol {DP_TOL['atol']}: {bad}; vs the CPU worst "
        f"max|dg|/max|g| {rel_cpu[worst_cpu]:.2e} ({worst_cpu}); step launches per rank "
        f"{json.dumps(dp['step_counts'])}")
    if bad:
        problems.append(f"DP-2 gradient vs the single-rank step beyond {DP_TOL}: {bad}")
    dedup_vs_card = {k: float((dp["dedup_grads"][k] - g).abs().max())
                     for k, g in single["dedup"].items()}
    bad_dedup = [k for k, g in single["dedup"].items()
                 if not torch.allclose(dp["dedup_grads"][k], g, **DP_TOL)]
    log(f"parallel DP-2 dedup (U = {len(dp['dd'][0])}, each rank encoding half): gradient "
        f"vs the single-rank dedup step on the card max|dg| "
        f"{max(dedup_vs_card.values()):.2e}, tensors beyond {DP_TOL}: {bad_dedup}")
    if bad_dedup:
        problems.append(f"DP-2 dedup gradient vs the single-rank dedup step beyond "
                        f"{DP_TOL}: {bad_dedup}")
    if rel_cpu[worst_cpu] > STEP_TOL:
        problems.append(f"DP-2 gradient vs the CPU beyond {STEP_TOL} ({worst_cpu})")
    for r, c in enumerate(dp["counts"]):
        if min(c[k] for k in DP_KERNELS) == 0 or any(c[k] for k in OLD_KERNELS):
            problems.append(f"DP rank {r}: K1, K1b and K2 must launch, the L2-streaming "
                            f"kernels never: {c}")
    p0, g0, p1, g1 = dp["runs"]
    unequal = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    if unequal or not torch.equal(g0, g1):
        problems.append(f"two identical DP-2 runs differ: {unequal[:5]}")
    ref_acc, ref_count = (evaluation["test"]["cached"][k] for k in ("accuracy", "count"))
    d_probs = float(np.abs(dp["probs"] - dp["probs_sharded"]).max())
    pcfg = load_config(os.path.join(plain, "config.json")).replace(data=packed.cfg)
    single_probs = predict_cached(pcfg, tr.restore_model(pcfg, plain, True, "cuda"),
                                  SharedTables.from_packed(packed.shared, "cuda"),
                                  Dataset(packed, "test"), pcfg.train.eval_batch_size)["probs"]
    d_single = float(np.abs(dp["probs"] - single_probs).max())
    top2 = np.sort(single_probs, -1)[:, -2:]
    flips = np.argmax(dp["probs"], -1) != np.argmax(single_probs, -1)
    far_flips = int((flips & (top2[:, 1] - top2[:, 0] > NEAR_TIE)).sum())
    near_flips = int(flips.sum()) - far_flips
    for name, m in dp["tests"].items():
        log(f"parallel `test` {name}: {json.dumps(m)[:200]} (phase 16, one rank: accuracy "
            f"{ref_acc}, count {ref_count})")
        # each entry on its own: the same questions, and a correct count that
        # differs from one rank's by no more than the near-tie predictions
        d_correct = abs(round(m["acc"] * m["count"]) - round(ref_acc * ref_count))
        if m["count"] != ref_count or d_correct > near_flips:
            problems.append(f"test {name}: accuracy {m['acc']} over {m['count']} vs one "
                            f"rank's {ref_acc} over {ref_count} ({near_flips} near-tie "
                            "predictions)")
    if dp["tests"]["dp2"]["acc"] != dp["tests"]["dp2_shard_cache"]["acc"]:
        problems.append("test at DP-2: the sharded cache's accuracy differs from the "
                        "replicated cache's (the sharded gather is bitwise)")
    log(f"parallel predict_cached DP-2 vs one rank: max|d probs| {d_single:.2e}, "
        f"{int(flips.sum())} different predictions ({far_flips} beyond a {NEAR_TIE} "
        f"top-2 gap); sharded vs replicated cache max|d probs| {d_probs}")
    if d_single > ENGINE_TOL or far_flips or d_probs != 0.0:
        problems.append(f"DP-2 predict_cached: {d_single}, {far_flips}, {d_probs}")
    recs = read_metrics(os.path.join(workdir, "dp2_run0", "metrics.jsonl"))
    qa = {"dp2": [r["qa_pairs_per_sec"] for r in recs if r["event"] == "train"],
          "one_rank": [r["qa_pairs_per_sec"] for r in read_metrics(
              os.path.join(plain, "metrics.jsonl")) if r["event"] == "train"]}
    qa = {k: float(np.median(v[1:])) for k, v in qa.items()}

    # context parallelism
    t1 = time.perf_counter()
    cfg_v, run, shared_v, vi = video_setup(VIDEO_T, keep_prob=1.0)
    with tv.exact_float32():
        state = tv.init_video_state(cfg_v, run, "cuda")
        out = state.model(video_shared_to(shared_v), vi.to("cuda"), train=True,
                          generator=state.generator)
        s = video_metrics("mc", out.logits, vi.to("cuda"))
        loss1 = s["loss_sum"] / torch.clamp(s["count"], min=1.0)
        names = [n for n, _ in state.model.named_parameters()]
        g1 = dict(zip(names, torch.autograd.grad(loss1, list(state.model.parameters()),
                                                 allow_unused=True)))
    logits1, l1 = out.logits.detach().cpu(), float(loss1.detach())
    cp_out = {}
    for cp in (2, 4):
        r = mesh.run_ranks(cp_rank, mesh.make_mesh(MeshConfig(context_parallel=cp),
                                                   SHARED_CARD * cp), cp)
        d_logits = float((r["logits"] - logits1).abs().max())
        bad = [n for n, g in r["grads"].items()
               if not torch.allclose(g, g1[n].cpu(), **CP_GRAD_TOL)]
        d_loss = abs(r["loss"] - l1) / abs(l1)
        log(f"parallel CP-{cp} at T={VIDEO_T} (ranks sharing the card): max|d logits| vs "
            f"cp=1 {d_logits:.2e}, loss {r['loss']:.6f} vs {l1:.6f}, gradients "
            f"beyond rtol {CP_GRAD_TOL['rtol']} / atol {CP_GRAD_TOL['atol']}: {bad}; "
            f"launches per rank {json.dumps(r['counts'])}")
        if not torch.allclose(r["logits"], logits1, **CP_LOGITS_TOL) or bad or \
                d_loss > CP_LOSS_RTOL:
            problems.append(f"CP-{cp} vs cp=1: logits {d_logits}, loss {d_loss}, {bad}")
        for rk, c in enumerate(r["counts"]):
            if min(c[k] for k in CP_KERNELS) == 0 or c["fvta_fwd"]:
                problems.append(f"CP-{cp} rank {rk}: K4, K5 and K6 must launch and K2 "
                                f"never: {c}")
        cp_out[cp] = {"max_abs_d_logits": d_logits, "loss_rel_err": d_loss,
                      "timing": r["timing"], "counts": r["counts"]}
    t_cp = time.perf_counter() - t1
    if problems:
        fail("parallel: " + "; ".join(problems))
    return {"label": f"ranks sharing one card ({smi}), gloo; not a multi-card figure",
            "dp2": {"timing": dp["timing"], "counts": dp["counts"],
                    "qa_pairs_per_sec": qa["dp2"],
                    "one_rank_qa_pairs_per_sec_phase7": qa["one_rank"],
                    "grad_max_abs_err_vs_one_rank": max(dp_vs_card.values()),
                    "dedup_grad_max_abs_err_vs_one_rank": max(dedup_vs_card.values()),
                    "grad_rel_err_vs_cpu": rel_cpu[worst_cpu],
                    "test": dp["tests"], "one_rank_accuracy": ref_acc,
                    "probs_max_abs_err_vs_one_rank": d_single},
            "cp": cp_out, "wall_s": {"dp": t_dp, "cp": t_cp,
                                     "total": time.perf_counter() - t0}}


# ---- phase 24: the grouped bi-LSTM, serving over a mesh, the CP memory table ----------

# (name, T, D): the flagship model's six per-modality time encoders
# (fvta_memexqa_tpu/models/fvta.py:223-234) over the N·A = 64 x 4 album slots
# of a batch-64 train step at the default DataConfig: photo (max_photos),
# photo titles (their 2H summaries), then album title, description, when and
# where (max_album_text_len); D = word + char-CNN = 2H = 200, H = 100.
GROUPED_ENCODERS = [("photo", 12, 200), ("photo_title", 12, 200), ("album_title", 24, 200),
                    ("album_desc", 24, 200), ("when", 24, 200), ("where", 24, 200)]
GROUPED_N = 64 * 4
GROUPED_KERNELS = {H: {"forward": {"lstm_proj": 1, "lstm_rec": 1},
                       "backward": {"lstm_rec_bwd": 1}},
                   OLD_H: {"forward": {"lstm_fwd": 1}, "backward": {"lstm_bwd": 1}}}
CP_TABLE_T = 65536
MESH_REPS = 5


def grouped_inputs(h: int, seed: int, device):
    """The six encoders' (pairs, xs, masks) and N(0, 1) x COTANGENT_SCALE
    cotangents (out, fin) per encoder."""
    import torch

    pairs, xs, masks, cots = [], [], [], []
    g = torch.Generator().manual_seed(seed)
    for k, (_, t, d) in enumerate(GROUPED_ENCODERS):
        x, mask, p_fw, p_bw = lstm_case(GROUPED_N, t, d, h, seed + k, device)
        pairs.append((p_fw, p_bw))
        xs.append(x)
        masks.append(mask)
        cots.append(tuple((torch.randn(*shape, generator=g) * COTANGENT_SCALE).to(device)
                          for shape in ((GROUPED_N, t, 2 * h), (GROUPED_N, 2 * h))))
    return pairs, xs, masks, cots


def grouped_grads(fn, pairs, xs, cots):
    """Outputs of fn(pairs, xs) and the gradients of sum <out, g_out> + <fin,
    g_fin> w.r.t. every weight, then every input."""
    import torch

    from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

    lw = [w.detach().clone().requires_grad_() for pair in pairs for p in pair for w in p]
    lx = [x.detach().clone().requires_grad_() for x in xs]
    ps = tuple((LSTMParams(*lw[6 * k:6 * k + 3]), LSTMParams(*lw[6 * k + 3:6 * k + 6]))
               for k in range(len(xs)))
    res = fn(ps, tuple(lx))
    loss = sum((o * go).sum() + (f * gf).sum() for (o, f), (go, gf) in zip(res, cots))
    return [t.detach() for r in res for t in r], torch.autograd.grad(loss, lw + lx)


def grouped_bilstm_check(h: int, device) -> dict:
    """bilstm_fused_grouped at K = 6 over the flagship's encoders at hidden
    width h: forward vs the plain version (LSTM_TOL) with one launch of each
    forward kernel of the route, under grad every gradient vs autograd through
    the plain version (GRAD_TOL) with one more forward and one backward
    launch, each group's outputs vs a lone bilstm_fused call (the maximum
    difference; bitwise expected) and K = 1 vs bilstm_fused bitwise."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused

    pairs, xs, masks, cots = grouped_inputs(h, 2400 + h, device)
    mm = tuple(masks)
    grouped = lambda ps, xx: lstm_fused.bilstm_fused_grouped(ps, xx, mm)
    plain = lambda ps, xx: lstm_fused.bilstm_fused_grouped_ref(ps, xx, mm)
    zero_lstm_counters()
    with torch.no_grad():
        res = grouped(tuple(pairs), tuple(xs))
        torch.cuda.synchronize()
        fwd = {k: v for k, v in lstm_counters().items() if v}
        ref = plain(pairs, xs)
        lone = [lstm_fused.bilstm_fused(*pair, x, m) for pair, x, m in zip(pairs, xs, masks)]
        one = lstm_fused.bilstm_fused_grouped((pairs[2],), (xs[2],), (masks[2],))[0]
    out_err = max(max_err(a, b) for r, rr in zip(res, ref) for a, b in zip(r, rr))
    fwd_ok = all(close(a, b, **LSTM_TOL) for r, rr in zip(res, ref) for a, b in zip(r, rr))
    lone_err = max(max_err(a, b) for r, rr in zip(res, lone) for a, b in zip(r, rr))
    lone_bitwise = all(torch.equal(a, b) for r, rr in zip(res, lone) for a, b in zip(r, rr))
    one_bitwise = all(torch.equal(a, b) for a, b in zip(one, lone[2]))
    ref_out, ref_g = grouped_grads(plain, pairs, xs, cots)
    zero_lstm_counters()
    got_out, got_g = grouped_grads(grouped, pairs, xs, cots)
    torch.cuda.synchronize()
    grad_launches = {k: v for k, v in lstm_counters().items() if v}
    grad_err = max(max_err(a, b) for a, b in zip(got_g, ref_g))
    bad_g = [i for i, (a, b) in enumerate(zip(got_g, ref_g)) if not close(a, b, **GRAD_TOL)]
    fwd_grad_err = max(max_err(a, b) for a, b in zip(got_out, ref_out))
    want = GROUPED_KERNELS[h]
    want_grad = {**want["forward"], **want["backward"]}
    row = {"H": h, "route": route_info(GROUPED_N, 24, 200, h), "launches_forward": fwd,
           "launches_under_grad": grad_launches, "max_abs_err_out": out_err,
           "max_abs_err_grads": grad_err, "max_abs_err_out_under_grad": fwd_grad_err,
           "max_abs_diff_vs_lone_calls": lone_err, "lone_calls_bitwise": lone_bitwise,
           "k1_bitwise_vs_bilstm_fused": one_bitwise}
    log(f"grouped K=6 H={h}: {json.dumps(row)}")
    if not fwd_ok or bad_g or fwd != want["forward"] or grad_launches != want_grad \
            or not one_bitwise:
        fail(f"bilstm_fused_grouped at H={h}: forward within {LSTM_TOL}: {fwd_ok}; gradients "
             f"beyond {GRAD_TOL}: {bad_g}; launches {fwd} / {grad_launches} (want "
             f"{want['forward']} / {want_grad}); K = 1 bitwise: {one_bitwise}")
    return row


def grouped_bilstm_times(device) -> dict:
    """The grouped call at H and K = 6 (one lstm_proj + one lstm_rec launch)
    beside the six separate bilstm_fused calls (12 launches), CUDA events and
    CUDA-graph replays; the plain version; the bounds; and the backward's K1b
    alone (one lstm_rec_bwd_grouped launch vs six lstm_rec_bwd), with the plain
    backward (autograd through the plain version from a kept graph)."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused

    pairs, xs, masks, cots = grouped_inputs(H, 2500, device)
    mm = tuple(masks)
    with torch.no_grad():
        grouped = lambda: lstm_fused.bilstm_fused_grouped(tuple(pairs), tuple(xs), mm)
        separate = lambda: [lstm_fused.bilstm_fused(*pr, x, m) for pr, x, m in
                            zip(pairs, xs, masks)]
        plain = lambda: lstm_fused.bilstm_fused_grouped_ref(pairs, xs, mm)
        x, lengths, wx, wh, b = lstm_fused._prep_group(pairs, xs, masks)
        k1 = lambda: lstm_fused.lstm_k1_grouped(x, lengths, wx, wh, b, 1.0, True)
        row = {"grouped_ms": cuda_ms(grouped), "separate_ms": cuda_ms(separate),
               "grouped_graph_ms": graph_ms(grouped), "separate_graph_ms": graph_ms(separate),
               "grouped_k1_only_ms": cuda_ms(k1), "grouped_k1_only_graph_ms": graph_ms(k1),
               "plain_ms": cuda_ms(plain, iters=3, warmup=1)}
        pre, out, fin, cell = lstm_fused.lstm_k1_grouped(x, lengths, wx, wh, b, 1.0, True, True,
                                                         True)
        g_out = torch.zeros_like(out)
        for k, (go, _) in enumerate(cots):
            g_out[k, :, :go.shape[1]] = go
        g_fin = torch.stack([gf for _, gf in cots])
        k1b = lambda: lstm_fused.lstm_rec_bwd_grouped(pre, lengths, wx, wh, cell, g_out, g_fin,
                                                      1.0)
        saved = []
        for pr, xx, m in zip(pairs, xs, masks):
            l32 = m.sum(1, dtype=torch.int32)
            p_, _, _, c_ = lstm_fused.lstm_k1(xx, l32, *pr, 1.0, True, True, True)
            saved.append((p_, l32, pr, c_))
        k1b_sep = lambda: [lstm_fused.lstm_rec_bwd(p_, l32, *pr, c_, go, gf, 1.0)
                           for (p_, l32, pr, c_), (go, gf) in zip(saved, cots)]
        row.update(k1b_grouped_ms=cuda_ms(k1b), k1b_separate_ms=cuda_ms(k1b_sep),
                   k1b_grouped_graph_ms=graph_ms(k1b), k1b_separate_graph_ms=graph_ms(k1b_sep))
    lw = [w.detach().clone().requires_grad_() for pr in pairs for p in pr for w in p]
    lx = [xx.detach().clone().requires_grad_() for xx in xs]
    from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

    ps = [(LSTMParams(*lw[6 * k:6 * k + 3]), LSTMParams(*lw[6 * k + 3:6 * k + 6]))
          for k in range(len(xs))]
    res = lstm_fused.bilstm_fused_grouped_ref(ps, lx, mm)
    loss = sum((o * go).sum() + (f * gf).sum() for (o, f), (go, gf) in zip(res, cots))
    row["k1b_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(loss, lw + lx, retain_graph=True),
                                  iters=3, warmup=1)
    fb = [0.0, 0.0]
    kb = [0.0, 0.0]
    for (_, t, d), m in zip(GROUPED_ENCODERS, masks):
        steps = int(m.sum())
        for i, v in enumerate(k1_bounds(GROUPED_N, t, d, H, steps, True)["fn"]):
            fb[i] += v
        # K1b: pre-activations, cells, cotangents and wh in, dgates out (k1b_times' count)
        kb[0] += 4 * (steps * 8 * H + GROUPED_N + 2 * H * 4 * H + 2 * steps * H
                      + 2 * steps * H + GROUPED_N * 2 * H + GROUPED_N * t * 8 * H) \
            / HBM_BYTES_PER_S * 1e3
        kb[1] += 2 * steps * (2 * 4 * H * H + 30 * H) / FP32_FLOPS * 1e3
    row.update(bound_ms=max(fb), bound_by="bytes" if fb[0] >= fb[1] else "operations",
               k1b_bound_ms=max(kb), k1b_bound_by="bytes" if kb[0] >= kb[1] else "operations")
    log(f"grouped K=6 times: {json.dumps(row)}")
    return row


def mesh_answers(engine, asks: list) -> list:
    """The engine's answers to `asks`, 8 per answer step."""
    return [r for i in range(0, len(asks), 8) for r in engine.answer_batch(asks[i:i + 8])]


def same_mesh_answers(what: str, got: list, ref: list) -> dict:
    import numpy as np

    d_p = max(float(np.abs(np.subtract(g["probs"], r["probs"])).max()) for g, r in zip(got, ref))
    d_s = max(float(np.abs(np.subtract(g["seq_attention"], r["seq_attention"])).max())
              for g, r in zip(got, ref))
    same = all(g["answer_index"] == r["answer_index"] and g["albums_found"] == r["albums_found"]
               for g, r in zip(got, ref))
    if not same or d_p > SERVE_TOL or d_s > SERVE_TOL:
        fail(f"mesh serving {what}: answers equal {same}, max|d probs| {d_p:.3e}, max|d "
             f"seq_attention| {d_s:.3e} vs dp = 1 (limit {SERVE_TOL})")
    return {"max_abs_d_probs": d_p, "max_abs_d_seq_attention": d_s, "answers_equal": same}


def mesh_serving(workdir: str) -> dict:
    """build_engine at dp = 1, at dp = 2 over devices ["cuda:0", "cuda:0"], and
    at dp = 2 with shard_cache, on phase 4's pack and phase 7's run: the 32
    serving questions 8 per answer step, answers equal to dp = 1's (probs and
    seq_attention within SERVE_TOL), K1 and K2 launched in the mesh's runs and
    the L2-streaming kernels never; the sharded cache's slot
    bytes summing to cache_bytes and a save / load round trip back on the same
    homes (crc32 % 2); asks/s of the answer steps at dp = 1 and dp = 2 in
    turns (one card: no multi-card figure)."""
    import torch

    from fvta_memexqa_torch.ops import fvta_fused
    from fvta_memexqa_torch.serve import AlbumStore, build_engine

    pack, run = os.path.join(workdir, "pack"), os.path.join(workdir, "train_plain")
    asks = serving_asks(pack)
    shared_card = SHARED_CARD * 2
    e1, s1, _ = build_engine(pack, run, device="cuda", batch_size=8)
    out = {}
    try:
        ref = mesh_answers(e1, asks)
        zero_lstm_counters()
        fvta_fused.fvta_fwd.launches = 0
        e2, s2, _ = build_engine(pack, run, batch_size=8, dp=2, devices=shared_card)
        try:
            out["replicated"] = same_mesh_answers("dp=2", mesh_answers(e2, asks), ref)
            e3, s3, _ = build_engine(pack, run, batch_size=8, dp=2, devices=shared_card,
                                     shard_cache=True)
            try:
                out["sharded"] = same_mesh_answers("dp=2 shard_cache",
                                                   mesh_answers(e3, asks), ref)
                torch.cuda.synchronize()
                launches = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches}
                per = s3.cache_bytes_per_device
                with tempfile.TemporaryDirectory() as cache:
                    s3.save(cache)
                    s4 = AlbumStore(s3.cfg, s3.model, s3.shared, s3.vocab, mesh=s3.mesh,
                                    shard_cache=True)
                    n_loaded = s4.load(cache)
                homes_ok = s4._home == {a: zlib_home(a, 2) for a in s3._store} == s3._home
                out["sharded"].update(cache_bytes_per_device=per, cache_bytes=s3.cache_bytes,
                                      reloaded=n_loaded, reloaded_bytes_per_device=(
                                          s4.cache_bytes_per_device), homes_by_hash=homes_ok)
                if sum(per) != s3.cache_bytes or not homes_ok or n_loaded != s3.num_albums \
                        or s4.cache_bytes_per_device != per:
                    fail(f"mesh serving: the sharded cache's bytes {per} vs {s3.cache_bytes}, "
                         f"homes by hash {homes_ok}, reloaded {n_loaded}")
                rates = {"dp1": [], "dp2": []}
                for name, eng in (("dp1", e1), ("dp2", e2), ("dp2", e2), ("dp1", e1)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(MESH_REPS):
                        mesh_answers(eng, asks)
                    torch.cuda.synchronize()
                    rates[name].append(len(asks) * MESH_REPS / (time.perf_counter() - t0))
            finally:
                e3.close()
        finally:
            e2.close()
    finally:
        e1.close()
    check_lstm_launches("mesh serving", launches, backward=False)
    if launches["fvta_fwd"] == 0:
        fail(f"mesh serving: K2 must launch: {launches}")
    out.update(launches=launches, answer_step_asks_per_s=rates,
               label="dp = 2 on one card (both shards on cuda:0): not a multi-card figure")
    log(f"mesh serving: {json.dumps(out)}")
    return out


def zlib_home(album_id: str, dp: int) -> int:
    import zlib

    return zlib.crc32(album_id.encode()) % dp


def cp_memory_phase() -> list:
    """capacity_probe.cp_memory_table at T = CP_TABLE_T (batch 2, J = 30, D =
    200) over 2 and 4 ranks sharing the card, forward and with grad; each
    side's counted bytes must be counted_mb's. Whether temp_mb falls from one
    rank to 2 and 4 is reported, not enforced."""
    from fvta_memexqa_torch import capacity_probe as cp

    tables = []
    for grad in (False, True):
        for n in (2, 4):
            t0 = time.perf_counter()
            tab = cp.cp_memory_table(t=CP_TABLE_T, devices=n, grad=grad)
            tab["wall_s"] = time.perf_counter() - t0
            counted = cp.counted_mb(CP_TABLE_T, 2, 30, 200, n, grad)
            for side, key in (("local", "local_per_device"), ("cp", "cp_per_device"),
                              ("local", "local_plain_per_device")):
                if any(tab[key][k] != counted[side][k] for k in ("argument_mb", "output_mb")):
                    fail(f"cp_memory_table {side} bytes {tab[key]} differ from the count "
                         f"{counted[side]}")
            log(f"cp_memory_table: {json.dumps(tab)}")
            tables.append(tab)
    for grad in (False, True):
        rows = [t for t in tables if t["grad"] == grad]
        temps = [rows[0]["local_per_device"]["temp_mb"]] + [
            t["cp_per_device"]["temp_mb"] for t in rows]
        falls = temps[2] < temps[1] < temps[0]
        log(f"cp_memory_table grad={grad}: per-rank temp_mb at 1, 2 and 4 ranks {temps}: "
            f"{'falls' if falls else 'does NOT fall'} with the ranks")
    return tables


def grouped_mesh_phase(workdir: str, device) -> dict:
    """Phase 24: bilstm_fused_grouped on both routes and its times, serving over
    a mesh of two shards on the one card, and the CP memory table."""
    t0 = time.perf_counter()
    checks = {h: grouped_bilstm_check(h, device) for h in (H, OLD_H)}
    times = grouped_bilstm_times(device)
    t1 = time.perf_counter()
    mesh = mesh_serving(workdir)
    t2 = time.perf_counter()
    tables = cp_memory_phase()
    return {"grouped": {"checks": checks, "times": times}, "mesh_serving": mesh,
            "cp_memory": tables, "wall_s": {"grouped": t1 - t0, "mesh_serving": t2 - t1,
                                            "cp_memory": time.perf_counter() - t2}}


def grouped_bilstm_entries(phase: dict) -> list:
    """The kernels-line entries of the grouped launches (phase 24's API run at
    H: its forward without and with grad, and the backward)."""
    c, tm = phase["grouped"]["checks"][H], phase["grouped"]["times"]
    work = ("bilstm_fused_grouped at K = 6 (G = 12 groups): the flagship's six time "
            f"encoders over {GROUPED_N} album slots, H = {H}")
    return [
        {"name": "lstm_proj+lstm_rec (grouped, G = 12)", "route": "cuda",
         "source": "fvta_memexqa_torch/csrc/lstm_rec.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:268",
         "launches": c["launches_under_grad"]["lstm_rec"] + c["launches_forward"]["lstm_rec"],
         "max_abs_err": max(c["max_abs_err_out"], c["max_abs_err_out_under_grad"]),
         "ms": tm["grouped_ms"], "graph_ms": tm["grouped_graph_ms"],
         "k1_only_ms": tm["grouped_k1_only_ms"], "separate_ms": tm["separate_ms"],
         "separate_graph_ms": tm["separate_graph_ms"], "plain_ms": tm["plain_ms"],
         "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"], "library_ms": None,
         "max_abs_diff_vs_lone_calls": c["max_abs_diff_vs_lone_calls"],
         "timed_work": work + "; ms: the whole call (padding and stacking included); "
                       "separate_*: the six bilstm_fused calls; library_ms: no one PyTorch "
                       "call computes six bi-LSTMs of different weights"},
        {"name": "lstm_rec_bwd (grouped, G = 12)", "route": "cuda",
         "source": "fvta_memexqa_torch/csrc/lstm_rec_bwd.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:324",
         "launches": c["launches_under_grad"]["lstm_rec_bwd"],
         "max_abs_err": c["max_abs_err_grads"], "ms": tm["k1b_grouped_ms"],
         "graph_ms": tm["k1b_grouped_graph_ms"], "separate_ms": tm["k1b_separate_ms"],
         "separate_graph_ms": tm["k1b_separate_graph_ms"], "plain_ms": tm["k1b_plain_ms"],
         "bound_ms": tm["k1b_bound_ms"], "bound_by": tm["k1b_bound_by"], "library_ms": None,
         "timed_work": work + "; ms: the one K1b launch for all groups (separate: six "
                       "lstm_rec_bwd); plain_ms and max_abs_err: the whole backward (dW "
                       "products included)"},
    ]


# ---- phase 25: TF checkpoints, the bf16 variant, the native tokenizer -------------------

# bf16 kernels vs the plain bf16 version on the card (tests/test_torch_kernels.py's
# bounds): forward within BF16_ATOL (a flipped rounding of x_proj moves an output
# by about one bf16 ulp and carries through the recurrence); gradients within
# BF16_GRAD_REL x max |g| + 1e-6 (the kernels differentiate straight through the
# roundings in float32, autograd through the plain version rounds the cotangents
# of its bf16 values). Besides, every value the BF16 K1 stores must be a bf16
# value, and the float32 instantiation on the same rounded inputs (a BF16
# instantiation that skipped its roundings) is measured against the same bounds.
BF16_ATOL = 2.0 ** -6
BF16_GRAD_REL = 2.0 ** -5
BF16_TRAIN_STEPS = 6
# The video models in bf16 vs float32 with the same weights: untrained, within
# tests/test_bf16.py's bound and VIDEO_BF16_UNTRAINED; trained by `cli video`
# (CLI_STEPS steps on the video pack), max |d| within VIDEO_BF16_REL of the
# largest float32 logit. Each measured bound is 4x the largest reading on the
# H100 in PR 16's chip runs, rounded up to a power of two.
VIDEO_BF16_BOUND = 0.5
VIDEO_BF16_UNTRAINED = 2.0 ** -10   # read 1.27e-4
VIDEO_BF16_REL = 2.0 ** -7          # read 1.23e-3 (dilated_conv)


def bf16_counters() -> dict:
    from fvta_memexqa_torch.ops import lstm_fused

    return {k: getattr(lstm_fused, k).bf16_launches for k in NEW_KERNELS + OLD_KERNELS}


def zero_bf16_counters() -> None:
    from fvta_memexqa_torch.ops import lstm_fused

    for k in NEW_KERNELS + OLD_KERNELS:
        getattr(lstm_fused, k).bf16_launches = 0


def tf_round_trip(workdir: str) -> dict:
    """Phase 7's run exported through the port's writer, re-imported with `cli
    import-tf-checkpoint` and evaluated with `cli test` on the card: accuracy and
    loss bitwise those of the run itself; K1 and K2 launched by the test."""
    from fvta_memexqa_torch.ops import fvta_fused
    from fvta_memexqa_torch.tf_import import read_tf_checkpoint

    pack, run = os.path.join(workdir, "pack"), os.path.join(workdir, "train_plain")
    prefix, imported = os.path.join(workdir, "tf_export", "ck"), os.path.join(workdir, "tf_run")
    exp, export_s = cli_json(["export-tf-checkpoint", pack, run, prefix])
    t0 = time.perf_counter()
    tensors = read_tf_checkpoint(prefix)
    read_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(prefix + s) for s in (".index", ".data-00000-of-00001"))
    imp, import_s = cli_json(["import-tf-checkpoint", prefix, pack, imported])
    ref, _ = cli_json(["test", pack, run])
    zero_lstm_counters()
    fvta_fused.fvta_fwd.launches = 0
    got, test_s = cli_json(["test", pack, imported])
    launches = {**lstm_counters(), "fvta_fwd": fvta_fused.fvta_fwd.launches}
    log(f"TF round trip: export {json.dumps(exp)} ({export_s:.2f} s, {nbytes} bytes, "
        f"{len(tensors)} tensors read back by the port's reader in {read_s:.2f} s: "
        f"{nbytes / 1e6 / read_s:.2f} MB/s, every CRC32C checked); import {json.dumps(imp)} "
        f"({import_s:.2f} s); cli test of the import {json.dumps(got)} vs the run "
        f"{json.dumps(ref)}; launches {json.dumps(launches)}")
    if (got["accuracy"], got["loss"], got["count"]) != (ref["accuracy"], ref["loss"],
                                                       ref["count"]):
        fail(f"the re-imported run tests {got}, not bitwise the run's {ref}")
    if imp["kept_init"] or imp["imported"] != imp["tf_variables"] - 14:
        fail(f"the import did not take every tensor: {imp}")
    check_lstm_launches("cli test of the imported run", launches, backward=False)
    if not launches["fvta_fwd"]:
        fail(f"cli test of the imported run launched no K2: {launches}")
    return {"export": exp, "import": imp, "test": got, "export_s": export_s,
            "import_s": import_s, "test_s": test_s, "read_s": read_s, "bytes": nbytes,
            "read_mb_per_s": nbytes / 1e6 / read_s, "launches": launches}


def bf16_train_run(workdir: str) -> dict:
    """`cli train --dtype bfloat16` at the flagship's widths on phase 4's pack:
    the BF16 instantiations of K1 and K1b launch, the float32 ones do not."""
    from fvta_memexqa_torch.ops import fvta_fused

    pack, run = os.path.join(workdir, "pack"), os.path.join(workdir, "train_bf16")
    zero_lstm_counters()
    zero_bf16_counters()
    fvta_fused.fvta_fwd.launches = 0
    res, wall = cli_json(["train", pack, run, "--num-steps", str(BF16_TRAIN_STEPS),
                          "--val-period", "3", "--log-period", "1", "--dtype", "bfloat16"])
    total, bf16 = lstm_counters(), bf16_counters()
    f32 = {k: total[k] - bf16[k] for k in total}
    losses = [r["loss"] for r in read_metrics(os.path.join(run, "metrics.jsonl"))
              if r["event"] == "train"]
    log(f"cli train --dtype bfloat16: {json.dumps(res)} in {wall:.1f} s, losses {losses}; "
        f"BF16 launches {json.dumps(bf16)}, float32 launches {json.dumps(f32)}, K2 "
        f"{fvta_fused.fvta_fwd.launches}")
    if (len(losses) != BF16_TRAIN_STEPS or not all(map(math.isfinite, losses))
            or any(f32.values()) or any(bf16[k] for k in OLD_KERNELS)
            or min(bf16[k] for k in NEW_KERNELS) == 0 or not fvta_fused.fvta_fwd.launches):
        fail("cli train --dtype bfloat16 must run the BF16 lstm_proj, lstm_rec and "
             f"lstm_rec_bwd and no float32 or L2-streaming bi-LSTM kernel: {bf16}, {f32}")
    return {"result": res, "wall_s": wall, "losses": losses, "bf16_launches": bf16,
            "f32_launches": f32, "k2_launches": fvta_fused.fvta_fwd.launches}


def bf16_kernel_checks(device) -> dict:
    """K1 (serving shapes, no grad) and K1b (the train step's shapes, under
    grad) in bf16 vs the plain bf16 version on the card, with each shape's
    times: the bf16 and the float32 instantiations on the same inputs (CUDA
    events and graph replays), the plain bf16 version."""
    import torch

    from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

    bf, out = torch.bfloat16, {"k1": [], "k1b": []}
    r = lambda p: lstm_ref.LSTMParams(*(a.to(bf).float() for a in p))
    for i, (name, n, t, d, emit) in enumerate(K1_SHAPES):
        x, mask, p_fw, p_bw = lstm_case(n, t, d, H, 2500 + i, device)
        l32 = mask.sum(1, dtype=torch.int32)
        xb, pf, pb = x.to(bf).float(), r(p_fw), r(p_bw)
        with torch.no_grad():
            o_r, f_r = (v.float() for v in lstm_ref.bilstm_ref(p_fw, p_bw, x, mask, dtype=bf))
            o, f = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask, dtype=bf)
            pre, o16, f16, c16 = lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, True, emit_cell=True,
                                                    bf16=True)
            o32, f32 = lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, True)[1:3]
            stored = {"out": o[mask], "fin": f, "x_proj": pre[mask], "k1_out": o16[mask],
                      "k1_fin": f16, "k1_cell": c16[mask]}
            not_bf16 = [k for k, v in stored.items() if not bf16_valued(v)]
            if not_bf16:
                fail(f"bf16 K1 at {name}: {not_bf16} hold values that are not bf16")
            k1_16 = lambda: lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, emit, bf16=True)
            k1_32 = lambda: lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, emit)
            row = {"name": name, "rows": n, "T": t, "D": d,
                   "max_abs_err": max(max_err(o[mask], o_r[mask]), max_err(f, f_r)),
                   "f32_inst_max_abs_err": max(max_err(o32[mask], o_r[mask]),
                                               max_err(f32, f_r)),
                   "bf16_ms": cuda_ms(k1_16), "f32_ms": cuda_ms(k1_32),
                   "bf16_graph_ms": graph_ms(k1_16), "f32_graph_ms": graph_ms(k1_32),
                   "plain_ms": cuda_ms(lambda: lstm_ref.bilstm_ref(p_fw, p_bw, x, mask,
                                                                   dtype=bf), iters=5, warmup=1)}
        steps = int(l32.sum())
        row.update(valid_steps=steps, bounds=k1_bounds(n, t, d, H, steps, emit)["fn"])
        out["k1"].append(row)
    for i, (name, n, t, d, fin_only) in enumerate(K1B_SHAPES):
        x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, 2600 + i, fin_only, device,
                                                     COTANGENT_SCALE)
        l32 = mask.sum(1, dtype=torch.int32)
        if fin_only:
            fn = lambda pf, pb, xx: (None, lstm_fused.bilstm_fused_final(pf, pb, xx, mask,
                                                                         dtype=bf))
        else:
            fn = lambda pf, pb, xx: lstm_fused.bilstm_fused(pf, pb, xx, mask, dtype=bf)
        plain = lambda pf, pb, xx: tuple(v.float() for v in lstm_ref.bilstm_ref(
            pf, pb, xx, mask, dtype=bf))
        rounded = lambda f_: lambda pf, pb, xx: f_(*(lstm_ref.LSTMParams(*map(
            lstm_fused._round_bf16, p)) for p in (pf, pb)), lstm_fused._round_bf16(xx))
        f32_fn = rounded(fused_fn(mask, fin_only))   # the bf16 path, float32 kernels
        got = lstm_grads(fn, x, p_fw, p_bw, g_out, g_fin)[2]
        ref = lstm_grads(plain, x, p_fw, p_bw, g_out, g_fin)[2]
        got32 = lstm_grads(f32_fn, x, p_fw, p_bw, g_out, g_fin)[2]
        rel_of = lambda gs: max(max_err(a, b) / (float(b.abs().max()) + 1e-6 / BF16_GRAD_REL)
                                for a, b in zip(gs, ref))
        rel = rel_of(got)
        abs_err = max(max_err(a, b) for a, b in zip(got, ref))
        xb, pf, pb = x.to(bf).float(), r(p_fw), r(p_bw)
        with torch.no_grad():
            pre16, _, _, cell16 = lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, True, emit_cell=True,
                                                     write_preact=True, bf16=True)
            pre32, _, _, cell32 = lstm_fused.lstm_k1(xb, l32, pf, pb, 1.0, True, emit_cell=True,
                                                     write_preact=True)
            b16 = lambda: lstm_fused.lstm_rec_bwd(pre16, l32, pf, pb, cell16, g_out, g_fin, 1.0,
                                                  bf16=True)
            b32 = lambda: lstm_fused.lstm_rec_bwd(pre32, l32, pf, pb, cell32, g_out, g_fin, 1.0)
            row = {"name": name, "rows": n, "T": t, "D": d, "grad_err_rel": rel,
                   "grad_err_abs": abs_err, "f32_inst_grad_err_rel": rel_of(got32),
                   "bf16_ms": cuda_ms(b16), "f32_ms": cuda_ms(b32),
                   "bf16_graph_ms": graph_ms(b16), "f32_graph_ms": graph_ms(b32)}
        leaves = [a.detach().clone().requires_grad_() for a in (x, *p_fw, *p_bw)]
        o_r, f_r = plain(lstm_ref.LSTMParams(*leaves[1:4]), lstm_ref.LSTMParams(*leaves[4:]),
                         leaves[0])
        loss_r = (f_r * g_fin).sum() + (0 if g_out is None else (o_r * g_out).sum())
        row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(loss_r, leaves, retain_graph=True),
                                  iters=5, warmup=1)
        steps = int(l32.sum())
        g_bytes = 2 * steps * H if g_out is not None else 0
        nbytes = 4 * (steps * 8 * H + n + 2 * H * 4 * H + 2 * steps * H + g_bytes + n * 2 * H
                      + n * t * 8 * H)
        flops = 2 * steps * (2 * 4 * H * H + 36 * H)
        row.update(valid_steps=steps, bounds=(nbytes / HBM_BYTES_PER_S * 1e3,
                                              flops / FP32_FLOPS * 1e3))
        out["k1b"].append(row)
    worst_fwd = max(r_["max_abs_err"] for r_ in out["k1"])
    worst_grad = max(r_["grad_err_rel"] for r_ in out["k1b"])
    f32_fwd = max(r_["f32_inst_max_abs_err"] for r_ in out["k1"])
    f32_grad = max(r_["f32_inst_grad_err_rel"] for r_ in out["k1b"])
    for key in ("k1", "k1b"):
        tot = {k: sum(r_[k] for r_ in out[key]) for k in ("bf16_ms", "f32_ms", "bf16_graph_ms",
                                                          "f32_graph_ms", "plain_ms")}
        log(f"{key.upper()} bf16 vs float32 instantiation ({len(out[key])} calls, sum): events "
            f"{tot['bf16_ms']:.4f} vs {tot['f32_ms']:.4f} ms, graph {tot['bf16_graph_ms']:.4f} "
            f"vs {tot['f32_graph_ms']:.4f} ms; plain bf16 {tot['plain_ms']:.3f} ms")
    log(f"bf16 K1 max |d| vs plain bf16 {worst_fwd:.3e} (bound {BF16_ATOL}); K1b + products "
        f"max |d| / max |g| {worst_grad:.3e} (bound {BF16_GRAD_REL}); every value the BF16 "
        f"K1 stored a bf16 value. The float32 instantiation on the same rounded inputs vs "
        f"plain bf16: forward {f32_fwd:.3e}, gradients {f32_grad:.3e} of max |g|")
    if worst_fwd > BF16_ATOL or worst_grad > BF16_GRAD_REL:
        fail(f"bf16 kernels vs the plain bf16 version: forward {worst_fwd}, gradients "
             f"{worst_grad}")
    return out


def bf16_valued(t) -> bool:
    """Whether every element of the float32 tensor t is a bf16 value."""
    import torch

    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


def trained_video_run(workdir: str, encoder: str) -> tuple[str, float]:
    """(run directory, seconds) of a video model `cli video` trained on the
    video pack (CLI_STEPS steps at H = 100): the video phase's run for the
    dilated_conv encoder, trained here the same way for the bilstm one."""
    pack = os.path.join(workdir, "video_pack")
    run = os.path.join(workdir, "video_run" if encoder == "dilated_conv"
                       else f"video_run_{encoder}")
    if os.path.exists(os.path.join(run, "video_run.json")):
        return run, 0.0
    _, wall = cli_json(["video", "--data", pack, "--out", run, "--encoder", encoder,
                        "--hidden-dim", "100", "--steps", str(CLI_STEPS), "--val-period", "12",
                        "--device", "cuda"])
    return run, wall


def bf16_video_logits(cfg, run, params, shared, batches) -> tuple:
    """(float32 logits, bf16 logits, BF16 bi-LSTM launches) of the video model
    with `params` on the card, float32 exact (no TF32), over `batches`' real
    examples."""
    import dataclasses as dc

    import torch

    from fvta_memexqa_torch.convert import video_model_from_run
    from fvta_memexqa_torch.train_video import exact_float32

    m32 = video_model_from_run(cfg, run)
    m16 = video_model_from_run(cfg.replace(model=dc.replace(cfg.model, dtype="bfloat16")), run)
    for m in (m32, m16):
        m.load_state_dict(params)
        m.to("cuda").eval()
    l32, l16 = [], []
    before16 = bf16_counters()
    with torch.no_grad(), exact_float32():
        for vi in batches:
            v = vi.to("cuda")
            l32.append(m32(shared, v).logits[v.ex_mask])
            l16.append(m16(shared, v).logits[v.ex_mask])
    launched = {k: n - before16[k] for k, n in bf16_counters().items()}
    return torch.cat(l32), torch.cat(l16), launched


def bf16_video_check(workdir: str) -> dict:
    """The full-width video model (dilated_conv and bilstm encoders, T = 1024)
    in bf16 against float32 with the same weights, twice: untrained (seeded
    weights, 8 synthetic videos, tests/test_bf16.py's setting) within 0.5
    (its bound) and VIDEO_BF16_UNTRAINED, above 0; trained (trained_video_run,
    the pack's test split) with the same argmax on every example and max |d|
    within VIDEO_BF16_REL of the largest float32 logit. An untrained model's
    logits nearly tie, so its argmax is not compared."""
    import torch

    from fvta_memexqa_torch.checkpoint import CheckpointManager
    from fvta_memexqa_torch.config import load_config
    from fvta_memexqa_torch.convert import VIDEO_RUN, video_model_from_run
    from fvta_memexqa_torch.data.video_pack import (VideoDataset, load_video_meta,
                                                    video_shared_tables)

    pack = os.path.join(workdir, "video_pack")
    dcfg, _, shared_np = load_video_meta(pack)
    pack_shared = video_shared_tables(dcfg, shared_np, "cuda")
    out = {}
    for encoder in ("dilated_conv", "bilstm"):
        cfg, run, shared, vi = video_setup(CLI_FRAMES, encoder, keep_prob=1.0, batch=8, seed=25)
        init = video_model_from_run(cfg, run, torch.Generator().manual_seed(25)).state_dict()
        u32, u16, launched = bf16_video_logits(cfg, run, init, video_shared_to(shared), [vi])
        d_init = max_err(u16, u32)
        rundir, train_s = trained_video_run(workdir, encoder)
        cfg = load_config(os.path.join(rundir, "config.json")).replace(data=dcfg)
        with open(os.path.join(rundir, VIDEO_RUN)) as f:
            run = json.load(f)
        params = CheckpointManager(rundir).load(best=True)["params"]
        l32, l16, launched_t = bf16_video_logits(
            cfg, run, params, pack_shared,
            VideoDataset(pack, "test").get_batches(cfg.train.eval_batch_size))
        d, top = max_err(l16, l32), float(l32.abs().max())
        top2 = l32.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        same = bool((l16.argmax(-1) == l32.argmax(-1)).all())
        out[encoder] = {"untrained_max_abs_d_logits": d_init, "max_abs_d_logits": d,
                        "max_abs_logit_f32": top, "rel_d_logits": d / top,
                        "argmax_equal": same, "examples": len(l32),
                        "min_top2_margin_f32": margin, "train_s": train_s,
                        "bf16_launches": {k: n + launched_t[k] for k, n in launched.items()}}
        log(f"video ({encoder}, T={CLI_FRAMES}) bf16 vs float32 logits: untrained (8 videos) "
            f"max |d| {d_init:.3e} (bounds {VIDEO_BF16_UNTRAINED}, {VIDEO_BF16_BOUND}); "
            f"trained ({CLI_STEPS} steps, {len(l32)} test examples) max |d| {d:.3e} of max "
            f"|logit| {top:.3e} ({d / top:.3e}, bound {VIDEO_BF16_REL}), argmax equal {same}, "
            f"smallest float32 top-two margin {margin:.3e}; BF16 bi-LSTM launches untrained "
            f"{json.dumps(launched)}, trained {json.dumps(launched_t)}")
        if not (0 < d_init < min(VIDEO_BF16_BOUND, VIDEO_BF16_UNTRAINED)
                and 0 < d / top < VIDEO_BF16_REL and same
                and torch.isfinite(u16).all() and torch.isfinite(l16).all()):
            fail(f"video {encoder}: bf16 logits {d_init} (untrained) / {d} of {top} (trained) "
                 f"from float32, or the trained model's argmax changed")
        if min(min(c[k] for k in NEW_KERNELS[:2]) for c in (launched, launched_t)) == 0:
            fail(f"video {encoder}: a bf16 model ran no BF16 K1: {launched}, {launched_t}")
    return out


def native_prepro_check(workdir: str) -> dict:
    """`cli prepro` on phase 16's raw files through the native tokenizer and under
    FVTA_NO_NATIVE=1: every file of the two packs byte-identical; the encoder's
    texts/s both ways on the corpus's texts."""
    from fvta_memexqa_torch.data import make_synthetic
    from fvta_memexqa_torch.data.pack import BatchEncoder
    from fvta_memexqa_torch.data.tokenize import try_load_native, tokenize_many
    from fvta_memexqa_torch.data.vocab import Vocab

    if try_load_native() is None:
        fail("the native tokenizer did not load on this machine (see the log above)")
    raw = os.path.join(workdir, "raw")
    files = [os.path.join(raw, f) for f in ("qas.json", "album_info.json", "test_question.ids",
                                            "glove.txt", "photo_feats.npz")]
    walls, packs = {}, {}
    for route in ("native", "regex"):
        packs[route] = os.path.join(workdir, f"pack_{route}")
        if route == "regex":
            os.environ["FVTA_NO_NATIVE"] = "1"
        try:
            _, walls[route] = cli_json(["prepro", *files, packs[route], "--seed", "0",
                                        "--image-feat-dim", str(SLICE_CORPUS["feat_dim"])])
        finally:
            os.environ.pop("FVTA_NO_NATIVE", None)
    names = sorted(os.listdir(packs["native"]))
    differ = [f for f in names if open(os.path.join(packs["native"], f), "rb").read()
              != open(os.path.join(packs["regex"], f), "rb").read()]
    if names != sorted(os.listdir(packs["regex"])) or differ:
        fail(f"cli prepro's packs differ between the native and the regex route: {differ}")
    qas, albums, *_ = make_synthetic(**SLICE_CORPUS)
    texts = [t for qa in qas for t in (qa.question, *qa.choices)]
    texts += [t for a in albums.values() for t in (a.title, a.description, a.where, a.when,
                                                   *a.photo_titles)]
    texts = texts * 20
    vocab = Vocab.build([w for toks in tokenize_many(texts[:5000]) for w in toks], None, dim=4,
                        seed=0)
    rates = {}
    for route in ("native", "regex"):
        if route == "regex":
            os.environ["FVTA_NO_NATIVE"] = "1"
        try:
            enc = BatchEncoder(vocab)
            t0 = time.perf_counter()
            enc.encode(texts, 30, 16)
            rates[route] = len(texts) / (time.perf_counter() - t0)
        finally:
            os.environ.pop("FVTA_NO_NATIVE", None)
    log(f"cli prepro native {walls['native']:.2f} s vs regex {walls['regex']:.2f} s, the "
        f"{len(names)} pack files byte-identical; BatchEncoder over {len(texts)} corpus texts: "
        f"native {rates['native']:.0f} texts/s, regex {rates['regex']:.0f} texts/s")
    return {"prepro_s": walls, "pack_files": len(names), "texts": len(texts),
            "texts_per_s": rates}


def port_complete_phase(workdir: str, device, smi: str) -> dict:
    """Phase 25: TF checkpoint export / import / test, the bf16 variant (cli
    train, kernels vs plain, video), the native tokenizer's prepro."""
    t0 = time.perf_counter()
    tf_rt = tf_round_trip(workdir)
    t1 = time.perf_counter()
    bf16_train = bf16_train_run(workdir)
    kernels = bf16_kernel_checks(device)
    video = bf16_video_check(workdir)
    t2 = time.perf_counter()
    native = native_prepro_check(workdir)
    return {"card": smi, "tf_round_trip": tf_rt, "bf16_train": bf16_train,
            "bf16_kernels": kernels, "bf16_video": video, "native_prepro": native,
            "wall_s": {"tf": t1 - t0, "bf16": t2 - t1, "native": time.perf_counter() - t2}}


def bf16_entries(phase: dict) -> list:
    """The kernels-line entries of the BF16 instantiations (phase 25)."""
    k = phase["bf16_kernels"]
    launches = phase["bf16_train"]["bf16_launches"]
    tot = lambda key, f: sum(r[f] for r in k[key])
    bound = lambda key: (sum(r["bounds"][0] for r in k[key]), sum(r["bounds"][1] for r in k[key]))
    (k1_b, k1_o), (k1b_b, k1b_o) = bound("k1"), bound("k1b")
    return [
        {"name": "lstm_proj+lstm_rec (bf16)", "route": "cuda",
         "source": "fvta_memexqa_torch/csrc/lstm_rec.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:75",
         "launches": launches["lstm_rec"], "launches_lstm_proj": launches["lstm_proj"],
         "max_abs_err": max(r["max_abs_err"] for r in k["k1"]), "ms": tot("k1", "bf16_ms"),
         "graph_ms": tot("k1", "bf16_graph_ms"), "f32_ms": tot("k1", "f32_ms"),
         "f32_graph_ms": tot("k1", "f32_graph_ms"), "plain_ms": tot("k1", "plain_ms"),
         "bound_ms": max(k1_b, k1_o), "bound_by": "bytes" if k1_b >= k1_o else "operations",
         "library_ms": None,
         "timed_work": "lstm_k1(bf16=True) at the 9 K1 calls of one 64-album ingest batch + one "
                       "8-question answer batch (sum); f32_*: the float32 instantiation on the "
                       "same inputs; plain_ms: bilstm_ref(dtype=bfloat16); launches: cli train "
                       "--dtype bfloat16; library_ms: no PyTorch call rounds as the JAX bf16 "
                       "scan does"},
        {"name": "lstm_rec_bwd (bf16)", "route": "cuda",
         "source": "fvta_memexqa_torch/csrc/lstm_rec_bwd.cu",
         "replaces": "fvta_memexqa_tpu/ops/lstm_fused.py:121",
         "launches": launches["lstm_rec_bwd"],
         "max_abs_err": max(r["grad_err_abs"] for r in k["k1b"]),
         "max_err_rel": max(r["grad_err_rel"] for r in k["k1b"]),
         "ms": tot("k1b", "bf16_ms"), "graph_ms": tot("k1b", "bf16_graph_ms"),
         "f32_ms": tot("k1b", "f32_ms"), "f32_graph_ms": tot("k1b", "f32_graph_ms"),
         "plain_ms": tot("k1b", "plain_ms"), "bound_ms": max(k1b_b, k1b_o),
         "bound_by": "bytes" if k1b_b >= k1b_o else "operations", "library_ms": None,
         "timed_work": "lstm_rec_bwd(bf16=True) at the 9 K1b calls of one batch-64 train step "
                       "(sum); max_abs_err: the whole backward's max |d| vs autograd through "
                       "the plain bf16 version (max_err_rel: over max |g|, per tensor); "
                       "plain_ms: that backward; f32_*: the float32 instantiation on the same "
                       "inputs"},
    ]


GRAPH_STEP_TIMED = 30   # phase 26: timed steps a path, after two warm-up steps


def graph_step_phase(device, smi: str) -> dict:
    """Phase 26: the train step eagerly (train.eager_step) and from its CUDA
    graph (train.train_step) at realistic_config, batch 64 and 256, from one
    seed's state over the same batches: two warm-up steps (the graphed side's
    eager step and capture), then GRAPH_STEP_TIMED steps under the host clock,
    ending in a synchronise; the parameters and moments after both runs must be
    equal bit for bit. Reads train_step's eager_steps, graph_captures and
    graph_replays over each run (the `graph_step` line)."""
    import torch

    from fvta_memexqa_torch import bench_lib as bl
    from fvta_memexqa_torch import train as tr
    from fvta_memexqa_torch.optim import Optimizer

    cfg = bl.realistic_config()
    shared = bl.synth_shared(cfg, seed=0, device=device)
    paths = ("eager_steps", "graph_captures", "graph_replays")
    out = {"card": smi, "timed_steps": GRAPH_STEP_TIMED}
    with tr.deterministic_algorithms(device):
        for bs in (64, 256):
            batches = [bl.synth_batch(cfg, bs, seed=1 + i, device=device) for i in range(4)]
            row, states = {}, {}
            for name, step in (("eager", tr.eager_step), ("graphed", tr.train_step)):
                state = tr.init_state(cfg, device, seed=0)
                opt = Optimizer(cfg.train)
                before = {k: getattr(tr.train_step, k) for k in paths}
                feed = itertools.cycle(batches)
                for _ in range(2):
                    step(state, opt, shared, next(feed))
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(GRAPH_STEP_TIMED):
                    step(state, opt, shared, next(feed))
                torch.cuda.synchronize(device)
                ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEP_TIMED
                row[name] = {"ms_per_step": ms, "qa_per_s": bs * 1e3 / ms,
                             **{k: getattr(tr.train_step, k) - before[k] for k in paths}}
                states[name] = state
            a, b = (dict(states[k].model.named_parameters()) for k in ("eager", "graphed"))
            moments = [(states["eager"].opt_state[g][n], states["graphed"].opt_state[g][n])
                       for g in ("mu", "nu") for n in a]
            row["bitwise"] = (all(torch.equal(a[n], b[n]) for n in a)
                              and all(torch.equal(x, y) for x, y in moments))
            row["speedup"] = row["eager"]["ms_per_step"] / row["graphed"]["ms_per_step"]
            if not row["bitwise"]:
                fail(f"the graphed train step at batch {bs} left other bits than the eager "
                     f"one: {json.dumps(row)}")
            if (row["graphed"]["graph_captures"], row["graphed"]["eager_steps"]) != (1, 1):
                fail(f"the graphed run at batch {bs} did not capture once after one eager "
                     f"step: {json.dumps(row)}")
            out[f"b{bs}"] = row
            del states, batches
    return out


STAGING_REPS = 12   # phase 27: timed moves a path and shape, after two warm-up moves


def staging_inputs(kind: str, seed: int):
    """A host batch of fresh seeded tensors at a cell's shapes: "video"
    tvqa-frames-train-b128's VideoInputs (128 x 270 frames of 2048 float32,
    ~283 MB), "memexqa" memexqa-train-b256's Batch."""
    import torch

    from fvta_memexqa_torch.data.device_prepro import Batch
    from fvta_memexqa_torch.models.video import VideoInputs

    g = torch.Generator().manual_seed(seed)
    ints = lambda *s: torch.randint(0, 12000, s, generator=g, dtype=torch.int32)
    bools = lambda *s: torch.rand(s, generator=g) < 0.5
    if kind == "video":
        n, t, f, jq, w, c, ja = 128, 270, 2048, 25, 16, 5, 15
        return VideoInputs(frame_feats=torch.rand((n, t, f), generator=g),
                           frame_mask=bools(n, t), q_words=ints(n, jq), q_chars=ints(n, jq, w),
                           q_mask=bools(n, jq), choice_words=ints(n, c, ja),
                           choice_chars=ints(n, c, ja, w), choice_mask=bools(n, c, ja),
                           label=ints(n), ex_mask=bools(n))
    n, jq, w, ja, a = 256, 30, 16, 8, 4
    return Batch(q_words=ints(n, jq), q_chars=ints(n, jq, w), q_mask=bools(n, jq),
                 choice_words=ints(n, 4, ja), choice_chars=ints(n, 4, ja, w),
                 choice_mask=bools(n, 4, ja), album_idx=ints(n, a), album_mask=bools(n, a),
                 label=ints(n), ex_mask=bools(n))


def staging_phase(device, smi: str) -> dict:
    """Phase 27 (see the module docstring): per shape, the plain move and the
    staged one in turns, STAGING_REPS timed moves each; medians (the
    `staging` line)."""
    import statistics

    import torch

    from fvta_memexqa_torch.data.device_prepro import stage_to

    def plain(x):
        return type(x)(**{k: t.to(device) for k, t in x.__dict__.items()})

    def staged(x):
        return x.to(device)

    def one_by_one(move, xs) -> dict:
        host, landed, events = [], [], []
        for i in range(STAGING_REPS):
            torch.cuda.synchronize(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            move(xs[i % len(xs)])
            end.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            landed.append((t2 - t0) * 1e3)
            events.append(start.elapsed_time(end))
        return {"host_ms": statistics.median(host), "landed_ms": statistics.median(landed),
                "event_ms": statistics.median(events)}

    def back_to_back(move, xs) -> float:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(STAGING_REPS):
            move(xs[i % len(xs)])
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3 / STAGING_REPS

    out = {"card": smi, "reps": STAGING_REPS, "intra_op_threads": torch.get_num_threads()}
    for kind in ("video", "memexqa"):
        xs = [staging_inputs(kind, seed) for seed in (1, 2, 3)]
        row = {"bytes": sum(t.nbytes for t in xs[0].__dict__.values())}
        for x in xs:
            a, b = plain(x), staged(x)
            if not all(torch.equal(getattr(a, k), getattr(b, k))
                       and getattr(a, k).dtype == getattr(b, k).dtype for k in x.__dict__):
                fail(f"the staged {kind} batch differs from the plain .to")
        waits = stage_to.waits
        for name, move in (("plain", plain), ("staged", staged), ("plain_again", plain),
                           ("staged_again", staged)):
            row[name] = one_by_one(move, xs)
            row[name]["back_to_back_ms"] = back_to_back(move, xs)
        row["staged_waits"] = stage_to.waits - waits
        out[kind] = row
        del xs
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA card")
    try:
        from fvta_memexqa_torch.ops import build
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from the root of a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    try:
        paths = build.build_all()
    except Exception as e:  # noqa: BLE001 - a kernel that does not build is fatal
        fail(f"kernel build: {e}")
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s with "
        f"nvcc {' '.join(build.NVCC_FLAGS)}")
    for stem, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas {stem}: {line.strip()}")

    zero_global_counters()   # read again at phase 18: no earlier phase takes a global route
    with tempfile.TemporaryDirectory() as workdir:
        prep = prepare_video_pack(workdir)   # CPU work, overlapped with the card's phases
        try:
            zero_lstm_counters()
            k1_err = k1_check(device)
            past_limit = lstm_counters()   # the L2-streaming kernels at H = OLD_H ...
            k2_err = k2_check(device)
            k2_rows = k2_timing(device)
            zero_grouped_counters()   # K7/K8 over the commands of phases 3-14 ...
            served = run_slice(workdir)
            log("serving " + json.dumps(served))
            cotangents = cotangent_probe(os.path.join(workdir, "pack"))
            before = lstm_counters()
            k1b_err = k1b_check(device)
            past_limit = {k: v + past_limit[k] for k, v in lstm_delta(before).items()}   # ... all
            log(f"launches of the bi-LSTM kernels in the checks: {json.dumps(past_limit)}")
            trained = run_train_slice(workdir)
            trained["k1b_cotangents"] = cotangents
            log("training " + json.dumps(trained))
            video, stats_entries = run_video_slice(workdir, prep)
            log("video " + json.dumps(video))
            from_cli = grouped_counters()
            grouped = grouped_check(device)
            evaluation = eval_check(workdir)   # ... and of phase 16
            log("evaluation " + json.dumps(evaluation))
            from_cli = {k: v + evaluation["grouped_launches"][k] for k, v in from_cli.items()}
            k2_paths = k2_path_checks(device)
            log("k2_paths " + json.dumps(k2_paths))
            serving_http = serving_http_phase(   # phase 21, on phases 4's, 7's and 16's files
                os.path.join(workdir, "pack"), os.path.join(workdir, "train_plain"),
                os.path.join(workdir, "raw"), workdir, smi)
            t0 = time.perf_counter()
            train_loader = train_loader_phase(workdir, smi)   # phase 22, on 4's and 7's files
            focal = focal_phase(workdir, smi)
            t_22 = time.perf_counter() - t0
            parallel = parallel_phase(workdir, evaluation, smi)   # phase 23
            log("parallel " + json.dumps(parallel))
            grouped_mesh = grouped_mesh_phase(workdir, device)   # phase 24
            port_complete = port_complete_phase(workdir, device, smi)   # phase 25
            log(f"K7/K8 launches over every command run (serving, training, video, "
                f"evaluation): {json.dumps(from_cli)}")
            if any(from_cli.values()):
                fail(f"a command launched K7 or K8 ({from_cli}): no command should reach them")
        finally:
            if prep.poll() is None:
                prep.kill()
                prep.wait()
    sweep = route_sweep(device)
    k1, k1_rows = k1_times(device, served["launches"], k1_err, past_limit)
    by_path = {"serving": served["launches"], "train": trained["plain_run"]["launches"],
               "train_dedup": trained["dedup_run"]["launches"],
               "video": video["cli_run"]["launches"], "evaluation": evaluation["launches"],
               "serving_http": serving_http["launches"]["total"]}
    bd = served["breakdown"]
    answer = {f"{k}_request{'s' if k > 1 else ''}":
              bd[f"answer_{k}_request{'s' if k > 1 else ''}"]["device_busy_ms"] for k in (1, 8)}
    log(f"answer step device ms: {json.dumps(answer)}")
    k2 = k2_times(k2_rows, by_path, k2_err, k2_paths, answer)
    k1b, k1b_rows = k1b_times(device, trained["plain_run"]["launches"], k1b_err, past_limit)
    grouped_entries, grouped_rows, grouped_traces = grouped_times(device, grouped, from_cli)
    t0 = time.perf_counter()
    widths = widths_phase()
    t_widths = time.perf_counter() - t0
    bench = bench_phase(smi)
    capacity = capacity_phase()
    graph_step = graph_step_phase(device, smi)   # phase 26
    staging = staging_phase(device, smi)   # phase 27
    entries = [*k1, *k2, *k1b, *stats_entries, *grouped_entries]
    add_global_routes(entries, widths)
    for e in entries:   # the front end's launches (phase 21's `cli serve` processes)
        if e["name"] in serving_http["launches"]["total"]:
            e["launches_serving_http"] = serving_http["launches"]["total"][e["name"]]
        if e["name"] in LOADER_KERNELS:   # phase 22's paths
            e["launches_train_prefetch"] = train_loader["prefetch"]["launches"][e["name"]]
            e["launches_train_stream"] = train_loader["stream"]["launches"][e["name"]]
            e["launches_focal"] = focal["launches"][e["name"]]
        if e["name"] in DP_KERNELS:   # phase 23's paths, per rank
            e["launches_dp2_ranks"] = [c[e["name"]] for c in parallel["dp2"]["counts"]]
        if e["name"] in CP_KERNELS:
            for cp, r in parallel["cp"].items():
                e[f"launches_cp{cp}_ranks"] = [c[e["name"]] for c in r["counts"]]
    entries += grouped_bilstm_entries(grouped_mesh)
    entries += bf16_entries(port_complete)
    widths["staged_graph_ms_vs_perf_md"] = staged_vs_perf_md(entries)
    log("k1_shapes " + json.dumps(k1_rows))
    log("k1b_shapes " + json.dumps(k1b_rows))
    log("grouped_shapes " + json.dumps(grouped_rows))
    log("grouped_api_host_traces " + json.dumps(grouped_traces))
    log("route_sweep " + json.dumps(sweep))
    log("widths " + json.dumps(widths))
    log("serving_http " + json.dumps(serving_http))
    log(f"phases 18-20 wall time: widths {t_widths:.1f} s, bench {bench['wall_s']:.1f} s, "
        f"capacity {capacity['wall_s']:.1f} s; phase 22 {t_22:.1f} s")
    log("train_loader " + json.dumps(train_loader))
    log("focal " + json.dumps(focal))
    log("grouped_mesh " + json.dumps(grouped_mesh))
    log("port_complete " + json.dumps(port_complete))
    log("graph_step " + json.dumps(graph_step))
    log("staging " + json.dumps(staging))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
