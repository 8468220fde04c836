"""Video-family (TGIF-QA-style) training and evaluation driver (the JAX
package's train_video.py), with the contract of train.py:

- train step: forward (the dilated-conv or bi-LSTM encoder, the FVTA attention
  in its streaming form from STREAM_MIN_T frames on: K4 forward, K5 + K6
  backward on the card), the task's loss, backward, optim.Optimizer;
- periodic validation on the pack's val split and keep-best checkpoints on a
  task score: accuracy for mc and frameqa, the NEGATIVE mse for count (the
  checkpoint manager keeps the highest);
- exact resume: a killed run continues from its latest checkpoint at
  step mod batches-per-epoch of the (seed, epoch)-determined stream,
  bit-identically (torch's deterministic algorithms and float32 convolutions
  for the run);
- JSONL metrics (loss, acc, qa_pairs_per_sec, p50_step_ms).

The run directory holds config.json, video_run.json (task, encoder,
num_choices, num_answers, max_frames, pack_dir), ckpts/, best/ and, at the
end, params.pt (best on val, else latest); `test_video` rebuilds the model
from those alone. Context parallelism (cp > 1) is a later slice and raises.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, load_config
from fvta_memexqa_torch.convert import VIDEO_RUN, save_video_rundir, video_model_from_run
from fvta_memexqa_torch.data.stream import Prefetcher
from fvta_memexqa_torch.data.video_pack import (VideoDataset, load_video_meta,
                                                video_shared_tables)
from fvta_memexqa_torch.models.video import (COUNT_MAX, COUNT_MIN, VideoFVTAModel,
                                             VideoInputs, video_loss, video_metrics)
from fvta_memexqa_torch.optim import Optimizer
from fvta_memexqa_torch.serve import resolve_device
from fvta_memexqa_torch.train import (TrainState, check_finite_loss, debug_nans_enabled,
                                      deterministic_algorithms)
from fvta_memexqa_torch.utils.metrics import MetricsLogger, Timer

CP_NOT_PORTED = ("context parallelism (cp > 1) is not ported yet: it is a later slice of "
                 "its own (parallel/cp.py and parallel/mesh.py over torch.distributed)")


def run_record(meta: dict, encoder: str, pack_dir: str | None = None) -> dict:
    """The video_run.json record of a pack's model: what rebuilds it."""
    rec = {"task": meta.get("task", "mc"), "encoder": encoder,
           "num_choices": meta["num_choices"],
           "num_answers": len(meta.get("answer_vocab", [])),
           "max_frames": meta["max_frames"]}
    if pack_dir is not None:
        rec["pack_dir"] = os.path.abspath(pack_dir)
    return rec


def video_model_from_meta(cfg: Config, meta: dict, encoder: str = "dilated_conv",
                          generator: torch.Generator | None = None) -> VideoFVTAModel:
    """Model shaped by a video pack's meta.json (packs without "task" are mc)."""
    return video_model_from_run(cfg, run_record(meta, encoder), generator)


@contextlib.contextmanager
def exact_float32():
    """Full float32 in cuDNN convolutions and cuBLAS products for the run (a
    float32 convolution otherwise runs in TF32 on the card), restored afterwards."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def init_video_state(cfg: Config, run: dict, device, seed: int | None = None) -> TrainState:
    """Fresh model (weights from a CPU generator seeded with `seed`), optimizer
    state, step 0, and a dropout generator on `device` seeded with seed + 1."""
    seed = cfg.train.seed if seed is None else seed
    device = torch.device(device)
    model = video_model_from_run(cfg, run, torch.Generator().manual_seed(seed)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    opt_state = Optimizer(cfg.train).init(dict(model.named_parameters()))
    return TrainState(model=model, opt_state=opt_state, step=0, generator=gen)


def video_train_step(state: TrainState, opt: Optimizer, shared, vi: VideoInputs) -> dict:
    """One optimizer step on a device batch (dropout on); moves state in place.
    Returns {"loss", "acc"} as device scalars."""
    loss, m = video_loss(state.model, shared, vi, True, state.generator)
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    opt.update(params, {n: torch.zeros_like(p) if g is None else g
                        for (n, p), g in zip(params.items(), grads)}, state.opt_state)
    state.step += 1
    return {"loss": loss.detach(), "acc": m["acc"].detach()}


def make_video_eval_step(model: VideoFVTAModel):
    """(shared, device batch) → the batch's sums {correct, sq_err, count, ...}."""
    @torch.no_grad()
    def eval_step(shared, vi: VideoInputs) -> dict:
        return video_metrics(model.task, model(shared, vi).logits, vi)
    return eval_step


def evaluate_video(eval_step, shared, dataset: VideoDataset, batch_size: int,
                   task: str) -> dict:
    """Full-split eval → {"acc", "count", "score"[, "mse"]}; "score" is the
    keep-best key (acc, or -mse for count). One host sync at the end."""
    device = shared.word_emb.device
    totals = None
    for vi in dataset.get_batches(batch_size):
        m = eval_step(shared, vi.to(device))
        totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
    totals = ({k: float(v) for k, v in totals.items()} if totals is not None
              else {"correct": 0.0, "sq_err": 0.0, "count": 0.0})
    n = max(totals["count"], 1.0)
    out = {"acc": totals["correct"] / n, "count": int(totals["count"])}
    if task == "count":
        out["mse"] = totals["sq_err"] / n
        out["score"] = -out["mse"]
    else:
        out["score"] = out["acc"]
    return out


def train_video(cfg: Config, pack_dir: str, out_dir: str, num_steps: int,
                encoder: str = "dilated_conv", cp: int = 1, metrics_path: str | None = None,
                echo: bool = True, prefetch: int = 0, device="cuda") -> dict:
    """Train over a video-prepro pack; resumes from out_dir's latest checkpoint.
    Returns {"best_val_score", "steps", "state", "model", "shared", "task"}
    ("best_val_score" covers this segment of a resumed run)."""
    if cp > 1:
        raise NotImplementedError(CP_NOT_PORTED)
    dev = resolve_device(device)
    with deterministic_algorithms(dev), exact_float32(), torch.autograd.set_detect_anomaly(
            debug_nans_enabled()):
        return _train_video(cfg, pack_dir, out_dir, num_steps, encoder, metrics_path, echo,
                            prefetch, dev)


def _train_video(cfg, pack_dir, out_dir, num_steps, encoder, metrics_path, echo, prefetch,
                 dev) -> dict:
    dcfg, meta, shared_np = load_video_meta(pack_dir)
    cfg = cfg.replace(data=dcfg)
    run = run_record(meta, encoder, pack_dir)
    task = run["task"]
    shared = video_shared_tables(dcfg, shared_np, dev)
    train_ds = VideoDataset(pack_dir, "train")
    if train_ds.n == 0:
        raise ValueError("the pack's train split is empty (check --test-ids / --val-fraction)")
    try:
        val_ds = VideoDataset(pack_dir, "val")
        val_ds = val_ds if val_ds.n else None
    except FileNotFoundError:
        val_ds = None

    t = cfg.train
    state = init_video_state(cfg, run, dev)
    opt = Optimizer(t)
    ckpt = CheckpointManager(out_dir, cfg, max_to_keep=t.keep_checkpoints)
    with open(os.path.join(out_dir, VIDEO_RUN), "w") as f:
        json.dump(run, f)
    nb = max(train_ds.num_batches(t.batch_size), 1)
    start_epoch = skip_batches = 0
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        start_epoch, skip_batches = divmod(state.step, nb)

    model = state.model
    eval_step = make_video_eval_step(model)
    log = MetricsLogger(metrics_path, echo=echo)
    timer = Timer()
    best_val = float("-inf")
    window_steps = 0

    def validate(step: int) -> None:
        nonlocal best_val
        vm = evaluate_video(eval_step, shared, val_ds, t.eval_batch_size, task)
        log.log("val", step=step, **{k: v for k, v in vm.items() if k != "score"})
        best_val = max(best_val, vm["score"])
        ckpt.save(step, state, val_acc=vm["score"])

    try:
        epoch = start_epoch
        while state.step < num_steps:
            batch_it = train_ds.get_batches(t.batch_size, shuffle=True, seed=t.seed,
                                            epoch=epoch)
            if epoch == start_epoch and skip_batches:
                batch_it = itertools.islice(batch_it, skip_batches, None)
            if prefetch > 0:
                batch_it = Prefetcher(batch_it, depth=prefetch, transfer=lambda v: v.to(dev))
            try:
                for vi in batch_it:
                    vi = vi.to(dev)
                    if not timer.samples and not timer.running:
                        timer.start()
                    m = video_train_step(state, opt, shared, vi)
                    window_steps += 1
                    step = state.step
                    if step % t.log_period == 0:
                        loss = float(m["loss"])
                        check_finite_loss(loss, step)
                        timer.stop()
                        window = timer.samples[-1]
                        n_steps = max(window_steps, 1)
                        log.log("train", step=step, epoch=epoch, loss=loss, acc=float(m["acc"]),
                                qa_pairs_per_sec=t.batch_size * n_steps / max(window, 1e-9),
                                p50_step_ms=window / n_steps * 1e3)
                        timer.reset()
                        window_steps = 0
                    if val_ds is not None and step % t.val_period == 0:
                        validate(step)
                        timer.reset()
                        window_steps = 0
                    elif step % t.save_period == 0:
                        ckpt.save(step, state)
                    if step >= num_steps:
                        break
            finally:
                if prefetch > 0:
                    batch_it.close()
            epoch += 1

        if val_ds is not None:
            validate(state.step)
        else:
            ckpt.save(state.step, state)
        best = video_model_from_run(cfg, run)
        best.load_state_dict(ckpt.load(best=True)["params"])
        save_video_rundir(out_dir, cfg, best, run)
    finally:
        log.close()
    return {"best_val_score": best_val, "steps": state.step, "state": state, "model": model,
            "shared": shared, "task": task}


@torch.no_grad()
def dump_video_attention(model: VideoFVTAModel, shared, dataset: VideoDataset,
                         batch_size: int, path: str) -> int:
    """Per-question frame-attention maps and predictions → .npz in the schema of
    the JAX package's dump (qid/pred/label/probs/time_attn/seq_attn, and
    seq_names=["frames"]). For count, pred is the rounded, clipped count and
    probs the raw prediction. Returns the number of questions written."""
    device = shared.word_emb.device
    rows = {k: [] for k in ("qid", "pred", "label", "probs", "time_attn", "seq_attn")}
    qids = dataset.qids
    seen = 0
    for vi in dataset.get_batches(batch_size):
        vi = vi.to(device)
        out = model(shared, vi)
        if model.task == "count":
            pred = torch.clamp(torch.round(out.logits[:, 0]), COUNT_MIN, COUNT_MAX).int()
            probs = out.logits
        else:
            pred = torch.argmax(out.logits, -1)
            probs = torch.softmax(out.logits, -1)
        keep = vi.ex_mask.cpu().numpy()
        n = int(keep.sum())
        rows["qid"].append(qids[seen: seen + n])
        for k, v in (("pred", pred), ("label", vi.label), ("probs", probs),
                     ("time_attn", out.attention.time_attn),
                     ("seq_attn", out.attention.seq_attn)):
            rows[k].append(v.cpu().numpy()[keep])
        seen += n
    out = {k: np.concatenate(v) for k, v in rows.items()}
    out["seq_names"] = np.asarray(["frames"], dtype="U16")
    np.savez_compressed(path, **out)
    return seen


def test_video(out_dir: str, pack_dir: str | None = None, split: str = "test",
               load_best: bool = True, batch_size: int | None = None,
               metrics_path: str | None = None, echo: bool = True,
               attention_path: str | None = None, device="cuda") -> dict:
    """Evaluate a video run directory on a pack split: rebuild the model from
    config.json + video_run.json, restore the best-on-val (default) or the
    latest checkpoint. Returns {"acc", "count", "score"[, "mse"]}."""
    dev = resolve_device(device)
    cfg = load_config(os.path.join(out_dir, "config.json"))
    with open(os.path.join(out_dir, VIDEO_RUN)) as f:
        run = json.load(f)
    pack_dir = pack_dir or run["pack_dir"]
    dcfg, _, shared_np = load_video_meta(pack_dir)
    cfg = cfg.replace(data=dcfg)
    model = video_model_from_run(cfg, run)
    model.load_state_dict(CheckpointManager(out_dir).load(best=load_best)["params"])
    model = model.to(dev).eval()
    shared = video_shared_tables(dcfg, shared_np, dev)
    ds = VideoDataset(pack_dir, split)
    bs = batch_size or cfg.train.eval_batch_size
    log = MetricsLogger(metrics_path, echo=echo)
    try:
        with exact_float32():
            timer = Timer()
            timer.start()
            m = evaluate_video(make_video_eval_step(model), shared, ds, bs, run["task"])
            timer.stop()
            log.log("test", split=split, wall_s=timer.samples[0],
                    **{k: v for k, v in m.items() if k != "score"})
            if attention_path:
                n = dump_video_attention(model, shared, ds, bs, attention_path)
                log.log("attention_dump", split=split, path=attention_path, count=n)
    finally:
        log.close()
    return m
