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
num_choices, num_answers, max_frames, cp, pack_dir), ckpts/, best/ and, at the
end, params.pt (best on val, else latest); `test_video` rebuilds the model
from those alone.

Context parallelism (cp > 1): one process per rank over the frame axis, the
ranks launched like train.train's (parallel/mesh.py). Every rank runs the
whole model on the whole batch but the attention, which takes the rank's
time shard (parallel/cp.make_cp_attention: K4 on the shard, K5 + K6 in the
backward, a rank-order combine); the parameters' gradients come out the same
on every rank, so the ranks step alike with no further reduction. Rank 0
writes the checkpoints, the metrics and the run directory.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import (Config, DataConfig, MeshConfig, ModelConfig,
                                       TrainConfig, load_config)
from fvta_memexqa_torch.convert import VIDEO_RUN, save_video_rundir, video_model_from_run
from fvta_memexqa_torch.data.stream import Prefetcher
from fvta_memexqa_torch.data.video_pack import (VideoDataset, load_video_meta,
                                                video_shared_tables)
from fvta_memexqa_torch.models.video import (COUNT_MAX, COUNT_MIN, VideoFVTAModel,
                                             VideoInputs, make_synthetic_video, video_loss,
                                             video_metrics)
from fvta_memexqa_torch.optim import Optimizer
from fvta_memexqa_torch.parallel import mesh
from fvta_memexqa_torch.parallel.cp import make_cp_attention
from fvta_memexqa_torch.serve import resolve_device
from fvta_memexqa_torch.train import (TrainState, check_finite_loss, debug_nans_enabled,
                                      deterministic_algorithms, rank_checkpoints)
from fvta_memexqa_torch.utils.metrics import MetricsLogger, Timer, span


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


def video_train_step(state: TrainState, opt: Optimizer, shared, vi: VideoInputs,
                     cp_attention=None) -> dict:
    """One optimizer step on a device batch (dropout on); moves state in place.
    Returns {"loss", "acc"} as device scalars. The span fvta.video.step covers
    the whole step (the frame encode inside it is fvta.video.frames); counts
    its steps in `video_train_step.steps`."""
    with span("fvta.video.step"):
        loss, m = video_loss(state.model, shared, vi, True, state.generator, cp_attention)
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        opt.update(params, {n: torch.zeros_like(p) if g is None else g
                            for (n, p), g in zip(params.items(), grads)}, state.opt_state)
        state.step += 1
        _VIDEO_STEP.steps += 1
        return {"loss": loss.detach(), "acc": m["acc"].detach()}


_VIDEO_STEP = video_train_step   # the counter stays on the function a test may wrap
video_train_step.steps = 0


def make_video_eval_step(model: VideoFVTAModel, cp_attention=None):
    """(shared, device batch) → the batch's sums {correct, sq_err, count, ...}."""
    @torch.no_grad()
    def eval_step(shared, vi: VideoInputs) -> dict:
        return video_metrics(model.task, model(shared, vi, cp_attention=cp_attention).logits,
                             vi)
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


def _cp_mesh(kw) -> MeshConfig:
    """mesh_of for mesh.launches_ranks: cp ranks over the frame axis, which
    the pack's max_frames must divide."""
    cp = kw["cp"]
    if cp > 1:
        max_frames = load_video_meta(kw["pack_dir"])[1]["max_frames"]
        if max_frames % cp:
            raise ValueError(f"cp={cp} requires max_frames ({max_frames}) to be "
                             "divisible by it")
    return MeshConfig(context_parallel=cp)


@mesh.launches_ranks(_cp_mesh)
def train_video(cfg: Config, pack_dir: str, out_dir: str, num_steps: int,
                encoder: str = "dilated_conv", cp: int = 1, metrics_path: str | None = None,
                echo: bool = True, prefetch: int = 0, device="cuda",
                devices: list | None = None) -> dict:
    """Train over a video-prepro pack; resumes from out_dir's latest checkpoint.
    cp > 1: context parallelism over cp ranks (the module docstring; the
    pack's max_frames must divide by cp), launched here outside a process
    group (mesh.launches_ranks over make_mesh(MeshConfig(1, cp), devices,
    device)), rank 0's result returned with its tensors on the CPU.
    Returns {"best_val_score", "steps", "state", "model", "shared", "task"}
    ("best_val_score" covers this segment of a resumed run)."""
    rank = mesh.current_rank(MeshConfig(context_parallel=cp), devices, device)
    dev = resolve_device(rank.device if rank else device)
    with deterministic_algorithms(dev), exact_float32(), torch.autograd.set_detect_anomaly(
            debug_nans_enabled()):
        return _train_video(cfg, pack_dir, out_dir, num_steps, encoder, metrics_path, echo,
                            prefetch, dev, cp, rank)


def _train_video(cfg, pack_dir, out_dir, num_steps, encoder, metrics_path, echo, prefetch,
                 dev, cp=1, rank=None) -> dict:
    first = rank is None or rank.is_first
    cp_attn = make_cp_attention(cfg.model.similarity) if rank is not None else None
    dcfg, meta, shared_np = load_video_meta(pack_dir)
    cfg = cfg.replace(data=dcfg)
    run = {**run_record(meta, encoder, pack_dir), "cp": cp}
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
    if first:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, VIDEO_RUN), "w") as f:
            json.dump(run, f)
    ckpt = rank_checkpoints(out_dir, cfg, t.keep_checkpoints, first)
    nb = max(train_ds.num_batches(t.batch_size), 1)
    start_epoch = skip_batches = 0
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        start_epoch, skip_batches = divmod(state.step, nb)

    model = state.model
    eval_step = make_video_eval_step(model, cp_attn)
    log = MetricsLogger(metrics_path if first else None, echo=echo and first)
    timer = Timer()
    best_val = float("-inf")
    window_steps = 0

    def save(step: int, score: float | None = None) -> None:
        if first:
            ckpt.save(step, state, val_acc=score)
        mesh.barrier()

    def validate(step: int) -> None:
        nonlocal best_val
        vm = evaluate_video(eval_step, shared, val_ds, t.eval_batch_size, task)
        log.log("val", step=step, **{k: v for k, v in vm.items() if k != "score"})
        best_val = max(best_val, vm["score"])
        save(step, vm["score"])

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
                    m = video_train_step(state, opt, shared, vi, cp_attn)
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
                        save(step)
                    if step >= num_steps:
                        break
            finally:
                if prefetch > 0:
                    batch_it.close()
            epoch += 1

        if val_ds is not None:
            validate(state.step)
        else:
            save(state.step)
        if first:
            best = video_model_from_run(cfg, run)
            best.load_state_dict(ckpt.load(best=True)["params"])
            save_video_rundir(out_dir, cfg, best, run)
        mesh.barrier()
    finally:
        log.close()
    return {"best_val_score": best_val, "steps": state.step, "state": state, "model": model,
            "shared": shared, "task": task}


@torch.no_grad()
def dump_video_attention(model: VideoFVTAModel, shared, dataset: VideoDataset,
                         batch_size: int, path: str, cp_attention=None) -> int:
    """Per-question frame-attention maps and predictions → .npz in the schema of
    the JAX package's dump (qid/pred/label/probs/time_attn/seq_attn, and
    seq_names=["frames"]). For count, pred is the rounded, clipped count and
    probs the raw prediction. Returns the number of questions written.
    cp_attention: the attention of a context-parallel rank; each rank's
    time_attn shard is all-gathered along the frame axis, and every rank
    writes the same file contents (call with a per-rank `path`, or only
    rank 0's file matters)."""
    device = shared.word_emb.device
    rows = {k: [] for k in ("qid", "pred", "label", "probs", "time_attn", "seq_attn")}
    qids = dataset.qids
    seen = 0
    for vi in dataset.get_batches(batch_size):
        vi = vi.to(device)
        out = model(shared, vi, cp_attention=cp_attention)
        time_attn = out.attention.time_attn
        if cp_attention is not None:
            time_attn = torch.cat(mesh.all_gather(time_attn), dim=2)
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
                     ("time_attn", time_attn),
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


def _plain_cp_mesh(kw) -> MeshConfig:
    return MeshConfig(context_parallel=kw["args"].cp)


@mesh.launches_ranks(_plain_cp_mesh)
def video_plain_run(args, device="cuda", devices: list | None = None):
    """`cli video`'s synthetic demo and plain loop over a pack (args: its
    parsed flags) → its JSON record (2 for an empty train split). args.cp > 1:
    the attention context-parallel over args.cp ranks, launched as
    train_video's; rank 0's record returned."""
    rank = mesh.current_rank(MeshConfig(context_parallel=args.cp), devices, device)
    dev = resolve_device(rank.device if rank else device)
    model_cfg = dict(hidden_dim=args.hidden_dim, char_emb_dim=8, char_cnn_filters=16,
                     keep_prob=1.0, vocab_embed=True, attention=args.attention)
    if args.data:
        dcfg, meta, shared_np = load_video_meta(args.data)
        task, num_choices = meta.get("task", "mc"), meta["num_choices"]
        num_answers = len(meta.get("answer_vocab", []))
        shared = video_shared_tables(dcfg, shared_np, dev)
        train_ds, test_ds = VideoDataset(args.data, "train"), VideoDataset(args.data, "test")
        if train_ds.n == 0:
            print("error: the pack's train split is empty (check --test-ids / "
                  "--val-fraction)", file=sys.stderr)
            return 2

        def train_batches(epoch):
            return train_ds.get_batches(args.batch_size, shuffle=True, seed=args.seed,
                                        epoch=epoch)
        test_batches = lambda: test_ds.get_batches(args.batch_size)
    else:
        dcfg = DataConfig(max_question_len=8, max_answer_len=3, max_word_len=6,
                          image_feat_dim=2537, word_emb_dim=50, word_vocab_size=64,
                          char_vocab_size=16, num_glove_words=0)
        model_cfg.update(char_emb_dim=4, char_cnn_filters=8, vocab_embed=False)
        task, num_choices = args.task, args.num_choices
        num_answers = 8 if task == "frameqa" else 0
        synth = lambda n, seed: make_synthetic_video(Config(data=dcfg), num_videos=n,
                                                     num_frames=args.num_frames,
                                                     num_choices=num_choices, seed=seed,
                                                     task=task)[0]
        vi_train, vi_test = synth(args.num_videos, args.seed), synth(
            max(args.num_videos // 4, 8), args.seed + 1)
        rng = np.random.default_rng(args.seed)
        emb = rng.normal(0, 0.3, (dcfg.word_vocab_size, dcfg.word_emb_dim)).astype(np.float32)
        shared = video_shared_tables(
            dcfg, {"word_emb_init": emb,
                   "vocab_chars": np.zeros((dcfg.word_vocab_size, dcfg.max_word_len),
                                           np.int32)}, dev)
        train_batches = lambda epoch: [vi_train]
        test_batches = lambda: [vi_test]
    cfg = Config(data=dcfg, model=ModelConfig(**model_cfg))
    model = VideoFVTAModel(cfg, num_choices=num_choices, temporal_encoder=args.encoder,
                           task=task, num_answers=num_answers,
                           generator=torch.Generator().manual_seed(args.seed)).to(dev)
    cp_attn = make_cp_attention(cfg.model.similarity) if rank else None
    opt = Optimizer(TrainConfig(learning_rate=args.lr, grad_clip_norm=0.0))
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    done, epoch, loss, acc = 0, 0, 0.0, 0.0
    with exact_float32():
        while done < args.steps:
            for vi in train_batches(epoch):
                loss_t, m = video_loss(model, shared, vi.to(dev), False,
                                       cp_attention=cp_attn)
                grads = torch.autograd.grad(loss_t, list(params.values()), allow_unused=True)
                opt.update(params, {n: torch.zeros_like(p) if g is None else g
                                    for (n, p), g in zip(params.items(), grads)}, opt_state)
                done += 1
                if done % 50 == 0:
                    loss, acc = float(loss_t.detach()), float(m["acc"].detach())
                    print(f"[video] step={done} loss={loss:.4f} train_acc={acc:.4f}",
                          file=sys.stderr)
                if done >= args.steps:
                    break
            epoch += 1
        loss, acc = float(loss_t.detach()), float(m["acc"].detach())
        totals = {"correct": 0.0, "sq_err": 0.0, "count": 0.0}
        with torch.no_grad():
            for vi in test_batches():
                vi = vi.to(dev)
                s = video_metrics(task, model(shared, vi, cp_attention=cp_attn).logits, vi)
                totals = {k: totals[k] + float(s[k]) for k in totals}
    n = max(totals["count"], 1.0)
    # the JAX CLI's keys: a pack's run reports its data, steps and test count,
    # the synthetic demo its frame count and the --cp it was given
    out = {"encoder": args.encoder, "task": task}
    if args.data:
        out.update(data=args.data, steps=done, train_acc=acc,
                   heldout_acc=totals["correct"] / n, test_count=int(totals["count"]))
    else:
        out.update(num_frames=args.num_frames, train_acc=acc,
                   heldout_acc=totals["correct"] / n, cp=args.cp)
    if task == "count":
        out["heldout_mse"] = totals["sq_err"] / n
    elif task == "frameqa" and args.data:
        out["answer_vocab_size"] = num_answers
    elif task == "frameqa":
        out["chance"] = 1.0 / max(num_answers, 1)
    else:
        out["chance"] = 1.0 / num_choices
    return out
