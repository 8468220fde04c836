"""Command line of the port: the paper's three stages `prepro → train → test`,
plus ablate, predict, synth and the video commands.

    python -m fvta_memexqa_torch.cli synth <rawdir> [--num-albums 6 --photos-per-album 4 \
        --num-questions 24 --feat-dim 64 --seed 0]
    python -m fvta_memexqa_torch.cli prepro <qas.json> <album_info.json> <test_question.ids> \
        <glove.txt|none> <photo_feats.npz> <packdir> [--val-fraction 0.1 --val-ids F \
        --seed 0 (DataConfig fields as --flags, e.g. --image-feat-dim 64)]
    python -m fvta_memexqa_torch.cli train <packdir> <rundir> [--num-steps N] \
        [--batch-size 64 --hidden-dim 100 ... (ModelConfig/TrainConfig/MeshConfig
        fields as --flags)] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli test <packdir> <rundir> [--load-latest --split test \
        --no-album-cache --dump-attention PATH --by-category --ensemble RUNDIR[,RUNDIR...]] \
        [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli ablate <packdir> <rundir> [--num-steps N \
        --variants fvta,flat,none --seeds S0[,S1...]] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli predict <packdir> <rundir> \
        --question "what year was the sunrise trip ?" --choices "2007|2009|2011|2013" \
        --album-ids album0 [--device cuda|cpu]

    python -m fvta_memexqa_torch.cli synth-video <rawdir> [--num-videos 48 --num-frames 32 \
        --feat-dim 64 --task mc|count|frameqa]
    python -m fvta_memexqa_torch.cli video-prepro <qas.jsonl> <frame_feats.npz> <packdir> \
        [--test-ids F --max-frames 64 --task mc ...]
    python -m fvta_memexqa_torch.cli video [--data <packdir> [--out <rundir>]] \
        [--encoder dilated_conv|bilstm --steps N --hidden-dim 64 ...] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli video-test <rundir> [--split test --latest \
        --dump-attention PATH] [--device cuda|cpu]

`synth` writes a synthetic raw corpus (data/synthetic.write_raw_files; `--focal`
is not ported yet and raises), `prepro` packs raw files (data/pack.pack) and
prints {"splits", "num_albums", "num_photos", "vocab"}. `test` evaluates a run
directory (train.test: through the album cache unless --no-album-cache) and
prints {"split", "accuracy", "loss", "count"[, "by_category"]}; with --ensemble
(train.test_ensemble) {"split", "accuracy", "count", "members"[, "by_category"]}.
`ablate` trains and tests each attention variant (per seed with --seeds) under
<rundir>/<variant> and prints {variant: {"val_acc", "test_acc", "steps"
[, "per_seed"]}}. These print the JAX CLI's JSON lines with the same keys.
`--shard-cache` and `--data-parallel` > 1 raise NotImplementedError: they
belong to the data-parallel slice.

`train` runs train.train on the pack (metrics to <rundir>/metrics.jsonl,
checkpoints under <rundir>, resuming from the latest one there) and prints
{"best_val_acc", "steps"}; the run directory then serves through `predict`.
`--use-pallas` is read and selects nothing, and `--dedup-albums` keeps the
config default (False) unless given. `predict` answers one question through
the serving engine (serve.build_engine) and prints the result as one JSON
line. The run directory is the port's (config.json + params.pt, see convert.py).

The video commands are the JAX package's: `synth-video` writes a synthetic raw
corpus, `video-prepro` packs one into streaming shards, `video` trains — the
synthetic demo without --data, a plain loop over a pack with --data, and the
full driver (train_video.train_video: keep-best checkpoints, metrics, exact
resume) with --data --out, then evaluates the best state on the test split —
and `video-test` evaluates a video run directory. `--cp N > 1` raises
NotImplementedError: context parallelism is a later slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from fvta_memexqa_torch.config import (Config, DataConfig, MeshConfig, ModelConfig,
                                       TrainConfig)


def _add_dataclass_flags(p: argparse.ArgumentParser, dc_type) -> None:
    for f in dataclasses.fields(dc_type):
        name = f"--{f.name.replace('_', '-')}"
        if f.type in ("int", int):
            p.add_argument(name, type=int, default=None)
        elif f.type in ("float", float):
            p.add_argument(name, type=float, default=None)
        elif f.type in ("bool", bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None)
        else:
            p.add_argument(name, type=str, default=None)


def _dc_from_args(args, dc_type, base):
    updates = {f.name: getattr(args, f.name) for f in dataclasses.fields(dc_type)
               if getattr(args, f.name, None) is not None}
    return dataclasses.replace(base, **updates)


def _model_config(args, base: Config, packed) -> Config:
    return Config(data=packed.cfg, model=_dc_from_args(args, ModelConfig, base.model),
                  train=_dc_from_args(args, TrainConfig, base.train),
                  mesh=_dc_from_args(args, MeshConfig, base.mesh))


def _run_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("packdir")
    p.add_argument("rundir")
    for dc in (ModelConfig, TrainConfig, MeshConfig):
        _add_dataclass_flags(p, dc)
    p.add_argument("--device", default="cuda")
    return p


def cmd_train(argv):
    p = _run_parser("fvta-torch train")
    p.add_argument("--num-steps", type=int, default=None,
                   help="stop after N optimizer steps (overrides epochs)")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.train import train

    packed = load_pack(args.packdir)
    cfg = _model_config(args, Config(), packed)
    os.makedirs(args.rundir, exist_ok=True)
    res = train(cfg, packed, args.rundir, num_steps=args.num_steps,
                metrics_path=os.path.join(args.rundir, "metrics.jsonl"),
                device=args.device)
    print(json.dumps({"best_val_acc": res["best_val_acc"], "steps": res["steps"]}))


def cmd_synth(argv):
    p = argparse.ArgumentParser(prog="fvta-torch synth")
    p.add_argument("outdir")
    p.add_argument("--num-albums", type=int, default=6)
    p.add_argument("--photos-per-album", type=int, default=4)
    p.add_argument("--num-questions", type=int, default=24)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--focal", action="store_true",
                   help="the focality corpus (not ported yet: raises)")
    args = p.parse_args(argv)
    if args.focal:
        raise NotImplementedError("synth --focal (data/synthetic.make_focal_synthetic) is "
                                  "not ported yet")
    from fvta_memexqa_torch.data.synthetic import make_synthetic, write_raw_files

    write_raw_files(args.outdir, *make_synthetic(
        num_albums=args.num_albums, photos_per_album=args.photos_per_album,
        num_questions=args.num_questions, feat_dim=args.feat_dim, seed=args.seed))
    print(json.dumps({"outdir": args.outdir, "questions": args.num_questions,
                      "albums": args.num_albums, "focal": args.focal}))


def _read_ids(path: str) -> set[str]:
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def cmd_prepro(argv):
    p = argparse.ArgumentParser(prog="fvta-torch prepro")
    p.add_argument("qas")
    p.add_argument("album_info")
    p.add_argument("test_ids")
    p.add_argument("glove", help="GloVe txt path, or 'none' to train all embeddings")
    p.add_argument("photo_npz")
    p.add_argument("outdir")
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--val-ids", default=None,
                   help="explicit val question-id file; overrides --val-fraction")
    p.add_argument("--seed", type=int, default=0)
    _add_dataclass_flags(p, DataConfig)
    args = p.parse_args(argv)
    from fvta_memexqa_torch.data import load_glove, pack, parse_album_info, parse_qas

    cfg = _dc_from_args(args, DataConfig, DataConfig())
    qas, qerr = parse_qas(args.qas)
    albums, aerr = parse_album_info(args.album_info)
    for e in (qerr + aerr)[:20]:
        print(f"prepro warning: {e}", file=sys.stderr)
    glove = None if args.glove == "none" else load_glove(args.glove, cfg.word_emb_dim)
    meta = pack(qas, albums, dict(np.load(args.photo_npz)), _read_ids(args.test_ids), glove,
                args.outdir, cfg, val_fraction=args.val_fraction, seed=args.seed,
                val_ids=_read_ids(args.val_ids) if args.val_ids else None)
    print(json.dumps({"splits": meta["split_sizes"], "num_albums": meta["num_albums"],
                      "num_photos": meta["num_photos"],
                      "vocab": meta["data_config"]["word_vocab_size"]}))


def cmd_test(argv):
    p = _run_parser("fvta-torch test")
    p.add_argument("--load-latest", action="store_true",
                   help="use the latest instead of the best-on-val checkpoint")
    p.add_argument("--split", default="test")
    p.add_argument("--no-album-cache", action="store_true",
                   help="re-encode every question's albums (the reference's evaluation)")
    p.add_argument("--shard-cache", action="store_true",
                   help="row-shard the album cache over a mesh (not ported yet: raises)")
    p.add_argument("--dump-attention", default=None, metavar="PATH",
                   help="write per-question attention maps and predictions to PATH (.npz)")
    p.add_argument("--by-category", action="store_true",
                   help="also report accuracy per question category")
    p.add_argument("--ensemble", default=None, metavar="RUNDIR[,RUNDIR...]",
                   help="average choice probabilities with these extra runs")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.config import load_config
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.train import test, test_ensemble

    packed = load_pack(args.packdir)
    cfg = _model_config(args, load_config(os.path.join(args.rundir, "config.json")), packed)
    metrics = os.path.join(args.rundir, "metrics.jsonl")
    if args.ensemble:
        if args.no_album_cache or args.dump_attention:
            print("test --ensemble always evaluates through the album cache and has no "
                  "attention dump; ignoring --no-album-cache/--dump-attention",
                  file=sys.stderr)
        dirs = [args.rundir] + [d for d in args.ensemble.split(",") if d]
        m = test_ensemble(cfg, packed, dirs, load_best=not args.load_latest, split=args.split,
                          metrics_path=metrics, by_category=args.by_category,
                          shard_cache=args.shard_cache, device=args.device)
        out = {"split": args.split, "accuracy": m["acc"], "count": m["count"],
               "members": m["members"]}
    else:
        m = test(cfg, packed, args.rundir, load_best=not args.load_latest, split=args.split,
                 metrics_path=metrics, album_cache=not args.no_album_cache,
                 attention_path=args.dump_attention, by_category=args.by_category,
                 shard_cache=args.shard_cache, device=args.device)
        out = {"split": args.split, "accuracy": m["acc"], "loss": m["loss"],
               "count": m["count"]}
    if args.by_category:
        out["by_category"] = m["by_category"]
    print(json.dumps(out))


def cmd_ablate(argv):
    """FVTA vs flat soft attention vs no attention, each trained and tested."""
    p = _run_parser("fvta-torch ablate")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--variants", default="fvta,flat,none")
    p.add_argument("--seeds", default=None, metavar="S0[,S1...]",
                   help="train each variant at every seed and report per-seed accuracies "
                        "and the mean; default: the configured seed")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.train import test as run_test, train as run_train

    packed = load_pack(args.packdir)
    base = _model_config(args, Config(), packed)
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [base.train.seed]
    results = {}
    for variant in args.variants.split(","):
        per_seed = {}
        for seed in seeds:
            cfg = base.replace(model=dataclasses.replace(base.model, attention=variant),
                               train=dataclasses.replace(base.train, seed=seed))
            # one seed keeps the layout <rundir>/<variant>
            rundir = os.path.join(args.rundir, variant if len(seeds) == 1
                                  else f"{variant}_s{seed}")
            os.makedirs(rundir, exist_ok=True)
            res = run_train(cfg, packed, rundir, num_steps=args.num_steps,
                            metrics_path=os.path.join(rundir, "metrics.jsonl"), echo=False,
                            device=args.device)
            m = run_test(cfg, packed, rundir, load_best=True, echo=False, device=args.device)
            per_seed[str(seed)] = {"val_acc": res["best_val_acc"], "test_acc": m["acc"],
                                   "steps": res["steps"]}
            print(f"[ablate] {variant} seed={seed}: val={res['best_val_acc']:.4f} "
                  f"test={m['acc']:.4f}", file=sys.stderr)
        n = len(per_seed)
        results[variant] = {"val_acc": sum(v["val_acc"] for v in per_seed.values()) / n,
                            "test_acc": sum(v["test_acc"] for v in per_seed.values()) / n,
                            "steps": per_seed[str(seeds[0])]["steps"]}
        if n > 1:
            results[variant]["per_seed"] = per_seed
    print(json.dumps(results))


def cmd_predict(argv):
    p = argparse.ArgumentParser(prog="fvta-torch predict")
    p.add_argument("packdir")
    p.add_argument("rundir")
    p.add_argument("--question", required=True)
    p.add_argument("--choices", required=True,
                   help="the 4 candidate answers, separated by '|'")
    p.add_argument("--album-ids", default="",
                   help="comma-separated raw album ids (as in album_info.json)")
    p.add_argument("--raw-albums", default=None,
                   help="album_info.json to ingest from (with --raw-photo-npz)")
    p.add_argument("--raw-photo-npz", default=None)
    p.add_argument("--load-latest", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.serve import build_engine

    # preingest=False: a one-shot predict only needs the referenced albums,
    # which the store encodes from their pack rows on first use
    engine, store, _ = build_engine(args.packdir, args.rundir, device=args.device,
                                    load_best=not args.load_latest, batch_size=1,
                                    preingest=False)
    try:
        album_ids = [a for a in args.album_ids.split(",") if a]
        if args.raw_albums and args.raw_photo_npz:
            from fvta_memexqa_torch.data.schema import parse_album_info

            albums, _ = parse_album_info(args.raw_albums)
            feats = dict(np.load(args.raw_photo_npz))
            for aid in album_ids:
                if aid in albums:
                    store.ingest(albums[aid], feats)
        res = engine.ask(args.question, args.choices.split("|"), album_ids)
        print(json.dumps(res))
    finally:
        engine.close()


def cmd_synth_video(argv):
    p = argparse.ArgumentParser(prog="fvta-torch synth-video")
    p.add_argument("outdir")
    p.add_argument("--num-videos", type=int, default=48)
    p.add_argument("--num-frames", type=int, default=32)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--num-choices", type=int, default=5)
    p.add_argument("--task", default="mc", choices=["mc", "count", "frameqa"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from fvta_memexqa_torch.data.video_pack import (make_synthetic_video_raw,
                                                    write_raw_video_files)

    qas, feats, test_ids = make_synthetic_video_raw(
        num_videos=args.num_videos, num_frames=args.num_frames, feat_dim=args.feat_dim,
        num_choices=args.num_choices, seed=args.seed, task=args.task)
    write_raw_video_files(args.outdir, qas, feats, test_ids)
    print(json.dumps({"outdir": args.outdir, "videos": args.num_videos,
                      "task": args.task, "test": len(test_ids)}))


def cmd_video_prepro(argv):
    p = argparse.ArgumentParser(prog="fvta-torch video-prepro")
    p.add_argument("qas", help="qas.jsonl (schema: data/video_pack.py)")
    p.add_argument("frame_npz", help="frame_feats.npz: video_id -> [T, F]")
    p.add_argument("outdir")
    p.add_argument("--test-ids", default=None)
    p.add_argument("--glove", default=None)
    p.add_argument("--num-choices", type=int, default=5)
    p.add_argument("--task", default="mc", choices=["mc", "count", "frameqa"])
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--shard-size", type=int, default=256)
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    _add_dataclass_flags(p, DataConfig)
    args = p.parse_args(argv)
    from fvta_memexqa_torch.data.video_pack import pack_video, parse_video_qas
    from fvta_memexqa_torch.data.vocab import load_glove

    cfg = _dc_from_args(args, DataConfig, DataConfig())
    qas, errs = parse_video_qas(args.qas, task=args.task)
    for e in errs[:20]:
        print(f"video-prepro warning: {e}", file=sys.stderr)
    test_ids = set()
    if args.test_ids:
        with open(args.test_ids) as f:
            test_ids = {line.strip() for line in f if line.strip()}
    glove = load_glove(args.glove, cfg.word_emb_dim) if args.glove else None
    meta = pack_video(qas, dict(np.load(args.frame_npz)), test_ids, glove, args.outdir, cfg,
                      num_choices=args.num_choices, max_frames=args.max_frames,
                      shard_size=args.shard_size, val_fraction=args.val_fraction,
                      seed=args.seed, task=args.task)
    print(json.dumps({"splits": meta["split_sizes"], "dropped": meta["dropped"],
                      "task": meta["task"], "answer_vocab_size": len(meta["answer_vocab"]),
                      "vocab": meta["data_config"]["word_vocab_size"],
                      "max_frames": meta["max_frames"]}))


def cmd_video(argv):
    p = argparse.ArgumentParser(prog="fvta-torch video")
    p.add_argument("--data", default=None,
                   help="packed video dir (video-prepro output); omit for the synthetic demo")
    p.add_argument("--out", default=None,
                   help="run dir (needs --data): the full driver, then the test split")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-videos", type=int, default=96)
    p.add_argument("--num-frames", type=int, default=64)
    p.add_argument("--num-choices", type=int, default=5)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--encoder", default="dilated_conv", choices=["dilated_conv", "bilstm"])
    p.add_argument("--task", default="mc", choices=["mc", "count", "frameqa"],
                   help="task head of the synthetic demo (packs carry their own)")
    p.add_argument("--attention", default="fvta", choices=["fvta", "flat", "none"])
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel degree (only 1: CP is not ported yet)")
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--decay-steps", type=int, default=0)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--val-period", type=int, default=50)
    p.add_argument("--log-period", type=int, default=50)
    p.add_argument("--save-period", type=int, default=200)
    p.add_argument("--prefetch", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.cp > 1:
        from fvta_memexqa_torch.train_video import CP_NOT_PORTED

        raise NotImplementedError(CP_NOT_PORTED)
    if args.out and not args.data:
        raise SystemExit("--out needs --data (the synthetic demo world is in-memory; "
                         "nothing to resume)")
    if args.out:
        return _video_driver(args)
    return _video_plain(args)


def _video_driver(args):
    """--data --out: train_video.train_video, then the best state on the test split."""
    from fvta_memexqa_torch.train_video import test_video, train_video

    cfg = Config(
        model=ModelConfig(hidden_dim=args.hidden_dim, char_emb_dim=8, char_cnn_filters=16,
                          keep_prob=1.0, vocab_embed=True, attention=args.attention),
        train=TrainConfig(batch_size=args.batch_size, eval_batch_size=args.batch_size,
                          learning_rate=args.lr, seed=args.seed,
                          lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
                          decay_steps=args.decay_steps, grad_accum=args.grad_accum,
                          val_period=args.val_period, log_period=args.log_period,
                          save_period=args.save_period))
    os.makedirs(args.out, exist_ok=True)
    r = train_video(cfg, args.data, args.out, num_steps=args.steps, encoder=args.encoder,
                    prefetch=args.prefetch, device=args.device,
                    metrics_path=os.path.join(args.out, "metrics.jsonl"))
    m = test_video(args.out, split="test", load_best=True, batch_size=args.batch_size,
                   echo=False, device=args.device)
    out = {"encoder": args.encoder, "task": r["task"], "data": args.data, "out": args.out,
           "steps": r["steps"], "best_val_score": r["best_val_score"],
           "heldout_acc": m["acc"], "test_count": m["count"]}
    if r["task"] == "count":
        out["heldout_mse"] = m["mse"]
    print(json.dumps(out))


def _video_plain(args):
    """The synthetic demo (no --data) or a plain loop over a pack (--data): Adam
    at --lr without dropout or clipping, then the held-out split."""
    import torch

    from fvta_memexqa_torch.data.video_pack import (VideoDataset, load_video_meta,
                                                    video_shared_tables)
    from fvta_memexqa_torch.models.video import (VideoFVTAModel, make_synthetic_video,
                                                 video_loss, video_metrics)
    from fvta_memexqa_torch.optim import Optimizer
    from fvta_memexqa_torch.serve import resolve_device
    from fvta_memexqa_torch.train_video import exact_float32

    dev = resolve_device(args.device)
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
    opt = Optimizer(TrainConfig(learning_rate=args.lr, grad_clip_norm=0.0))
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    done, epoch, loss, acc = 0, 0, 0.0, 0.0
    with exact_float32():
        while done < args.steps:
            for vi in train_batches(epoch):
                loss_t, m = video_loss(model, shared, vi.to(dev), False)
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
                s = video_metrics(task, model(shared, vi).logits, vi)
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
    print(json.dumps(out))


def cmd_video_test(argv):
    p = argparse.ArgumentParser(prog="fvta-torch video-test")
    p.add_argument("out", help="run dir written by `video --data ... --out`")
    p.add_argument("--data", default=None, help="pack dir (default: the run's)")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--latest", action="store_true",
                   help="restore the latest checkpoint instead of best-on-val")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dump-attention", default=None, metavar="PATH",
                   help="also write per-question frame-attention maps to PATH (.npz)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.train_video import test_video

    m = test_video(args.out, pack_dir=args.data, split=args.split, load_best=not args.latest,
                   batch_size=args.batch_size, echo=False, attention_path=args.dump_attention,
                   device=args.device)
    print(json.dumps({"split": args.split, **{k: v for k, v in m.items() if k != "score"}}))


COMMANDS = {"synth": cmd_synth, "prepro": cmd_prepro, "train": cmd_train, "test": cmd_test,
            "ablate": cmd_ablate, "predict": cmd_predict, "synth-video": cmd_synth_video,
            "video-prepro": cmd_video_prepro, "video": cmd_video, "video-test": cmd_video_test}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m fvta_memexqa_torch.cli {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
