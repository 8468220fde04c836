"""Command line of the port: the paper's three stages `prepro → train → test`,
plus ablate, predict, serve, synth, the two reports, the TF checkpoint import
and export, and the video commands.

    python -m fvta_memexqa_torch.cli synth <rawdir> [--num-albums 6 --photos-per-album 4 \
        --num-questions 24 --feat-dim 64 --seed 0 --focal]
    python -m fvta_memexqa_torch.cli prepro <qas.json> <album_info.json> <test_question.ids> \
        <glove.txt|none> <photo_feats.npz> <packdir> [--val-fraction 0.1 --val-ids F \
        --seed 0 (DataConfig fields as --flags, e.g. --image-feat-dim 64)]
    python -m fvta_memexqa_torch.cli train <packdir> <rundir> [--num-steps N --profile \
        --stream-shard-size N --prefetch N] [--batch-size 64 --hidden-dim 100 ...
        --data-parallel N (ModelConfig/TrainConfig/MeshConfig fields as --flags)] \
        [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli test <packdir> <rundir> [--load-latest --split test \
        --no-album-cache --dump-attention PATH --by-category --ensemble RUNDIR[,RUNDIR...] \
        --data-parallel N --shard-cache] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli ablate <packdir> <rundir> [--num-steps N \
        --variants fvta,flat,none --seeds S0[,S1...]] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli predict <packdir> <rundir> \
        --question "what year was the sunrise trip ?" --choices "2007|2009|2011|2013" \
        --album-ids album0 [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli serve <packdir> <rundir> [--port 8777 --batch-size 8 \
        --max-cache-mb N --cache-dir DIR --cache-dtype float32|bfloat16|int8 \
        --max-pending N --auth-token T1[,T2...] --max-rps R --max-rps-per-client R \
        --tls-cert PEM --tls-key PEM --raw-albums album_info.json --raw-photo-npz F \
        --no-preingest --load-latest] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli import-tf-checkpoint <ckpt> <packdir> <rundir> \
        [--map F --dump-map F --list --tf-prefix model (ModelConfig/TrainConfig/MeshConfig \
        fields as --flags)] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli export-tf-checkpoint <packdir> <rundir> <out_prefix> \
        [--load-latest --tf-prefix model --map F]
    python -m fvta_memexqa_torch.cli report <rundir> [--json]
    python -m fvta_memexqa_torch.cli attention-report <attention.npz> [--qid Q --top 3 \
        --limit 10 --json --wrong-only]

    python -m fvta_memexqa_torch.cli synth-video <rawdir> [--num-videos 48 --num-frames 32 \
        --feat-dim 64 --task mc|count|frameqa]
    python -m fvta_memexqa_torch.cli video-prepro <qas.jsonl> <frame_feats.npz> <packdir> \
        [--test-ids F --max-frames 64 --task mc ...]
    python -m fvta_memexqa_torch.cli video [--data <packdir> [--out <rundir>]] \
        [--encoder dilated_conv|bilstm --steps N --hidden-dim 64 ...] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli video-test <rundir> [--split test --latest \
        --dump-attention PATH] [--device cuda|cpu]

`synth` writes a synthetic raw corpus (data/synthetic.write_raw_files; `--focal`
the focality corpus of make_focal_synthetic, with its album-holdout
val_question.ids for `prepro --val-ids`), `prepro` packs raw files (data/pack.pack) and
prints {"splits", "num_albums", "num_photos", "vocab"}. `test` evaluates a run
directory (train.test: through the album cache unless --no-album-cache) and
prints {"split", "accuracy", "loss", "count"[, "by_category"]}; with --ensemble
(train.test_ensemble) {"split", "accuracy", "count", "members"[, "by_category"]}.
`ablate` trains and tests each attention variant (per seed with --seeds) under
<rundir>/<variant> and prints {variant: {"val_acc", "test_acc", "steps"
[, "per_seed"]}}. These print the JAX CLI's JSON lines with the same keys.
`--data-parallel N` (train, test, ablate) runs N data-parallel ranks, one
process each (parallel/mesh.py): one per card by default, CPU processes with
`--device cpu`; under torchrun each process is one rank of the group
(`main` joins it) and rank 0 prints. `test --shard-cache` row-shards the
album cache over those ranks. `--context-parallel` ranks are replicas here,
as in the JAX package (its MemexQA batch shards over "data" only).

`train` runs train.train on the pack (metrics to <rundir>/metrics.jsonl,
checkpoints under <rundir>, resuming from the latest one there) and prints
{"best_val_acc", "steps"}; the run directory then serves through `predict`.
`--stream-shard-size N` streams the train and val splits from shard files of N
rows written into the pack directory (data/stream.ensure_split_shards; reused
while the split files are unchanged), `--prefetch N` prepares batches N ahead
in a background thread, and `--profile` writes a torch.profiler chrome trace
of steps 11-15 into <rundir>/profile.
`--use-pallas` is read and selects nothing, and `--dedup-albums` keeps the
config default (False) unless given. `predict` answers one question through
the serving engine (serve.build_engine) and prints the result as one JSON
line (an answer step that fails gives {"error": ...}, as in the JAX CLI). The
run directory is the port's (config.json + params.pt, see convert.py). `serve`
(serve.main) serves the run directory over HTTP on 127.0.0.1 (GET /healthz,
GET /stats, POST /ask, POST /albums) with the JAX CLI's flags; `--dp N`
answers each micro-batch in N shards, one per card (N CPU slots with --device
cpu; fewer cards than N is make_mesh's ValueError), and `--shard-cache` puts
each album's cache entry on one device of that mesh. `report`
summarizes a run directory's metrics.jsonl and `attention-report` renders a
`--dump-attention` npz, as the JAX CLI's do (text, or JSON with --json).
`import-tf-checkpoint` reads a TF V2 checkpoint without TensorFlow
(tf_import.py), maps it onto the model built from the pack and writes a run
directory at step 0 (prints {"rundir", "imported", "kept_init",
"tf_variables"}; `--list` prints each variable and shape, `--dump-map` writes
the default name mapping); `export-tf-checkpoint` writes a run's best (or
latest) parameters as a TF1-layout Saver checkpoint (prints {"tf_checkpoint",
"step", "from"}).

The video commands are the JAX package's: `synth-video` writes a synthetic raw
corpus, `video-prepro` packs one into streaming shards, `video` trains — the
synthetic demo without --data, a plain loop over a pack with --data, and the
full driver (train_video.train_video: keep-best checkpoints, metrics, exact
resume) with --data --out, then evaluates the best state on the test split —
and `video-test` evaluates a video run directory. `--cp N` trains (and, in
the synthetic demo and the plain loop, evaluates) with the attention's frame
axis split over N ranks (parallel/cp.py), one process each, as `train
--data-parallel` launches them.
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


def _print_first(line: str) -> None:
    """Print on rank 0 only when the command runs as one rank of a group."""
    from fvta_memexqa_torch.parallel.mesh import is_first_rank

    if is_first_rank():
        print(line)


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
    p.add_argument("--profile", action="store_true",
                   help="trace steps 11-15 with torch.profiler (CPU and CUDA activity) into "
                        "rundir/profile as a chrome trace (torch's format, not jax.profiler's)")
    p.add_argument("--stream-shard-size", type=int, default=0,
                   help="stream splits from shard files of this many rows "
                        "(memory-bounded loading; 0 = in-memory Dataset)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="prefetch depth: prepare and move batches to the device in a "
                        "background thread this many ahead (0 = inline)")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.train import train

    datasets = None
    if args.stream_shard_size > 0:
        from fvta_memexqa_torch.data.stream import StreamingDataset, ensure_split_shards

        # the split arrays stay on disk; the shard conversion is skipped when a
        # matching index exists
        packed = load_pack(args.packdir, load_splits=False)
        ensure_split_shards(args.packdir, "train", args.stream_shard_size)
        val_ds = None
        if packed.meta["split_sizes"].get("val", 0) > 0:
            ensure_split_shards(args.packdir, "val", args.stream_shard_size)
            val_ds = StreamingDataset(args.packdir, "val")
        datasets = (StreamingDataset(args.packdir, "train"), val_ds)
    else:
        packed = load_pack(args.packdir)
    cfg = _model_config(args, Config(), packed)
    os.makedirs(args.rundir, exist_ok=True)
    res = train(cfg, packed, args.rundir, num_steps=args.num_steps,
                metrics_path=os.path.join(args.rundir, "metrics.jsonl"),
                profile_dir=os.path.join(args.rundir, "profile") if args.profile else None,
                datasets=datasets, prefetch=args.prefetch, device=args.device)
    _print_first(json.dumps({"best_val_acc": res["best_val_acc"], "steps": res["steps"]}))


def cmd_synth(argv):
    p = argparse.ArgumentParser(prog="fvta-torch synth")
    p.add_argument("outdir")
    p.add_argument("--num-albums", type=int, default=6)
    p.add_argument("--photos-per-album", type=int, default=4)
    p.add_argument("--num-questions", type=int, default=24)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--focal", action="store_true",
                   help="emit the focality-discriminating corpus (answers hidden at single "
                        "photo positions behind decoy-saturated album text; whole albums "
                        "held out for test and val) instead of the derivable one")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.data.synthetic import (make_focal_synthetic, make_synthetic,
                                                   write_raw_files)

    gen = make_focal_synthetic if args.focal else make_synthetic
    write_raw_files(args.outdir, *gen(
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
                   help="row-shard the album cache over the --data-parallel ranks (each "
                        "keeps 1/N of the rows); identical metrics")
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
    _print_first(json.dumps(out))


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
    from fvta_memexqa_torch.parallel.mesh import is_first_rank
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
            if is_first_rank():
                print(f"[ablate] {variant} seed={seed}: val={res['best_val_acc']:.4f} "
                      f"test={m['acc']:.4f}", file=sys.stderr)
        n = len(per_seed)
        results[variant] = {"val_acc": sum(v["val_acc"] for v in per_seed.values()) / n,
                            "test_acc": sum(v["test_acc"] for v in per_seed.values()) / n,
                            "steps": per_seed[str(seeds[0])]["steps"]}
        if n > 1:
            results[variant]["per_seed"] = per_seed
    _print_first(json.dumps(results))


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


def cmd_serve(argv):
    from fvta_memexqa_torch.serve import main as serve_main

    return serve_main(argv)


def _tf_mapping(args) -> dict:
    from fvta_memexqa_torch.tf_import import default_tf1_map

    if args.map_file:
        with open(args.map_file) as f:
            return json.load(f)
    return default_tf1_map(args.tf_prefix)


def cmd_import_tf(argv):
    """Import a TF1 (tf.train.Saver) or Keras-layout TF V2 checkpoint into a port
    run directory at step 0, so `cli test <packdir> <rundir>` evaluates the
    imported weights (the route from the reference's weights to its accuracy)."""
    p = argparse.ArgumentParser(prog="fvta-torch import-tf-checkpoint")
    p.add_argument("ckpt", help="TF checkpoint prefix (Saver V2 format) or its directory")
    p.add_argument("packdir", help="pack providing shapes/vocab for the model")
    p.add_argument("rundir", help="port run dir to write (step 0)")
    p.add_argument("--map", dest="map_file", default=None,
                   help="JSON name mapping (our leaf path -> tf var name); "
                        "default: tf_import.default_tf1_map(--tf-prefix)")
    p.add_argument("--dump-map", default=None, metavar="PATH",
                   help="write the default mapping JSON for hand-editing, then exit")
    p.add_argument("--list", action="store_true",
                   help="list the checkpoint's variables + shapes, then exit")
    p.add_argument("--tf-prefix", default="model",
                   help="scope prefix for the default name mapping")
    for dc in (ModelConfig, TrainConfig, MeshConfig):
        _add_dataclass_flags(p, dc)
    p.add_argument("--device", default="cuda",
                   help="device of the run's dropout generator state (train resumes there)")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.tf_import import (convert_params, default_tf1_map,
                                              read_tf_checkpoint)

    if args.dump_map:
        with open(args.dump_map, "w") as f:
            json.dump(default_tf1_map(args.tf_prefix), f, indent=2)
        print(json.dumps({"dumped": args.dump_map}))
        return
    tfvars = read_tf_checkpoint(args.ckpt)
    if args.list:
        for name in sorted(tfvars):
            print(f"{name}  {list(np.shape(tfvars[name]))}")
        return

    from fvta_memexqa_torch.checkpoint import CheckpointManager
    from fvta_memexqa_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.serve import resolve_device
    from fvta_memexqa_torch.train import init_state

    packed = load_pack(args.packdir, load_splits=False)
    cfg = _model_config(args, Config(), packed)
    state = init_state(cfg, resolve_device(args.device))
    new, report = convert_params(flax_tree_from_state_dict(state.model.state_dict()), tfvars,
                                 _tf_mapping(args), forget_bias=cfg.model.forget_bias)
    state.model.load_state_dict(state_dict_from_flax(new))
    CheckpointManager(args.rundir, cfg).save(0, state)
    print(json.dumps({"rundir": args.rundir, **report, "tf_variables": len(tfvars)}))


def cmd_export_tf(argv):
    """Inverse of import-tf-checkpoint: write a port run's parameters (best on
    val, or latest) as a TF1-layout tf.train.Saver checkpoint (fused LSTM
    kernels, (i,j,f,o) gates, in-cell forget bias), so weights trained here can
    be handed back to a TF consumer."""
    p = argparse.ArgumentParser(prog="fvta-torch export-tf-checkpoint")
    p.add_argument("packdir", help="pack providing shapes/vocab for the model")
    p.add_argument("rundir", help="port run dir holding the checkpoint")
    p.add_argument("out_prefix", help="TF checkpoint prefix to write")
    p.add_argument("--load-latest", action="store_true",
                   help="export latest instead of best-on-val checkpoint")
    p.add_argument("--tf-prefix", default="model",
                   help="scope prefix for the TF variable names")
    p.add_argument("--map", dest="map_file", default=None,
                   help="JSON name mapping (our leaf path -> tf var name); "
                        "default: tf_import.default_tf1_map(--tf-prefix)")
    args = p.parse_args(argv)
    from fvta_memexqa_torch.checkpoint import CheckpointManager
    from fvta_memexqa_torch.config import load_config
    from fvta_memexqa_torch.convert import flax_tree_from_state_dict
    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.models import FVTAModel
    from fvta_memexqa_torch.tf_import import export_tf1_checkpoint

    packed = load_pack(args.packdir, load_splits=False)
    cfg = load_config(os.path.join(args.rundir, "config.json")).replace(data=packed.cfg)
    ck = CheckpointManager(args.rundir).load(best=not args.load_latest)
    model = FVTAModel(cfg)   # holds the weights for their shapes; computes nothing
    model.load_state_dict(ck["params"])
    prefix = export_tf1_checkpoint(flax_tree_from_state_dict(model.state_dict()),
                                   args.out_prefix, prefix=args.tf_prefix,
                                   mapping=_tf_mapping(args))
    print(json.dumps({"tf_checkpoint": prefix, "step": int(ck["step"]),
                      "from": "latest" if args.load_latest else "best"}))


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
                   help="context-parallel degree: split the FVTA attention's frame axis "
                        "over N ranks (the frame count must divide by N)")
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
                    cp=args.cp, prefetch=args.prefetch, device=args.device,
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
    at --lr without dropout or clipping, then the held-out split. --cp N > 1:
    in N context-parallel ranks (rank 0's line printed)."""
    from fvta_memexqa_torch.train_video import video_plain_run

    if args.cp > 1:
        from fvta_memexqa_torch.data.video_pack import load_video_meta

        frames = load_video_meta(args.data)[1]["max_frames"] if args.data else args.num_frames
        if frames % args.cp:
            raise SystemExit(f"--cp {args.cp} requires the frame count ({frames}) to be "
                             "divisible by it")
    out = video_plain_run(args, device=args.device)
    if isinstance(out, int):
        return out
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


def cmd_attention_report(argv):
    """A readable report over a `test --dump-attention` (or `video-test
    --dump-attention`) npz: per question, the across-sequence focus (seq_attn)
    and the top (sequence, time) cells of the joint weight seq_attn[s] *
    time_attn[s, t], named by (album, modality) or by the dump's seq_names.
    Prints what the JAX CLI prints; 2 for an unknown --qid."""
    p = argparse.ArgumentParser(prog="fvta-torch attention-report")
    p.add_argument("npz", help="output of `cli test --dump-attention PATH`")
    p.add_argument("--qid", default=None, help="report only this question id")
    p.add_argument("--top", type=int, default=3,
                   help="top-K (sequence, time) cells per question")
    p.add_argument("--limit", type=int, default=10,
                   help="max questions in the report (0 = all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSONL instead of the text table")
    p.add_argument("--wrong-only", action="store_true",
                   help="only questions the model got wrong")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.config import MODALITIES

    z = np.load(args.npz, allow_pickle=True)
    qids = [str(q) for q in z["qid"]]
    ta, sa = z["time_attn"], z["seq_attn"]          # [N,S,T], [N,S]
    pred, label, probs = z["pred"], z["label"], z["probs"]
    n_mod = len(MODALITIES)
    # video dumps name their sequences (seq_names=["frames"]); the (album,
    # modality) decomposition is MemexQA's
    seq_names = ([str(x) for x in z["seq_names"]]
                 if "seq_names" in getattr(z, "files", []) else None)
    rows = range(len(qids))
    if args.qid is not None:
        if args.qid not in qids:
            print(f"error: qid {args.qid!r} not in {args.npz}", file=sys.stderr)
            return 2
        rows = [qids.index(args.qid)]
    reported = 0
    for i in rows:
        if args.wrong_only and int(pred[i]) == int(label[i]):
            continue
        if args.limit and reported >= args.limit:
            break
        reported += 1
        joint = sa[i][:, None] * ta[i]
        flat = joint.reshape(-1)
        top = np.argsort(flat)[::-1][: args.top]
        cells = []
        for k in top:
            s, t = divmod(int(k), ta.shape[2])
            cell = {"t": t, "weight": float(flat[k]), "seq_weight": float(sa[i][s])}
            if seq_names is not None:
                cell["seq"] = seq_names[s % len(seq_names)]
            else:
                cell["album"] = s // n_mod
                cell["modality"] = MODALITIES[s % n_mod]
            cells.append(cell)
        rec = {
            "qid": qids[i], "pred": int(pred[i]), "label": int(label[i]),
            "correct": bool(pred[i] == label[i]),
            # count dumps carry the regression value in probs[:, 0], no class p
            "p_pred": (float(probs[i][int(pred[i])])
                       if int(pred[i]) < probs.shape[1] else None),
            "focus": cells,
        }
        if args.as_json:
            print(json.dumps(rec))
        else:
            mark = "✓" if rec["correct"] else f"✗ (gold {rec['label']})"
            p_str = f"p={rec['p_pred']:.2f} " if rec["p_pred"] is not None else ""
            print(f"{rec['qid']}: pred choice {rec['pred']} {p_str}{mark}")
            for c in cells:
                name = (c["seq"] if "seq" in c
                        else f"album {c['album']} · {c['modality']:<12s}")
                print(f"    {name} t={c['t']:<3d} "
                      f"joint={c['weight']:.3f} (seq {c['seq_weight']:.3f})")
    if not args.as_json:
        print(f"[{reported} question(s) reported from {args.npz}]", file=sys.stderr)
    return 0


def cmd_report(argv):
    """A summary of a run directory's metrics.jsonl: training progress, the best
    validation (accuracy, or mse for a video count run), every test,
    by-category and ensemble record; rows of a foreign or partial schema render
    too. Prints what the JAX CLI prints; 1 when there is no metrics.jsonl."""
    p = argparse.ArgumentParser(prog="fvta-torch report")
    p.add_argument("rundir")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary instead of the table")
    args = p.parse_args(argv)
    path = os.path.join(args.rundir, "metrics.jsonl")
    if not os.path.exists(path):
        print(f"no metrics.jsonl under {args.rundir}", file=sys.stderr)
        return 1
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    by = lambda ev: [e for e in events if e.get("event") == ev]  # noqa: E731
    trains, vals, tests = by("train"), by("val"), by("test")
    bycat, ens = by("test_by_category"), by("test_ensemble")
    strip = lambda e, drop=("event", "time"): {  # noqa: E731
        k: v for k, v in e.items() if k not in drop}
    accs = [v for v in vals if "acc" in v]
    mses = [v for v in vals if "acc" not in v and "mse" in v]
    best_val = (max(accs, key=lambda v: v["acc"]) if accs
                else min(mses, key=lambda v: v["mse"]) if mses else None)
    summary = {
        "steps": trains[-1].get("step", 0) if trains else 0,
        "final_train_loss": trains[-1].get("loss") if trains else None,
        "train_qa_pairs_per_sec": (trains[-1].get("qa_pairs_per_sec")
                                   if trains else None),
        "best_val_acc": best_val.get("acc") if best_val else None,
        "best_val_mse": best_val.get("mse") if best_val else None,
        "best_val_step": best_val.get("step") if best_val else None,
        "val_evals": len(vals),
        "tests": [strip(t) for t in tests],
        "by_category": strip(bycat[-1], ("event", "time", "split")) if bycat else None,
        "ensembles": [strip(e) for e in ens],
    }
    if args.json:
        print(json.dumps(summary))
        return 0
    print(f"run: {args.rundir}")
    cfg_path = os.path.join(args.rundir, "config.json")
    if os.path.exists(cfg_path):
        from fvta_memexqa_torch.config import load_config

        try:
            c = load_config(cfg_path)
        except (ValueError, TypeError, AttributeError):
            c = None   # a config.json of another schema: no model line
        if c is not None:
            print(f"model: attention={c.model.attention} "
                  f"hidden={c.model.hidden_dim}"
                  f" | train: bs={c.train.batch_size} "
                  f"lr={c.train.learning_rate} opt={c.train.optimizer}")
    if trains:
        loss = summary["final_train_loss"]
        print(f"train: {summary['steps']} steps"
              + (f", final loss {loss:.4f}" if loss is not None else "")
              + (f", {summary['train_qa_pairs_per_sec']:.0f} qa/s"
                 if summary["train_qa_pairs_per_sec"] else ""))
    if best_val:
        metric = ("best acc " + format(best_val["acc"], ".4f") if "acc" in best_val
                  else "best mse " + format(best_val["mse"], ".4f"))
        print(f"val:   {metric} @ step {best_val.get('step', '?')} "
              f"({len(vals)} evals)")
    for t in summary["tests"]:
        score = (f"acc {t['acc']:.4f}" if "acc" in t
                 else f"mse {t['mse']:.4f}" if "mse" in t else "?")
        print(f"test:  {t.get('split', '?')}: {score} "
              f"({t.get('count', '?')} questions)")
    if summary["by_category"]:
        print("by category: " + "  ".join(
            f"{k}={v:.4f}" for k, v in summary["by_category"].items()))
    for e in summary["ensembles"]:
        acc = e.get("acc")
        print(f"ensemble: {e.get('split', '?')}: "
              + (f"acc {acc:.4f} " if acc is not None else "acc ? ")
              + f"(members {e.get('member_accs')})")
    return 0


COMMANDS = {"synth": cmd_synth, "prepro": cmd_prepro, "train": cmd_train, "test": cmd_test,
            "ablate": cmd_ablate, "serve": cmd_serve, "predict": cmd_predict,
            "import-tf-checkpoint": cmd_import_tf, "export-tf-checkpoint": cmd_export_tf,
            "synth-video": cmd_synth_video,
            "video-prepro": cmd_video_prepro, "video": cmd_video, "video-test": cmd_video_test,
            "attention-report": cmd_attention_report, "report": cmd_report}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("train", "test", "ablate"):
        from fvta_memexqa_torch.parallel.mesh import maybe_initialize_distributed

        maybe_initialize_distributed()   # under torchrun: this process is one rank
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m fvta_memexqa_torch.cli {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    return COMMANDS[argv[0]](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
