"""Command line of the port.

    python -m fvta_memexqa_torch.cli train <packdir> <rundir> [--num-steps N] \
        [--batch-size 64 --hidden-dim 100 ... (ModelConfig/TrainConfig/MeshConfig
        fields as --flags)] [--device cuda|cpu]
    python -m fvta_memexqa_torch.cli predict <packdir> <rundir> \
        --question "what year was the sunrise trip ?" --choices "2007|2009|2011|2013" \
        --album-ids album0 [--device cuda|cpu]

`train` runs train.train on the pack (metrics to <rundir>/metrics.jsonl,
checkpoints under <rundir>, resuming from the latest one there) and prints
{"best_val_acc", "steps"}; the run directory then serves through `predict`.
`--use-pallas` is read and selects nothing, and `--dedup-albums` keeps the
config default (False) unless given. `predict` answers one question through
the serving engine (serve.build_engine) and prints the result as one JSON
line. The run directory is the port's (config.json + params.pt, see convert.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from fvta_memexqa_torch.config import Config, MeshConfig, ModelConfig, TrainConfig


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


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="fvta-torch train")
    p.add_argument("packdir")
    p.add_argument("rundir")
    for dc in (ModelConfig, TrainConfig, MeshConfig):
        _add_dataclass_flags(p, dc)
    p.add_argument("--num-steps", type=int, default=None,
                   help="stop after N optimizer steps (overrides epochs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.data.pack import load_pack
    from fvta_memexqa_torch.train import train

    packed = load_pack(args.packdir)
    base = Config()
    cfg = Config(data=packed.cfg, model=_dc_from_args(args, ModelConfig, base.model),
                 train=_dc_from_args(args, TrainConfig, base.train),
                 mesh=_dc_from_args(args, MeshConfig, base.mesh))
    os.makedirs(args.rundir, exist_ok=True)
    res = train(cfg, packed, args.rundir, num_steps=args.num_steps,
                metrics_path=os.path.join(args.rundir, "metrics.jsonl"),
                device=args.device)
    print(json.dumps({"best_val_acc": res["best_val_acc"], "steps": res["steps"]}))


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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from fvta_memexqa_torch.serve import build_engine

    # preingest=False: a one-shot predict only needs the referenced albums,
    # which the store encodes from their pack rows on first use
    engine, store, _ = build_engine(args.packdir, args.rundir, device=args.device,
                                    batch_size=1, preingest=False)
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


COMMANDS = {"train": cmd_train, "predict": cmd_predict}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m fvta_memexqa_torch.cli {{{'|'.join(COMMANDS)}}} ...",
              file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
