#!/usr/bin/env python3
"""chip_smoke.py's phase 22 alone: `cli train`'s loader flags and the focality
workflow on one NVIDIA card, without the other phases:

    python3 scripts/loader_smoke.py      # from the root of a checkout, on a CUDA machine

Builds the kernels, then makes what phase 22 reads from earlier phases: phase
4's pack (the 64-album synthetic corpus at F=2537, default DataConfig) and
phase 7's run (`cli train`, 24 steps, chip_smoke.train_run). Runs
chip_smoke.train_loader_phase (`--prefetch 2` bitwise equal to the inline run;
`--stream-shard-size 64 --prefetch 2 --profile` and its trace) and
chip_smoke.focal_phase (`synth --focal`, `prepro --val-ids`, `train`, `test
--dump-attention`, `attention-report`, `report`) and prints their
`train_loader` and `focal` lines, the card line and {"ok": true, "device": {...}}.
Then it runs phase 7's inline run and the `--prefetch 2` run once more, in
turns, and prints their qa/s (the `prefetch_turns` line).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script runs only on a CUDA card")
    from fvta_memexqa_torch import cli
    from fvta_memexqa_torch.config import DataConfig
    from fvta_memexqa_torch.data import make_synthetic, pack
    from fvta_memexqa_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    with tempfile.TemporaryDirectory() as workdir:
        packdir = os.path.join(workdir, "pack")
        pack(*make_synthetic(**cs.SLICE_CORPUS), packdir, DataConfig(), seed=0)
        cs.train_run(packdir, os.path.join(workdir, "train_plain"), dedup=False)
        t0 = time.perf_counter()
        loader = cs.train_loader_phase(workdir, smi)
        focal = cs.focal_phase(workdir, smi)
        wall = time.perf_counter() - t0
        turns = []
        for depth in (0, 2, 2, 0):
            run = os.path.join(workdir, f"turn_{len(turns)}")
            cli.main(["train", packdir, run, "--num-steps", str(cs.TRAIN_STEPS),
                      "--val-period", "12", "--log-period", "1", "--save-period", "1000",
                      "--prefetch", str(depth), "--device", "cuda"])
            turns.append({"prefetch": depth, "qa_pairs_per_sec": cs.qa_per_s(run)})
    cs.log(f"phase 22: {wall:.1f} s")
    cs.log("train_loader " + json.dumps(loader))
    cs.log("focal " + json.dumps(focal))
    cs.log("prefetch_turns " + json.dumps({"card": smi, "turns": turns}))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
