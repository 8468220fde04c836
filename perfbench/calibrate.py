"""The readings behind the limits of `correct` (PERF.md lists them with the
limits set from them). On the chip, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --variants sound,tf32,bf16,half,unchanged,altered

prints one JSON line per seed and variant with every number the cell compares:
- sound: the program as the configuration states it (a run at a short window);
- tf32: the control, the plain reference with TF32 on in cuBLAS and cuDNN, put
  in the program's place (the configuration states float32 with TF32 off);
- bf16: the program's own bf16 activation path (ModelConfig.dtype) switched on;
- half, unchanged, altered: the faults of perfbench/faults.py the cell can have.
A training cell names the worst leaf of each number on standard error.
"""

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import faults, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="sound")
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    kind = cell.spec["kind"]
    traffic = importlib.import_module(f"perfbench.traffic.{kind}")
    variants = args.variants.split(",")
    unknown = set(variants) - {"sound", "tf32", "bf16", *faults.FAULTS[kind]}
    if unknown:
        ap.error(f"{args.workload} has no variant {sorted(unknown)}")
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in variants:
            t = time.perf_counter()
            line = {"workload": args.workload, "seed": seed, "variant": variant}
            if variant == "tf32":
                run = harness.new_run(cell, seed, args.device)
                prog, ref = traffic.reference(run, tf32=True), traffic.reference(run, tf32=False)
                line.update(traffic.compare(prog, ref))
            else:
                over = {"config": {"model": {"dtype": "bfloat16"}}} if variant == "bf16" else None
                fault = faults.FAULTS[kind].get(variant)
                with (fault() if fault else contextlib.nullcontext()):
                    res = harness.run_cell(args.workload, seed, args.seconds, False, args.device,
                                           over)
                line.update({k: v["value"] for k, v in res["checks"].items()})
                line["correct"] = res["correct"]
            line["s"] = round(time.perf_counter() - t, 2)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
