"""The benchmark's command. From the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON line last on standard output: {"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "checks"}. --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer metrics from a profiled
stretch after the window. It exits non-zero and prints no result without the
CUDA cards the cell asks for, or where JAX or the JAX package got loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t0=T0)
    found = harness.banned_modules()   # the last step before the result
    if found:
        print(f"loaded in this process: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


def finite(x):
    """The result with every number that is not finite (a check that found no
    answer, or a shape that differs) as null, so the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
