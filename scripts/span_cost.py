#!/usr/bin/env python3
"""The cost of one enter and exit of the program's span helper
(`utils/metrics.span`), in microseconds a span, on this host:

- `off_us`: no profiler running (the shared no-op context);
- `record_function_off_us`: torch.profiler.record_function itself with no
  profiler running (what an unguarded span would cost);
- `on_us`: under torch.profiler.profile with CPU activity, and CUDA activity
  where a card is present (the spans' cost in a traced run).

    python3 scripts/span_cost.py [--n N]

Each is the best of 5 timed loops of N spans (N / 100 under the profiler),
after a warm-up loop. Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from fvta_memexqa_torch.utils.metrics import span  # noqa: E402


def per_span_us(make, n: int) -> float:
    best = float("inf")
    for rep in range(6):
        t = time.perf_counter()
        for _ in range(n):
            with make("fvta.step"):
                pass
        dt = (time.perf_counter() - t) / n * 1e6
        if rep:   # the first loop warms up
            best = min(best, dt)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    n = ap.parse_args().n
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "off_us": per_span_us(span, n),
           "record_function_off_us": per_span_us(torch.profiler.record_function, n // 10)}
    with torch.profiler.profile(activities=acts):
        out["on_us"] = per_span_us(span, max(n // 100, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
