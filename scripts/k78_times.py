#!/usr/bin/env python3
"""K7 (csrc/lstm_grouped.cu) and K8 (csrc/lstm_stream.cu) against their plain
version, each other and K1, then timed, on one NVIDIA card, without
chip_smoke.py's other phases:

    python3 scripts/k78_times.py      # from the root of a checkout, on a CUDA machine

Checks (chip_smoke.grouped_check, phase 15): the grouped-scan API at the
eleven phase-15 shapes with its launch counts, then both kernels directly, G =
2 and G = 1, against plain, bitwise against each other, their repeats and K1
fed its own projection. Times (chip_smoke.grouped_times, phase 17): the scan
alone under CUDA events and from a CUDA graph, the API's projection + scan
before and after the host-work repairs, K1, cuDNN, the bounds, and the API's
host traces. Prints the per-shape rows, the traces and one JSON line with the
kernels' entries.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from fvta_memexqa_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        build.build_all()
    except Exception as e:  # noqa: BLE001 - a kernel that does not build is fatal
        cs.fail(f"kernel build: {e}")
    for stem, text in build.build_log.items():
        for line in text.splitlines():
            if stem in ("lstm_grouped", "lstm_stream") and any(
                    k in line for k in ("Compiling entry", "registers", "spill", "error")):
                cs.log(f"  ptxas {stem}: {line.strip()}")
    device = torch.device("cuda")
    grouped = cs.grouped_check(device)
    entries, rows, traces = cs.grouped_times(device, grouped, {})   # no command runs here
    cs.log("grouped_shapes " + json.dumps(rows))
    cs.log("grouped_api_host_traces " + json.dumps(traces))
    cs.log(json.dumps({"card": smi, "kernels": entries}))


if __name__ == "__main__":
    main()
