#!/usr/bin/env python3
"""K4 (csrc/fvta_stats.cu), K5 and K6 (csrc/fvta_bwd.cu) against their plain
versions, then timed, on one NVIDIA card, without chip_smoke.py's other
phases:

    python3 scripts/k45_times.py      # from the root of a checkout, on a CUDA machine

Checks (chip_smoke.k456_check): K4, K5 and K6 on the arguments of the
full-width T=4096 video train step (read by wrapping the kernels) and on
chip_smoke's K4_SYNTH cases, against plain; K6's float64 witness, the
geq-only case and bitwise repeats. Times
(chip_smoke.stats_kernel_times) at the T=4096 step's call and at a synthetic
twin of `cli video`'s call (N=16, S=1, T=1024, J=30, D=200; chip_smoke.py
times the recorded call itself): under CUDA events, from a CUDA graph, and
split by kernel. Prints one JSON line.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def twin_args(n, t, seed):
    """A K6 call's arguments at (n, S=1, t, J=30, D=200): stats_case's inputs,
    K4's and K5's outputs, N(0, 1) cotangents."""
    import torch

    from fvta_memexqa_torch.ops import fvta_stats as fs

    h, cm, q, qm, wx, wy, wxy = cs.stats_case(n, 1, t, 30, 200, seed, "cuda")
    g = torch.Generator().manual_seed(seed + 1)
    de, geq, gv = (torch.randn(sh, generator=g).cuda() for sh in ((n, 1, t), (n, 30), (n, 1, 200)))
    with torch.no_grad():
        m, _, _, eq, e = fs.stats_fwd(h, cm, q, qm, wx, wy, wxy)
        cnt = fs.qcnt(h, cm, q, wx, wy, wxy, eq)
    return (h, cm, q, qm, wx, wy, wxy, de, geq, eq, cnt, e, m, gv)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from fvta_memexqa_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        build.build_all()
    except Exception as e:  # noqa: BLE001 - a kernel that does not build is fatal
        cs.fail(f"kernel build: {e}")
    for stem, text in build.build_log.items():
        for line in text.splitlines():
            if stem in ("fvta_stats", "fvta_bwd") and any(
                    k in line for k in ("Compiling entry", "registers", "spill", "error")):
                cs.log(f"  ptxas {stem}: {line.strip()}")
    fwd_args, bwd_args = cs.video_main_path_args()
    checks = cs.k456_check(fwd_args, bwd_args)
    twin = twin_args(16, 1024, 990)
    twin_errs = cs.stats_check_case("cli_video_twin", list(twin[:7]), [twin[7], twin[8], twin[13]])
    errs = {"k4_main": checks["k4_max_abs_err"], "k6_main": checks["k6_max_abs_err"],
            **{f"{k}_cli": v for k, v in twin_errs.items()}}
    launches = {name: 0 for name, *_ in cs.STATS_KERNELS}
    entries, _ = cs.stats_kernel_times(
        {"the T=4096 train step's call": bwd_args, "cli video's call (synthetic twin)": twin},
        launches, errs)
    cs.log(json.dumps({"card": smi, "checks": checks, "kernels": entries}))


if __name__ == "__main__":
    main()
