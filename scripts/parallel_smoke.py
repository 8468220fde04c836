#!/usr/bin/env python3
"""chip_smoke.py's phase 23 alone: data and context parallelism with the ranks
sharing one NVIDIA card, without the other phases:

    python3 scripts/parallel_smoke.py    # from the root of a checkout, on a CUDA machine

Builds the kernels, then makes what phase 23 reads from earlier phases: phase
4's pack (the 64-album synthetic corpus at F=2537, default DataConfig), phase
7's run (`cli train`, 24 steps, chip_smoke.train_run) and phase 16's cached
`cli test` accuracy on it. Runs chip_smoke.parallel_phase and prints its
`parallel` line, the card line and {"ok": true, "device": {...}}.
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
        plain = os.path.join(workdir, "train_plain")
        cs.train_run(packdir, plain, dedup=False)
        cached, _ = cs.cli_json(["test", packdir, plain, "--device", "cuda"])
        t0 = time.perf_counter()
        parallel = cs.parallel_phase(workdir, {"test": {"cached": cached}}, smi)
        wall = time.perf_counter() - t0
    cs.log(f"phase 23: {wall:.1f} s")
    cs.log("parallel " + json.dumps(parallel))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
