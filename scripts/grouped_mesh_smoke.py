#!/usr/bin/env python3
"""chip_smoke.py's phase 24 alone: the grouped bi-LSTM (bilstm_fused_grouped),
serving over a mesh of two shards on one NVIDIA card, and the CP memory table,
without the other phases:

    python3 scripts/grouped_mesh_smoke.py    # from the root of a checkout, on a CUDA machine

Builds the kernels, then makes what phase 24 reads from earlier phases: phase
4's pack (the 64-album synthetic corpus at F=2537, default DataConfig) and
phase 7's run (`cli train`, 24 steps, chip_smoke.train_run). Runs
chip_smoke.grouped_mesh_phase and prints its `grouped_mesh` line, the two
grouped kernels-line entries, the card line and {"ok": true, "device": {...}}.
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        phase = cs.grouped_mesh_phase(workdir, torch.device("cuda"))
        wall = time.perf_counter() - t0
    cs.log(f"phase 24: {wall:.1f} s")
    cs.log("grouped_mesh " + json.dumps(phase))
    cs.log(json.dumps({"kernels": cs.grouped_bilstm_entries(phase)}))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
