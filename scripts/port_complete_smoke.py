#!/usr/bin/env python3
"""chip_smoke.py's phase 25 alone: TF checkpoint export / import / test, the
bf16 activation variant and the native tokenizer on one NVIDIA card, without
the other phases:

    python3 scripts/port_complete_smoke.py    # from the root of a checkout, on a CUDA machine

Builds the kernels, then makes what phase 25 reads from earlier phases: phase
4's pack (the 64-album synthetic corpus at F=2537, default DataConfig), its
raw files (phase 16's), phase 7's run (`cli train`, 24 steps,
chip_smoke.train_run) and the video pack (chip_smoke.prepare_video_pack, made
in a CPU process meanwhile; phase 25 trains its video models on it). Runs chip_smoke.port_complete_phase and prints its
`port_complete` line, the two bf16 kernels-line entries, the card line and
{"ok": true, "device": {...}}.
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
    from fvta_memexqa_torch.data import make_synthetic, pack, write_raw_files
    from fvta_memexqa_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    with tempfile.TemporaryDirectory() as workdir:
        prep = cs.prepare_video_pack(workdir)
        try:
            corpus = make_synthetic(**cs.SLICE_CORPUS)
            packdir = os.path.join(workdir, "pack")
            pack(*corpus, packdir, DataConfig(), seed=0)
            write_raw_files(os.path.join(workdir, "raw"), *corpus)
            cs.train_run(packdir, os.path.join(workdir, "train_plain"), dedup=False)
            if prep.wait(timeout=600) != 0:
                cs.fail("the video pack was not made: "
                        + open(os.path.join(workdir, "video_prep.log")).read()[-2000:])
        finally:
            if prep.poll() is None:
                prep.kill()
                prep.wait()
        t0 = time.perf_counter()
        phase = cs.port_complete_phase(workdir, torch.device("cuda"), smi)
        wall = time.perf_counter() - t0
    cs.log(f"phase 25: {wall:.1f} s")
    cs.log("port_complete " + json.dumps(phase))
    cs.log(json.dumps({"kernels": cs.bf16_entries(phase)}))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
