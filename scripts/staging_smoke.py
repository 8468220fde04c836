#!/usr/bin/env python3
"""chip_smoke.py's phase 27 alone: a batch's move to the card, the plain
per-field .to against the staged one (data.device_prepro.stage_to), at
tvqa-frames-train-b128's VideoInputs and memexqa-train-b256's Batch, on one
NVIDIA card:

    python3 scripts/staging_smoke.py    # from the root of a checkout, on a CUDA machine

Prints chip_smoke.staging_phase's `staging` line, the card line and
{"ok": true, "device": {...}}. Builds no kernel: the phase runs none.
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
        cs.fail("torch.cuda.is_available() is False: this script runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.log("staging " + json.dumps(cs.staging_phase(torch.device("cuda"), smi)))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
