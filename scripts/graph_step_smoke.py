#!/usr/bin/env python3
"""chip_smoke.py's phase 26 alone: the train step from its CUDA graph against
the eager step at realistic_config, batch 64 and 256, on one NVIDIA card:

    python3 scripts/graph_step_smoke.py    # from the root of a checkout, on a CUDA machine

Builds the kernels, runs chip_smoke.graph_step_phase and prints its
`graph_step` line, the card line and {"ok": true, "device": {...}}.
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
    from fvta_memexqa_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    cs.log("graph_step " + json.dumps(cs.graph_step_phase(torch.device("cuda"), smi)))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
