#!/usr/bin/env python3
"""chip_smoke.py's phase 21 alone: the serving front end (`cli serve` over HTTP)
on one NVIDIA card, without the other phases:

    python3 scripts/serve_http_smoke.py      # from the root of a checkout, on a CUDA machine

Builds the kernels, then makes what phase 21 reads from earlier phases: phase
4's pack (the 64-album synthetic corpus at F=2537, default DataConfig), a run
directory (here a seeded full-width model, where chip_smoke uses phase 7's
trained one) and phase 16's raw files (album_info.json, photo_feats.npz). Runs
chip_smoke.serving_http_phase (f32 server with auth, limits and a cache dir;
a 1 MiB byte budget; bfloat16 and int8 caches; a restart on the saved cache;
the refusals of --dp past the cards and of --shard-cache without --dp; TLS;
open-loop Poisson load) and prints
its `serving_http` line, the card line and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script runs only on a CUDA card")
    from fvta_memexqa_torch.config import Config, DataConfig
    from fvta_memexqa_torch.convert import save_rundir
    from fvta_memexqa_torch.data import make_synthetic, pack, write_raw_files
    from fvta_memexqa_torch.models import FVTAModel
    from fvta_memexqa_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    with tempfile.TemporaryDirectory() as workdir:
        packdir, rundir, raw = (os.path.join(workdir, d) for d in ("pack", "run", "raw"))
        corpus = make_synthetic(**cs.SLICE_CORPUS)
        meta = pack(*corpus, packdir, DataConfig(), seed=0)
        cfg = Config(data=DataConfig(**meta["data_config"]))
        save_rundir(rundir, cfg, FVTAModel(cfg, generator=torch.Generator().manual_seed(0)))
        write_raw_files(raw, *corpus)
        out = cs.serving_http_phase(packdir, rundir, raw, workdir, smi)
    cs.log("serving_http " + json.dumps(out))
    cs.log(smi)
    cs.log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
