#!/usr/bin/env python3
"""What sets capacity_probe.cp_memory_table's per-rank temp: the allocations
live at the peak of one rank's second attention call, by the line of the
package that made them.

    python3 scripts/cp_memory_peak.py    # from the root of a checkout, on a CUDA machine

For 1, 2 and 4 CP ranks sharing the cards there are (mesh.run_ranks, as the
table runs them), forward and with grad, on the table's inputs (T = 65536,
batch 2, J = 30, D = 200): each rank calls fvta_attention_cp once, then again
under torch.cuda.memory._record_memory_history (Python stacks), and replays
the trace: the bytes allocated and not yet freed, largest at the peak, equal
the rise of max_memory_allocated over the call (the table's temp plus the
outputs). Each block at that peak is charged to the innermost frame in
fvta_memexqa_torch (else the innermost frame, else "<no Python frame>").
Prints one JSON line per case: rank 0's peak MB, its outputs' MB, and the
sites by MB; then every rank's peak MB.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGE = "fvta_memexqa_torch"
T, BATCH, J, D = 65536, 2, 30, 200


def site(frames) -> str:
    for f in frames:
        if PACKAGE in f["filename"]:
            return f"{f['filename'].split(PACKAGE + '/')[-1]}:{f['line']} {f['name']}"
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "<no Python frame>"


def peak_blocks(trace) -> tuple[int, list]:
    """(peak bytes, [(bytes, site)] live at it) over a device trace, counting a
    block from its alloc to its free_requested (when memory_allocated drops)."""
    live, total, peak, at_peak = {}, 0, 0, []
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev.get("frames", [])))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, list(live.values())
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    return peak, at_peak


def rank_peak(grad: bool) -> dict:
    """One rank (run by mesh.run_ranks): its time shard, two calls, the trace."""
    import torch
    import torch.distributed as dist

    from fvta_memexqa_torch import capacity_probe as cp
    from fvta_memexqa_torch.parallel import mesh
    from fvta_memexqa_torch.parallel.cp import fvta_attention_cp

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    step = T // world
    args = cp._device_args(rank * step, (rank + 1) * step, cp.cp_inputs(T, BATCH, J, D), dev)
    fn = cp._attention_call(lambda h, cm, q, qm, p: fvta_attention_cp(h, cm, q, qm, "trilinear",
                                                                      p), grad)
    fn(*args)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    outs = fn(*args)
    torch.cuda.synchronize(dev)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    rise = torch.cuda.max_memory_allocated(dev) - before
    peak, blocks = peak_blocks(snap["device_traces"][dev.index])
    by_site = {}
    for size, where in blocks:
        by_site[where] = by_site.get(where, 0) + size
    mb = lambda b: round(b / 2**20, 4)
    mine = {"rank": rank, "peak_mb": mb(peak), "max_allocated_rise_mb": mb(rise),
            "outputs_mb": mb(cp._bytes(outs)), "blocks_at_peak": len(blocks),
            "sites_mb": {k: mb(v) for k, v in sorted(by_site.items(), key=lambda kv: -kv[1])}}
    ranks = mesh.gather_objects(mine)
    return {**ranks[0], "peak_mb_per_rank": [r["peak_mb"] for r in ranks]}


def main() -> None:
    import torch

    from fvta_memexqa_torch.capacity_probe import _rank_mesh
    from fvta_memexqa_torch.parallel import mesh

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script runs only on a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    for grad in (False, True):
        for ranks in (1, 2, 4):
            out = mesh.run_ranks(rank_peak, _rank_mesh(ranks), grad)
            print(json.dumps({"ranks": ranks, "grad": grad, **out}), flush=True)


if __name__ == "__main__":
    main()
