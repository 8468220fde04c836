"""Capacity probe: the largest context length T each attention path runs on one
card, forward or with grad, and the per-device memory of the attention
unsharded vs context-parallel.

The port of fvta_memexqa_tpu/capacity_probe.py. Two paths of the FVTA
attention:

- "plain": ops/fvta_ref's one-pass attention, which materialises the
  correlation C [N, S, T, J] (and under grad its backward intermediates): the
  counterpart of the JAX package's XLA path, used only by this probe;
- "kernel": ops/fvta_fused.fvta_attention_fused, the model's own call, which
  from STREAM_MIN_T = 1024 frames on streams through K4 (and K5 + K6 under
  grad) without C in device memory, and below that runs K2.

`probe_largest_t` doubles T (or walks an explicit `t_list`) until a path runs
out of device memory: only torch.cuda.OutOfMemoryError counts as that; any
other error is re-raised. Inputs are minted on the device with the JAX
package's sin-iota fill (one output buffer each, no host copy).

`cp_memory_table` is the JAX package's table (capacity_probe.py:142-190) of the
attention's per-device memory, unsharded vs context parallelism over `devices`
ranks, on the JAX table's inputs. Both sides run the same per-rank path
(parallel/cp.fvta_attention_cp: K4, and K5 + K6 under grad), the unsharded
side as one rank holding the whole context, so the two differ only in the
sharding; the plain path on the whole context (the JAX table's XLA side, which
materialises C) is reported beside them. XLA's compiled memory analysis has no
PyTorch counterpart, so `argument_mb` and `output_mb` are counted from the
tensors each device holds (a rank: its time shard of h and cm, q, qm and the
weights in; the replicated context, or its shard of dh with the replicated dq
and weight gradients, out) and `temp_mb` is measured:
torch.cuda.max_memory_allocated over the call less the arguments and outputs,
in each rank's own process (mesh.run_ranks; each process has its own
allocator, also where ranks share a card), whose largest is reported. It is
read on the second call: the first also allocates what the process keeps for
later calls (cuBLAS's workspace), reported beside it as `first_call_temp_mb`.

    python -m fvta_memexqa_torch.capacity_probe [--grad] [--t-list 16384,24576] [--cp-only]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fvta_memexqa_torch.config import MeshConfig
from fvta_memexqa_torch.ops.fvta_fused import fvta_attention_fused
from fvta_memexqa_torch.ops.fvta_ref import fvta_attention, similarity_tensor
from fvta_memexqa_torch.parallel import mesh

PATHS = ("plain", "kernel")


def mint(shape, device) -> torch.Tensor:
    """sin(i2 * 7.77e-3 + i3 * 0.31) over `shape`, i2 and i3 the indices of its
    last two axes (the JAX probe's fill), as one float32 buffer."""
    i2 = torch.arange(shape[-2], dtype=torch.float32, device=device)[:, None]
    i3 = torch.arange(shape[-1], dtype=torch.float32, device=device)[None, :]
    return torch.sin(i2 * 7.77e-3 + i3 * 0.31).expand(shape).contiguous()


def _attention_fn(path: str):
    """The context output of one attention path (h, cm, q, qm, params), with
    the trilinear similarity."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r} (expected one of {PATHS})")

    def fn(h, cm, q, qm, params):
        if path == "kernel":
            return fvta_attention_fused(h, cm, q, qm, "trilinear", params).context
        return fvta_attention(h, cm, q, qm, similarity_tensor(h, q, "trilinear", params)).context

    return fn


def _run_at_t(t: int, path: str, batch: int, j: int, d: int, s: int = 8, grad: bool = False,
              device="cuda") -> None:
    """One attention at context length t on inputs minted on `device` (ones as
    masks, 0.1 as the trilinear weights). Raises on OOM. grad=True takes the
    gradient of the context's sum with respect to h, q and the weights (the
    training-capacity probe)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and no CUDA card is available")
    h = mint((batch, s, t, d), dev)
    cm = torch.ones((batch, s, t), dtype=torch.bool, device=dev)
    q = mint((batch, j, d), dev)
    qm = torch.ones((batch, j), dtype=torch.bool, device=dev)
    params = {k: torch.full((d,), 0.1, device=dev) for k in ("w_x", "w_y", "w_xy")}
    fn = _attention_fn(path)
    if grad:
        leaves = [h.requires_grad_(), q.requires_grad_(),
                  *(v.requires_grad_() for v in params.values())]
        with torch.enable_grad():
            loss = fn(h, cm, q, qm, params).sum()
            grads = torch.autograd.grad(loss, leaves)
        total = sum(g.sum() for g in grads)
    else:
        with torch.no_grad():
            total = fn(h, cm, q, qm, params).sum()
    total.item()   # wait for the device


def probe_largest_t(batch: int = 8, j: int = 512, d: int = 200, s: int = 8,
                    t_start: int = 1 << 14, t_cap: int = 1 << 22, grad: bool = False,
                    t_list: list[int] | None = None, device="cuda") -> dict:
    """Per path, the largest T that runs and the first that runs out of device
    memory: T doubles from t_start up to t_cap, or walks exactly the points of
    `t_list` (the finer grid between doubling steps)."""
    results = {}
    for path in PATHS:
        last_ok, first_oom = None, None
        ts = iter(t_list) if t_list else None
        t = next(ts) if ts else t_start
        while t <= t_cap:
            try:
                _run_at_t(t, path, batch, j, d, s, grad=grad, device=device)
            except torch.cuda.OutOfMemoryError as e:
                first_oom = t
                print(f"[{path}] T={t}: OOM ({type(e).__name__})", file=sys.stderr, flush=True)
                break
            finally:
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            last_ok = t
            print(f"[{path}] T={t}: ok", file=sys.stderr, flush=True)
            t = next(ts, t_cap + 1) if ts else t * 2
        results[path] = {"last_ok_t": last_ok, "first_oom_t": first_oom}
    return {"batch": batch, "j": j, "d": d, "s": s, "grad": grad, "t_cap": t_cap, **results}


SIM_WEIGHTS = ("w_x", "w_y", "w_xy")
CP_TABLE_DEVICES = 8      # the CP ranks of main's table, as the JAX probe's
CP_RANK_BYTES = 2 << 30   # main's allowance per CP rank: its CUDA context and its shard


def cp_inputs(t: int, batch: int, j: int, d: int) -> tuple:
    """The JAX table's inputs, as numpy: h [batch, 1, t, d] and q [batch, j, d]
    drawn N(0, 1) in that order from default_rng(0), all-true masks, and 0.1
    as each trilinear weight [d]."""
    rng = np.random.default_rng(0)
    h = rng.normal(0, 1, (batch, 1, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (batch, j, d)).astype(np.float32)
    return (h, np.ones((batch, 1, t), bool), q, np.ones((batch, j), bool),
            [np.full((d,), 0.1, np.float32) for _ in SIM_WEIGHTS])


def _bytes(arrays) -> int:
    """The bytes of numpy arrays or tensors."""
    return sum(a.nbytes for a in arrays)


def _mb(nbytes: int) -> float:
    return round(nbytes / 2**20, 2)


def counted_mb(t: int, batch: int, j: int, d: int, devices: int, grad: bool) -> dict:
    """{"local": ..., "cp": ...}, each {"argument_mb", "output_mb"}: the bytes
    of the tensors one device holds, unsharded and as one of `devices` CP
    ranks (its time shard of h and cm; dh too under grad), on cp_inputs. The
    output is the context [batch, d] forward, (dh, dq, the weights'
    gradients) under grad."""
    h, cm, q, qm, w = cp_inputs(t, batch, j, d)
    h_s, cm_s = (a[:, :, :t // devices] for a in (h, cm))
    out = (lambda hh: [hh, q, *w]) if grad else (lambda hh: [np.empty((batch, d), np.float32)])
    return {side: {"argument_mb": _mb(_bytes([hh, cc, q, qm, *w])),
                   "output_mb": _mb(_bytes(out(hh)))}
            for side, hh, cc in (("local", h, cm), ("cp", h_s, cm_s))}


def _temp_bytes(fn, args, device) -> tuple[list, int, int]:
    """(outputs of fn(*args), the peak bytes a call allocated on `device`
    beyond its arguments and outputs, and the same for the process's first
    call). The first call also allocates what stays for later calls (cuBLAS's
    workspace, under CUBLAS_WORKSPACE_CONFIG=:4096:8 32 MiB); the second call's
    peak is the attention's own."""
    temps = []
    for _ in range(2):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        outs = fn(*args)
        torch.cuda.synchronize(device)
        temps.append(torch.cuda.max_memory_allocated(device) - before - _bytes(outs))
    return outs, temps[1], temps[0]


def _attention_call(attention, grad: bool):
    """fn(h, cm, q, qm, *weights) → [context] (forward, no grad) or the
    gradients of the context's sum w.r.t. h, q and the weights."""
    def fn(h, cm, q, qm, *w):
        params = dict(zip(SIM_WEIGHTS, w))
        if not grad:
            with torch.no_grad():
                return [attention(h, cm, q, qm, params).context]
        with torch.enable_grad():
            leaves = [h.requires_grad_(), q.requires_grad_(), *(v.requires_grad_() for v in w)]
            return list(torch.autograd.grad(attention(h, cm, q, qm, params).context.sum(),
                                            leaves))
    return fn


def _device_args(t0: int, t1: int, inputs, device) -> list:
    """cp_inputs with h and cm cut to time steps [t0, t1), on `device`."""
    h, cm, q, qm, w = inputs
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (h[:, :, t0:t1], cm[:, :, t0:t1], q, qm, *w)]


def _cp_rank(t: int, batch: int, j: int, d: int, grad: bool) -> dict:
    """One CP rank of cp_memory_table (run by mesh.run_ranks): its time shard
    of the inputs on its card, fvta_attention_cp, its temp bytes; returns the
    ranks' largest temp and rank 0's counted bytes."""
    import torch.distributed as dist

    from fvta_memexqa_torch.parallel.cp import fvta_attention_cp

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    step = t // world
    args = _device_args(rank * step, (rank + 1) * step, cp_inputs(t, batch, j, d), dev)
    attention = lambda h, cm, q, qm, p: fvta_attention_cp(h, cm, q, qm, "trilinear", p)
    outs, temp, first = _temp_bytes(_attention_call(attention, grad), args, dev)
    temps = mesh.gather_objects((temp, first))
    return {"argument_mb": _mb(_bytes(args)), "output_mb": _mb(_bytes(outs)),
            "temp_mb": _mb(max(t for t, _ in temps)),
            "temp_mb_per_rank": [_mb(t) for t, _ in temps],
            "first_call_temp_mb": _mb(max(f for _, f in temps))}


def _rank_mesh(ranks: int) -> mesh.RankLayout:
    """`ranks` CP ranks, rank r on card r % cards (ranks share a card when
    there are fewer cards than ranks; gloo then carries the collectives
    through the host)."""
    cards = torch.cuda.device_count()
    return mesh.make_mesh(MeshConfig(context_parallel=ranks),
                          [f"cuda:{r % cards}" for r in range(ranks)])


def cp_memory_table(t: int = 65536, batch: int = 2, j: int = 30, d: int = 200,
                    devices: int = CP_TABLE_DEVICES, grad: bool = False, device="cuda") -> dict:
    """Per-device memory of the attention on cp_inputs: fvta_attention_cp
    unsharded (one rank, the whole context) vs context-parallel over `devices`
    ranks (each rank's time shard; t must divide by devices), forward or, with
    grad, the gradients w.r.t. h, q and the weights. Returns {"t", "devices",
    "grad", "local_per_device", "cp_per_device", "local_plain_per_device"},
    each {"argument_mb", "output_mb", "temp_mb", "first_call_temp_mb"} (see
    the module docstring), the CP side also each rank's temp, the plain side
    the plain path on the whole context in this process. Runs on a card only:
    a CPU `device` raises ValueError."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"cp_memory_table measures CUDA memory; got device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and no CUDA card is available")
    if t % devices:
        raise ValueError(f"t ({t}) must divide by devices ({devices})")
    dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    args = _device_args(0, t, cp_inputs(t, batch, j, d), dev)
    plain = lambda h, cm, q, qm, p: fvta_attention(h, cm, q, qm,
                                                   similarity_tensor(h, q, "trilinear", p))
    outs, temp, first = _temp_bytes(_attention_call(plain, grad), args, dev)
    local_plain = {"argument_mb": _mb(_bytes(args)), "output_mb": _mb(_bytes(outs)),
                   "temp_mb": _mb(temp), "first_call_temp_mb": _mb(first)}
    del args, outs
    local = mesh.run_ranks(_cp_rank, _rank_mesh(1), t, batch, j, d, grad)
    del local["temp_mb_per_rank"]
    cp = mesh.run_ranks(_cp_rank, _rank_mesh(devices), t, batch, j, d, grad)
    return {"t": t, "devices": devices, "grad": grad, "local_per_device": local,
            "cp_per_device": cp, "local_plain_per_device": local_plain}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fvta_memexqa_torch.capacity_probe")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--j", type=int, default=512,
                   help="question length; C [N,S,T,J] dominates the inputs when J >> D")
    p.add_argument("--d", type=int, default=200)
    p.add_argument("--s", type=int, default=8, help="sequences per example")
    p.add_argument("--t-start", type=int, default=1 << 14)
    p.add_argument("--t-cap", type=int, default=1 << 22)
    p.add_argument("--t-list", type=str, default=None,
                   help="comma-separated T probe points (ascending) instead of doubling")
    p.add_argument("--grad", action="store_true",
                   help="probe a full backward (training capacity) instead of the forward")
    p.add_argument("--cp-only", action="store_true", help="only the CP memory table")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    out = {}
    if not args.cp_only:
        t_list = [int(x) for x in args.t_list.split(",")] if args.t_list else None
        out["largest_t"] = probe_largest_t(batch=args.batch, j=args.j, d=args.d, s=args.s,
                                           t_start=args.t_start, t_cap=args.t_cap,
                                           grad=args.grad, t_list=t_list, device=args.device)
    if torch.device(args.device).type != "cuda":
        out["cp_memory"] = "skipped: the table measures CUDA memory (--device cuda)"
    elif torch.cuda.mem_get_info()[0] < CP_TABLE_DEVICES * CP_RANK_BYTES:
        out["cp_memory"] = (f"skipped: {CP_TABLE_DEVICES} ranks need "
                            f"{CP_TABLE_DEVICES * CP_RANK_BYTES >> 30} GiB of free card memory")
    else:
        out["cp_memory"] = cp_memory_table(grad=args.grad)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
