"""Capacity probe: the largest context length T each attention path runs on one
card, forward or with grad.

The port of fvta_memexqa_tpu/capacity_probe.py:34-140 (`cp_memory_table`, the
context-parallel memory table, waits for the data- and context-parallel slice).
Two paths of the FVTA attention:

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

    python -m fvta_memexqa_torch.capacity_probe [--grad] [--t-list 16384,24576]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fvta_memexqa_torch.ops.fvta_fused import fvta_attention_fused
from fvta_memexqa_torch.ops.fvta_ref import fvta_attention, similarity_tensor

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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    t_list = [int(x) for x in args.t_list.split(",")] if args.t_list else None
    out = probe_largest_t(batch=args.batch, j=args.j, d=args.d, s=args.s,
                          t_start=args.t_start, t_cap=args.t_cap, grad=args.grad,
                          t_list=t_list, device=args.device)
    print(json.dumps({"largest_t": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
