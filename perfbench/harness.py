"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, the result line.

Everything a cell needs is found by name: its entry in BENCHMARK.json, its
workload file perfbench/workloads/<cell>.json (the traffic kind, its
parameters, the check's limits), its configuration file (BENCHMARK.json's
`configs`), the traffic module perfbench/traffic/<kind>.py, and one reader
perfbench/metrics/<metric>.py per per-layer metric that BENCHMARK.json gives
the cell. `run_cell` takes the device, so the tests drive it on the CPU at a
small size; run.py refuses a machine without the cards the cell asks for.
"""

from __future__ import annotations

import copy
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"
BANNED = ("jax", "jaxlib", "flax", "optax", "fvta_memexqa_tpu")
CACHE_DIR = ROOT / ".perfbench_cache"


def set_cache_dirs() -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    program's own nvcc libraries already live in fvta_memexqa_torch/_build/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, overrides: dict | None = None) -> SimpleNamespace:
    """The cell's entry, workload file, configuration and metrics, by name.
    overrides: {"config": {...}, "params": {...}} merged in (tests shrink sizes)."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"perfbench/workloads/{name}.json names {spec['config']} / "
                         f"{spec['traffic']}, BENCHMARK.json {entry['config']} / "
                         f"{entry['traffic']}")
    conf = [c for c in manifest["configs"] if c["name"] == entry["config"]][0]
    cfg = load_json(ROOT / conf["file"])
    over = overrides or {}
    cfg = _merge(cfg, over.get("config", {}))
    params = _merge(spec["params"], over.get("params", {}))
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return SimpleNamespace(name=name, chips=entry["chips"], spec=spec, cfg=cfg, params=params,
                           end_to_end=e2e, per_layer=layer)


def load_reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counter(key: str) -> int:
    module, attr = key.split(":")
    return int(getattr(importlib.import_module(module), attr).launches)


def banned_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    """The card's name, power limit and SM clock as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def timed(drv, seconds: float) -> tuple[int, float]:
    """Steps until `seconds` have passed, then the device drained: (steps, s)."""
    drv.sync()
    start = time.perf_counter()
    n = 0
    while True:
        drv.step()
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    drv.sync()
    return n, time.perf_counter() - start


def new_run(cell, seed: int, device) -> SimpleNamespace:
    import torch

    return SimpleNamespace(seed=int(seed), device=torch.device(device), cfg=cell.cfg,
                           params=cell.params, d=SimpleNamespace(**cell.cfg["data"]),
                           m=SimpleNamespace(**cell.cfg["model"]))


def check(traffic, run, outputs, limits: dict) -> dict:
    """The reference's outputs, the numbers compared and each limit."""
    ref = traffic.reference(run)
    numbers = traffic.compare(outputs, ref)
    return {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in numbers.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, t0: float | None = None, log=None) -> dict:
    """One run; returns the result (the line run.py prints, once it has found
    neither JAX nor the JAX package loaded)."""
    import torch

    from perfbench.lib import trace as tracing

    t0 = time.perf_counter() if t0 is None else t0
    log = log or sys.stderr
    cell = load_cell(name, overrides)
    traffic = importlib.import_module(f"perfbench.traffic.{cell.spec['kind']}")
    readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer} if trace else {}
    run = new_run(cell, seed, device)
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_setup = time.perf_counter()
    drv = traffic.setup(run)
    drv.sync()
    t_warm = time.perf_counter()
    drv.warm()
    drv.sync()
    setup_s = time.perf_counter() - t0
    print(f"set-up: {t_setup - t0:.3f} s to the traffic, {t_warm - t_setup:.3f} s inputs, "
          f"weights and model, {time.perf_counter() - t_warm:.3f} s warm-up", file=log)
    units, window_s = timed(drv, seconds)
    print(f"window: {units} steps x {drv.unit} in {window_s:.4f} s; set-up {setup_s:.4f} s",
          file=log)
    metrics, extra = {}, {}
    if trace:
        keys = sorted({k for r in readers.values() for k in getattr(r, "COUNTERS", ())})
        before = {k: _counter(k) for k in keys}
        traced_units = int(cell.params["trace_units"])
        tr = tracing.profile(drv.step, traced_units, drv.sync, dev)
        ctx = SimpleNamespace(
            run=run, trace=tr, units=traced_units, off_units=units, off_seconds=window_s,
            unit=drv.unit, counters={k: _counter(k) - before[k] for k in keys},
            peaks=load_json(BENCH / "peaks.json").get(
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else "", None))
        print(f"trace: window {tr.window_s:.6f} s, device busy {tr.busy_s:.6f} s, "
              f"{len(tr.device_ops)} device operations, {tr.launches} launch calls over "
              f"{traced_units} units; counters {ctx.counters}", file=log)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_op_seconds(), "idle_gaps": tr.idle_gaps()}
    else:
        rate = cell.spec["rate_metric"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate:
                metrics[rate] = {"value": units * drv.unit / window_s, "unit": m["unit"]}
            else:
                raise SystemExit(f"{name} has no way to read end-to-end metric {m['name']}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0), **extra}
    if dev.type == "cuda":
        print(f"card: {card_line()}", file=log)
    outputs, failed = drv.outputs(), drv.failed()
    drv.release()
    del drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(traffic, run, outputs, cell.spec["limits"])
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=log)
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=log)
    return result
