"""What the per-layer metric readers (perfbench/metrics/<metric>.py) share.

Each reader gets the traced run's context: `trace` (lib/trace.Trace of the
profiled units), `units` (how many), `off_units` and `off_seconds` (the
profiler-off window before it), `counters` (the program's launch counters
over the profiled units), `peaks` (this card's row of perfbench/peaks.json,
None for a card not in it) and `run` (sizes and parameters). A reader that
finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

import sys

from perfbench.lib import costs


def launches_per_unit(ctx) -> float | None:
    """Host calls that enqueue device work, per unit of work."""
    return ctx.trace.launches / ctx.units if ctx.trace.launches else None


def device_idle(ctx) -> float | None:
    """Percent of the profiled window in which no operation ran on the device."""
    busy, window = ctx.trace.busy_s, ctx.trace.window_s
    if busy <= 0 or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)


def mfu(ctx, flops_per_unit: float) -> float | None:
    """Percent of the card's float32 peak that the unit's counted FLOPs reach
    over the profiler-off window's time."""
    if ctx.peaks is None or ctx.off_seconds <= 0:
        return None
    return 100.0 * flops_per_unit * ctx.off_units / ctx.off_seconds / ctx.peaks["fp32_flops_per_s"]


def roofline(ctx, name: str, kernels, work_per_unit, calls_per_unit: dict) -> float | None:
    """Percent of the named kernels' profiled device time that the least time
    of their calls takes (each call max(FLOPs / peak, bytes / peak)).
    calls_per_unit: {counter: launches a unit must count}; a count that
    differs means the call structure changed, and the frozen work no longer
    describes it."""
    if ctx.peaks is None:
        return None
    for key, want in calls_per_unit.items():
        if ctx.counters.get(key) != want * ctx.units:
            print(f"{name}: {key} counted {ctx.counters.get(key)} launches over {ctx.units} "
                  f"units, the frozen work has {want} a unit: not read", file=sys.stderr)
            return None
    spent = ctx.trace.kernel_s(kernels)
    if spent <= 0:
        return None
    least, bound = costs.least_seconds(work_per_unit, ctx.peaks["fp32_flops_per_s"],
                                       ctx.peaks["hbm_bytes_per_s"])
    print(f"{name}: least {least * ctx.units:.6e} s of {spent:.6e} s device time, "
          f"bound by {bound}", file=sys.stderr)
    return 100.0 * least * ctx.units / spent
