"""Device-idle time inside the program's spans, per unit of work.

The program marks its layers with torch.profiler ranges
(fvta_memexqa_torch/utils/metrics.span), which land in the traced window on
the main thread, on the clock of the card's operations. A span metric is the
part of the window in which the device ran nothing (the window less
lib/trace.Trace.busy) that falls inside the union of the named spans'
intervals on the main thread, less the union of the `minus` spans, in ms per
unit: |(window - busy) & (U spans - U minus)| / units.

Nested or repeated spans of one name are counted once. A metric is None where
the trace holds no device operation (a run on the CPU) or no span of its
names (a program without them).
"""

from __future__ import annotations

from perfbench.lib.trace import _union

LOADER = ("fvta.loader.batch", "fvta.loader.h2d")
FORWARD = ("fvta.forward",)
BACKWARD = ("fvta.backward",)
OPTIMIZER = ("fvta.optimizer",)
CACHE = ("fvta.eval.tables", "fvta.eval.cache")
ANSWER = ("fvta.eval.answer",)


def named(trace, names) -> list[tuple[float, float]]:
    """The union of the main thread's ranges whose name is in `names` (us)."""
    return _union([(a, b) for a, b, n in trace.host if n in names])


def idle(trace) -> list[tuple[float, float]]:
    """The window's stretches in which no device operation ran (us)."""
    out, t = [], trace.w0
    for a, b in trace.busy:
        if a > t:
            out.append((t, min(a, trace.w1)))
        t = max(t, b)
    if t < trace.w1:
        out.append((t, trace.w1))
    return out


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted unions of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(xs, ys) -> list[tuple[float, float]]:
    """xs less ys, both sorted unions of intervals."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def idle_ms_per_unit(ctx, names, minus=()) -> float | None:
    """Device-idle ms per unit inside the `names` spans less the `minus` spans."""
    tr = ctx.trace
    spans = named(tr, names)
    if not tr.busy or not spans:
        return None
    if minus:
        spans = subtract(spans, named(tr, minus))
    return overlap(idle(tr), spans) * 1e-3 / ctx.units
