"""lib/spans.py on hand-made chrome-trace events read through lib/trace.Trace:
the device-idle time inside the program's spans, per unit of work."""

import random
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.lib import spans
from perfbench.lib.trace import WINDOW, Trace

MAIN = dict(pid=1, tid=1)
CELLS = ["memexqa-train-b256", "memexqa-eval-b256"]


def window(t0, t1):
    return {"ph": "X", "name": WINDOW, "cat": "user_annotation", "ts": t0, "dur": t1 - t0,
            **MAIN}


def span(name, a, b, **where):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": a, "dur": b - a,
            **(where or MAIN)}


def kernel(a, b):
    return {"ph": "X", "name": "k", "cat": "kernel", "ts": a, "dur": b - a, "pid": 0, "tid": 7}


def ctx(events, units=1):
    return SimpleNamespace(trace=Trace(events), units=units)


def test_idle_inside_one_span_is_the_hand_computed_intervals():
    # window [0, 1000] us; device busy [100, 200] and [400, 450]
    base = [window(0, 1000), kernel(100, 200), kernel(400, 450)]
    # idle inside [50, 500]: [50, 100] + [200, 400] + [450, 500] = 300 us
    c = ctx(base + [span("fvta.forward", 50, 500)])
    assert spans.idle_ms_per_unit(c, spans.FORWARD) == pytest.approx(0.3)
    # over 3 units, per unit
    c = ctx(base + [span("fvta.forward", 50, 500)], units=3)
    assert spans.idle_ms_per_unit(c, spans.FORWARD) == pytest.approx(0.1)
    # a span that straddles a device operation counts only its idle part
    c = ctx(base + [span("fvta.backward", 150, 300)])
    assert spans.idle_ms_per_unit(c, spans.BACKWARD) == pytest.approx(0.1)
    # a span wholly under a device operation reads 0, not None
    c = ctx(base + [span("fvta.optimizer", 120, 180)])
    assert spans.idle_ms_per_unit(c, spans.OPTIMIZER) == 0.0


def test_nested_and_repeated_spans_count_once():
    base = [window(0, 1000), kernel(100, 200)]
    one = ctx(base + [span("fvta.loader.batch", 0, 300)])
    many = ctx(base + [span("fvta.loader.batch", 0, 300), span("fvta.loader.batch", 20, 250),
                       span("fvta.loader.h2d", 40, 300), span("fvta.loader.h2d", 50, 60)])
    assert spans.idle_ms_per_unit(one, spans.LOADER) == pytest.approx(0.2)
    assert spans.idle_ms_per_unit(many, spans.LOADER) == pytest.approx(0.2)


def test_minus_spans_and_other_threads():
    base = [window(0, 1000), kernel(500, 600)]
    c = ctx(base + [span("fvta.eval.answer", 100, 700), span("fvta.loader.h2d", 100, 200),
                    span("fvta.loader.h2d", 650, 800),
                    span("fvta.eval.answer", 0, 900, pid=1, tid=2)])
    # [100, 700] less h2d [100, 200] and [650, 800], less busy [500, 600]: 300 + 50 us;
    # the range on another thread is not read
    assert spans.idle_ms_per_unit(c, spans.ANSWER, minus=spans.LOADER) == pytest.approx(0.35)


def test_none_without_a_device_operation_or_a_span_of_the_name():
    assert spans.idle_ms_per_unit(ctx([window(0, 100), span("fvta.forward", 0, 50)]),
                                  spans.FORWARD) is None
    c = ctx([window(0, 100), kernel(10, 20), span("fvta.forward", 0, 50)])
    assert spans.idle_ms_per_unit(c, spans.BACKWARD) is None
    assert spans.idle_ms_per_unit(c, spans.FORWARD) == pytest.approx(0.04)


@pytest.mark.parametrize("xs,ys", [([(0, 10), (20, 30)], [(5, 25)]),
                                   ([(0, 10)], [(0, 10)]),
                                   ([(0, 10), (12, 14)], [(2, 3), (4, 5), (13, 20)]),
                                   ([(0, 5)], [])])
def test_subtract_and_overlap_agree_with_a_grid(xs, ys):
    grid = [t + 0.5 for t in range(40)]
    inside = lambda ivs, t: any(a <= t < b for a, b in ivs)
    got = spans.subtract(xs, ys)
    assert [t for t in grid if inside(got, t)] == [t for t in grid
                                                   if inside(xs, t) and not inside(ys, t)]
    assert spans.overlap(xs, ys) == sum(inside(xs, t) and inside(ys, t) for t in grid)


def program_trace(cell, rng, units):
    """A window of `units` steps or evaluations laid out as the program calls
    its spans, with device operations at random."""
    ev, t = [], 0.0

    def add(name, length):
        nonlocal t
        a = t + rng.uniform(0, 5)
        t = a + length
        ev.append(span(name, a, t))

    def parent(name, children):
        nonlocal t
        a = t + rng.uniform(0, 5)
        t = a
        children()
        t += rng.uniform(0, 5)
        ev.append(span(name, a, t))

    for _ in range(units):
        if cell == "memexqa-train-b256":
            add("fvta.loader.batch", rng.uniform(1, 50))
            add("fvta.loader.h2d", rng.uniform(1, 50))
            parent("fvta.step", lambda: [add(n, rng.uniform(1, 200)) for n in
                                         ("fvta.forward", "fvta.backward", "fvta.optimizer")])
        else:
            def batches():
                add("fvta.eval.tables", rng.uniform(1, 50))
                add("fvta.eval.cache", rng.uniform(1, 200))
                for _ in range(rng.randint(1, 4)):
                    add("fvta.loader.batch", rng.uniform(1, 50))
                    parent("fvta.eval.answer",
                           lambda: add("fvta.loader.h2d", rng.uniform(1, 50)))
            parent("fvta.eval", batches)
    t1 = t + rng.uniform(0, 20)
    for _ in range(rng.randint(1, 60)):
        a = rng.uniform(0, t1)
        ev.append(kernel(a, min(a + rng.uniform(0, 80), t1)))
    return [window(0.0, t1)] + ev


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_span_metrics_never_exceed_the_windows_idle_time(cell, seed):
    """The cell's span readers partition the idle time inside the spans they
    read: their sum times the units is that idle time, at most the window's."""
    rng = random.Random(seed)
    units = rng.randint(1, 5)
    c = ctx(program_trace(cell, rng, units), units)
    readers = [m["name"] for m in harness.load_cell(cell).per_layer
               if m["source"] == "program_span"]
    assert len(readers) == (4 if cell == CELLS[0] else 3)
    values = [harness.load_reader(n).read(c) for n in readers]
    assert all(v is not None and v >= 0 for v in values)
    idle_us = sum(b - a for a, b in spans.idle(c.trace))
    read = spans.named(c.trace, spans.LOADER + spans.FORWARD + spans.BACKWARD
                       + spans.OPTIMIZER + spans.CACHE + spans.ANSWER)
    inside_us = spans.overlap(spans.idle(c.trace), read)
    assert sum(values) * units * 1e3 == pytest.approx(inside_us, rel=1e-9, abs=1e-6)
    assert sum(values) * units * 1e3 <= idle_us + 1e-6
    assert idle_us == pytest.approx((c.trace.window_s - c.trace.busy_s) * 1e6)
