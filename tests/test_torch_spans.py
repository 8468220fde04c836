"""The program's spans (`utils/metrics.span`) on the CPU: under torch.profiler a
train step fed through `train.on_device`, `evaluate_cached(cache=None)` and
`predict_cached` record every span of their layers, once each where the
program runs the layer once, nested as the calls nest and in the calls' order;
with no profiler running the helper is one shared no-op and records nothing;
and the spans appear whether the profiler is a context manager or is started
and stopped (as `train._ProfileWindow` runs it)."""

import contextlib
import itertools

import pytest
import torch

from fvta_memexqa_torch import eval_cache
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.data import SharedTables
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.optim import Optimizer
from fvta_memexqa_torch.utils import metrics

BS = 4
STEPS = 2
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def env(packed_synth, small_config):
    cfg = Config.from_json(small_config.to_json())
    return dict(cfg=cfg, packed=packed_synth,
                shared=SharedTables.from_packed(packed_synth.shared, "cpu"))


def run(env, case):
    """One call of the case's entry (two train steps); returns the batches it
    read."""
    cfg, packed, shared = env["cfg"], env["packed"], env["shared"]
    if case == "train":
        state = tr.init_state(cfg, "cpu", seed=0)
        opt = Optimizer(cfg.train)
        it = Dataset(packed, "train").get_batches(BS, shuffle=True, seed=0, epoch=0)
        with tr.on_device(it, lambda b: b.to("cpu"), 0) as batches:
            for batch in itertools.islice(batches, STEPS):
                tr.train_step(state, opt, shared, batch)
        return STEPS
    model = tr.init_state(cfg, "cpu", seed=0).model.eval()
    ds = Dataset(packed, "test")
    fn = eval_cache.evaluate_cached if case == "evaluate" else eval_cache.predict_cached
    fn(cfg, model, shared, ds, BS)
    return ds.num_batches(BS)


def span_tree(events) -> list:
    """The fvta.* ranges as nested (name, [children]) in call order; a range
    that overlaps a sibling without nesting fails."""
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.name.startswith("fvta.")), key=lambda s: (s[0], -s[1]))
    assert len({e.thread for e in events if e.name.startswith("fvta.")}) == 1
    root: list = []
    stack: list = [(float("-inf"), float("inf"), root)]
    for a, b, name in spans:
        while a >= stack[-1][1]:
            stack.pop()
        assert b <= stack[-1][1], f"{name} [{a}, {b}] straddles the end of its parent"
        children: list = []
        stack[-1][2].append((name, children))
        stack.append((a, b, children))
    return root


def expected(case, units) -> list:
    h2d, batch = ("fvta.loader.h2d", []), ("fvta.loader.batch", [])
    if case == "train":
        step = ("fvta.step", [("fvta.forward", []), ("fvta.backward", []),
                              ("fvta.optimizer", [])])
        return [batch, h2d, step] * units
    answers = [batch, ("fvta.eval.answer", [h2d])] * units
    return [("fvta.eval", [("fvta.eval.tables", []), ("fvta.eval.cache", []), *answers])]


@pytest.mark.parametrize("case", ["train", "evaluate", "predict"])
def test_spans_nest_and_count_as_the_calls(env, case):
    """Train: per step fvta.loader.batch, then fvta.loader.h2d, each closed
    before fvta.step opens, which holds fvta.forward, fvta.backward and
    fvta.optimizer once each in that order. Evaluation: fvta.eval holds the
    tables, the cache, then per batch fvta.loader.batch closed before its
    fvta.eval.answer, which holds the batch's fvta.loader.h2d."""
    with torch.profiler.profile(activities=CPU) as prof:
        units = run(env, case)
    assert units >= 2
    assert span_tree(prof.events()) == expected(case, units)


def test_span_without_a_profiler_is_one_shared_no_op(env, monkeypatch):
    opened = []

    def counted(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    no_op = metrics.span("fvta.step")
    assert isinstance(no_op, contextlib.nullcontext)
    assert all(metrics.span(n) is no_op for n in ("fvta.forward", "fvta.eval", "x"))
    for case in ("train", "evaluate"):
        run(env, case)
    assert opened == []
    with torch.profiler.profile(activities=CPU):
        run(env, "train")
    assert opened[:3] == ["fvta.loader.batch", "fvta.loader.h2d", "fvta.step"]


@pytest.mark.parametrize("case", ["train", "evaluate"])
def test_spans_under_a_started_and_stopped_profiler(env, case):
    prof = torch.profiler.profile(activities=CPU)
    prof.start()
    try:
        units = run(env, case)
    finally:
        prof.stop()
    assert span_tree(prof.events()) == expected(case, units)
