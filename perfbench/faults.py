"""Faults planted under the timed path, for the check's tests and readings:
each is a context manager that breaks the program where the fault lives and
puts it back on leaving. `correct` has to come out false under each fault a
cell can have (FAULTS[kind])."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half(batch):
    """The first half of a batch's rows."""
    n = batch.ex_mask.shape[0] // 2
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:n]
                                         for f in dataclasses.fields(batch)})


@contextlib.contextmanager
def unchanged_state():
    """Every optimizer step leaves the parameters and the state as they were."""
    from fvta_memexqa_torch.optim import Optimizer

    with _patched(Optimizer, "update", lambda self, params, grads, state: None):
        yield


@contextlib.contextmanager
def half_batch_train():
    """The MemexQA train step sees the first half of each batch."""
    from fvta_memexqa_torch import train

    step = train.train_step
    with _patched(train, "train_step", lambda state, opt, shared, batch, *a, **k:
                  step(state, opt, shared, _half(batch), *a, **k)):
        yield


class _HalfBatches:
    def __init__(self, ds):
        self.ds = ds

    def get_batches(self, batch_size, **kw):
        for b in self.ds.get_batches(batch_size, **kw):
            yield _half(b)


@contextlib.contextmanager
def half_batch_eval():
    """Each eval batch is answered for its first half; the sums cover the rest."""
    from fvta_memexqa_torch import eval_cache

    evaluate = eval_cache.evaluate_cached
    with _patched(eval_cache, "evaluate_cached", lambda cfg, model, shared, ds, bs, **k:
                  evaluate(cfg, model, shared, _HalfBatches(ds), bs, **k)):
        yield


@contextlib.contextmanager
def altered_answer():
    """One question's first logit is moved by 1/8 where the model answers."""
    from fvta_memexqa_torch.models.fvta import FVTAModel

    answer = FVTAModel.answer

    def altered(self, *a, **k):
        out = answer(self, *a, **k)
        bump = torch.zeros_like(out.logits)
        bump[0, 0] = 0.125
        return out._replace(logits=out.logits + bump)

    with _patched(FVTAModel, "answer", altered):
        yield


FAULTS = {
    "memexqa_train": {"unchanged": unchanged_state, "half": half_batch_train},
    "memexqa_eval": {"half": half_batch_eval, "altered": altered_answer},
}
