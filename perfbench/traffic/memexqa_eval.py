"""MemexQA checkpoint evaluation as `cli test` runs it per checkpoint: whole
`eval_cache.evaluate_cached` calls with cache=None (the per-checkpoint
vocabulary and photo tables, the album cache of every album row, then the
answers in eval batches), over a test split of seeded questions read through
the port's `data.pipeline.Dataset`, on seeded MemexQA-scale tables and weights.

One step is one whole evaluation, which ends in the host reading its sums.
The logits of every evaluation and the album cache of the last one are kept
for the check (the model's encode_context and answer, wrapped on the
instance to keep their outputs).

Parameters: eval_batch_size, questions, warm_evals.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from perfbench.lib import compare as cmp
from perfbench.lib import gen
from perfbench.reference import memexqa, plain
from perfbench.traffic import _common as c


def _split(run) -> dict:
    p = run.params
    arrays = gen.synth_batch(run.d, p["questions"], run.cfg["corpus"]["num_albums"],
                             gen.seed_for(run.seed, c.SPLIT))
    arrays["qid"] = np.array([f"q{i}" for i in range(p["questions"])])
    return arrays


def _tables(run) -> dict:
    corpus = run.cfg["corpus"]
    return gen.synth_shared(run.d, corpus["num_albums"], corpus["num_photos"],
                            gen.seed_for(run.seed, c.TABLES))


class EvalDriver:
    def __init__(self, run):
        from fvta_memexqa_torch import eval_cache
        from fvta_memexqa_torch.data.device_prepro import SharedTables
        from fvta_memexqa_torch.data.pipeline import Dataset
        from fvta_memexqa_torch.models.fvta import FVTAModel

        p, dev = run.params, run.device
        self.device, self.bs, self.warm_evals = dev, p["eval_batch_size"], p["warm_evals"]
        self.unit = p["questions"]
        self.cfg = c.program_config(run, eval_batch_size=self.bs)
        self.precision = plain.precision(False)
        self.precision.__enter__()
        self.shared = SharedTables(**c.to_device(_tables(run), dev))
        self.ds = Dataset(SimpleNamespace(splits={"test": _split(run)}), "test")
        model = FVTAModel(self.cfg).to(dev)
        c.load_weights(model, plain.make_weights(memexqa.param_spec(run.d, run.m),
                                                 gen.seed_for(run.seed, c.WEIGHTS), dev))
        self.model = model.eval()
        self.evaluate = eval_cache.evaluate_cached
        self.evals: list[tuple] = []
        self.encodes: list = []
        self.answers: list = []
        self.logits: list = []
        encode, answer = model.encode_context, model.answer

        def kept_encode(*a, **k):
            out = encode(*a, **k)
            self.encodes.append(out)
            return out

        def kept_answer(*a, **k):
            out = answer(*a, **k)
            self.answers.append(out.logits)
            return out

        model.encode_context, model.answer = kept_encode, kept_answer

    def step(self) -> None:
        self.encodes, self.answers = [], []
        m = self.evaluate(self.cfg, self.model, self.shared, self.ds, self.bs)
        self.evals.append((m["acc"], m["loss"], m["count"]))
        self.logits.append(self.answers)

    def warm(self) -> None:
        for _ in range(self.warm_evals):
            self.step()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self) -> dict:
        sizes = {sum(x.shape[0] for x in ans) for ans in self.logits}
        return {"cache_h": torch.cat([h for h, _ in self.encodes]) if self.encodes else None,
                "cache_m": torch.cat([m for _, m in self.encodes]) if self.encodes else None,
                "logits": (torch.stack([torch.cat(ans) for ans in self.logits])
                           if len(sizes) == 1 else None)}

    def failed(self) -> int:
        """Evaluations whose loss was not finite or that missed questions."""
        return sum(1 for acc, loss, count in self.evals
                   if not np.isfinite(loss) or count != self.unit)

    def release(self) -> None:
        self.precision.__exit__(None, None, None)
        self.model = self.shared = self.ds = None
        self.encodes, self.answers, self.logits = [], [], []


def setup(run) -> EvalDriver:
    return EvalDriver(run)


def reference(run, tf32: bool = False) -> dict:
    dev, d, m = run.device, run.d, run.m
    split = _split(run)
    del split["qid"]
    split = c.to_device(split, dev)
    shared = c.to_device(_tables(run), dev)
    with plain.precision(tf32):
        prm = plain.make_weights(memexqa.param_spec(d, m), gen.seed_for(run.seed, c.WEIGHTS), dev)
        vt, cache_h, cache_m = memexqa.album_cache(prm, shared, d, m)
        logits = memexqa.cached_logits(prm, split, vt, cache_h, cache_m, m,
                                       run.params["eval_batch_size"])
    return {"cache_h": cache_h, "cache_m": cache_m, "logits": logits}


compare = cmp.eval_numbers
