"""MemexQA training as `cli train` runs it: `train.train_step` (forward,
backward, Adam; dropout on; torch's deterministic algorithms) on batches the
port's loader delivers (`data.pipeline.Dataset` shuffled per (seed, epoch), each
moved to the device inline through `train.on_device`), over a train split of
seeded questions on seeded MemexQA-scale tables.

Parameters: batch_size, train_questions, checked_steps, warm_steps.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import torch

from perfbench.lib import gen
from perfbench.reference import memexqa, plain
from perfbench.traffic import _common as c


def _split(run) -> dict:
    p, d = run.params, run.d
    arrays = gen.synth_batch(d, p["train_questions"], run.cfg["corpus"]["num_albums"],
                             gen.seed_for(run.seed, c.SPLIT))
    arrays["qid"] = [f"q{i}" for i in range(p["train_questions"])]
    return arrays


def _tables(run) -> dict:
    corpus = run.cfg["corpus"]
    return gen.synth_shared(run.d, corpus["num_albums"], corpus["num_photos"],
                            gen.seed_for(run.seed, c.TABLES))


def setup(run) -> c.TrainDriver:
    from fvta_memexqa_torch import train as ftrain
    from fvta_memexqa_torch.data.device_prepro import SharedTables
    from fvta_memexqa_torch.data.pipeline import Dataset
    from fvta_memexqa_torch.models.fvta import FVTAModel
    from fvta_memexqa_torch.optim import Optimizer

    p, dev = run.params, run.device
    bs = p["batch_size"]
    cfg = c.program_config(run, batch_size=bs)
    contexts = [ftrain.deterministic_algorithms(dev), plain.precision(False)]
    shared = SharedTables(**c.to_device(_tables(run), dev))
    ds = Dataset(SimpleNamespace(splits={"train": _split(run)}), "train")
    weights = plain.make_weights(memexqa.param_spec(run.d, run.m),
                                 gen.seed_for(run.seed, c.WEIGHTS), dev)
    model = FVTAModel(cfg).to(dev)
    c.load_weights(model, weights)
    state = ftrain.TrainState(
        model=model, opt_state=Optimizer(cfg.train).init(dict(model.named_parameters())),
        step=0, generator=torch.Generator(device=dev).manual_seed(
            gen.seed_for(run.seed, c.DROPOUT)))
    opt = Optimizer(cfg.train)
    order_seed = gen.seed_for(run.seed, c.ORDER)
    train_step = ftrain.train_step

    def batches():
        for epoch in itertools.count():
            it = ds.get_batches(bs, shuffle=True, seed=order_seed, epoch=epoch)
            with ftrain.on_device(it, lambda b: (b.to(dev), None), 0) as on_dev:
                yield from on_dev

    return c.TrainDriver(state, lambda b: train_step(state, opt, shared, *b), batches(), bs,
                         weights, p["checked_steps"], p["warm_steps"], dev, contexts)


def reference(run, tf32: bool = False) -> dict:
    p, dev, d, m = run.params, run.device, run.d, run.m
    bs, n = p["batch_size"], p["train_questions"]
    split, shared = _split(run), c.to_device(_tables(run), dev)
    order = gen.split_order(n, gen.seed_for(run.seed, c.ORDER), 0)
    keys = ("q_words", "q_mask", "choice_words", "choice_mask", "album_idx", "album_mask",
            "label", "ex_mask")
    batches = [{k: torch.from_numpy(split[k][order[i * bs:(i + 1) * bs]]).to(dev) for k in keys}
               for i in range(p["checked_steps"])]
    t = run.cfg["train"]
    return c.train_reference(memexqa.param_spec(d, m),
                             lambda prm, b, g: memexqa.train_loss(prm, shared, b, d, m, g),
                             batches, run.seed, dev, t["learning_rate"], t["grad_clip_norm"],
                             tf32)


compare = c.train_compare
