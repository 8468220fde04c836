"""What the kinds of traffic share: seed streams, the program's Config from a
configuration file, the training driver and its reference."""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from perfbench.lib import compare, gen
from perfbench.reference import plain

# independent seed streams of one run (lib/gen.seed_for)
WEIGHTS, TABLES, SPLIT, DROPOUT, ORDER = range(5)


def program_config(run, **train):
    """The program's Config from the configuration file's sections (train
    settings as the workload gives them)."""
    from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    c = run.cfg
    return Config(data=DataConfig(**c["data"]), model=ModelConfig(**c["model"]),
                  train=TrainConfig(**{**c["train"], **train}))


def to_device(arrays: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def load_weights(model, weights: dict) -> None:
    """Copy the benchmark's weights into the program's model (every leaf)."""
    missing, unexpected = model.load_state_dict(weights, strict=True)
    if missing or unexpected:
        raise RuntimeError(f"weights do not fit the model: {missing} {unexpected}")


class TrainDriver:
    """Drives a program train step, `step_fn(batch) -> {"loss", ...}`, on the
    batches an iterator delivers. warm() runs the checked steps (the first
    `checked`, whose losses, first gradient and parameter change are compared
    with the reference) and `extra` more, then the window continues the same
    object and stream."""

    def __init__(self, state, step_fn, batches, unit: int, weights: dict, checked: int,
                 extra: int, device, contexts):
        self.state, self.step_fn, self.batches = state, step_fn, batches
        self.unit, self.weights, self.checked, self.extra = unit, weights, checked, extra
        self.device = torch.device(device)
        self.stack = contextlib.ExitStack()
        for c in contexts:
            self.stack.enter_context(c)
        self.losses: list[torch.Tensor] = []
        self.grad1 = self.params = None

    def step(self) -> None:
        self.losses.append(self.step_fn(next(self.batches))["loss"])

    def warm(self) -> None:
        from fvta_memexqa_torch.optim import ADAM_B1

        for i in range(self.checked + self.extra):
            t = time.perf_counter()
            self.step()
            self.sync()
            print(f"warm-up step {i + 1}: {time.perf_counter() - t:.3f} s", file=sys.stderr)
            if i == 0:   # Adam's first moment holds (1 - b1) x the gradient it got
                self.grad1 = {n: mu / (1 - ADAM_B1) for n, mu in
                              self.state.opt_state["mu"].items()}
            if i == self.checked - 1:
                self.params = {n: p.detach().clone() for n, p in
                               self.state.model.named_parameters()}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def outputs(self) -> dict:
        return {"losses": [float(x) for x in self.losses[:self.checked]],
                "grad1": self.grad1,
                "delta3": {n: p - self.weights[n] for n, p in self.params.items()}}

    def failed(self) -> int:
        """Steps whose loss was not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        self.stack.close()
        self.state = self.step_fn = self.batches = None
        self.losses = []


def train_reference(spec, loss_fn, batches, seed: int, device, lr: float, clip: float,
                    tf32: bool) -> dict:
    """The reference's first len(batches) steps from the seed's weights and
    dropout stream: {"losses", "grad1" (clipped, as Adam got it), "delta3",
    "grad_max" (each entry's largest |clipped gradient| over the steps)}."""
    with plain.precision(tf32):
        w0 = plain.make_weights(spec, gen.seed_for(seed, WEIGHTS), device)
        p = {n: w.clone().requires_grad_() for n, w in w0.items()}
        g = torch.Generator(device=device).manual_seed(gen.seed_for(seed, DROPOUT))
        state: dict = {}
        losses, grad1, grad_max = [], None, None
        for batch in batches:
            loss = loss_fn(p, batch, g)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            grads = {n: torch.zeros_like(v) if gr is None else gr
                     for (n, v), gr in zip(p.items(), grads)}
            clipped = plain.adam_step(p, grads, state, lr, clip)
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {n: v.detach() for n, v in clipped.items()}
                grad_max = {n: v.detach().abs() for n, v in clipped.items()}
            else:
                grad_max = {n: torch.maximum(grad_max[n], v.detach().abs())
                            for n, v in clipped.items()}
        return {"losses": losses, "grad1": grad1, "grad_max": grad_max,
                "delta3": {n: p[n].detach() - w0[n] for n in p}}


def train_compare(prog: dict, ref: dict) -> dict:
    numbers, worst = compare._numbers(prog, ref)
    print(f"worst leaves: {worst}", file=sys.stderr)
    return numbers
