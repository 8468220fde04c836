"""The optimizer chain of the JAX package (train.py `_optimizer_from_key`),
written as optax computes it:

    [MultiSteps(k)] ∘ clip_by_global_norm(c) → adam | adadelta → scale_by_learning_rate

- adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected moments
  (optax.scale_by_adam); adadelta: rho 0.9, eps 1e-6 (optax.scale_by_adadelta).
- clip: optax's formula, g if ‖g‖ < c else (g / ‖g‖) · c over the global norm
  of all gradients. `torch.nn.utils.clip_grad_norm_` scales by
  c / (‖g‖ + 1e-6) and is a different function.
- learning rate: a constant, or a schedule over optimizer steps (constant,
  cosine-to-0 or linear-to-0 over decay_steps, each after an optional linear
  warmup), evaluated at its own counter as optax.scale_by_schedule does.
- grad_accum > 1: optax.MultiSteps — a running mean of k micro-batch
  gradients, applied on the k-th; the parameters do not move in between.

The state is a plain dict of tensors (moments on the parameters' device,
integer counters as 0-d int64 tensors on the CPU, so reading them never waits
for the device); the checkpoint saves it as is. `convert.opt_state_from_optax`
carries an optax state across. Scalars (bias corrections, the schedule) are
computed on the host in float32, as optax does under jit (`advance`).

The moments are written into the tensors the state already holds, so a CUDA
graph of the step (train.StepGraph) replays onto the same state. A captured
step reads its scalars from `DeviceScalars`, which the caller fills from
`advance` before each replay.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fvta_memexqa_torch.config import TrainConfig

ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6

Params = dict[str, torch.Tensor]


def _f32(x) -> float:
    return float(np.float32(x))


def lr_at(tcfg: TrainConfig, count: int) -> float:
    """The learning rate at optimizer step `count` (optax's schedules: linear
    warmup 0 → lr, then constant, cosine_decay_schedule or linear_schedule to 0
    over decay_steps; join_schedules hands over at warmup_steps)."""
    lr, warm, decay = tcfg.learning_rate, tcfg.warmup_steps, tcfg.decay_steps
    if warm > 0 and count < warm:
        return _f32(lr * count / warm)
    c = count - warm if warm > 0 else count
    if tcfg.lr_schedule == "constant":
        return _f32(lr)
    c = min(c, decay)
    if tcfg.lr_schedule == "cosine":
        return _f32(lr * 0.5 * (1.0 + math.cos(math.pi * c / decay)))
    return _f32(lr * (1.0 - c / decay))                 # linear to 0


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """optax.clip_by_global_norm: g if ‖g‖ < max_norm else (g / ‖g‖) · max_norm,
    with ‖g‖ the norm over all tensors (no host sync: a select on the device)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    return {n: torch.where(keep, g, (g / g_norm) * max_norm) for n, g in grads.items()}


class Optimizer:
    """init(params) → state; update(params, grads, state) moves the parameters
    in place. `params` and `grads` are dicts keyed by parameter name, in the
    order that the global norm sums them."""

    def __init__(self, tcfg: TrainConfig):
        if tcfg.optimizer not in ("adam", "adadelta"):
            raise ValueError(f"unknown optimizer {tcfg.optimizer}")
        if tcfg.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r} "
                             "(expected constant | cosine | linear)")
        if tcfg.lr_schedule in ("cosine", "linear") and tcfg.decay_steps <= 0:
            raise ValueError(f"lr_schedule={tcfg.lr_schedule!r} needs decay_steps > 0 "
                             "(the horizon it decays over)")
        self.tcfg = tcfg
        # a plain constant keeps optax's state without a schedule counter
        self.scheduled = not (tcfg.lr_schedule == "constant" and tcfg.warmup_steps <= 0)

    def init(self, params: Params) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        count = lambda: torch.zeros((), dtype=torch.int64)
        state: dict = {}
        if self.tcfg.optimizer == "adam":
            state.update(count=count(), mu=zeros(), nu=zeros())
        else:
            state.update(e_g=zeros(), e_x=zeros())
        if self.scheduled:
            state["schedule_count"] = count()
        if self.tcfg.grad_accum > 1:
            state.update(mini_step=count(), gradient_step=count(), acc_grads=zeros())
        return state

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: dict,
               scalars: "DeviceScalars | None" = None) -> None:
        """scalars: a captured step's device scalars, which the caller fills from
        `advance` (the counters then move outside the graph); None: advance here."""
        k = self.tcfg.grad_accum
        if k > 1:
            mini = int(state["mini_step"])
            acc = state["acc_grads"]
            for name, g in grads.items():
                acc[name] = acc[name] + (g - acc[name]) / float(mini + 1)
            if mini != k - 1:
                state["mini_step"] = torch.tensor(mini + 1, dtype=torch.int64)
                return
            grads = acc
            state["acc_grads"] = {n: torch.zeros_like(a) for n, a in acc.items()}
            state["mini_step"] = torch.zeros((), dtype=torch.int64)
            state["gradient_step"] = state["gradient_step"] + 1
        updates = self._inner(grads, state, self.advance(state) if scalars is None
                              else scalars)
        for name, u in updates.items():
            params[name].add_(u)

    def advance(self, state: dict) -> dict[str, float]:
        """Move the step counters on and return this step's host scalars, in
        float32 as optax computes them under jit: Adam's bias corrections
        (bc1, bc2) and the learning-rate schedule's `step_size`."""
        t = self.tcfg
        out = {}
        if t.optimizer == "adam":
            c = int(state["count"]) + 1
            state["count"] = torch.tensor(c, dtype=torch.int64)
            out["bc1"] = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(c))
            out["bc2"] = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(c))
        if self.scheduled:
            sc = int(state["schedule_count"])
            out["step_size"] = _f32(-lr_at(t, sc))
            state["schedule_count"] = torch.tensor(sc + 1, dtype=torch.int64)
        else:
            out["step_size"] = -t.learning_rate
        return out

    def _inner(self, grads: Params, state: dict, s) -> Params:
        """The updates; s: `advance`'s host scalars, or DeviceScalars."""
        t = self.tcfg
        if t.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, t.grad_clip_norm)
        on_card = isinstance(s, DeviceScalars)
        updates = {}
        if t.optimizer == "adam":
            for n, g in grads.items():
                mu, nu = state["mu"][n], state["nu"][n]
                torch.add((1 - ADAM_B1) * g, ADAM_B1 * mu, out=mu)
                torch.add((1 - ADAM_B2) * (g * g), ADAM_B2 * nu, out=nu)
                mu_hat = mu * s.inv_bc1 if on_card else mu / s["bc1"]
                nu_hat = nu * s.inv_bc2 if on_card else nu / s["bc2"]
                updates[n] = mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS)
        else:
            for n, g in grads.items():
                e_g, e_x = state["e_g"][n], state["e_x"][n]
                torch.add((1 - ADADELTA_RHO) * (g * g), ADADELTA_RHO * e_g, out=e_g)
                u = (torch.sqrt(e_x + ADADELTA_EPS) / torch.sqrt(e_g + ADADELTA_EPS)) * g
                torch.add((1 - ADADELTA_RHO) * (u * u), ADADELTA_RHO * e_x, out=e_x)
                updates[n] = u
        step_size = s.step_size if on_card else s["step_size"]
        return {n: step_size * u for n, u in updates.items()}


class DeviceScalars:
    """A step's scalars as 0-d float32 tensors on the card, for a step captured
    in a CUDA graph: `fill` writes `Optimizer.advance`'s values before each
    replay, each a kernel argument of its fill (skipped where the tensor holds
    the value already: a constant learning rate, a converged bias
    correction). A bias correction is held as its float32 reciprocal, because
    CUDA's division of a tensor by a host scalar is the multiply by that
    reciprocal: the captured step keeps the eager step's bits."""

    def __init__(self, device):
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
        self.inv_bc1, self.inv_bc2, self.step_size = zero(), zero(), zero()
        self._held: dict[str, float] = {}

    def fill(self, host: dict[str, float]) -> None:
        values = {"step_size": float(np.float32(host["step_size"]))}
        if "bc1" in host:
            values.update(inv_bc1=float(np.float32(1) / np.float32(host["bc1"])),
                          inv_bc2=float(np.float32(1) / np.float32(host["bc2"])))
        for name, value in values.items():
            if self._held.get(name) != value:
                getattr(self, name).fill_(value)
                self._held[name] = value


def state_to(state: dict, device) -> dict:
    """A state dict with its floating tensors on `device` (counters stay on the
    CPU), for a state read back from a checkpoint."""
    if isinstance(state, dict):
        return {k: state_to(v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor) and state.is_floating_point():
        return state.to(device)
    return state
