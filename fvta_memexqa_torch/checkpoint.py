"""Torch-native checkpoints: latest-N, best-on-val, exact resume.

The JAX package's checkpoint.py (orbax) keeps two directories, and so does
this one:

    <run>/config.json
    <run>/ckpts/step_<N>.pt      the latest `max_to_keep` checkpoints
    <run>/best/step_<N>.pt       the best on val_acc (one), with best/best.json

A checkpoint holds the parameters, the optimizer state (optim.py's dict), the
step and the dropout generator's state, all on the CPU, so a killed run
restores and continues bit-identically. Every write goes to a temporary file
in the same directory first and is then renamed over the target
(`os.replace`), so a reader never sees half a file. `restore(best=True)` falls
back to the latest checkpoint when no validation metric was ever recorded.
"""

from __future__ import annotations

import json
import os
import re

import torch

from fvta_memexqa_torch.config import Config, load_config, save_config
from fvta_memexqa_torch.optim import state_to

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def atomic_torch_save(obj, path: str) -> None:
    """torch.save to a temporary file beside `path`, then rename it over `path`."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_write_text(text: str, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _STEP_FILE.match(f)))


class CheckpointManager:
    """Latest-N checkpoints in ckpts/ plus the best-on-val one in best/."""

    def __init__(self, directory: str, cfg: Config | None = None, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.ckpt_dir = os.path.join(self.directory, "ckpts")
        self.best_dir = os.path.join(self.directory, "best")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.best_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        cfg_path = os.path.join(self.directory, "config.json")
        if cfg is not None:
            save_config(cfg, cfg_path)
            self.cfg = cfg
        elif os.path.exists(cfg_path):
            self.cfg = load_config(cfg_path)
        else:
            self.cfg = None

    def save(self, step: int, state, val_acc: float | None = None) -> None:
        """Checkpoint a train.TrainState (on the CPU) as `step`; with a val_acc
        it also becomes the best one if no earlier one scored higher."""
        payload = {"step": int(state.step),
                   "params": _cpu(dict(state.model.state_dict())),
                   "opt_state": _cpu(state.opt_state),
                   "rng": state.generator.get_state(),
                   "val_acc": None if val_acc is None else float(val_acc)}
        atomic_torch_save(payload, os.path.join(self.ckpt_dir, f"step_{step}.pt"))
        for old in _steps(self.ckpt_dir)[:-self.max_to_keep]:
            os.remove(os.path.join(self.ckpt_dir, f"step_{old}.pt"))
        if val_acc is None:
            return
        best = self._best_record()
        # ties go to the newer checkpoint, as orbax's best-N ordering keeps it
        if best is not None and float(val_acc) < best["val_acc"]:
            return
        atomic_torch_save(payload, os.path.join(self.best_dir, f"step_{step}.pt"))
        _atomic_write_text(json.dumps({"step": step, "val_acc": float(val_acc)}),
                           os.path.join(self.best_dir, "best.json"))
        for old in _steps(self.best_dir):
            if old != step:
                os.remove(os.path.join(self.best_dir, f"step_{old}.pt"))

    def _best_record(self) -> dict | None:
        path = os.path.join(self.best_dir, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        steps = _steps(self.ckpt_dir)
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        rec = self._best_record()
        return None if rec is None else int(rec["step"])

    def load(self, step: int | None = None, best: bool = False) -> dict:
        """The checkpoint payload of `step` (default: latest; best=True →
        best-on-val, falling back to the latest when none was recorded)."""
        if step is None and best:
            bstep = self.best_step()
            if bstep is not None:
                return torch.load(os.path.join(self.best_dir, f"step_{bstep}.pt"),
                                  map_location="cpu", weights_only=True)
            print(f"checkpoint: no best-on-val metric recorded in {self.directory}; "
                  "restoring the LATEST checkpoint instead", flush=True)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.ckpt_dir, f"step_{step}.pt"),
                          map_location="cpu", weights_only=True)

    def restore(self, state, step: int | None = None, best: bool = False):
        """Load a checkpoint into a train.TrainState in place (parameters copied
        into the model, optimizer state moved to its device, step and dropout
        generator restored) and return it."""
        ck = self.load(step, best)
        state.model.load_state_dict(ck["params"])
        device = next(state.model.parameters()).device
        state.opt_state = state_to(ck["opt_state"], device)
        state.step = int(ck["step"])
        state.generator.set_state(ck["rng"])
        return state
