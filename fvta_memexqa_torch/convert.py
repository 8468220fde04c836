"""Carry weights from the JAX package's flax parameter tree into the port, and
save/load the port's run directory.

`state_dict_from_flax` takes the tree as nested dicts / NamedTuples of numpy
arrays (what `jax.tree.map(np.asarray, params)` yields; the outer {"params": ...}
is optional) and returns the port's `state_dict`. Layout traps:

- flax `Dense.kernel` is [in, out]; `nn.Linear.weight` is [out, in] (transposed);
- `LSTMParams(wx [D, 4H], wh [H, 4H], b [4H])` keeps the TF1 i, j, f, o gate order;
- `conv_kernel` is the im2col [width * E, F] matrix, window-major, kept as is.

`opt_state_from_optax` does the same for the optimizer state of the JAX
package's chain (optax adam or adadelta, with clip, a schedule counter and
MultiSteps) into optim.py's dict.

A port run directory holds `config.json` (the JAX package's format) and
`params.pt` (the state_dict, tensors on the CPU). Reading an orbax run
directory needs JAX and is not done here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import atomic_torch_save
from fvta_memexqa_torch.config import MODALITIES, Config, load_config, save_config
from fvta_memexqa_torch.models.fvta import FVTAModel

_DENSE = ("photo_proj", "scorer")


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lstm_field(p, name: str):
    return getattr(p, name) if hasattr(p, name) else p[name]


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax FVTAModel params → FVTAModel.state_dict() of the port."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {
        "word_embed.oov_emb": _leaf(p["word_embed"]["oov_emb"]),
        "char_cnn.char_emb": _leaf(p["char_cnn"]["char_emb"]),
        "char_cnn.conv_kernel": _leaf(p["char_cnn"]["conv_kernel"]),
        "char_cnn.conv_bias": _leaf(p["char_cnn"]["conv_bias"]),
    }
    for name, layer in p["highway"].items():
        sd[f"highway.{name}.weight"] = _leaf(layer["kernel"]).T.contiguous()
        sd[f"highway.{name}.bias"] = _leaf(layer["bias"])
    for name in _DENSE:
        sd[f"{name}.weight"] = _leaf(p[name]["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = _leaf(p[name]["bias"])
    encoders = {"enc_word": "enc_word"}
    encoders.update({f"enc_{mod}": f"enc_time.{mod}" for mod in MODALITIES})
    for src, dst in encoders.items():
        for d in ("fw", "bw"):
            for field in ("wx", "wh", "b"):
                sd[f"{dst}.{d}_{field}"] = _leaf(_lstm_field(p[src][d], field))
    for name in ("sim_w_x", "sim_w_y", "sim_w_xy", "sim_w_bilinear"):
        if name in p:
            sd[name] = _leaf(p[name])
    return sd


def _count(x) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int64)


def opt_state_from_optax(opt_state) -> dict:
    """An optax state of the JAX package's optimizer chain (nested tuples and
    NamedTuples of numpy arrays, as `jax.tree.map(np.asarray, state)` yields)
    → optim.Optimizer's state dict. The states are told apart by their fields:
    ScaleByAdamState (count, mu, nu), ScaleByAdaDeltaState (e_g, e_x),
    ScaleByScheduleState (count), MultiStepsState (mini_step, gradient_step,
    inner_opt_state, acc_grads); clip and empty states carry nothing."""
    out: dict = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is None:
            if isinstance(node, (tuple, list)):
                for child in node:
                    walk(child)
            return
        if "mini_step" in fields:
            out.update(mini_step=_count(node.mini_step),
                       gradient_step=_count(node.gradient_step),
                       acc_grads=state_dict_from_flax(node.acc_grads))
            walk(node.inner_opt_state)
        elif {"mu", "nu"} <= set(fields):
            out.update(count=_count(node.count), mu=state_dict_from_flax(node.mu),
                       nu=state_dict_from_flax(node.nu))
        elif {"e_g", "e_x"} <= set(fields):
            out.update(e_g=state_dict_from_flax(node.e_g), e_x=state_dict_from_flax(node.e_x))
        elif tuple(fields) == ("count",):
            out["schedule_count"] = _count(node.count)

    walk(opt_state)
    return out


def model_from_flax(cfg: Config, params: dict) -> FVTAModel:
    """A port FVTAModel (on the CPU, eval mode) holding the flax weights."""
    model = FVTAModel(cfg)
    model.load_state_dict(state_dict_from_flax(params))
    return model.eval()


def save_rundir(rundir: str, cfg: Config, model: FVTAModel) -> None:
    """config.json + params.pt; params.pt is written to a temporary file and
    renamed, so a reader never sees half of it."""
    os.makedirs(rundir, exist_ok=True)
    save_config(cfg, os.path.join(rundir, "config.json"))
    atomic_torch_save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                      os.path.join(rundir, "params.pt"))


def load_rundir(rundir: str, device, cfg: Config | None = None) -> tuple[Config, FVTAModel]:
    """(cfg, model in eval mode on `device`). cfg overrides the saved config
    (serving passes the saved one with the pack's data config)."""
    cfg = cfg or load_config(os.path.join(rundir, "config.json"))
    model = FVTAModel(cfg)
    sd = torch.load(os.path.join(rundir, "params.pt"), map_location="cpu",
                    weights_only=True)
    model.load_state_dict(sd)
    return cfg, model.to(device).eval()
