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

`video_state_dict_from_flax` does the same for the video model
(models/video.VideoFVTAModel); a flax `Conv` kernel [k, in, out] becomes
`Conv1d.weight` [out, in, k]. A video run directory holds `config.json`,
`video_run.json` (task, encoder, num_choices, num_answers, max_frames) and
`params.pt`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import atomic_torch_save
from fvta_memexqa_torch.config import MODALITIES, Config, load_config, save_config
from fvta_memexqa_torch.models.fvta import FVTAModel
from fvta_memexqa_torch.models.video import VideoFVTAModel
from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

_DENSE = ("photo_proj", "scorer")


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lstm_field(p, name: str):
    return getattr(p, name) if hasattr(p, name) else p[name]


def lstm_params_from_jax(p) -> LSTMParams:
    """The JAX package's LSTMParams (or a {"wx", "wh", "b"} dict) of numpy or
    jax arrays → the port's LSTMParams of float32 CPU tensors."""
    return LSTMParams(*(_leaf(_lstm_field(p, f)) for f in ("wx", "wh", "b")))


def _dense(sd: dict, dst: str, layer) -> None:
    sd[f"{dst}.weight"] = _leaf(layer["kernel"]).T.contiguous()
    sd[f"{dst}.bias"] = _leaf(layer["bias"])


def _bilstm(sd: dict, dst: str, layer) -> None:
    for d in ("fw", "bw"):
        for field in ("wx", "wh", "b"):
            sd[f"{dst}.{d}_{field}"] = _leaf(_lstm_field(layer[d], field))


def _embed_and_sim(p) -> dict[str, torch.Tensor]:
    """The embedding (word, char-CNN, highway) and similarity parameters both
    models share."""
    sd: dict[str, torch.Tensor] = {
        "word_embed.oov_emb": _leaf(p["word_embed"]["oov_emb"]),
        "char_cnn.char_emb": _leaf(p["char_cnn"]["char_emb"]),
        "char_cnn.conv_kernel": _leaf(p["char_cnn"]["conv_kernel"]),
        "char_cnn.conv_bias": _leaf(p["char_cnn"]["conv_bias"]),
    }
    for name, layer in p["highway"].items():
        _dense(sd, f"highway.{name}", layer)
    for name in ("sim_w_x", "sim_w_y", "sim_w_xy", "sim_w_bilinear"):
        if name in p:
            sd[name] = _leaf(p[name])
    _bilstm(sd, "enc_word", p["enc_word"])
    return sd


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax FVTAModel params → FVTAModel.state_dict() of the port."""
    p = params.get("params", params)
    sd = _embed_and_sim(p)
    for name in _DENSE:
        _dense(sd, name, p[name])
    for mod in MODALITIES:
        _bilstm(sd, f"enc_time.{mod}", p[f"enc_{mod}"])
    return sd


_VIDEO_DENSE = ("scorer", "count_head", "count_frame", "count_qproj", "frameqa_head",
                "frame_proj")


def video_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax VideoFVTAModel params → VideoFVTAModel.state_dict() of the port."""
    p = params.get("params", params)
    sd = _embed_and_sim(p)
    for name in _VIDEO_DENSE:
        if name in p:
            _dense(sd, name, p[name])
    enc = p["enc_frames"]
    if "fw" in enc:
        _bilstm(sd, "enc_frames", enc)
    else:
        _dense(sd, "enc_frames.in_proj", enc["in_proj"])
        for name, layer in enc.items():
            if name.startswith("conv"):
                # flax Conv kernel [k, in, out] → Conv1d weight [out, in, k]
                sd[f"enc_frames.{name}.weight"] = _leaf(layer["kernel"]).permute(2, 1, 0).contiguous()
                sd[f"enc_frames.{name}.bias"] = _leaf(layer["bias"])
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


def save_rundir(rundir: str, cfg: Config, model: torch.nn.Module) -> None:
    """config.json + params.pt; params.pt is written to a temporary file and
    renamed, so a reader never sees half of it."""
    os.makedirs(rundir, exist_ok=True)
    save_config(cfg, os.path.join(rundir, "config.json"))
    atomic_torch_save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                      os.path.join(rundir, "params.pt"))


VIDEO_RUN = "video_run.json"


def save_video_rundir(rundir: str, cfg: Config, model, run: dict) -> None:
    """A video run directory: config.json, video_run.json (`run`, which names
    the task, encoder, num_choices, num_answers and max_frames) and params.pt."""
    save_rundir(rundir, cfg, model)
    with open(os.path.join(rundir, VIDEO_RUN), "w") as f:
        json.dump(run, f)


def video_model_from_run(cfg: Config, run: dict, generator=None) -> VideoFVTAModel:
    """A freshly initialized VideoFVTAModel shaped by a video_run.json record."""
    return VideoFVTAModel(cfg, num_choices=run["num_choices"],
                          temporal_encoder=run["encoder"], task=run["task"],
                          num_answers=run["num_answers"], generator=generator)


def load_video_rundir(rundir: str, device, cfg: Config | None = None):
    """(cfg, run record, VideoFVTAModel in eval mode on `device`) from a video
    run directory; cfg overrides the saved config."""
    cfg = cfg or load_config(os.path.join(rundir, "config.json"))
    with open(os.path.join(rundir, VIDEO_RUN)) as f:
        run = json.load(f)
    model = video_model_from_run(cfg, run)
    model.load_state_dict(torch.load(os.path.join(rundir, "params.pt"), map_location="cpu",
                                     weights_only=True))
    return cfg, run, model.to(device).eval()


def load_rundir(rundir: str, device, cfg: Config | None = None) -> tuple[Config, FVTAModel]:
    """(cfg, model in eval mode on `device`). cfg overrides the saved config
    (serving passes the saved one with the pack's data config)."""
    cfg = cfg or load_config(os.path.join(rundir, "config.json"))
    model = FVTAModel(cfg)
    sd = torch.load(os.path.join(rundir, "params.pt"), map_location="cpu",
                    weights_only=True)
    model.load_state_dict(sd)
    return cfg, model.to(device).eval()
