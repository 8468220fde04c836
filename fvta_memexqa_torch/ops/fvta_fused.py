"""Fused FVTA attention forward: kernel K2 (csrc/fvta_fwd.cu) and its plain version.

`fvta_attention_fused` computes similarity_tensor + fvta_attention (ops/fvta_ref)
in one kernel for the trilinear and dot similarities, without materializing the
[N, S, T, J] correlation. On a CUDA tensor it launches K2; on a CPU tensor it
runs the plain version. The bilinear similarity has no kernel (nor does the
JAX package) and always runs the plain version.

K2 replaces the TPU kernel fvta_memexqa_tpu/ops/fvta_pallas.py:_kernel. It runs
one thread-block cluster per example, whose CTAs split the example's S x T
rows and combine their partial softmax statistics through distributed shared
memory in a fixed order; its geometry comes from the library
(`fvta_fwd_geometry`), read once per device and shape by `geometry` and
passed back at each launch. Past the last staging that fits a CTA's shared
memory the geometry takes the "global" route (h, q and each segment's V in
device memory; launches also counted in `fvta_fwd.global_launches`);
`fvta_fwd_global` forces it at any width and no path calls it.
Under grad on the card, `_FVTAFn` runs K2 forward and takes the gradient by
recomputing the plain version under autograd (the JAX package's `_core_bwd`, fvta_pallas.py:581-591: at T = 24
there is no backward kernel there either).

From STREAM_MIN_T time steps on (the repo's video lengths, T = 1024 and 4096),
the trilinear and dot similarities take the streaming form instead, on both
devices: ops/fvta_stats.fvta_stats_fused (kernel K4, and K5 + K6 under grad)
and then the plain focal_finalize — the long-T branch of the JAX package's
fvta_attention_pallas (fvta_pallas.py:531-545). The constant is a shape rule,
not a tuned crossover.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fvta_memexqa_torch.ops import build
from fvta_memexqa_torch.ops.fvta_ref import (AttentionOutput, focal_finalize,
                                             fvta_attention, similarity_tensor)
from fvta_memexqa_torch.ops.fvta_stats import fvta_stats_fused

STREAM_MIN_T = 1024   # time steps from which the attention takes the streaming form


@functools.cache
def _lib():
    lib = build.library("fvta_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fvta_fwd.argtypes = [p] * 12 + [i] * 12 + [ll, i, p]
    lib.fvta_fwd.restype = i
    for name in ("fvta_fwd_geometry", "fvta_fwd_geometry_global"):
        getattr(lib, name).argtypes = [i] * 5 + [p]
        getattr(lib, name).restype = i
    lib.fvta_fwd_error_string.argtypes = [i]
    lib.fvta_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _error(kernel: str, err: int) -> RuntimeError:
    return RuntimeError(f"{kernel} failed: {_lib().fvta_fwd_error_string(err).decode()}")


GEOMETRY_KEYS = ("cluster", "chunks", "chunk_len", "segs", "rows", "bufs", "qtile", "smem",
                 "active_clusters", "sms", "cluster_cap", "route", "scratch")
ROUTES = ("staged", "global")   # a geometry's route, by the library's number


@functools.cache
def _geometry_on(device: int, n, s, t, j, d, force_global: bool = False) -> dict:
    name = "fvta_fwd_geometry_global" if force_global else "fvta_fwd_geometry"
    out = (ctypes.c_longlong * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device):
        err = getattr(_lib(), name)(n, s, t, j, d, out)
    if err != 0:
        raise _error(f"{name} at (N, S, T, J, D) = {(n, s, t, j, d)}", err)
    geo = dict(zip(GEOMETRY_KEYS, out))
    geo["route"] = ROUTES[geo["route"]]
    return geo


def geometry(n, s, t, j, d, force_global: bool = False) -> dict:
    """K2's launch geometry on the current CUDA device, as the library plans it
    (csrc/fvta_fwd.cuh) and finds schedulable: CTAs per example (the cluster),
    chunks per sequence and their length, segments per CTA, rows per staged
    block, buffers, q staged in tiles, shared memory per CTA (bytes), what it
    was planned from, the route ("staged" wherever a staging fits, else
    "global"; force_global: "global" at any width) and the global route's V
    scratch (floats). Read once per device and shape; `fvta_fwd` passes it to
    the launch unchanged."""
    return _geometry_on(torch.cuda.current_device(), n, s, t, j, d, force_global)


def _checked(kernel: str, h, cm, q, qm, wx, wy, wxy):
    """Check the inputs of a K2 launch; returns the shape and empty outputs."""
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {h.device}")
    n, s, t, d = h.shape
    j = q.shape[1]
    dev = h.device
    for name, a, shape in (("h", h, (n, s, t, d)), ("ctx_mask", cm, (n, s, t)),
                           ("q", q, (n, j, d)), ("q_mask", qm, (n, j)),
                           ("w_x", wx, (d,)), ("w_y", wy, (d,)), ("w_xy", wxy, (d,))):
        build.check_f32(name, a, shape, dev)
    if min(s, t, j, d) < 1:
        raise ValueError(f"{kernel} needs S, T, J, D >= 1, got {(s, t, j, d)}")
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    return (n, s, t, j, d), AttentionOutput(empty(n, d), empty(n, d), empty(n, s, t),
                                            empty(n, s))


def _ptrs(args, out) -> list[int]:
    return [a.data_ptr() for a in (*args, *out)]


def _fvta_fwd(wrapper, force_global: bool, h, cm, q, qm, wx, wy, wxy) -> AttentionOutput:
    shape, out = _checked(wrapper.__name__, h, cm, q, qm, wx, wy, wxy)
    if shape[0] == 0:
        return out
    dev = h.device
    with torch.cuda.device(dev):
        g = geometry(*shape, force_global)
        # the global route's V scratch; the staged route takes none (a null pointer)
        vscr = (torch.empty(g["scratch"], dtype=torch.float32, device=dev)
                if g["route"] == "global" else None)
        err = _lib().fvta_fwd(*_ptrs((h, cm, q, qm, wx, wy, wxy), out),
                              None if vscr is None else vscr.data_ptr(),
                              *shape, g["cluster"], g["chunks"], g["chunk_len"], g["segs"],
                              g["rows"], g["bufs"], g["qtile"], g["smem"],
                              ROUTES.index(g["route"]),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _error(f"{wrapper.__name__} launch", err)
    build.count_launch(wrapper, g["route"] == "global")
    return out


def fvta_fwd(h: torch.Tensor, cm: torch.Tensor, q: torch.Tensor, qm: torch.Tensor,
             wx: torch.Tensor, wy: torch.Tensor, wxy: torch.Tensor) -> AttentionOutput:
    """Launch K2. h [N, S, T, D], cm [N, S, T], q [N, J, D], qm [N, J] (masks as
    float32 0/1), wx/wy/wxy [D]; all f32, contiguous, on one CUDA device.
    Counts its launches in `fvta_fwd.launches`, those on the global route also
    in `fvta_fwd.global_launches`."""
    return _fvta_fwd(fvta_fwd, False, h, cm, q, qm, wx, wy, wxy)


def fvta_fwd_global(h: torch.Tensor, cm: torch.Tensor, q: torch.Tensor, qm: torch.Tensor,
                    wx: torch.Tensor, wy: torch.Tensor, wxy: torch.Tensor) -> AttentionOutput:
    """K2 on the global route at any width (`fvta_fwd`'s arguments and
    results; no path calls it). Counts its launches in
    `fvta_fwd_global.launches`."""
    return _fvta_fwd(fvta_fwd_global, True, h, cm, q, qm, wx, wy, wxy)


fvta_fwd.launches = fvta_fwd.global_launches = 0
fvta_fwd_global.launches = fvta_fwd_global.global_launches = 0


def fvta_attention_fused(h: torch.Tensor, ctx_mask: torch.Tensor, q: torch.Tensor,
                         q_mask: torch.Tensor, similarity: str,
                         sim_params: dict[str, torch.Tensor]) -> AttentionOutput:
    """Drop-in for similarity_tensor + fvta_attention (AttentionOutput layout)."""
    if similarity in ("trilinear", "dot") and h.shape[2] >= STREAM_MIN_T:
        m, den, v, eq, e = fvta_stats_fused(h, ctx_mask, q, q_mask, similarity, sim_params)
        return focal_finalize(m, den, v, eq, e, q, q_mask, ctx_mask.any(-1))
    if h.device.type == "cpu" or similarity not in ("trilinear", "dot"):
        c = similarity_tensor(h, q, similarity, sim_params)
        return fvta_attention(h, ctx_mask, q, q_mask, c)
    if similarity == "trilinear":
        wx, wy, wxy = sim_params["w_x"], sim_params["w_y"], sim_params["w_xy"]
    else:  # dot
        d = h.shape[-1]
        wx = torch.zeros(d, dtype=h.dtype, device=h.device)
        wy = torch.zeros(d, dtype=h.dtype, device=h.device)
        wxy = torch.ones(d, dtype=h.dtype, device=h.device)
    f32 = lambda m: m.to(torch.float32).contiguous()
    args = (h.contiguous(), f32(ctx_mask), q.contiguous(), f32(q_mask),
            wx.contiguous(), wy.contiguous(), wxy.contiguous())
    if torch.is_grad_enabled() and any(a.requires_grad for a in (h, q, wx, wy, wxy)):
        return AttentionOutput(*_FVTAFn.apply(*args))
    return fvta_fwd(*args)


class _FVTAFn(torch.autograd.Function):
    """K2 forward; backward by recomputing similarity_tensor + fvta_attention
    (trilinear form; dot is w_x = w_y = 0, w_xy = 1) under autograd. The plain
    version's `amax` splits a tie's gradient evenly, as JAX's reduce_max VJP
    does — with exp_mask, the rows of an all-masked question are all ties."""

    @staticmethod
    def forward(ctx, h, cm_f, q, qm_f, wx, wy, wxy):
        ctx.save_for_backward(h, cm_f, q, qm_f, wx, wy, wxy)
        ctx.set_materialize_grads(False)
        return tuple(fvta_fwd(h, cm_f, q, qm_f, wx, wy, wxy))

    @staticmethod
    def backward(ctx, *grads):
        h, cm_f, q, qm_f, wx, wy, wxy = ctx.saved_tensors
        inputs = [a.detach().requires_grad_() for a in (h, q, wx, wy, wxy)]
        with torch.enable_grad():
            h_, q_, wx_, wy_, wxy_ = inputs
            c = similarity_tensor(h_, q_, "trilinear", {"w_x": wx_, "w_y": wy_, "w_xy": wxy_})
            out = fvta_attention(h_, cm_f > 0.5, q_, qm_f > 0.5, c)
        used = [(o, g) for o, g in zip(out, grads) if g is not None]
        if not used:
            return (None,) * 7
        dh, dq, dwx, dwy, dwxy = torch.autograd.grad(
            [o for o, _ in used], inputs, [g for _, g in used], allow_unused=True)
        return dh, None, dq, None, dwx, dwy, dwxy
