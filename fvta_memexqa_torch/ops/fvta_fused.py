"""Fused FVTA attention forward: kernel K2 (csrc/fvta_fwd.cu) and its plain version.

`fvta_attention_fused` computes similarity_tensor + fvta_attention (ops/fvta_ref)
in one kernel for the trilinear and dot similarities, without materializing the
[N, S, T, J] correlation. On a CUDA tensor it launches K2; on a CPU tensor it
runs the plain version. The bilinear similarity has no kernel (nor does the
JAX package) and always runs the plain version.

K2 replaces the TPU kernel fvta_memexqa_tpu/ops/fvta_pallas.py:_kernel. Under
grad on the card, `_FVTAFn` runs K2 forward and takes the gradient by
recomputing the plain version under autograd (the JAX package's `_core_bwd`,
fvta_pallas.py:581-591: at T = 24 there is no backward kernel there either).

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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fvta_fwd.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.fvta_fwd.restype = i
    lib.fvta_fwd_smem_bytes.argtypes = [i, i, i]
    lib.fvta_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.fvta_fwd_error_string.argtypes = [i]
    lib.fvta_fwd_error_string.restype = ctypes.c_char_p
    return lib


def fvta_fwd(h: torch.Tensor, cm: torch.Tensor, q: torch.Tensor, qm: torch.Tensor,
             wx: torch.Tensor, wy: torch.Tensor, wxy: torch.Tensor) -> AttentionOutput:
    """Launch K2. h [N, S, T, D], cm [N, S, T], q [N, J, D], qm [N, J] (masks as
    float32 0/1), wx/wy/wxy [D]; all f32, contiguous, on one CUDA device.
    Counts its launches in `fvta_fwd.launches`."""
    if h.device.type != "cuda":
        raise ValueError(f"fvta_fwd launches on a CUDA device, got {h.device}")
    n, s, t, d = h.shape
    j = q.shape[1]
    dev = h.device
    for name, a, shape in (("h", h, (n, s, t, d)), ("ctx_mask", cm, (n, s, t)),
                           ("q", q, (n, j, d)), ("q_mask", qm, (n, j)),
                           ("w_x", wx, (d,)), ("w_y", wy, (d,)), ("w_xy", wxy, (d,))):
        build.check_f32(name, a, shape, dev)
    if min(s, t, j, d) < 1:
        raise ValueError(f"fvta_fwd needs S, T, J, D >= 1, got {(s, t, j, d)}")
    ctx = torch.empty((n, d), dtype=torch.float32, device=dev)
    qatt = torch.empty((n, d), dtype=torch.float32, device=dev)
    ta = torch.empty((n, s, t), dtype=torch.float32, device=dev)
    sa = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0:
        return AttentionOutput(ctx, qatt, ta, sa)
    lib = _lib()
    smem = lib.fvta_fwd_smem_bytes(s, j, d)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"fvta_fwd needs {smem} B of shared memory at S={s}, J={j}, "
                         f"D={d}; a block has {build.SMEM_LIMIT}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fvta_fwd(h.data_ptr(), cm.data_ptr(), q.data_ptr(), qm.data_ptr(),
                           wx.data_ptr(), wy.data_ptr(), wxy.data_ptr(), ctx.data_ptr(),
                           qatt.data_ptr(), ta.data_ptr(), sa.data_ptr(),
                           n, s, t, j, d, stream)
    if err != 0:
        raise RuntimeError(f"fvta_fwd launch failed: {lib.fvta_fwd_error_string(err).decode()}")
    build.count_launch(fvta_fwd)
    return AttentionOutput(ctx, qatt, ta, sa)


fvta_fwd.launches = 0


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
