"""Grouped LSTM scans over a precomputed input projection: kernels K7
(csrc/lstm_grouped.cu) and K8 (csrc/lstm_stream.cu), and their plain version.

The counterpart of fvta_memexqa_tpu/ops/lstm_pallas.py, the round-1 fused scans
that lstm_fused.py superseded: `lstm_scan_grouped` is `lstm_scan_pallas` and
`bilstm_grouped` is `bilstm_pallas`, with the contract of lstm_ref.lstm_scan_ref
and bilstm_ref — (out [N, T, H or 2H], fin [N, H or 2H]), outputs 0 past each
row's length, fin the last carried h.

- The input projection x @ Wx + b stays a matmul outside the kernel, as in the
  JAX package; the kernels own only the recurrence gates = x_proj[t] + h @ Wh,
  for G independent scans in one launch (G = 2 for the two directions of a
  bi-LSTM, whose backward direction reads the length-aware flip of x and has
  its output flipped back).
- A call on the card routes by the JAX package's rule (`_run_grouped`,
  lstm_pallas.py:280): K8, which streams x_proj[t + 1] into shared memory while
  step t computes, when n >= 1024 and t >= 2; K7, which reads x_proj[t] from
  global memory at step t, otherwise. The rule was tuned for the TPU; it is
  kept so that the same calls reach the same kernels in both packages.
- `block_b` is read and selects nothing (the TPU's batch tile); the kernels
  tile rows themselves.
- Backward: as in the JAX package's custom_vjp (lstm_pallas.py:317-326,
  361-371), the backward is no kernel. `_GroupedFn.backward` recomputes the
  forward through the plain lstm_scan_ref / bilstm_ref under autograd and
  returns its gradients; that is the reference's own design, not a fallback.

On a CUDA tensor the forward launches K7 or K8 (a kernel that fails to build or
launch raises; there is no fallback); on a CPU tensor it runs the plain
`grouped_scan_ref` through the same routing. Masks must be contiguous prefixes:
the kernels see only lengths = mask.sum(1).

K7 replaces fvta_memexqa_tpu/ops/lstm_pallas.py:_grouped_kernel, K8
:_stream_kernel. Nothing on the model's paths calls them (the model runs
lstm_fused's K1/K1b); the public functions here are their only route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fvta_memexqa_torch.ops import build
from fvta_memexqa_torch.ops.lstm_ref import (LSTMParams, _flip_to_front, bilstm_ref,
                                             lstm_cell, lstm_scan_ref)

STREAM_MIN_ROWS = 1024   # the JAX package's routing rule: K8 from 1024 rows ...
STREAM_MIN_T = 2         # ... and 2 time steps on


def uses_stream(n: int, t: int) -> bool:
    """Whether a scan of n rows over t steps goes to K8 (else K7)."""
    return n >= STREAM_MIN_ROWS and t >= STREAM_MIN_T


# ---- plain version ----------------------------------------------------------------

def grouped_scan_ref(x_proj: torch.Tensor, lengths: torch.Tensor, wh: torch.Tensor,
                     forget_bias: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's and K8's function: x_proj [G, N, T, 4H], lengths int [G, N], wh
    [G, H, 4H] → (out [G, N, T, H], fin [G, N, H]); step t updates h and c of
    the rows with t < length and outputs 0 for the others."""
    g, n, t, g4 = x_proj.shape
    hdim = g4 // 4
    h = x_proj.new_zeros(g, n, hdim)
    c = x_proj.new_zeros(g, n, hdim)
    outs = []
    for step in range(t):
        nh, nc = lstm_cell(x_proj[:, :, step], h, c, wh, forget_bias)
        live = (step < lengths)[..., None]
        h = torch.where(live, nh, h)
        c = torch.where(live, nc, c)
        outs.append(torch.where(live, nh, 0.0))
    out = torch.stack(outs, dim=2) if outs else x_proj.new_zeros(g, n, 0, hdim)
    return out, h


# ---- kernel wrappers -----------------------------------------------------------------

@functools.cache
def _lib(stem: str) -> ctypes.CDLL:
    """csrc/<stem>.cu's library: <stem>(x_proj, lengths, wh, out, fin, g, n, t, h,
    forget_bias, stream), <stem>_smem_bytes(h), <stem>_error_string(err)."""
    lib = build.library(stem)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, stem)
    fn.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float, p]
    fn.restype = i
    getattr(lib, f"{stem}_smem_bytes").argtypes = [i]
    getattr(lib, f"{stem}_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, f"{stem}_error_string").argtypes = [i]
    getattr(lib, f"{stem}_error_string").restype = ctypes.c_char_p
    return lib


def _launch(wrapper, stem: str, x_proj: torch.Tensor, lengths: torch.Tensor,
            wh: torch.Tensor, forget_bias: float) -> tuple[torch.Tensor, torch.Tensor]:
    if x_proj.device.type != "cuda":
        raise ValueError(f"{stem} launches on a CUDA device, got {x_proj.device}")
    g, n, t, g4 = x_proj.shape
    h = wh.shape[1]
    dev = x_proj.device
    build.check_f32("x_proj", x_proj, (g, n, t, 4 * h), dev)
    build.check_f32("wh", wh, (g, h, 4 * h), dev)
    if lengths.device != dev or lengths.dtype != torch.int32 or tuple(lengths.shape) != (g, n):
        raise ValueError("lengths must be int32 [G, N] on the device of x_proj")
    if g * n * t == 0:
        return (torch.zeros((g, n, t, h), dtype=torch.float32, device=dev),
                torch.zeros((g, n, h), dtype=torch.float32, device=dev))
    # the kernels write every element of out and fin
    out = torch.empty((g, n, t, h), dtype=torch.float32, device=dev)
    fin = torch.empty((g, n, h), dtype=torch.float32, device=dev)
    lib = _lib(stem)
    smem = getattr(lib, f"{stem}_smem_bytes")(h)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"{stem} keeps Wh resident and needs {smem} B of shared memory at "
                         f"H={h}; a block has {build.SMEM_LIMIT}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, stem)(x_proj.data_ptr(), lengths.data_ptr(), wh.data_ptr(),
                                 out.data_ptr(), fin.data_ptr(), g, n, t, h,
                                 float(forget_bias), stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{stem} launch failed: {msg}")
    build.count_launch(wrapper)
    return out, fin


def scan_grouped(x_proj: torch.Tensor, lengths: torch.Tensor, wh: torch.Tensor,
                 forget_bias: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 (arguments and results as `grouped_scan_ref`; float32,
    contiguous, on one CUDA device; lengths int32). Counts its launches in
    `scan_grouped.launches`."""
    return _launch(scan_grouped, "lstm_grouped", x_proj, lengths, wh, forget_bias)


scan_grouped.launches = 0


def scan_stream(x_proj: torch.Tensor, lengths: torch.Tensor, wh: torch.Tensor,
                forget_bias: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 (as `scan_grouped`; x_proj 16-byte aligned, as K8 copies it in
    16-byte pieces). Counts its launches in `scan_stream.launches`."""
    if x_proj.data_ptr() % 16:
        raise ValueError("lstm_stream copies x_proj in 16-byte pieces: its data must be "
                         "16-byte aligned")
    return _launch(scan_stream, "lstm_stream", x_proj, lengths, wh, forget_bias)


scan_stream.launches = 0


def _kernels(device: torch.device):
    """(K7, K8) for tensors on `device`: the kernels on the card, the plain
    version (for both) on the CPU."""
    if device.type == "cpu":
        return grouped_scan_ref, grouped_scan_ref
    return scan_grouped, scan_stream


def _scan(x_proj, lengths, wh, forget_bias):
    """The routed grouped scan: K8 or K7 by the JAX package's rule."""
    _, n, t, _ = x_proj.shape
    k7, k8 = _kernels(x_proj.device)
    return (k8 if uses_stream(n, t) else k7)(x_proj.contiguous(), lengths, wh.contiguous(),
                                            forget_bias)


# ---- the API ---------------------------------------------------------------------------

def _uni_forward(x, mask, forget_bias, wx, wh, b):
    out, fin = _scan((x @ wx + b)[None], mask.sum(1, dtype=torch.int32)[None], wh[None],
                     forget_bias)
    return out[0], fin[0]


def _bi_forward(x, mask, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
    lengths = mask.sum(1, dtype=torch.int32)
    x_rev = _flip_to_front(x, lengths)
    xp = torch.stack([x @ wx_f + b_f, x_rev @ wx_b + b_b])
    out, fin = _scan(xp, lengths[None].expand(2, -1).contiguous(), torch.stack([wh_f, wh_b]),
                     forget_bias)
    out_bw = _flip_to_front(out[1], lengths)
    return torch.cat([out[0], out_bw], dim=-1), torch.cat([fin[0], fin[1]], dim=-1)


def _uni_ref(x, mask, forget_bias, wx, wh, b):
    return lstm_scan_ref(LSTMParams(wx, wh, b), x, mask, forget_bias)


def _bi_ref(x, mask, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
    return bilstm_ref(LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b), x, mask,
                      forget_bias)


class _GroupedFn(torch.autograd.Function):
    """Forward through K7/K8 (the plain scan on the CPU); backward by recomputing
    the plain reference under autograd, as the JAX package's custom_vjp does.
    Inputs: bidirectional, x, mask (bool), forget_bias, then the weights (wx, wh,
    b; both directions' for a bi-LSTM)."""

    @staticmethod
    def forward(ctx, bidirectional, x, mask, forget_bias, *weights):
        ctx.save_for_backward(x, mask, *weights)
        ctx.bidirectional, ctx.forget_bias = bidirectional, forget_bias
        fwd = _bi_forward if bidirectional else _uni_forward
        return fwd(x, mask, forget_bias, *weights)

    @staticmethod
    def backward(ctx, g_out, g_fin):
        x, mask, *weights = ctx.saved_tensors
        need = ctx.needs_input_grad[1:2] + ctx.needs_input_grad[4:]
        leaves = [a.detach().requires_grad_(nd) for a, nd in zip((x, *weights), need)]
        wanted = [a for a in leaves if a.requires_grad]
        ref = _bi_ref if ctx.bidirectional else _uni_ref
        with torch.enable_grad():
            out, fin = ref(leaves[0], mask, ctx.forget_bias, *leaves[1:])
            grads = iter(torch.autograd.grad((out, fin), wanted, (g_out, g_fin),
                                             allow_unused=True))
        dx, *dw = [next(grads) if a.requires_grad else None for a in leaves]
        return (None, dx, None, None, *dw)


def lstm_scan_grouped(params: LSTMParams, x: torch.Tensor, mask_f: torch.Tensor,
                      forget_bias: float = 1.0, block_b: int = 256
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unidirectional scan, x [N, T, D], mask_f float [N, T] (contiguous prefixes):
    (outputs [N, T, H], final_h [N, H]), the contract of lstm_scan_ref.
    `block_b` is read and selects nothing."""
    return _GroupedFn.apply(False, x, mask_f > 0.5, float(forget_bias), *params)


def bilstm_grouped(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                   mask: torch.Tensor, forget_bias: float = 1.0, block_b: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional encode, the contract of bilstm_ref: (outputs [N, T, 2H],
    final [N, 2H]); both directions run as one G = 2 launch. `block_b` is read
    and selects nothing."""
    return _GroupedFn.apply(True, x, mask.bool(), float(forget_bias), *params_fw, *params_bw)
