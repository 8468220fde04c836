"""Fused bi-LSTM: kernels K1 (csrc/lstm_fwd.cu) and K1b (csrc/lstm_bwd.cu), and
their plain version.

`bilstm_fused` / `bilstm_fused_final` have the contract of ops/lstm_ref.bilstm_ref
(TF1 numerics, zero outputs past each row's length, fin = last carried h). On a
CUDA tensor they launch K1 — both directions, the input projection and the cell
in one kernel — and on a CPU tensor they run the plain `bilstm_ref` (autograd
through it). There is no fallback from the card to the plain version: a kernel
that fails to build or launch raises.

Under grad on the card they run `_BiLSTMFn`: the forward launches K1 with its
per-step outputs and cell states (kept for the backward), the backward launches
K1b for the gate cotangents dgates [N, T, 8H] and forms dX, dWx, dWh and db as
four matrix products (`_assemble_bwd` in the JAX package). dgates, out and cell
sit at the original time positions in both directions, so x and h_{t-1} line up
with dgates without a flip.

K1 replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_fwd_step_kernel,
K1b its backward :_bwd_step_kernel. Masks must be contiguous prefixes
(pack-time invariant, data/pack.py _assert_prefix_masks): the kernels see only
lengths = mask.sum(1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fvta_memexqa_torch.ops import build
from fvta_memexqa_torch.ops.lstm_ref import LSTMParams, bilstm_ref

@functools.cache
def _lib(stem: str, n_ptr: int) -> ctypes.CDLL:
    """csrc/<stem>.cu's library: <stem>(n_ptr pointers, n, t, d, h, forget_bias,
    stream), <stem>_smem_bytes(d, h), <stem>_error_string(err)."""
    lib = build.library(stem)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, stem)
    fn.argtypes = [p] * n_ptr + [i] * 4 + [ctypes.c_float, p]
    fn.restype = i
    getattr(lib, f"{stem}_smem_bytes").argtypes = [i, i]
    getattr(lib, f"{stem}_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, f"{stem}_error_string").argtypes = [i]
    getattr(lib, f"{stem}_error_string").restype = ctypes.c_char_p
    return lib


def _check_common(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
                  params_bw: LSTMParams, kernel: str) -> tuple[int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {x.device}")
    n, t, d = x.shape
    h = params_fw.wh.shape[0]
    dev = x.device
    build.check_f32("x", x, (n, t, d), dev)
    for tag, p in (("fw", params_fw), ("bw", params_bw)):
        build.check_f32(f"{tag}.wx", p.wx, (d, 4 * h), dev)
        build.check_f32(f"{tag}.wh", p.wh, (h, 4 * h), dev)
        build.check_f32(f"{tag}.b", p.b, (4 * h,), dev)
    if lengths.device != dev or lengths.dtype != torch.int32 or tuple(lengths.shape) != (n,):
        raise ValueError("lengths must be int32 [N] on the device of x")
    return n, t, d, h


def _ptr(a: torch.Tensor | None):
    return a.data_ptr() if a is not None else None


def lstm_fwd(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, forget_bias: float, emit_out: bool,
             emit_cell: bool = False
             ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """Launch K1. x [N, T, D] f32, lengths [N] int32, and per direction wx [D, 4H],
    wh [H, 4H], b [4H], all contiguous on one CUDA device; the kernel reads both
    directions' weights where they lie. Returns (out [N, T, 2H] or None,
    fin [N, 2H], cell [N, T, 2H] or None); cell holds the carried c of each step
    at the original time positions, for the backward. Counts its launches in
    `lstm_fwd.launches`."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_fwd")
    dev = x.device
    seq = lambda: torch.empty((n, t, 2 * h), dtype=torch.float32, device=dev)
    out = seq() if emit_out else None
    cell = seq() if emit_cell else None
    fin = torch.empty((n, 2 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return out, fin, cell
    lib = _lib("lstm_fwd", 11)
    smem = lib.lstm_fwd_smem_bytes(d, h)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lstm_fwd needs {smem} B of shared memory at D={d}, H={h}; "
                         f"a block has {build.SMEM_LIMIT}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_fwd(x.data_ptr(), lengths.data_ptr(),
                           *(getattr(p, f).data_ptr() for f in ("wx", "wh", "b")
                             for p in (params_fw, params_bw)),
                           _ptr(out), _ptr(cell), fin.data_ptr(), n, t, d, h,
                           float(forget_bias), stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd launch failed: {lib.lstm_fwd_error_string(err).decode()}")
    build.count_launch(lstm_fwd)
    return out, fin, cell


lstm_fwd.launches = 0


def lstm_bwd(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, out: torch.Tensor, cell: torch.Tensor,
             g_out: torch.Tensor | None, g_fin: torch.Tensor | None,
             forget_bias: float) -> torch.Tensor:
    """Launch K1b: the gate cotangents dgates [N, T, 8H] (forward direction's
    (i, j, f, o) in [:4H], backward's in [4H:], at the original time positions)
    from K1's out and cell [N, T, 2H] and the cotangents g_out [N, T, 2H] and
    g_fin [N, 2H] (None = zero). Inputs as for `lstm_fwd`. Counts its launches
    in `lstm_bwd.launches`."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_bwd")
    dev = x.device
    for name, a, shape in (("out", out, (n, t, 2 * h)), ("cell", cell, (n, t, 2 * h)),
                           ("g_out", g_out, (n, t, 2 * h)), ("g_fin", g_fin, (n, 2 * h))):
        if a is not None:
            build.check_f32(name, a, shape, dev)
    dgates = torch.empty((n, t, 8 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return dgates
    lib = _lib("lstm_bwd", 15)
    smem = lib.lstm_bwd_smem_bytes(d, h)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lstm_bwd needs {smem} B of shared memory at D={d}, H={h}; "
                         f"a block has {build.SMEM_LIMIT}")
    wht = [p.wh.t().contiguous() for p in (params_fw, params_bw)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_bwd(x.data_ptr(), lengths.data_ptr(),
                           params_fw.wx.data_ptr(), params_bw.wx.data_ptr(),
                           params_fw.wh.data_ptr(), params_bw.wh.data_ptr(),
                           wht[0].data_ptr(), wht[1].data_ptr(),
                           params_fw.b.data_ptr(), params_bw.b.data_ptr(),
                           out.data_ptr(), cell.data_ptr(), _ptr(g_out), _ptr(g_fin),
                           dgates.data_ptr(), n, t, d, h, float(forget_bias), stream)
    if err != 0:
        raise RuntimeError(f"lstm_bwd launch failed: {lib.lstm_bwd_error_string(err).decode()}")
    build.count_launch(lstm_bwd)
    return dgates


lstm_bwd.launches = 0


def _assemble_bwd(x, params_fw: LSTMParams, params_bw: LSTMParams, out, dgates,
                  need_dx: bool):
    """dX, and (dwx, dwh, db) per direction, from dgates [N, T, 8H]: the products
    the JAX package leaves to XLA (lstm_fused.py _assemble_bwd). h_{t-1} is the
    forward output one position earlier and the backward output one later (K1's
    outputs are 0 past a row's length, and dgates are 0 there)."""
    n, t, d = x.shape
    h = params_fw.wh.shape[0]
    g4 = 4 * h
    dg = dgates.reshape(n * t, 2 * g4)
    dx = None
    if need_dx:
        wx = torch.cat([params_fw.wx, params_bw.wx], dim=1)          # [D, 8H]
        dx = (dg @ wx.t()).reshape(n, t, d)
    dwx = x.reshape(n * t, d).t() @ dg                                # [D, 8H]
    zero = out.new_zeros(n, 1, h)
    h_prev = (torch.cat([zero, out[:, :-1, :h]], dim=1),             # forward: p-1
              torch.cat([out[:, 1:, h:], zero], dim=1))              # backward: p+1
    db = dg.sum(dim=0)
    grads = []
    for k, hp in enumerate(h_prev):
        dgk = dg[:, k * g4:(k + 1) * g4]
        grads.append(LSTMParams(dwx[:, k * g4:(k + 1) * g4], hp.reshape(n * t, h).t() @ dgk,
                                db[k * g4:(k + 1) * g4]))
    return dx, grads[0], grads[1]


class _BiLSTMFn(torch.autograd.Function):
    """K1 with cells forward, K1b + products backward. Inputs: x, lengths, then
    the six weight tensors (wx, wh, b forward; wx, wh, b backward)."""

    @staticmethod
    def forward(ctx, x, lengths, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        out, fin, cell = lstm_fwd(x, lengths, p_fw, p_bw, forget_bias, emit_out=True,
                                  emit_cell=True)
        ctx.save_for_backward(x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell)
        ctx.forget_bias = forget_bias
        ctx.set_materialize_grads(False)
        return out, fin

    @staticmethod
    def backward(ctx, g_out, g_fin):
        x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell = ctx.saved_tensors
        if g_out is None and g_fin is None:
            return (None,) * 9
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        dgates = lstm_bwd(x, lengths, p_fw, p_bw, out, cell,
                          None if g_out is None else g_out.contiguous(),
                          None if g_fin is None else g_fin.contiguous(), ctx.forget_bias)
        dx, d_fw, d_bw = _assemble_bwd(x, p_fw, p_bw, out, dgates, ctx.needs_input_grad[0])
        return (dx, None, None, *d_fw, *d_bw)


def _launch(params_fw: LSTMParams, params_bw: LSTMParams, x, mask, forget_bias,
            emit_out: bool):
    """(out or None, fin) on the card: K1 alone without grad, _BiLSTMFn with it."""
    x = x.contiguous()
    lengths = mask.sum(dim=1, dtype=torch.int32)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in (*params_fw, *params_bw))):
        out, fin = _BiLSTMFn.apply(x, lengths, float(forget_bias), *params_fw, *params_bw)
        return (out if emit_out else None), fin
    out, fin, _ = lstm_fwd(x, lengths, params_fw, params_bw, forget_bias, emit_out)
    return out, fin


def bilstm_fused(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                 mask: torch.Tensor, forget_bias: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bi-LSTM encode: (outputs [N, T, 2H], final [N, 2H])."""
    if x.device.type == "cpu":
        return bilstm_ref(params_fw, params_bw, x, mask, forget_bias)
    return _launch(params_fw, params_bw, x, mask, forget_bias, emit_out=True)


def bilstm_fused_final(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                       mask: torch.Tensor, forget_bias: float = 1.0) -> torch.Tensor:
    """Final-state-only fused bi-LSTM: fin [N, 2H]. Without grad no per-step
    output is written on the card; under grad the forward keeps the per-step
    outputs and cells that the backward needs (as the JAX package's vjp does)."""
    if x.device.type == "cpu":
        return bilstm_ref(params_fw, params_bw, x, mask, forget_bias)[1]
    return _launch(params_fw, params_bw, x, mask, forget_bias, emit_out=False)[1]
