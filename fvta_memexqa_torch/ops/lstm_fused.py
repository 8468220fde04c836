"""Fused bi-LSTM: kernels K1 and K1b, and their plain version.

`bilstm_fused` / `bilstm_fused_final` have the contract of ops/lstm_ref.bilstm_ref
(TF1 numerics, zero outputs past each row's length, fin = last carried h). On a
CPU tensor they run the plain `bilstm_ref` (autograd through it). On a CUDA
tensor `lstm_route` picks, by shape, one of two kernel sets (forward and
backward together):

- the Hopper design (every width the repo's configurations use): K1 is
  `lstm_proj`'s kernel (csrc/lstm_proj.cuh: x.Wx + b of both directions for all
  positions, one tiled product) then `lstm_rec`'s (csrc/lstm_rec.cu: the
  recurrence, Wh resident in shared memory, a thread-block cluster split over
  hidden units when the grid is thin), both in csrc/lstm_rec.cu's library and
  launched from one host call by `lstm_k1`; K1b is `lstm_rec_bwd` (csrc/lstm_rec_bwd.cu), which reads the
  pre-activations `lstm_rec` saved;
- past the shared memory of the largest cluster (H above ~250 at D = 200),
  the L2-streaming kernels: `lstm_fwd` (csrc/lstm_fwd.cu, projection and cell
  in one kernel, weights from L2) and `lstm_bwd` (csrc/lstm_bwd.cu, which
  recomputes the pre-activations).

This is a choice by shape, never a fallback: a kernel that fails to build or
launch raises.

Under grad on the card they run `_BiLSTMFn`: the forward keeps the per-step
outputs and cell states (and, on the Hopper route, the pre-activations, written
in place over lstm_proj's output: [N, T, 8H] float32 per call, alive until the
backward), the backward launches K1b for the gate cotangents dgates [N, T, 8H]
and forms dX, dWx, dWh and db as four matrix products (`_assemble_bwd` in the
JAX package). dgates, out and cell sit at the original time positions in both
directions, so x and h_{t-1} line up with dgates without a flip.

K1 replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_fwd_step_kernel,
K1b its backward :_bwd_step_kernel. Masks must be contiguous prefixes
(pack-time invariant, data/pack.py _assert_prefix_masks): the kernels see only
lengths = mask.sum(1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


# ---- the route: which kernels, cluster size, rows per tile -----------------------

SM_COUNT = 132                  # streaming multiprocessors of the H100 SXM
MAX_CLUSTER = 8                 # the largest portable thread-block cluster
MIN_UNITS_PER_CTA = 8           # a cluster is not split finer than this many units
REC_KERNELS = ("lstm_proj", "lstm_rec", "lstm_rec_bwd")
OLD_KERNELS = ("lstm_fwd", "lstm_bwd")
_MAX_THREADS = {8: 512, 16: 416}   # the recurrences' __launch_bounds__ per tile height


class LSTMRoute(NamedTuple):
    """What `bilstm_fused` launches on the card for one shape: `kernels` (the
    forward's, then the backward's), and for the Hopper kernels the cluster size,
    the rows per tile and the lanes that split each unit's dot products."""
    kernels: tuple[str, ...]
    cluster: int
    rows: int
    split: int


def _conflict_free(stride: int, width: int, blocks: int) -> bool:
    banks = [(i * stride + b) % 32 for i in range(blocks) for b in range(width)]
    return len(set(banks)) == len(banks)


def _pad_stride(stride: int, step: int, width: int, blocks: int) -> int:
    while not _conflict_free(stride, width, blocks):
        stride += step
    return stride


def rec_geometry(h: int, cluster: int, rows: int, split: int) -> tuple[int, int, int]:
    """(threads, forward smem bytes, backward smem bytes) of lstm_rec /
    lstm_rec_bwd: fwd_geometry and bwd_geometry of csrc/lstm_rec.cuh."""
    upw = 32 // split
    hc = -(-h // cluster)
    units = -(-hc // upw) * upw
    threads = units // upw * 32
    fwd = 4 * (h * _pad_stride(4 * units, 4, 128 // split, split // 4) + 2 * h * rows)
    bwd = 4 * (4 * h * _pad_stride(units, 1, 32 // split, split // 4) + 2 * 4 * h * rows)
    return threads, fwd, bwd


_SPLITS = {8: (16, 8, 4), 16: (4,)}   # the (rows, split) pairs the sources instantiate


def _split(h: int, cluster: int, rows: int) -> int | None:
    """The most lanes per unit within the thread limit whose shared memory fits,
    forward and backward; None if none does."""
    for split in _SPLITS[rows]:
        threads, fwd, bwd = rec_geometry(h, cluster, rows, split)
        if threads <= _MAX_THREADS[rows] and max(fwd, bwd) <= build.SMEM_LIMIT:
            return split
    return None


@functools.cache
def lstm_route(n: int, t: int, d: int, h: int) -> LSTMRoute:
    """The kernels for a bi-LSTM of n rows, t steps, input width d and hidden
    width h on the card. The Hopper kernels take every h whose Wh slice, with
    the other shared buffers, fits one CTA of a cluster of at most MAX_CLUSTER;
    past that, the L2-streaming kernels. With blocks = 2 directions x
    ceil(n / 8) tiles: up to 2 x SM_COUNT blocks the cluster is at least 2 and
    doubles while blocks x cluster stays within SM_COUNT (one CTA per SM,
    shorter per-step chains) and each CTA keeps MIN_UNITS_PER_CTA units; past
    2 x SM_COUNT, one-CTA clusters with tiles of 16 rows where the shared
    memory allows (the grid is full: per-SM throughput, not a step's latency,
    bounds it). Chosen from chip_smoke's route sweep on the H100 (PERF.md).
    t and d do not change the choice."""
    del t, d
    fit = next((c for c in (1, 2, 4, 8) if _split(h, c, 8) is not None), None)
    if fit is None:
        return LSTMRoute(OLD_KERNELS, 1, 8, 0)
    blocks = 2 * -(-n // 8)
    if blocks > 2 * SM_COUNT:
        if fit == 1 and 2 * -(-n // 16) >= SM_COUNT and _split(h, 1, 16) is not None:
            return LSTMRoute(REC_KERNELS, 1, 16, _split(h, 1, 16))
        return LSTMRoute(REC_KERNELS, fit, 8, _split(h, fit, 8))
    c = fit
    while (2 * c <= MAX_CLUSTER and (c < 2 or blocks * 2 * c <= SM_COUNT)
           and -(-h // (2 * c)) >= MIN_UNITS_PER_CTA and _split(h, 2 * c, 8) is not None):
        c *= 2
    return LSTMRoute(REC_KERNELS, c, 8, _split(h, c, 8))


# ---- the Hopper kernels: lstm_proj, lstm_rec, lstm_rec_bwd -----------------------

@functools.cache
def _rec_lib(stem: str) -> ctypes.CDLL:
    """csrc/<stem>.cu's library (lstm_rec or lstm_rec_bwd) with its argument
    types (see each source); lstm_rec's also exports lstm_proj and lstm_k1."""
    lib = build.library(stem)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, stem)
    fn.argtypes = {"lstm_rec": [p] * 7 + [i] * 6 + [f, i, p],
                   "lstm_rec_bwd": [p] * 8 + [i] * 6 + [f, p]}[stem]
    fn.restype = i
    if stem == "lstm_rec":
        lib.lstm_proj.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.lstm_proj.restype = i
        lib.lstm_k1.argtypes = [p] * 12 + [i] * 7 + [f, i, p]
        lib.lstm_k1.restype = i
    getattr(lib, f"{stem}_smem_bytes").argtypes = [i] * 4
    getattr(lib, f"{stem}_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, f"{stem}_error_string").argtypes = [i]
    getattr(lib, f"{stem}_error_string").restype = ctypes.c_char_p
    return lib


def _rec_call(stem: str, wrappers, dev, *args, fn: str | None = None) -> None:
    """Call csrc/<stem>.cu's `fn` (default: <stem>) on the current stream of
    `dev`; count one launch on each of `wrappers`."""
    lib = _rec_lib(stem)
    with torch.cuda.device(dev):
        err = getattr(lib, fn or stem)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{fn or stem} launch failed: {msg}")
    for wrapper in wrappers:
        build.count_launch(wrapper)


@functools.cache
def _rec_route(stem: str, n: int, t: int, d: int, h: int) -> LSTMRoute:
    route = lstm_route(n, t, d, h)
    if route.kernels != REC_KERNELS:
        raise ValueError(f"{stem} keeps Wh resident in shared memory and does not take "
                         f"H={h} (route {route.kernels}): past the largest cluster the route "
                         "goes to lstm_fwd / lstm_bwd")
    lib = _rec_lib(stem)
    smem = getattr(lib, f"{stem}_smem_bytes")(h, route.cluster, route.rows, route.split)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"{stem} needs {smem} B of shared memory at H={h}, route {route}; "
                         f"a block has {build.SMEM_LIMIT}")
    return route


def lstm_proj(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
              params_bw: LSTMParams) -> torch.Tensor:
    """Launch the projection (the first half of K1): xg [N, T, 8H] = x . [wx_fw |
    wx_bw] + [b_fw | b_bw] at the original positions; positions in 64- or
    128-position tiles that lie wholly past their rows' lengths are left
    unwritten (no recurrence reads them). Inputs as for `lstm_fwd`. Counts its
    launches in `lstm_proj.launches`."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_proj")
    xg = torch.empty((n, t, 8 * h), dtype=torch.float32, device=x.device)
    if n * t == 0:
        return xg
    _rec_call("lstm_rec", (lstm_proj,), x.device, x.data_ptr(), lengths.data_ptr(),
              params_fw.wx.data_ptr(), params_bw.wx.data_ptr(), params_fw.b.data_ptr(),
              params_bw.b.data_ptr(), xg.data_ptr(), n, t, d, h, fn="lstm_proj")
    return xg


lstm_proj.launches = 0


def lstm_rec(xg: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, forget_bias: float, emit_out: bool,
             emit_cell: bool = False, write_preact: bool = False
             ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """Launch the recurrence (the second half of K1) on lstm_proj's xg
    [N, T, 8H]: (out [N, T, 2H] or None, fin [N, 2H], cell [N, T, 2H] or None),
    as `lstm_fwd` returns them. With write_preact each step's gate
    pre-activations xg[t] + h_{t-1} . Wh overwrite xg[t] in place (the input of
    `lstm_rec_bwd`). Cluster, tile and lane split from `lstm_route`. Counts its
    launches in `lstm_rec.launches`."""
    if xg.device.type != "cuda":
        raise ValueError(f"lstm_rec launches on a CUDA device, got {xg.device}")
    n, t = xg.shape[:2]
    d, h = params_fw.wx.shape[0], params_fw.wh.shape[0]
    dev = xg.device
    build.check_f32("xg", xg, (n, t, 8 * h), dev)
    for tag, p in (("fw", params_fw), ("bw", params_bw)):
        build.check_f32(f"{tag}.wh", p.wh, (h, 4 * h), dev)
    if lengths.device != dev or lengths.dtype != torch.int32 or tuple(lengths.shape) != (n,):
        raise ValueError("lengths must be int32 [N] on the device of xg")
    seq = lambda: torch.empty((n, t, 2 * h), dtype=torch.float32, device=dev)
    out = seq() if emit_out else None
    cell = seq() if emit_cell else None
    fin = torch.empty((n, 2 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return out, fin, cell
    route = _rec_route("lstm_rec", n, t, d, h)
    _rec_call("lstm_rec", (lstm_rec,), dev, xg.data_ptr(), lengths.data_ptr(),
              params_fw.wh.data_ptr(), params_bw.wh.data_ptr(), _ptr(out), _ptr(cell),
              fin.data_ptr(), n, t, h, route.cluster, route.rows, route.split,
              float(forget_bias), int(write_preact))
    return out, fin, cell


lstm_rec.launches = 0


def lstm_k1(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
            params_bw: LSTMParams, forget_bias: float, emit_out: bool,
            emit_cell: bool = False, write_preact: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """K1 on the Hopper route from one host call (csrc/lstm_rec.cu's lstm_k1):
    lstm_proj's kernel, then lstm_rec's, as `lstm_proj` followed by `lstm_rec`
    computes them, with half the host work. Returns (pre [N, T, 8H], out or
    None, fin, cell or None); pre holds the projection, overwritten by the
    pre-activations under write_preact. Counts one launch on each of
    `lstm_proj.launches` (none at T = 0, where the C call skips the
    projection) and `lstm_rec.launches`."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_k1")
    dev = x.device
    seq = lambda: torch.empty((n, t, 2 * h), dtype=torch.float32, device=dev)
    pre = torch.empty((n, t, 8 * h), dtype=torch.float32, device=dev)
    out = seq() if emit_out else None
    cell = seq() if emit_cell else None
    fin = torch.empty((n, 2 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return pre, out, fin, cell
    route = _rec_route("lstm_rec", n, t, d, h)
    launched = (lstm_proj, lstm_rec) if t > 0 else (lstm_rec,)
    _rec_call("lstm_rec", launched, dev, x.data_ptr(), lengths.data_ptr(),
              params_fw.wx.data_ptr(), params_bw.wx.data_ptr(), params_fw.b.data_ptr(),
              params_bw.b.data_ptr(), params_fw.wh.data_ptr(), params_bw.wh.data_ptr(),
              pre.data_ptr(), _ptr(out), _ptr(cell), fin.data_ptr(), n, t, d, h, route.cluster,
              route.rows, route.split, float(forget_bias), int(write_preact), fn="lstm_k1")
    return pre, out, fin, cell


def lstm_rec_bwd(pre: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
                 params_bw: LSTMParams, cell: torch.Tensor, g_out: torch.Tensor | None,
                 g_fin: torch.Tensor | None, forget_bias: float) -> torch.Tensor:
    """Launch the redesigned K1b: dgates [N, T, 8H] (as `lstm_bwd` returns them)
    from the pre-activations `lstm_rec` wrote under grad, its cell [N, T, 2H]
    and the cotangents g_out [N, T, 2H], g_fin [N, 2H] (None = zero). Reads wh
    of both directions; no x, no wx. Counts its launches in
    `lstm_rec_bwd.launches`."""
    if pre.device.type != "cuda":
        raise ValueError(f"lstm_rec_bwd launches on a CUDA device, got {pre.device}")
    n, t = pre.shape[:2]
    d, h = params_fw.wx.shape[0], params_fw.wh.shape[0]
    dev = pre.device
    build.check_f32("pre", pre, (n, t, 8 * h), dev)
    for tag, p in (("fw", params_fw), ("bw", params_bw)):
        build.check_f32(f"{tag}.wh", p.wh, (h, 4 * h), dev)
    for name, a, shape in (("cell", cell, (n, t, 2 * h)), ("g_out", g_out, (n, t, 2 * h)),
                           ("g_fin", g_fin, (n, 2 * h))):
        if a is not None:
            build.check_f32(name, a, shape, dev)
    if lengths.device != dev or lengths.dtype != torch.int32 or tuple(lengths.shape) != (n,):
        raise ValueError("lengths must be int32 [N] on the device of pre")
    dgates = torch.empty((n, t, 8 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return dgates
    route = _rec_route("lstm_rec_bwd", n, t, d, h)
    _rec_call("lstm_rec_bwd", (lstm_rec_bwd,), dev, pre.data_ptr(), lengths.data_ptr(),
              params_fw.wh.data_ptr(), params_bw.wh.data_ptr(), cell.data_ptr(), _ptr(g_out),
              _ptr(g_fin), dgates.data_ptr(), n, t, h, route.cluster, route.rows,
              route.split, float(forget_bias))
    return dgates


lstm_rec_bwd.launches = 0


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
    """K1 with cells forward, K1b + products backward, on the kernels
    `lstm_route` names. Inputs: x, lengths, then the six weight tensors (wx, wh,
    b forward; wx, wh, b backward)."""

    @staticmethod
    def forward(ctx, x, lengths, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        n, t, d = x.shape
        pre = None
        if lstm_route(n, t, d, wh_f.shape[0]).kernels == REC_KERNELS:
            pre, out, fin, cell = lstm_k1(x, lengths, p_fw, p_bw, forget_bias, emit_out=True,
                                          emit_cell=True, write_preact=True)
        else:
            out, fin, cell = lstm_fwd(x, lengths, p_fw, p_bw, forget_bias, emit_out=True,
                                      emit_cell=True)
        ctx.save_for_backward(x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell, pre)
        ctx.forget_bias = forget_bias
        ctx.set_materialize_grads(False)
        return out, fin

    @staticmethod
    def backward(ctx, g_out, g_fin):
        x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell, pre = ctx.saved_tensors
        if g_out is None and g_fin is None:
            return (None,) * 9
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        g_out = None if g_out is None else g_out.contiguous()
        g_fin = None if g_fin is None else g_fin.contiguous()
        if pre is not None:
            dgates = lstm_rec_bwd(pre, lengths, p_fw, p_bw, cell, g_out, g_fin,
                                  ctx.forget_bias)
        else:
            dgates = lstm_bwd(x, lengths, p_fw, p_bw, out, cell, g_out, g_fin, ctx.forget_bias)
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
    n, t, d = x.shape
    if lstm_route(n, t, d, params_fw.wh.shape[0]).kernels == REC_KERNELS:
        _, out, fin, _ = lstm_k1(x, lengths, params_fw, params_bw, forget_bias, emit_out)
    else:
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
