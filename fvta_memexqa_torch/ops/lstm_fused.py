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

`bilstm_fused_grouped` runs K bi-LSTMs over one shared batch (the JAX package's
bilstm_fused_grouped, e.g. the six per-modality time encoders) as G = 2K groups
of ONE launch of each kernel of the route: the kernels take a group axis (the
grid's y axis; the projection's z axis), and each group's sums are those of a
lone `bilstm_fused` call on its bi-LSTM. `_GroupedBiLSTMFn` forms dX, dWx, dWh
and db per bi-LSTM from the one K1b launch's dgates. The K7/K8 scan API is
another module, ops/lstm_grouped.

`dtype=torch.bfloat16` (ModelConfig.dtype = "bfloat16") is the bf16
activation variant: the JAX package's bilstm_ref(dtype=bfloat16), which it
runs even under use_pallas. On a CPU tensor the plain `bilstm_ref(dtype=)`; on
the card each kernel's BF16 instantiation (the same sources' entry points with
their `bf16` flag set, one bi-LSTM a launch): x and the weights are rounded to bf16 here,
the kernels round x.Wx + b, and c and h after each step, and keep float32
storage holding those values; the backward runs straight through the
roundings. Either way the outputs come back as float32 tensors holding bf16
values. The launches count on the same wrappers' `.launches`, and those of the
BF16 instantiations also on `.bf16_launches`.

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
    k, wx_ms, wh_ms, b_ms, bf16, stream), <stem>_smem_bytes(d, h),
    <stem>_error_string(err)."""
    lib = build.library(stem)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    getattr(lib, stem).argtypes = [p] * n_ptr + [i] * 4 + [ctypes.c_float, i, ll, ll, ll, i, p]
    getattr(lib, stem).restype = i
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


def _check_grouped(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                   b: torch.Tensor, kernel: str) -> tuple[int, int, int, int, int]:
    """(K, N, T, D, H) of K bi-LSTMs over one batch as the grouped launchers take
    them: x [K, N, T, D], lengths [K, N] int32, and the weights as [2K, ...]
    stacks (group 2m + dir: bi-LSTM m, direction dir) wx [2K, D, 4H], wh
    [2K, H, 4H], b [2K, 4H], all contiguous on one CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {x.device}")
    if x.dim() != 4 or wh.dim() != 3:
        raise ValueError(f"{kernel} takes x [K, N, T, D] and wh [2K, H, 4H], got "
                         f"{tuple(x.shape)} and {tuple(wh.shape)}")
    k, n, t, d = x.shape
    h = wh.shape[1]
    dev = x.device
    build.check_f32("x", x, (k, n, t, d), dev)
    build.check_f32("wx", wx, (2 * k, d, 4 * h), dev)
    build.check_f32("wh", wh, (2 * k, h, 4 * h), dev)
    build.check_f32("b", b, (2 * k, 4 * h), dev)
    if (lengths.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (k, n) or not lengths.is_contiguous()):
        raise ValueError("lengths must be contiguous int32 [K, N] on the device of x")
    return k, n, t, d, h


def _ptr(a: torch.Tensor | None):
    return a.data_ptr() if a is not None else None


def _bases(w) -> tuple[int, int, int]:
    """(forward base, backward base, elements from one bi-LSTM's weights to the
    next's in a direction) of one weight: a (forward, backward) pair of tensors
    where they lie (one bi-LSTM; the stride is unread) or a [2K, ...] stack."""
    if isinstance(w, torch.Tensor):
        return w[0].data_ptr(), w[1].data_ptr(), 2 * w[0].numel()
    return w[0].data_ptr(), w[1].data_ptr(), 0


def _pairs(params_fw: LSTMParams, params_bw: LSTMParams) -> tuple:
    """One bi-LSTM's (wx, wh, b), each a (forward, backward) pair for _bases."""
    return tuple((getattr(params_fw, f), getattr(params_bw, f)) for f in ("wx", "wh", "b"))


def lstm_fwd(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, forget_bias: float, emit_out: bool,
             emit_cell: bool = False, bf16: bool = False
             ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """Launch K1. x [N, T, D] f32, lengths [N] int32, and per direction wx [D, 4H],
    wh [H, 4H], b [4H], all contiguous on one CUDA device; the kernel reads both
    directions' weights where they lie. Returns (out [N, T, 2H] or None,
    fin [N, 2H], cell [N, T, 2H] or None); cell holds the carried c of each step
    at the original time positions, for the backward. bf16: the BF16
    instantiation (inputs holding bf16 values). Counts its
    launches in `lstm_fwd.launches` (and `.bf16_launches`)."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_fwd")
    return _fwd_call(x, lengths, _pairs(params_fw, params_bw), (), 1, n, t, d, h, forget_bias,
                     emit_out, emit_cell, bf16)


lstm_fwd.launches = lstm_fwd.bf16_launches = 0


def _old_call(stem: str, dev, d: int, h: int, *args, bf16: bool = False) -> None:
    """Check csrc/<stem>.cu's shared memory at (d, h) (lstm_fwd or lstm_bwd),
    call its launcher with args and the bf16 flag on the current stream of
    `dev`; count one launch."""
    lib = _lib(stem, {"lstm_fwd": 11, "lstm_bwd": 15}[stem])
    smem = getattr(lib, f"{stem}_smem_bytes")(d, h)
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"{stem} needs {smem} B of shared memory at D={d}, H={h}; "
                         f"a block has {build.SMEM_LIMIT}")
    with torch.cuda.device(dev):
        err = getattr(lib, stem)(*args, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{stem} launch failed: {msg}")
    build.count_launch(globals()[stem], bf16=bf16)


def _fwd_call(x, lengths, weights, lead, k, n, t, d, h, forget_bias, emit_out, emit_cell,
              bf16=False):
    """lstm_fwd's launch for k bi-LSTMs (weights: (wx, wh, b) as _bases takes
    them); outputs shaped lead + [N, ...]."""
    dev = x.device
    seq = lambda: torch.empty((*lead, n, t, 2 * h), dtype=torch.float32, device=dev)
    out = seq() if emit_out else None
    cell = seq() if emit_cell else None
    fin = torch.empty((*lead, n, 2 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return out, fin, cell
    (wxf, wxb, wxs), (whf, whb, whs), (bf, bb, bs) = map(_bases, weights)
    _old_call("lstm_fwd", dev, d, h, x.data_ptr(), lengths.data_ptr(), wxf, wxb, whf, whb, bf, bb,
              _ptr(out), _ptr(cell), fin.data_ptr(), n, t, d, h, float(forget_bias), k, wxs,
              whs, bs, bf16=bf16)
    return out, fin, cell


def lstm_fwd_grouped(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor, forget_bias: float, emit_out: bool,
                     emit_cell: bool = False
                     ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """`lstm_fwd` for K bi-LSTMs over one batch in one launch (inputs as
    _check_grouped takes them): (out [K, N, T, 2H] or None, fin [K, N, 2H],
    cell [K, N, T, 2H] or None). Counts one launch in `lstm_fwd.launches`."""
    k, n, t, d, h = _check_grouped(x, lengths, wx, wh, b, "lstm_fwd")
    return _fwd_call(x, lengths, (wx, wh, b), (k,), k, n, t, d, h, forget_bias, emit_out,
                     emit_cell)


def lstm_bwd(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, out: torch.Tensor, cell: torch.Tensor,
             g_out: torch.Tensor | None, g_fin: torch.Tensor | None,
             forget_bias: float, bf16: bool = False) -> torch.Tensor:
    """Launch K1b: the gate cotangents dgates [N, T, 8H] (forward direction's
    (i, j, f, o) in [:4H], backward's in [4H:], at the original time positions)
    from K1's out and cell [N, T, 2H] and the cotangents g_out [N, T, 2H] and
    g_fin [N, 2H] (None = zero). Inputs as for `lstm_fwd` (bf16: the backward
    of lstm_fwd's BF16 instantiation). Counts its launches in
    `lstm_bwd.launches` (and `.bf16_launches`)."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_bwd")
    wht = tuple(p.wh.t().contiguous() for p in (params_fw, params_bw))
    return _bwd_call(x, lengths, _pairs(params_fw, params_bw), wht, (), 1, n, t, d, h, out,
                     cell, g_out, g_fin, forget_bias, bf16)


lstm_bwd.launches = lstm_bwd.bf16_launches = 0


def _bwd_call(x, lengths, weights, wht, lead, k, n, t, d, h, out, cell, g_out, g_fin,
              forget_bias, bf16=False):
    """lstm_bwd's launch for k bi-LSTMs (weights as _fwd_call's, wht the
    transposed wh in wh's layout); dgates shaped lead + [N, T, 8H]."""
    dev = x.device
    for name, a, shape in (("out", out, (n, t, 2 * h)), ("cell", cell, (n, t, 2 * h)),
                           ("g_out", g_out, (n, t, 2 * h)), ("g_fin", g_fin, (n, 2 * h))):
        if a is not None:
            build.check_f32(name, a, (*lead, *shape), dev)
    dgates = torch.empty((*lead, n, t, 8 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return dgates
    (wxf, wxb, wxs), (whf, whb, whs), (bf, bb, bs) = map(_bases, weights)
    (wtf, wtb, _) = _bases(wht)
    _old_call("lstm_bwd", dev, d, h, x.data_ptr(), lengths.data_ptr(), wxf, wxb, whf, whb,
              wtf, wtb, bf, bb, out.data_ptr(), cell.data_ptr(), _ptr(g_out), _ptr(g_fin),
              dgates.data_ptr(), n, t, d, h, float(forget_bias), k, wxs, whs, bs, bf16=bf16)
    return dgates


def lstm_bwd_grouped(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor, out: torch.Tensor, cell: torch.Tensor,
                     g_out: torch.Tensor | None, g_fin: torch.Tensor | None,
                     forget_bias: float) -> torch.Tensor:
    """`lstm_bwd` for K bi-LSTMs over one batch in one launch (inputs as
    `lstm_fwd_grouped` takes them; out, cell, g_out [K, N, T, 2H], g_fin
    [K, N, 2H]): dgates [K, N, T, 8H]. Counts one launch in `lstm_bwd.launches`."""
    k, n, t, d, h = _check_grouped(x, lengths, wx, wh, b, "lstm_bwd")
    return _bwd_call(x, lengths, (wx, wh, b), wh.transpose(1, 2).contiguous(), (k,), k, n, t, d,
                     h, out, cell, g_out, g_fin, forget_bias)


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
    types (see each source); lstm_rec's also exports lstm_proj and lstm_k1.
    lstm_k1 and lstm_rec_bwd take a bf16 flag before the stream."""
    lib = build.library(stem)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    types = {"lstm_rec": {"lstm_rec": [p] * 7 + [i] * 6 + [f, i, i, ll, p],
                          "lstm_proj": [p] * 7 + [i] * 5 + [ll, ll, p],
                          "lstm_k1": [p] * 12 + [i] * 7 + [f, i, i, ll, ll, ll, i, p]},
             "lstm_rec_bwd": {"lstm_rec_bwd": [p] * 8 + [i] * 6 + [f, i, ll, i, p]}}[stem]
    for name, argtypes in types.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    getattr(lib, f"{stem}_smem_bytes").argtypes = [i] * 4
    getattr(lib, f"{stem}_smem_bytes").restype = ctypes.c_longlong
    getattr(lib, f"{stem}_error_string").argtypes = [i]
    getattr(lib, f"{stem}_error_string").restype = ctypes.c_char_p
    return lib


def _rec_call(stem: str, wrappers, dev, *args, fn: str | None = None,
              bf16: bool = False) -> None:
    """Call csrc/<stem>.cu's `fn` (default: <stem>) on the current stream of
    `dev`; count one launch on each of `wrappers` (bf16: a launch of the BF16
    instantiation, which args select)."""
    lib = _rec_lib(stem)
    name = fn or stem
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")
    for wrapper in wrappers:
        build.count_launch(wrapper, bf16=bf16)


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
    launches in `lstm_proj.launches` (lstm_k1's launches of its BF16
    instantiation also in `.bf16_launches`)."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_proj")
    xg = torch.empty((n, t, 8 * h), dtype=torch.float32, device=x.device)
    if n * t == 0:
        return xg
    _rec_call("lstm_rec", (lstm_proj,), x.device, x.data_ptr(), lengths.data_ptr(),
              params_fw.wx.data_ptr(), params_bw.wx.data_ptr(), params_fw.b.data_ptr(),
              params_bw.b.data_ptr(), xg.data_ptr(), n, t, d, h, 1, 0, 0, fn="lstm_proj")
    return xg


lstm_proj.launches = lstm_proj.bf16_launches = 0


def lstm_rec(xg: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
             params_bw: LSTMParams, forget_bias: float, emit_out: bool,
             emit_cell: bool = False, write_preact: bool = False
             ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """Launch the recurrence (the second half of K1) on lstm_proj's xg
    [N, T, 8H]: (out [N, T, 2H] or None, fin [N, 2H], cell [N, T, 2H] or None),
    as `lstm_fwd` returns them. With write_preact each step's gate
    pre-activations xg[t] + h_{t-1} . Wh overwrite xg[t] in place (the input of
    `lstm_rec_bwd`). Cluster, tile and lane split from `lstm_route`. Counts its
    launches in `lstm_rec.launches` (lstm_k1's launches of its BF16
    instantiation also in `.bf16_launches`)."""
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
              float(forget_bias), int(write_preact), 1, 0)
    return out, fin, cell


lstm_rec.launches = lstm_rec.bf16_launches = 0


def lstm_k1(x: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
            params_bw: LSTMParams, forget_bias: float, emit_out: bool,
            emit_cell: bool = False, write_preact: bool = False, bf16: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor | None]:
    """K1 on the Hopper route from one host call (csrc/lstm_rec.cu's lstm_k1):
    lstm_proj's kernel, then lstm_rec's, as `lstm_proj` followed by `lstm_rec`
    computes them, with half the host work. Returns (pre [N, T, 8H], out or
    None, fin, cell or None); pre holds the projection, overwritten by the
    pre-activations under write_preact; bf16: both kernels' BF16
    instantiations. Counts one launch on each of `lstm_proj.launches` (none at
    T = 0, where the C call skips the projection) and `lstm_rec.launches` (and
    on their `.bf16_launches`)."""
    n, t, d, h = _check_common(x, lengths, params_fw, params_bw, "lstm_k1")
    return _k1_call(x, lengths, _pairs(params_fw, params_bw), (), 1, n, t, d, h, forget_bias,
                    emit_out, emit_cell, write_preact, bf16)


def _k1_call(x, lengths, weights, lead, k, n, t, d, h, forget_bias, emit_out, emit_cell,
             write_preact, bf16=False):
    """lstm_k1's launches for k bi-LSTMs (weights: (wx, wh, b) as _bases takes
    them), on the route of one bi-LSTM of the shape; outputs shaped lead +
    [N, ...]."""
    dev = x.device
    seq = lambda: torch.empty((*lead, n, t, 2 * h), dtype=torch.float32, device=dev)
    pre = torch.empty((*lead, n, t, 8 * h), dtype=torch.float32, device=dev)
    out = seq() if emit_out else None
    cell = seq() if emit_cell else None
    fin = torch.empty((*lead, n, 2 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return pre, out, fin, cell
    route = _rec_route("lstm_rec", n, t, d, h)
    launched = (lstm_proj, lstm_rec) if t > 0 else (lstm_rec,)
    (wxf, wxb, wxs), (whf, whb, whs), (bf, bb, bs) = map(_bases, weights)
    _rec_call("lstm_rec", launched, dev, x.data_ptr(), lengths.data_ptr(), wxf, wxb, bf, bb,
              whf, whb, pre.data_ptr(), _ptr(out), _ptr(cell), fin.data_ptr(), n, t, d, h,
              route.cluster, route.rows, route.split, float(forget_bias), int(write_preact),
              k, wxs, whs, bs, int(bf16), fn="lstm_k1", bf16=bf16)
    return pre, out, fin, cell


def lstm_k1_grouped(x: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                    b: torch.Tensor, forget_bias: float, emit_out: bool,
                    emit_cell: bool = False, write_preact: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor,
                               torch.Tensor | None]:
    """`lstm_k1` for K bi-LSTMs over one batch (inputs as _check_grouped takes
    them): one launch of lstm_proj's kernel and one of lstm_rec's for all 2K
    groups, each group on the route `lstm_route` gives one bi-LSTM of the shape
    (so each group's sums are a lone call's). Returns (pre [K, N, T, 8H], out
    [K, N, T, 2H] or None, fin [K, N, 2H], cell [K, N, T, 2H] or None). Counts
    as `lstm_k1` does."""
    k, n, t, d, h = _check_grouped(x, lengths, wx, wh, b, "lstm_k1")
    return _k1_call(x, lengths, (wx, wh, b), (k,), k, n, t, d, h, forget_bias, emit_out,
                    emit_cell, write_preact)


def lstm_rec_bwd(pre: torch.Tensor, lengths: torch.Tensor, params_fw: LSTMParams,
                 params_bw: LSTMParams, cell: torch.Tensor, g_out: torch.Tensor | None,
                 g_fin: torch.Tensor | None, forget_bias: float,
                 bf16: bool = False) -> torch.Tensor:
    """Launch the redesigned K1b: dgates [N, T, 8H] (as `lstm_bwd` returns them)
    from the pre-activations `lstm_rec` wrote under grad, its cell [N, T, 2H]
    and the cotangents g_out [N, T, 2H], g_fin [N, 2H] (None = zero). Reads wh
    of both directions; no x, no wx. bf16: the backward of lstm_rec's BF16
    instantiation. Counts its launches in `lstm_rec_bwd.launches` (and
    `.bf16_launches`)."""
    if pre.device.type != "cuda":
        raise ValueError(f"lstm_rec_bwd launches on a CUDA device, got {pre.device}")
    n, t = pre.shape[:2]
    d, h = params_fw.wx.shape[0], params_fw.wh.shape[0]
    for tag, p in (("fw", params_fw), ("bw", params_bw)):
        build.check_f32(f"{tag}.wh", p.wh, (h, 4 * h), pre.device)
    return _rec_bwd_call(pre, lengths, (params_fw.wh, params_bw.wh), (), 1, n, t, d, h, cell,
                         g_out, g_fin, forget_bias, bf16)


lstm_rec_bwd.launches = lstm_rec_bwd.bf16_launches = 0


def _rec_bwd_call(pre, lengths, wh, lead, k, n, t, d, h, cell, g_out, g_fin, forget_bias,
                  bf16=False):
    """lstm_rec_bwd's launch for k bi-LSTMs (wh as _bases takes it); dgates
    shaped lead + [N, T, 8H]."""
    dev = pre.device
    build.check_f32("pre", pre, (*lead, n, t, 8 * h), dev)
    for name, a, shape in (("cell", cell, (n, t, 2 * h)), ("g_out", g_out, (n, t, 2 * h)),
                           ("g_fin", g_fin, (n, 2 * h))):
        if a is not None:
            build.check_f32(name, a, (*lead, *shape), dev)
    if (lengths.device != dev or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (*lead, n) or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be contiguous int32 {[*lead, n]} on the device of pre")
    dgates = torch.empty((*lead, n, t, 8 * h), dtype=torch.float32, device=dev)
    if n == 0:
        return dgates
    route = _rec_route("lstm_rec_bwd", n, t, d, h)
    whf, whb, whs = _bases(wh)
    _rec_call("lstm_rec_bwd", (lstm_rec_bwd,), dev, pre.data_ptr(), lengths.data_ptr(), whf, whb,
              cell.data_ptr(), _ptr(g_out), _ptr(g_fin), dgates.data_ptr(), n, t, h,
              route.cluster, route.rows, route.split, float(forget_bias), k, whs, int(bf16),
              bf16=bf16)
    return dgates


def lstm_rec_bwd_grouped(pre: torch.Tensor, lengths: torch.Tensor, wx: torch.Tensor,
                         wh: torch.Tensor, cell: torch.Tensor, g_out: torch.Tensor | None,
                         g_fin: torch.Tensor | None, forget_bias: float) -> torch.Tensor:
    """`lstm_rec_bwd` for K bi-LSTMs over one batch in one launch: dgates
    [K, N, T, 8H] from `lstm_k1_grouped`'s pre and cell and the cotangents
    g_out [K, N, T, 2H], g_fin [K, N, 2H] (None = zero); wx [2K, D, 4H] and wh
    [2K, H, 4H] as lstm_k1_grouped took them (wx gives D for the route and is
    not read). Counts one launch in `lstm_rec_bwd.launches`."""
    if pre.device.type != "cuda":
        raise ValueError(f"lstm_rec_bwd launches on a CUDA device, got {pre.device}")
    k, n, t = pre.shape[:3]
    d, h = wx.shape[1], wh.shape[1]
    build.check_f32("wh", wh, (2 * k, h, 4 * h), pre.device)
    return _rec_bwd_call(pre, lengths, wh, (k,), k, n, t, d, h, cell, g_out, g_fin, forget_bias)


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
    `lstm_route` names. Inputs: x, lengths, forget_bias, the six weight tensors
    (wx, wh, b forward; wx, wh, b backward), then bf16 (optional: the BF16
    instantiations, on inputs already holding bf16 values; the backward runs
    straight through the kernels' roundings)."""

    @staticmethod
    def forward(ctx, x, lengths, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b, bf16=False):
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        n, t, d = x.shape
        pre = None
        if lstm_route(n, t, d, wh_f.shape[0]).kernels == REC_KERNELS:
            pre, out, fin, cell = lstm_k1(x, lengths, p_fw, p_bw, forget_bias, emit_out=True,
                                          emit_cell=True, write_preact=True, bf16=bf16)
        else:
            out, fin, cell = lstm_fwd(x, lengths, p_fw, p_bw, forget_bias, emit_out=True,
                                      emit_cell=True, bf16=bf16)
        ctx.save_for_backward(x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell, pre)
        ctx.forget_bias, ctx.bf16 = forget_bias, bf16
        ctx.set_materialize_grads(False)
        return out, fin

    @staticmethod
    def backward(ctx, g_out, g_fin):
        x, lengths, wx_f, wh_f, b_f, wx_b, wh_b, b_b, out, cell, pre = ctx.saved_tensors
        if g_out is None and g_fin is None:
            return (None,) * 10
        p_fw, p_bw = LSTMParams(wx_f, wh_f, b_f), LSTMParams(wx_b, wh_b, b_b)
        g_out = None if g_out is None else g_out.contiguous()
        g_fin = None if g_fin is None else g_fin.contiguous()
        if pre is not None:
            dgates = lstm_rec_bwd(pre, lengths, p_fw, p_bw, cell, g_out, g_fin,
                                  ctx.forget_bias, bf16=ctx.bf16)
        else:
            dgates = lstm_bwd(x, lengths, p_fw, p_bw, out, cell, g_out, g_fin, ctx.forget_bias,
                              bf16=ctx.bf16)
        dx, d_fw, d_bw = _assemble_bwd(x, p_fw, p_bw, out, dgates, ctx.needs_input_grad[0])
        return (dx, None, None, *d_fw, *d_bw, None)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 → bf16 → float32 (round to nearest even), differentiable."""
    return t.to(torch.bfloat16).to(torch.float32)


def _launch(params_fw: LSTMParams, params_bw: LSTMParams, x, mask, forget_bias,
            emit_out: bool, bf16: bool = False):
    """(out or None, fin) on the card: K1 alone without grad, _BiLSTMFn with it.
    bf16: x and the weights rounded to bf16 first (as the JAX scan casts them;
    their cotangents come back rounded, as JAX's do), then the BF16
    instantiations."""
    if bf16:
        x = _round_bf16(x)
        params_fw, params_bw = (LSTMParams(*map(_round_bf16, p)) for p in (params_fw, params_bw))
    x = x.contiguous()
    lengths = mask.sum(dim=1, dtype=torch.int32)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in (*params_fw, *params_bw))):
        out, fin = _BiLSTMFn.apply(x, lengths, float(forget_bias), *params_fw, *params_bw, bf16)
        return (out if emit_out else None), fin
    n, t, d = x.shape
    if lstm_route(n, t, d, params_fw.wh.shape[0]).kernels == REC_KERNELS:
        _, out, fin, _ = lstm_k1(x, lengths, params_fw, params_bw, forget_bias, emit_out,
                                 bf16=bf16)
    else:
        out, fin, _ = lstm_fwd(x, lengths, params_fw, params_bw, forget_bias, emit_out,
                               bf16=bf16)
    return out, fin


def _is_bf16(dtype) -> bool:
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"the bi-LSTM's activation dtype is float32 or bfloat16, got {dtype}")
    return dtype == torch.bfloat16


def bilstm_fused(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                 mask: torch.Tensor, forget_bias: float = 1.0, dtype=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bi-LSTM encode: (outputs [N, T, 2H], final [N, 2H]), float32.
    dtype=torch.bfloat16: the bf16 activation variant (module docstring)."""
    bf16 = _is_bf16(dtype)
    if x.device.type == "cpu":
        out, fin = bilstm_ref(params_fw, params_bw, x, mask, forget_bias, dtype=dtype)
        return out.float(), fin.float()
    return _launch(params_fw, params_bw, x, mask, forget_bias, emit_out=True, bf16=bf16)


def bilstm_fused_final(params_fw: LSTMParams, params_bw: LSTMParams, x: torch.Tensor,
                       mask: torch.Tensor, forget_bias: float = 1.0, dtype=None) -> torch.Tensor:
    """Final-state-only fused bi-LSTM: fin [N, 2H]. Without grad no per-step
    output is written on the card; under grad the forward keeps the per-step
    outputs and cells that the backward needs (as the JAX package's vjp does).
    dtype as for bilstm_fused."""
    bf16 = _is_bf16(dtype)
    if x.device.type == "cpu":
        return bilstm_ref(params_fw, params_bw, x, mask, forget_bias, dtype=dtype)[1].float()
    return _launch(params_fw, params_bw, x, mask, forget_bias, emit_out=False, bf16=bf16)[1]


# ---- K bi-LSTMs over one batch in one launch of K1 and one of K1b ------------------

def _prep_group(params_pairs, xs, masks):
    """K bi-LSTMs over a shared batch as one stack of G = 2K groups (the JAX
    package's _prep_group without its 128-lane gate padding): x [K, N, T_max,
    D_max] with zero time and feature padding, lengths [K, N] int32, wx [2K,
    D_max, 4H] with zero rows past each D_k (so the padding adds exact zeros to
    every sum), wh [2K, H, 4H], b [2K, 4H]; group 2m + dir is bi-LSTM m's
    direction dir. H must be shared; N too."""
    if not params_pairs or not (len(params_pairs) == len(xs) == len(masks)):
        raise ValueError(f"bilstm_fused_grouped takes as many (p_fw, p_bw) pairs, inputs and "
                         f"masks, at least one: got {len(params_pairs)}, {len(xs)}, "
                         f"{len(masks)}")
    hs = {p.wh.shape[0] for pair in params_pairs for p in pair}
    if len(hs) != 1:   # padding only equalizes T and D; H must match across the group
        raise ValueError(f"grouped bi-LSTMs must share hidden_dim, got {sorted(hs)}")
    if len({x.shape[0] for x in xs}) != 1:
        raise ValueError(f"grouped bi-LSTMs run over one batch, got N = "
                         f"{[x.shape[0] for x in xs]}")
    t_max = max(x.shape[1] for x in xs)
    d_max = max(x.shape[2] for x in xs)
    x = torch.stack([torch.nn.functional.pad(x, (0, d_max - x.shape[2], 0, t_max - x.shape[1]))
                     for x in xs])
    lengths = torch.stack([m.sum(dim=1, dtype=torch.int32) for m in masks])
    ps = [p for pair in params_pairs for p in pair]
    wx = torch.stack([torch.nn.functional.pad(p.wx, (0, 0, 0, d_max - p.wx.shape[0]))
                      for p in ps])
    return (x.contiguous(), lengths, wx, torch.stack([p.wh for p in ps]),
            torch.stack([p.b for p in ps]))


def _grouped_k1(x, lengths, wx, wh, b, forget_bias, emit_cell: bool):
    """(pre or None, out [K, N, T, 2H], fin [K, N, 2H], cell or None): one K1
    launch for the stack on the route of one bi-LSTM of its shape."""
    k, n, t, d = x.shape
    if lstm_route(n, t, d, wh.shape[1]).kernels == REC_KERNELS:
        return lstm_k1_grouped(x, lengths, wx, wh, b, forget_bias, emit_out=True,
                               emit_cell=emit_cell, write_preact=emit_cell)
    return (None, *lstm_fwd_grouped(x, lengths, wx, wh, b, forget_bias, emit_out=True,
                                    emit_cell=emit_cell))


def _unstack(out, fin, xs):
    """Each bi-LSTM's (out [N, T_k, 2H], fin [N, 2H]) from the stack's outputs."""
    return tuple(o for k, x in enumerate(xs) for o in (out[k, :, :x.shape[1]], fin[k]))


class _GroupedBiLSTMFn(torch.autograd.Function):
    """K bi-LSTMs over one batch: one K1 launch forward (cells and, on the Hopper
    route, the pre-activations kept), one K1b launch backward, then dX, dWx,
    dWh and db per bi-LSTM as _assemble_bwd's products (as the JAX package's
    _grouped_bwd forms them outside Pallas). Inputs: forget_bias, K, then the K
    masks, the K inputs and the 6K weights (wx, wh, b forward, then backward,
    per bi-LSTM). Outputs: out_1, fin_1, ..., out_K, fin_K."""

    @staticmethod
    def forward(ctx, forget_bias, k, *tensors):
        masks, xs, ws = tensors[:k], tensors[k:2 * k], tensors[2 * k:]
        pairs = [(LSTMParams(*ws[6 * m:6 * m + 3]), LSTMParams(*ws[6 * m + 3:6 * m + 6]))
                 for m in range(k)]
        x, lengths, wx, wh, b = _prep_group(pairs, xs, masks)
        pre, out, fin, cell = _grouped_k1(x, lengths, wx, wh, b, forget_bias, emit_cell=True)
        ctx.save_for_backward(x, lengths, wx, wh, b, out, cell, pre)
        ctx.forget_bias, ctx.shapes = forget_bias, [tuple(xx.shape) for xx in xs]
        ctx.set_materialize_grads(False)
        return _unstack(out, fin, xs)

    @staticmethod
    def backward(ctx, *grads):
        x, lengths, wx, wh, b, out, cell, pre = ctx.saved_tensors
        k = len(ctx.shapes)
        if all(g is None for g in grads):
            return (None,) * (2 + 8 * k)
        n, t_max = x.shape[1:3]
        h = wh.shape[1]
        g_out = x.new_zeros(k, n, t_max, 2 * h)
        g_fin = x.new_zeros(k, n, 2 * h)
        for m, (_, t_m, _) in enumerate(ctx.shapes):
            if grads[2 * m] is not None:
                g_out[m, :, :t_m] = grads[2 * m]
            if grads[2 * m + 1] is not None:
                g_fin[m] = grads[2 * m + 1]
        if pre is not None:
            dgates = lstm_rec_bwd_grouped(pre, lengths, wx, wh, cell, g_out, g_fin,
                                          ctx.forget_bias)
        else:
            dgates = lstm_bwd_grouped(x, lengths, wx, wh, b, out, cell, g_out, g_fin,
                                      ctx.forget_bias)
        dxs, dws = [], []
        for m, (_, t_m, d_m) in enumerate(ctx.shapes):
            p_fw = LSTMParams(wx[2 * m], wh[2 * m], b[2 * m])
            p_bw = LSTMParams(wx[2 * m + 1], wh[2 * m + 1], b[2 * m + 1])
            dx, d_fw, d_bw = _assemble_bwd(x[m], p_fw, p_bw, out[m], dgates[m],
                                           ctx.needs_input_grad[2 + k + m])
            dxs.append(None if dx is None else dx[:, :t_m, :d_m])
            dws += [d_fw.wx[:d_m], d_fw.wh, d_fw.b, d_bw.wx[:d_m], d_bw.wh, d_bw.b]
        return (None, None, *(None,) * k, *dxs, *dws)


def bilstm_fused_grouped_ref(params_pairs, xs, masks, forget_bias: float = 1.0
                             ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """bilstm_fused_grouped's plain version: `bilstm_ref` per pair."""
    return tuple(bilstm_ref(p_fw, p_bw, x, mask, forget_bias)
                 for (p_fw, p_bw), x, mask in zip(params_pairs, xs, masks))


def bilstm_fused_grouped(params_pairs, xs, masks, forget_bias: float = 1.0
                         ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """K independent bi-LSTM encodes over one shared batch in ONE launch of K1
    and (under grad) one of K1b, G = 2K groups each: the JAX package's
    bilstm_fused_grouped (fvta_memexqa_tpu/ops/lstm_fused.py:495), e.g. the
    flagship model's six per-modality time encoders. params_pairs: tuple of
    (p_fw, p_bw) sharing H; xs: tuple of [N, T_k, D_k]; masks: tuple of
    [N, T_k] prefix masks. Returns a tuple of (out [N, T_k, 2H], fin [N, 2H]),
    each equal to `bilstm_fused` of its pair. The inputs are padded to the
    longest T and the widest D; each group runs on the route `lstm_route` gives
    one bi-LSTM of (N, T_max, D_max, H). Not ops/lstm_grouped.bilstm_grouped,
    which is the K7/K8 scan API (lstm_pallas.py's counterpart). On a CPU tensor
    it runs `bilstm_fused_grouped_ref`."""
    if len({p.wh.shape[0] for pair in params_pairs for p in pair}) > 1:
        _prep_group(params_pairs, xs, masks)   # raises the shared-H ValueError
    if xs[0].device.type == "cpu":
        return bilstm_fused_grouped_ref(params_pairs, xs, masks, forget_bias)
    k = len(xs)
    weights = [w for pair in params_pairs for p in pair for w in p]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*xs, *weights)):
        flat = _GroupedBiLSTMFn.apply(float(forget_bias), k, *masks, *xs, *weights)
    else:
        x, lengths, wx, wh, b = _prep_group(params_pairs, xs, masks)
        _, out, fin, _ = _grouped_k1(x, lengths, wx, wh, b, forget_bias, emit_cell=False)
        flat = _unstack(out, fin, xs)
    return tuple(zip(flat[0::2], flat[1::2]))
