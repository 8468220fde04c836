"""Grouped LSTM scans over a precomputed input projection: kernels K7
(csrc/lstm_grouped.cu) and K8 (csrc/lstm_stream.cu), and their plain version.

The counterpart of fvta_memexqa_tpu/ops/lstm_pallas.py, the round-1 fused scans
that lstm_fused.py superseded: `lstm_scan_grouped` is `lstm_scan_pallas` and
`bilstm_grouped` is `bilstm_pallas` (not ops/lstm_fused.bilstm_fused_grouped,
K bi-LSTMs over one batch in one launch of K1 and K1b), with the contract of lstm_ref.lstm_scan_ref
and bilstm_ref — (out [N, T, H or 2H], fin [N, H or 2H]), outputs 0 past each
row's length, fin the last carried h.

- The input projection x @ Wx + b stays a matmul outside the kernel, as in the
  JAX package; the kernels own only the recurrence gates = x_proj[t] + h @ Wh,
  for G independent scans in one launch (G = 2 for the two directions of a
  bi-LSTM, whose backward direction reads the length-aware flip of x and has
  its output flipped back).
- Both kernels run K1's Hopper recurrence (csrc/lstm_gscan.cuh over
  csrc/lstm_rec.cuh) over G groups: thread-block clusters split the hidden
  units, `grouped_route` picks (cluster, rows per tile, lanes per unit) and the
  library's own route is read once per device and shape. Past the largest
  cluster that holds the Wh slices (H = 316 and up), the route reads Wh from
  device memory at every step (the library says so with its route,
  `takes_wh_global`; those launches also counted in `.global_launches`);
  `scan_grouped_wh_global` / `scan_stream_wh_global` force that at any width,
  and no path calls them. They differ only in
  how x_proj arrives: K7 loads step t + 1 into registers during step t, K8
  streams it into a shared-memory ring by bulk async copies. The sums run in
  the same order, so K7 and K8 give the same bits, and a G = 2 call fed K1's
  projection gives K1's bits wherever the routes share a lane split.
- A call on the card routes by the JAX package's rule (`_run_grouped`,
  lstm_pallas.py:280): K8 when n >= 1024 and t >= 2, K7 otherwise. The rule
  was tuned for the TPU; it is kept so that the same calls reach the same
  kernels in both packages.
- `block_b` is read and selects nothing (the TPU's batch tile); the kernels
  tile rows themselves.
- Backward: as in the JAX package's custom_vjp (lstm_pallas.py:317-326,
  361-371), the backward is no kernel. `_GroupedFn.backward` recomputes the
  forward through the plain lstm_scan_ref / bilstm_ref under autograd and
  returns its gradients; that is the reference's own design, not a fallback.

On a CUDA tensor the forward launches K7 or K8 (a kernel that fails to build or
launch raises; there is no fallback); on a CPU tensor it runs the plain
`grouped_scan_ref` through the same routing. Masks must be contiguous
prefixes: the kernels see only lengths = mask.sum(1).

K7 replaces fvta_memexqa_tpu/ops/lstm_pallas.py:_grouped_kernel, K8
:_stream_kernel. Nothing on the model's paths calls them (the model runs
lstm_fused's K1/K1b); the public functions here are their only route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from fvta_memexqa_torch.ops import build, lstm_fused
from fvta_memexqa_torch.ops.lstm_ref import (LSTMParams, _flip_to_front, bilstm_ref,
                                             lstm_cell, lstm_scan_ref)

STREAM_MIN_ROWS = 1024   # the JAX package's routing rule: K8 from 1024 rows ...
STREAM_MIN_T = 2         # ... and 2 time steps on


def uses_stream(n: int, t: int) -> bool:
    """Whether a scan of n rows over t steps goes to K8 (else K7)."""
    return n >= STREAM_MIN_ROWS and t >= STREAM_MIN_T


# ---- plain version ----------------------------------------------------------------

def grouped_scan_ref(x_proj: torch.Tensor, lengths: torch.Tensor,
                     wh: torch.Tensor | Sequence[torch.Tensor], forget_bias: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's and K8's function: x_proj [G, N, T, 4H], lengths int [G, N], wh
    [G, H, 4H] (or G tensors [H, 4H]) → (out [G, N, T, H], fin [G, N, H]);
    step t updates h and c of the rows with t < length and outputs 0 for the
    others."""
    if not torch.is_tensor(wh):
        wh = torch.stack(list(wh))
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


# ---- the route: cluster, rows per tile, lanes per unit ----------------------------

HEADER_BYTES = 128   # shared memory of the ring's mbarriers and the tile's lengths
MAX_THREADS_WH_GLOBAL = 1024   # the Wh-global kernels' __launch_bounds__


class GroupedRoute(NamedTuple):
    """The launch shape of K7 and K8 for one call: clusters of `cluster` CTAs,
    tiles of `rows` rows, `split` lanes per hidden unit."""
    cluster: int
    rows: int
    split: int


def ring_stride(h: int, cluster: int) -> int:
    """Floats between the (row, gate) runs of K8's ring: ceil(H / C) rounded up
    to 4 (gscan::ring_stride)."""
    return -(-(-(-h // cluster)) // 4) * 4


def grouped_smem(h: int, cluster: int, rows: int, split: int, stream: bool,
                 wh_global: bool = False) -> int:
    """Dynamic shared memory per CTA of K7 (stream=False) or K8: the header,
    lstm_rec's forward geometry (Wh slice, h double-buffered; with Wh global h
    alone) and K8's ring (gscan::layout_bytes)."""
    if wh_global:
        staged = 4 * 2 * h * rows
    else:
        staged = lstm_fused.rec_geometry(h, cluster, rows, split)[1]
    ring = 4 * 2 * 4 * rows * ring_stride(h, cluster) if stream else 0
    return HEADER_BYTES + staged + ring


def _split(h: int, cluster: int, rows: int) -> int | None:
    """The most lanes per unit within the thread limit whose K8 fits with Wh
    resident; None if none does (gscan::pick_split)."""
    for split in lstm_fused._SPLITS[rows]:
        threads = lstm_fused.rec_geometry(h, cluster, rows, split)[0]
        if (threads <= lstm_fused._MAX_THREADS[rows]
                and grouped_smem(h, cluster, rows, split, True) <= build.SMEM_LIMIT):
            return split
    return None


@functools.cache
def grouped_route(g: int, n: int, t: int, h: int) -> GroupedRoute | None:
    """The Python mirror of csrc/lstm_gscan.cuh's `route`: lstm_fused.lstm_route's
    rule with blocks = g x ceil(n / 8) for g groups and the grouped kernels' own
    shared memory (K8's ring included, so that K7 and K8 share a route); past
    the largest cluster, Wh global at clusters of 8 (None only where even h
    does not fit, H > 1024). At g = 2 it picks lstm_route's (cluster, rows,
    split) wherever K8's ring fits beside K1's choice (every width up to 100,
    the repo's). t does not change the choice."""
    del t
    fit = next((c for c in (1, 2, 4, 8) if _split(h, c, 8) is not None), None)
    if fit is None:   # 4 lanes per unit: a warp's Wh loads take whole 32-byte sectors
        c = lstm_fused.MAX_CLUSTER
        fits = (lstm_fused.rec_geometry(h, c, 8, 4)[0] <= MAX_THREADS_WH_GLOBAL
                and grouped_smem(h, c, 8, 4, True, True) <= build.SMEM_LIMIT)
        return GroupedRoute(c, 8, 4) if fits else None
    sms = lstm_fused.SM_COUNT
    blocks = g * -(-n // 8)
    if blocks > 2 * sms:
        if fit == 1 and g * -(-n // 16) >= sms and _split(h, 1, 16) is not None:
            return GroupedRoute(1, 16, _split(h, 1, 16))
        return GroupedRoute(fit, 8, _split(h, fit, 8))
    c = fit
    while (2 * c <= lstm_fused.MAX_CLUSTER and (c < 2 or blocks * 2 * c <= sms)
           and -(-h // (2 * c)) >= lstm_fused.MIN_UNITS_PER_CTA
           and _split(h, 2 * c, 8) is not None):
        c *= 2
    return GroupedRoute(c, 8, _split(h, c, 8))


# ---- kernel wrappers -----------------------------------------------------------------

@functools.cache
def _lib(stem: str) -> ctypes.CDLL:
    """csrc/<stem>.cu's library: <stem> (the Hopper kernel), <stem>_wh_global
    (forced to read Wh from device memory), <stem>_route, <stem>_smem_bytes and
    <stem>_error_string."""
    lib = build.library(stem)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    pi = ctypes.POINTER(ctypes.c_int)
    for name, args, res in (
            (stem, [p, p, ll, p, ll, p, p] + [i] * 7 + [f, p], i),
            (f"{stem}_wh_global", [p, p, ll, p, ll, p, p] + [i] * 7 + [f, p], i),
            (f"{stem}_route", [i] * 4 + [pi] * 4, i),
            (f"{stem}_smem_bytes", [i] * 4, ll),
            (f"{stem}_error_string", [i], ctypes.c_char_p)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    return lib


@functools.cache
def _route(stem: str, device: int, g: int, n: int, t: int, h: int
           ) -> tuple[GroupedRoute, bool]:
    """The library's route for a call and whether its launch reads Wh from
    device memory (read once per device and shape)."""
    del device   # one route for every H100; the key keeps a second card's read apart
    c, rows, split, glob = (ctypes.c_int() for _ in range(4))
    if getattr(_lib(stem), f"{stem}_route")(g, n, t, h, *map(ctypes.byref,
                                                              (c, rows, split, glob))) != 0:
        raise RuntimeError(f"{stem}_route: no launch shape holds h at H={h} in a CTA's "
                           "shared memory")
    return GroupedRoute(c.value, rows.value, split.value), bool(glob.value)


def takes_wh_global(g: int, n: int, t: int, h: int) -> bool:
    """Whether K7 and K8 read Wh from device memory for a call of g groups of n
    rows, t steps at width h on the current CUDA device, as the library's route
    says."""
    return _route("lstm_grouped", torch.cuda.current_device(), g, n, t, h)[1]


def _wh_layout(wh, g: int, h: int, dev) -> tuple[int, int]:
    """(pointer, group stride in floats) of Wh: a [G, H, 4H] tensor, or G tensors
    [H, 4H] read where they lie (one stride between consecutive ones)."""
    if torch.is_tensor(wh):
        build.check_f32("wh", wh, (g, h, 4 * h), dev)
        return wh.data_ptr(), h * 4 * h
    if len(wh) != g:
        raise ValueError(f"{len(wh)} Wh tensors for {g} groups")
    for k, w in enumerate(wh):
        build.check_f32(f"wh[{k}]", w, (h, 4 * h), dev)
    ptrs = [w.data_ptr() for w in wh]
    steps = {b - a for a, b in zip(ptrs, ptrs[1:])}
    if len(steps) > 1 or any(s % 4 for s in steps):
        raise ValueError("the groups' Wh tensors must lie one stride of whole floats apart")
    return ptrs[0], (steps.pop() // 4 if steps else 0)


def _outputs(g: int, n: int, t: int, h: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    if g * n * t == 0:
        return (torch.zeros((g, n, t, h), dtype=torch.float32, device=dev),
                torch.zeros((g, n, h), dtype=torch.float32, device=dev))
    # the kernels write every element of out and fin
    return (torch.empty((g, n, t, h), dtype=torch.float32, device=dev),
            torch.empty((g, n, h), dtype=torch.float32, device=dev))


def _check(stem: str, x_proj: torch.Tensor, lengths: torch.Tensor) -> tuple[int, int, int, int]:
    if x_proj.device.type != "cuda":
        raise ValueError(f"{stem} launches on a CUDA device, got {x_proj.device}")
    g, n, t, g4 = x_proj.shape
    h = g4 // 4
    build.check_f32("x_proj", x_proj, (g, n, t, 4 * h), x_proj.device)
    if (lengths.device != x_proj.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (g, n) or (n > 1 and lengths.stride(1) != 1)):
        raise ValueError("lengths must be int32 [G, N] on the device of x_proj, "
                         "contiguous along N")
    return g, n, t, h


def _launch(wrapper, stem: str, x_proj: torch.Tensor, lengths: torch.Tensor, wh,
            forget_bias: float, route: GroupedRoute | None = None,
            entry: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch `entry` (default the kernel itself under the library's route, Wh
    global where the library says so) of csrc/<stem>.cu; the forced entries
    take `route` (default the library's) and always read Wh globally."""
    g, n, t, h = _check(stem, x_proj, lengths)
    dev = x_proj.device
    wh_ptr, wh_stride = _wh_layout(wh, g, h, dev)
    out, fin = _outputs(g, n, t, h, dev)
    if g * n * t == 0:
        return out, fin
    if entry is None:
        entry = stem
        route, glob = _route(stem, dev.index, g, n, t, h)
    else:
        route, glob = route or _route(stem, dev.index, g, n, t, h)[0], True
    lib = _lib(stem)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(x_proj.data_ptr(), lengths.data_ptr(), lengths.stride(0),
                                  wh_ptr, wh_stride, out.data_ptr(), fin.data_ptr(), g, n, t, h,
                                  route.cluster, route.rows, route.split, float(forget_bias),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")
    build.count_launch(wrapper, glob)
    return out, fin


def scan_grouped(x_proj: torch.Tensor, lengths: torch.Tensor,
                 wh: torch.Tensor | Sequence[torch.Tensor], forget_bias: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 (arguments and results as `grouped_scan_ref`; float32,
    contiguous, on one CUDA device; lengths int32, contiguous along N, its
    group stride may be 0; wh a [G, H, 4H] tensor or G [H, 4H] tensors at one
    stride, read where they lie). Counts its launches in
    `scan_grouped.launches`, those reading Wh from device memory also in
    `scan_grouped.global_launches`."""
    return _launch(scan_grouped, "lstm_grouped", x_proj, lengths, wh, forget_bias)


def scan_stream(x_proj: torch.Tensor, lengths: torch.Tensor,
                wh: torch.Tensor | Sequence[torch.Tensor], forget_bias: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 (as `scan_grouped`). Counts its launches in
    `scan_stream.launches` and `scan_stream.global_launches`."""
    return _launch(scan_stream, "lstm_stream", x_proj, lengths, wh, forget_bias)


def scan_grouped_wh_global(x_proj: torch.Tensor, lengths: torch.Tensor,
                           wh: torch.Tensor | Sequence[torch.Tensor], forget_bias: float,
                           route: GroupedRoute | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 reading Wh from device memory at any width, under `route` (default
    the library's route; any instantiated (rows, split)). No path calls it; at
    the same route it gives `scan_grouped`'s bits. Counts its launches in
    `scan_grouped_wh_global.launches` and `.global_launches`."""
    return _launch(scan_grouped_wh_global, "lstm_grouped", x_proj, lengths, wh, forget_bias,
                   route, "lstm_grouped_wh_global")


def scan_stream_wh_global(x_proj: torch.Tensor, lengths: torch.Tensor,
                          wh: torch.Tensor | Sequence[torch.Tensor], forget_bias: float,
                          route: GroupedRoute | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 reading Wh from device memory (as `scan_grouped_wh_global`). Counts
    its launches in `scan_stream_wh_global.launches` and `.global_launches`."""
    return _launch(scan_stream_wh_global, "lstm_stream", x_proj, lengths, wh, forget_bias,
                   route, "lstm_stream_wh_global")


for _w in (scan_grouped, scan_stream, scan_grouped_wh_global, scan_stream_wh_global):
    _w.launches = _w.global_launches = 0


def _kernels(device: torch.device):
    """(K7, K8) for tensors on `device`: the kernels on the card, the plain
    version (for both) on the CPU."""
    if device.type == "cpu":
        return grouped_scan_ref, grouped_scan_ref
    return scan_grouped, scan_stream


def _scan(x_proj, lengths, whs, forget_bias):
    """The routed grouped scan over the G tensors `whs`: K8 or K7 by the JAX
    package's rule."""
    _, n, t, _ = x_proj.shape
    k7, k8 = _kernels(x_proj.device)
    return (k8 if uses_stream(n, t) else k7)(x_proj.contiguous(), lengths,
                                            tuple(w.contiguous() for w in whs), forget_bias)


# ---- the API ---------------------------------------------------------------------------

def _project(xs, wxs, bs):
    """x @ wx + b of each (x [N, T, D], wx, b) into one [G, N, T, 4H], written in
    place (no stacked copy; a product, then the bias added, as `x @ wx + b`
    rounds: cuBLASLt's fused bias costs more host time per call than the add)."""
    n, t, _ = xs[0].shape
    xp = xs[0].new_empty(len(xs), n, t, wxs[0].shape[1])
    for k, (x, wx, b) in enumerate(zip(xs, wxs, bs)):
        torch.matmul(x, wx, out=xp[k]).add_(b)
    return xp


def _uni_forward(x, mask, forget_bias, wx, wh, b):
    lengths = mask.sum(1, dtype=torch.int32)
    out, fin = _scan(_project([x], [wx], [b]), lengths[None], (wh,), forget_bias)
    return out[0], fin[0]


def _bi_forward(x, mask, forget_bias, wx_f, wh_f, b_f, wx_b, wh_b, b_b):
    lengths = mask.sum(1, dtype=torch.int32)
    xp = _project([x, _flip_to_front(x, lengths)], [wx_f, wx_b], [b_f, b_b])
    out, fin = _scan(xp, lengths[None].expand(2, -1), (wh_f, wh_b), forget_bias)
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
    and selects nothing. The K7/K8 API (lstm_pallas.bilstm_pallas's
    counterpart); K bi-LSTMs in one K1 launch are ops/lstm_fused's
    bilstm_fused_grouped."""
    return _GroupedFn.apply(True, x, mask.bool(), float(forget_bias), *params_fw, *params_bw)
