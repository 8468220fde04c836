"""Streaming FVTA statistics: kernel K4 (csrc/fvta_stats.cu) and its backward pair,
K5 (tie counts) and K6 (gradient) in csrc/fvta_bwd.cu, each beside its plain
version.

`fvta_stats_fused` computes fvta_ref.focal_local_stats — (m, den, v, eq, e),
which fvta_ref.focal_finalize turns into the attention output — without the
[N, S, T, J] correlation in device memory. It is the long-T form of the FVTA
attention (ops/fvta_fused.fvta_attention_fused takes it from STREAM_MIN_T
time steps on). Under grad it runs `_StatsFn`:

- forward: K4 (`stats_fwd`);
- backward: the prologue of the JAX package's `_stats_bwd`
  (fvta_memexqa_tpu/ops/fvta_pallas.py:683-691) in torch — p = exp(e - m),
  dp = gden + <gv, h>, dm = gm - sum_t p dp, de = ge + p dp + tie_m dm / #tie_m —
  then K5 (`qcnt`), the global tie counts of eq, then K6 (`stats_bwd`), which
  recomputes C, routes de and geq through the two maxima and returns dh, dq and
  per-example dwx, dwy, dwxy; those are summed over N here, as the JAX package
  does.

On a CUDA tensor these launch the kernels (a kernel that fails to build or
launch raises; there is no fallback); on a CPU tensor `_StatsFn` runs the
plain versions `stats_fwd_ref`, `qcnt_ref` and `stats_bwd_ref`, so the CPU walks
the same decomposition as the card. The bilinear similarity has no kernel and
runs focal_local_stats under autograd.

K4 replaces fvta_memexqa_tpu/ops/fvta_pallas.py:_stats_kernel, K5 :_qcnt_kernel
and K6 :_bwd_kernel. K4 and K5 walk the time axis in runs of chunks, one CTA
per run, with the geometry `run_geometry` reads once per device and shape.
Each geometry names its route: "staged" (h and q in shared memory) wherever
that fits, else "global" (h and q read from device memory), so every width
runs; the kernels count the global route's launches in `.global_launches`
beside `.launches`. `stats_fwd_global`, `qcnt_global` and `stats_bwd_global`
force the global route at any width: no path calls them; they hold the two
routes against each other, bit for bit, on the card.
Earlier kernels that no path calls are kept to be timed and checked beside
the ones the paths launch: `stats_fwd_chunked` and `qcnt_chunked` (one block
per chunk of 32 steps) and `stats_bwd_twopass` (dC through device memory).
The TPU-only parts of the JAX dispatch (S >= 8 padding, _pick_tblock, the
short-T XLA-remat branch of _stats_bwd) have no counterpart: on the card the
backward is always K5 + K6.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fvta_memexqa_torch.ops import build
from fvta_memexqa_torch.ops.fvta_ref import focal_local_stats, similarity_tensor
from fvta_memexqa_torch.ops.masking import exp_mask

TCH = 32   # time steps per chunk in the kernels (csrc/fvta_corr.cuh)


def _trilinear(wx, wy, wxy) -> dict[str, torch.Tensor]:
    return {"w_x": wx, "w_y": wy, "w_xy": wxy}


# ---- plain versions --------------------------------------------------------------

def stats_fwd_ref(h, cm_f, q, qm_f, wx, wy, wxy):
    """K4's function: focal_local_stats with masks given as float 0/1."""
    return focal_local_stats(h, cm_f > 0.5, q, qm_f > 0.5, "trilinear",
                             _trilinear(wx, wy, wxy))


def qcnt_ref(h, cm_f, q, wx, wy, wxy, eq):
    """K5's function: qcnt [N, J] f32, the number of (s, t) whose ctx-masked
    correlation equals eq exactly."""
    c = exp_mask(similarity_tensor(h, q, "trilinear", _trilinear(wx, wy, wxy)),
                 cm_f[..., None] > 0.5)
    return (c == eq[:, None, None, :]).to(h.dtype).sum(dim=(1, 2))


def stats_bwd_ref(h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt, e, m, gv):
    """K6's function over the whole T: (dh [N,S,T,D], dq [N,J,D], and per example
    dwx, dwy, dwxy [N, D]) from the time-score cotangent de [N,S,T], eq's
    cotangent geq [N,J], the global tie counts qcnt [N,J], the saved e, m and v's
    cotangent gv [N,S,D]."""
    c = similarity_tensor(h, q, "trilinear", _trilinear(wx, wy, wxy))   # [N,S,T,J]
    cq = exp_mask(c, qm_f[:, None, None, :] > 0.5)
    tie_j = (cq == torch.amax(cq, dim=-1, keepdim=True)).to(h.dtype)
    dc = tie_j * (de[..., None] / tie_j.sum(dim=-1, keepdim=True))
    tie_q = (exp_mask(c, cm_f[..., None] > 0.5) == eq[:, None, None, :]).to(h.dtype)
    dc = dc + tie_q * (geq / torch.clamp(qcnt, min=1.0))[:, None, None, :]
    rowsum = dc.sum(dim=-1)                                             # [N,S,T]
    colsum = dc.sum(dim=(1, 2))                                         # [N,J]
    p = torch.exp(e - m[..., None])
    dh = (torch.einsum("nstj,njd->nstd", dc, q * wxy) + rowsum[..., None] * wx
          + p[..., None] * gv[:, :, None, :])
    tmp = torch.einsum("nstj,nstd->njd", dc, h)
    dq = tmp * wxy + colsum[..., None] * wy
    dwx = torch.einsum("nst,nstd->nd", rowsum, h)
    dwy = torch.einsum("nj,njd->nd", colsum, q)
    dwxy = (tmp * q).sum(dim=1)
    return dh, dq, dwx, dwy, dwxy


# ---- kernel wrappers ---------------------------------------------------------------

@functools.cache
def _stats_lib():
    lib = build.library("fvta_stats")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fvta_stats.argtypes = [p] * 13 + [i] * 9 + [ll, i, p]
    lib.fvta_stats.restype = i
    for name in ("fvta_stats_geometry", "fvta_stats_geometry_global"):
        getattr(lib, name).argtypes = [i] * 5 + [p]
        getattr(lib, name).restype = i
    lib.fvta_stats_chunked.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.fvta_stats_chunked.restype = i
    lib.fvta_stats_chunked_smem_bytes.argtypes = [i]
    lib.fvta_stats_chunked_smem_bytes.restype = ll
    lib.fvta_stats_error_string.argtypes = [i]
    lib.fvta_stats_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = build.library("fvta_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fvta_qcnt.argtypes = [p] * 8 + [i] * 9 + [ll, i, p]
    lib.fvta_qcnt.restype = i
    lib.fvta_qcnt_chunked.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.fvta_qcnt_chunked.restype = i
    lib.fvta_stats_bwd.argtypes = [p] * 20 + [i] * 9 + [ll, i, p]
    lib.fvta_stats_bwd.restype = i
    for name in ("fvta_stats_bwd_geometry", "fvta_stats_bwd_geometry_global"):
        getattr(lib, name).argtypes = [i] * 5 + [p]
        getattr(lib, name).restype = i
    lib.fvta_stats_bwd_twopass.argtypes = [p] * 22 + [i] * 5 + [p]
    lib.fvta_stats_bwd_twopass.restype = i
    lib.fvta_qcnt_chunked_smem_bytes.argtypes = [i]
    lib.fvta_qcnt_chunked_smem_bytes.restype = ll
    lib.fvta_stats_bwd_twopass_smem_bytes.argtypes = [i, i]
    lib.fvta_stats_bwd_twopass_smem_bytes.restype = ll
    lib.fvta_bwd_error_string.argtypes = [i]
    lib.fvta_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(kernel: str, h, cm_f, q, wx, wy, wxy, qm_f=None):
    if h.device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {h.device}")
    n, s, t, d = h.shape
    j = q.shape[1]
    dev = h.device
    args = [("h", h, (n, s, t, d)), ("ctx_mask", cm_f, (n, s, t)), ("q", q, (n, j, d)),
            ("w_x", wx, (d,)), ("w_y", wy, (d,)), ("w_xy", wxy, (d,))]
    if qm_f is not None:
        args.append(("q_mask", qm_f, (n, j)))
    for name, a, shape in args:
        build.check_f32(name, a, shape, dev)
    if min(n, s, t, j, d) < 1:
        raise ValueError(f"{kernel} needs N, S, T, J, D >= 1, got {(n, s, t, j, d)}")
    return n, s, t, j, d


def _smem_ok(kernel: str, smem: int, shape) -> None:
    """The kept old kernels' guard: they stage h in shared memory at every width."""
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"{kernel} needs {smem} B of shared memory at {shape}; a block "
                         f"has {build.SMEM_LIMIT}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


ROUTES = ("staged", "global")   # a geometry's route, by the library's number


def _geometry(name: str, lib, error_string, keys, device: int, shape) -> dict:
    """Read the library's geometry `name` for `shape` on `device`; raises where
    the library reports a shape it cannot run."""
    out = (ctypes.c_longlong * len(keys))()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*shape, out)
    if err != 0:
        raise RuntimeError(f"{name} at (N, S, T, J, D) = {shape}: "
                           f"{error_string(err).decode()}")
    geo = dict(zip(keys, out))
    geo["route"] = ROUTES[geo["route"]]
    return geo


RUN_KEYS = ("per_seq", "chunks_per_cta", "rows", "h_buffers", "smem", "scratch", "route")


@functools.cache
def _run_geometry_on(device: int, n, s, t, j, d, force_global: bool = False) -> dict:
    name = "fvta_stats_geometry_global" if force_global else "fvta_stats_geometry"
    lib = _stats_lib()
    return _geometry(name, lib, lib.fvta_stats_error_string, RUN_KEYS, device, (n, s, t, j, d))


def run_geometry(n, s, t, j, d, force_global: bool = False) -> dict:
    """K4's and K5's launch geometry on the current CUDA device, as the library
    computes it (csrc/fvta_corr.cuh run_geometry): CTAs per sequence, chunks per
    CTA, rows per pass, h buffers, shared memory per CTA (bytes), K4's scratch
    (floats), route ("staged" wherever it fits, else "global"; force_global:
    "global" at any width). Read once per device and shape; `stats_fwd` and
    `qcnt` pass it to the launch unchanged."""
    return _run_geometry_on(torch.cuda.current_device(), n, s, t, j, d, force_global)


def _stats_fwd(wrapper, force_global, h, cm_f, q, qm_f, wx, wy, wxy):
    shape = _check(wrapper.__name__, h, cm_f, q, wx, wy, wxy, qm_f)
    n, s, t, j, d = shape
    dev = h.device
    empty = lambda *sh: torch.empty(sh, dtype=torch.float32, device=dev)
    m, den, v, eq, e = empty(n, s), empty(n, s), empty(n, s, d), empty(n, j), empty(n, s, t)
    lib = _stats_lib()
    with torch.cuda.device(dev):
        geo = run_geometry(*shape, force_global)
        scratch = empty(geo["scratch"])
        ptrs = [a.data_ptr() for a in (h, cm_f, q, qm_f, wx, wy, wxy, m, den, v, eq, e,
                                       scratch)]
        err = lib.fvta_stats(*ptrs, *shape, geo["per_seq"], geo["chunks_per_cta"],
                             geo["rows"], geo["h_buffers"], geo["smem"],
                             ROUTES.index(geo["route"]), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           f"{lib.fvta_stats_error_string(err).decode()}")
    build.count_launch(wrapper, geo["route"] == "global")
    return m, den, v, eq, e


def stats_fwd(h, cm_f, q, qm_f, wx, wy, wxy):
    """Launch K4. h [N,S,T,D], cm_f [N,S,T], q [N,J,D], qm_f [N,J] (masks as
    float32 0/1), wx/wy/wxy [D]; all f32, contiguous, on one CUDA device.
    Returns (m [N,S], den [N,S], v [N,S,D], eq [N,J], e [N,S,T]). Counts its
    launches in `stats_fwd.launches`, those on the global route also in
    `stats_fwd.global_launches`."""
    return _stats_fwd(stats_fwd, False, h, cm_f, q, qm_f, wx, wy, wxy)


def stats_fwd_global(h, cm_f, q, qm_f, wx, wy, wxy):
    """K4 on the global route at any width (`stats_fwd`'s arguments and
    results; no path calls it). Counts its launches in
    `stats_fwd_global.launches`."""
    return _stats_fwd(stats_fwd_global, True, h, cm_f, q, qm_f, wx, wy, wxy)


stats_fwd.launches = stats_fwd.global_launches = 0
stats_fwd_global.launches = stats_fwd_global.global_launches = 0


def stats_fwd_chunked(h, cm_f, q, qm_f, wx, wy, wxy):
    """The chunked K4 (one block per chunk of 32 steps, then a combine of N
    blocks), computing what `stats_fwd` computes. No path calls it; it is kept
    to be timed and checked beside `stats_fwd`. Counts its launches in
    `stats_fwd_chunked.launches`."""
    n, s, t, j, d = _check("stats_fwd_chunked", h, cm_f, q, wx, wy, wxy, qm_f)
    lib = _stats_lib()
    _smem_ok("stats_fwd_chunked", lib.fvta_stats_chunked_smem_bytes(d), f"D={d}")
    dev = h.device
    chunks = -(-t // TCH)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    m, den, v, eq, e = empty(n, s), empty(n, s), empty(n, s, d), empty(n, j), empty(n, s, t)
    m_p, den_p = empty(n, s, chunks), empty(n, s, chunks)
    v_p, eq_p = empty(n, s, chunks, d), empty(n, s, chunks, j)
    ptrs = [a.data_ptr() for a in (h, cm_f, q, qm_f, wx, wy, wxy, m, den, v, eq, e,
                                   m_p, den_p, v_p, eq_p)]
    with torch.cuda.device(dev):
        err = lib.fvta_stats_chunked(*ptrs, n, s, t, j, d, _stream(dev))
    if err != 0:
        raise RuntimeError(f"stats_fwd_chunked launch failed: "
                           f"{lib.fvta_stats_error_string(err).decode()}")
    build.count_launch(stats_fwd_chunked)
    return m, den, v, eq, e


stats_fwd_chunked.launches = 0


def _qcnt(wrapper, force_global, h, cm_f, q, wx, wy, wxy, eq):
    shape = _check(wrapper.__name__, h, cm_f, q, wx, wy, wxy)
    n, j = shape[0], shape[3]
    build.check_f32("eq", eq, (n, j), h.device)
    dev = h.device
    cnt = torch.zeros((n, j), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        geo = run_geometry(*shape, force_global)
        err = _bwd_lib().fvta_qcnt(
            *(a.data_ptr() for a in (h, cm_f, q, wx, wy, wxy, eq, cnt)), *shape,
            geo["per_seq"], geo["chunks_per_cta"], geo["rows"], geo["h_buffers"], geo["smem"],
            ROUTES.index(geo["route"]), _stream(dev))
    _launched(wrapper.__name__, wrapper, err, geo)
    return cnt.to(torch.float32)


def qcnt(h, cm_f, q, wx, wy, wxy, eq):
    """Launch K5: qcnt [N, J] f32 from K4's eq [N, J]. Inputs as for
    `stats_fwd`. Counts its launches in `qcnt.launches`, those on the global
    route also in `qcnt.global_launches`."""
    return _qcnt(qcnt, False, h, cm_f, q, wx, wy, wxy, eq)


def qcnt_global(h, cm_f, q, wx, wy, wxy, eq):
    """K5 on the global route at any width (no path calls it). Counts its
    launches in `qcnt_global.launches`."""
    return _qcnt(qcnt_global, True, h, cm_f, q, wx, wy, wxy, eq)


qcnt.launches = qcnt.global_launches = 0
qcnt_global.launches = qcnt_global.global_launches = 0


def qcnt_chunked(h, cm_f, q, wx, wy, wxy, eq):
    """The chunked K5 (one block per chunk of 32 steps), computing what `qcnt`
    computes. No path calls it; it is kept to be timed and checked beside
    `qcnt`. Counts its launches in `qcnt_chunked.launches`."""
    n, s, t, j, d = _check("qcnt_chunked", h, cm_f, q, wx, wy, wxy)
    build.check_f32("eq", eq, (n, j), h.device)
    lib = _bwd_lib()
    _smem_ok("qcnt_chunked", lib.fvta_qcnt_chunked_smem_bytes(d), f"D={d}")
    dev = h.device
    cnt = torch.zeros((n, j), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fvta_qcnt_chunked(*(a.data_ptr() for a in (h, cm_f, q, wx, wy, wxy, eq, cnt)),
                                    n, s, t, j, d, _stream(dev))
    _launched("qcnt_chunked", qcnt_chunked, err)
    return cnt.to(torch.float32)


qcnt_chunked.launches = 0


def _bwd_args(kernel, h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e, m, gv):
    n, s, t, j, d = _check(kernel, h, cm_f, q, wx, wy, wxy, qm_f)
    for name, a, shape in (("de", de, (n, s, t)), ("geq", geq, (n, j)), ("eq", eq, (n, j)),
                           ("qcnt", qcnt_, (n, j)), ("e", e, (n, s, t)), ("m", m, (n, s)),
                           ("gv", gv, (n, s, d))):
        build.check_f32(name, a, shape, h.device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=h.device)
    outs = (empty(n, s, t, d), empty(n, j, d), empty(n, d), empty(n, d), empty(n, d))
    ins = (h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e, m, gv)
    return (n, s, t, j, d), [a.data_ptr() for a in ins + outs], outs, empty


def _launched(kernel: str, wrapper, err: int, geo: dict | None = None) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{_bwd_lib().fvta_bwd_error_string(err).decode()}")
    build.count_launch(wrapper, geo is not None and geo["route"] == "global")


BWD_KEYS = ("per_seq", "chunks_per_cta", "smem", "scratch", "h_buffers", "acc_smem", "route")


@functools.cache
def _bwd_geometry_on(device: int, n, s, t, j, d, force_global: bool = False) -> dict:
    name = "fvta_stats_bwd_geometry_global" if force_global else "fvta_stats_bwd_geometry"
    lib = _bwd_lib()
    return _geometry(name, lib, lib.fvta_bwd_error_string, BWD_KEYS, device, (n, s, t, j, d))


def bwd_geometry(n, s, t, j, d, force_global: bool = False) -> dict:
    """K6's launch geometry on the current CUDA device, as the library computes
    it: CTAs per sequence, chunks per CTA, shared memory per CTA (bytes), scratch
    (floats), h buffers, dC^T h kept in shared memory, route ("staged" wherever
    it fits, else "global"; force_global: "global" at any width). Read once per
    device and shape; `stats_bwd` passes it to the launch unchanged."""
    return _bwd_geometry_on(torch.cuda.current_device(), n, s, t, j, d, force_global)


def _stats_bwd(wrapper, force_global, h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e,
               m, gv):
    shape, ptrs, outs, empty = _bwd_args(wrapper.__name__, h, cm_f, q, qm_f, wx, wy, wxy, de,
                                         geq, eq, qcnt_, e, m, gv)
    dev = h.device
    with torch.cuda.device(dev):
        geo = bwd_geometry(*shape, force_global)
        scratch = empty(geo["scratch"])
        err = _bwd_lib().fvta_stats_bwd(
            *ptrs, scratch.data_ptr(), *shape, geo["per_seq"], geo["chunks_per_cta"],
            geo["h_buffers"], geo["acc_smem"], geo["smem"], ROUTES.index(geo["route"]),
            _stream(dev))
    _launched(wrapper.__name__, wrapper, err, geo)
    return outs


def stats_bwd(h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e, m, gv):
    """Launch K6 (arguments as `stats_bwd_ref`, all f32 contiguous on one CUDA
    device; qcnt_ from K5, eq, e and m from K4). Returns (dh, dq, dwx, dwy, dwxy)
    with dw* per example [N, D]. Counts its launches in `stats_bwd.launches`,
    those on the global route also in `stats_bwd.global_launches`."""
    return _stats_bwd(stats_bwd, False, h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_,
                      e, m, gv)


def stats_bwd_global(h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e, m, gv):
    """K6 on the global route at any width (no path calls it). Counts its
    launches in `stats_bwd_global.launches`."""
    return _stats_bwd(stats_bwd_global, True, h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq,
                      qcnt_, e, m, gv)


stats_bwd.launches = stats_bwd.global_launches = 0
stats_bwd_global.launches = stats_bwd_global.global_launches = 0


def stats_bwd_twopass(h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt_, e, m, gv):
    """The two-pass K6 (dC through device memory, then a reduction over 32
    columns of D a block), computing what `stats_bwd` computes. No path calls it;
    it is kept to be timed and checked beside `stats_bwd`. Counts its launches
    in `stats_bwd_twopass.launches`."""
    shape, ptrs, outs, empty = _bwd_args("stats_bwd_twopass", h, cm_f, q, qm_f, wx, wy, wxy,
                                         de, geq, eq, qcnt_, e, m, gv)
    n, s, t, j, d = shape
    lib = _bwd_lib()
    _smem_ok("stats_bwd_twopass", lib.fvta_stats_bwd_twopass_smem_bytes(j, d),
             f"J={j}, D={d}")
    chunks = -(-t // TCH)
    scratch = (empty(n, s, t, j), empty(n, s, chunks, d), empty(n, s, chunks, j))
    dev = h.device
    with torch.cuda.device(dev):
        err = lib.fvta_stats_bwd_twopass(*ptrs, *(a.data_ptr() for a in scratch), *shape,
                                         _stream(dev))
    _launched("stats_bwd_twopass", stats_bwd_twopass, err)
    return outs


stats_bwd_twopass.launches = 0


def _kernels(device: torch.device):
    """(K4, K5, K6) for tensors on `device`: the kernels on the card, their plain
    versions on the CPU."""
    if device.type == "cpu":
        return stats_fwd_ref, qcnt_ref, stats_bwd_ref
    return stats_fwd, qcnt, stats_bwd


def stats_prologue(h, e, m, grads):
    """The time-score cotangent de [N,S,T] from the stats' cotangents (gm, gden,
    gv, geq, ge; None = zero): everything of the backward that needs no
    correlation (fvta_pallas.py:683-691)."""
    gm, gden, gv, _, ge = grads
    p = torch.exp(e - m[..., None])
    dp = gden[..., None] + torch.einsum("nsd,nstd->nst", gv, h)
    dm_tot = gm - torch.sum(p * dp, dim=-1)
    tie_m = (e == m[..., None]).to(e.dtype)
    cnt_m = torch.sum(tie_m, dim=-1, keepdim=True)
    return ge + p * dp + tie_m * (dm_tot[..., None] / cnt_m)


class _StatsFn(torch.autograd.Function):
    """K4 forward; prologue + K5 + K6 backward (their plain versions on the CPU).
    Inputs: h, cm_f, q, qm_f, wx, wy, wxy (float masks, contiguous)."""

    @staticmethod
    def forward(ctx, h, cm_f, q, qm_f, wx, wy, wxy):
        out = _kernels(h.device)[0](h, cm_f, q, qm_f, wx, wy, wxy)
        m, _, _, eq, e = out
        ctx.save_for_backward(h, cm_f, q, qm_f, wx, wy, wxy, m, eq, e)
        return out

    @staticmethod
    def backward(ctx, gm, gden, gv, geq, ge):
        h, cm_f, q, qm_f, wx, wy, wxy, m, eq, e = ctx.saved_tensors
        _, k_qcnt, k_bwd = _kernels(h.device)
        grads = [g.contiguous() for g in (gm, gden, gv, geq, ge)]
        de = stats_prologue(h, e, m, grads).contiguous()
        counts = k_qcnt(h, cm_f, q, wx, wy, wxy, eq)
        dh, dq, dwx, dwy, dwxy = k_bwd(h, cm_f, q, qm_f, wx, wy, wxy, de, grads[3], eq,
                                       counts, e, m, grads[2])
        return dh, None, dq, None, dwx.sum(0), dwy.sum(0), dwxy.sum(0)


def fvta_stats_fused(h: torch.Tensor, ctx_mask: torch.Tensor, q: torch.Tensor,
                     q_mask: torch.Tensor, similarity: str,
                     sim_params: dict[str, torch.Tensor]):
    """Drop-in for focal_local_stats: (m, den, v, eq, e)."""
    if similarity not in ("trilinear", "dot"):
        return focal_local_stats(h, ctx_mask, q, q_mask, similarity, sim_params)
    if similarity == "trilinear":
        wx, wy, wxy = sim_params["w_x"], sim_params["w_y"], sim_params["w_xy"]
    else:  # dot
        d = h.shape[-1]
        wx = torch.zeros(d, dtype=h.dtype, device=h.device)
        wy = torch.zeros(d, dtype=h.dtype, device=h.device)
        wxy = torch.ones(d, dtype=h.dtype, device=h.device)
    f32 = lambda a: a.to(torch.float32).contiguous()
    args = (h.contiguous(), f32(ctx_mask), q.contiguous(), f32(q_mask),
            wx.contiguous(), wy.contiguous(), wxy.contiguous())
    if torch.is_grad_enabled() and any(a.requires_grad for a in (h, q, wx, wy, wxy)):
        return _StatsFn.apply(*args)
    return _kernels(h.device)[0](*args)
