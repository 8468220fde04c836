"""The port's CUDA kernels against their plain PyTorch versions, and the wrappers'
dispatch contract. Imports neither JAX nor the JAX package, so the `gpu` tests
also run on a CUDA machine without JAX (see README: the conftest imports JAX,
hence --noconftest there):

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

Without a card the `gpu` tests skip inside the test; the CPU tests check that
no wrapper falls back, that the CPU path (a backward included) needs no build,
which kernels, cluster size and tile height `lstm_route` picks per shape, and
that the bi-LSTM autograd Function with K1 and K1b emulated on the CPU matches
autograd through the plain version, on both routes (`hopper_emulated`:
lstm_proj, lstm_rec, lstm_rec_bwd; `old_route`: the L2-streaming kernels;
tests/test_torch_lstm.py also uses them). K2's cluster decomposition and its
geometry are restated here for the CPU (`k2_emulated`, `k2_plan`;
tests/test_torch_k2.py holds them against the JAX package and the CUDA header),
and so are K4's and K5's runs of chunks (`k4_run_emulated`, `k5_run_emulated`,
`k45_geometry`; tests/test_torch_k45.py). The `gpu` tests of K4 and K5 also
hold them against the chunked kernels they replaced, bit for bit where the
result is a maximum or a count.
"""

import math
import re
import shutil
import subprocess
from collections import namedtuple

import numpy as np
import pytest
import torch

from fvta_memexqa_torch.ops import (build, fvta_fused, fvta_ref, fvta_stats, lstm_fused,
                                    lstm_grouped, lstm_ref)
from fvta_memexqa_torch.ops.fvta_ref import AttentionOutput

# Kernel vs plain on the card, both float32; the plain version sums in another
# order (cuBLAS tiles vs per-column FMA chains / warp shuffles), the recurrence
# carries rounding over up to 30 steps, and K2 splits each example's rows over
# a cluster: its time softmax is online across blocks and chunks, and its
# context a fixed-order sum of the CTAs' partials.
LSTM_TOL = dict(rtol=1e-5, atol=1e-6)
FVTA_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("context", "question", "time_attn", "seq_attn")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def lstm_case(n, t, d, h, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, t, d)).astype(np.float32)
    lens = rng.integers(0, t + 1, n)
    lens[0], lens[1] = t, 0            # cover full and empty rows
    mask = np.arange(t)[None, :] < lens[:, None]
    lim = np.sqrt(6.0 / (d + 5 * h))
    params = []
    for _ in range(2):
        k = rng.uniform(-lim, lim, (d + h, 4 * h)).astype(np.float32)
        b = rng.normal(0, 0.1, 4 * h).astype(np.float32)
        params.append(lstm_ref.LSTMParams(*(torch.from_numpy(a).to(device)
                                            for a in (k[:d], k[d:], b))))
    return (torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device),
            params[0], params[1])


def fvta_case(n, s, t, j, d, seed, device="cpu", dead=False, bounded=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (n, s, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (n, j, d)).astype(np.float32)
    if bounded:
        # context and question states are bi-LSTM outputs on the main path: |h| < 1
        h, q = np.tanh(h), np.tanh(q)
    cm = np.arange(t)[None, None, :] < rng.integers(1, t + 1, (n, s))[..., None]
    qm = np.arange(j)[None, :] < rng.integers(1, j + 1, n)[:, None]
    if dead:
        cm[:, min(3, s - 1), :] = False    # a dead sequence in every example
        qm[min(1, n - 1), :] = False       # an all-masked question row
        cm[0] = False                      # an example with no valid context
    h, q = h * cm[..., None], q * qm[..., None]
    params = {k: torch.from_numpy(rng.normal(0, 1, d).astype(np.float32)).to(device)
              for k in ("w_x", "w_y", "w_xy")}
    t_ = lambda a: torch.from_numpy(a).to(device)
    return t_(h), t_(cm), t_(q), t_(qm), params


# ---- CPU emulations of K1 (with cells) and K1b --------------------------------
# Step for step as the kernels compute, in torch with the rows vectorized and the
# kernels' layouts: out/cell at the original positions, the backward direction at
# L-1-t, dgates [N, T, 8H]. Swapped in for the launches, they let the CPU run
# `ops.lstm_fused._BiLSTMFn` (the layout, the four products of the backward,
# None cotangents) against autograd through the plain version and the JAX package.

def k1_emulated(x, lengths, p_fw, p_bw, forget_bias, emit_out, emit_cell=False):
    n, t, _ = x.shape
    h = p_fw.wh.shape[0]
    rows = torch.arange(n)
    ln = lengths.long()
    out = x.new_zeros(n, t, 2 * h)
    cell = x.new_zeros(n, t, 2 * h)
    fin = x.new_zeros(n, 2 * h)
    for k, p in enumerate((p_fw, p_bw)):
        hh, c = x.new_zeros(n, h), x.new_zeros(n, h)
        sl = slice(k * h, (k + 1) * h)
        for step in range(t):
            live = step < ln
            pos = torch.where(live, ln - 1 - step if k else torch.full_like(ln, step),
                              torch.full_like(ln, step))
            nh, nc = lstm_ref.lstm_cell(x[rows, pos] @ p.wx + p.b, hh, c, p.wh, forget_bias)
            hh = torch.where(live[:, None], nh, hh)
            c = torch.where(live[:, None], nc, c)
            o = out[rows, pos]
            o[:, sl] = torch.where(live[:, None], nh, 0.0)
            out[rows, pos] = o
            cc = cell[rows, pos]
            cc[:, sl] = c
            cell[rows, pos] = cc
        fin[:, sl] = hh
    return (out if emit_out else None), fin, (cell if emit_cell else None)


def k1b_emulated(x, lengths, p_fw, p_bw, out, cell, g_out, g_fin, forget_bias):
    n, t, _ = x.shape
    h = p_fw.wh.shape[0]
    rows = torch.arange(n)
    ln = lengths.long()
    dgates = x.new_zeros(n, t, 8 * h)
    for k, p in enumerate((p_fw, p_bw)):
        sl = slice(k * h, (k + 1) * h)
        dh, dc = x.new_zeros(n, h), x.new_zeros(n, h)
        for step in range(t - 1, -1, -1):
            live = (step < ln)[:, None]
            pos = (ln - 1 - step if k else torch.full_like(ln, step)).clamp(0, t - 1)
            prev = (pos + 1 if k else pos - 1).clamp(0, t - 1)
            nz = 1.0 if step > 0 else 0.0
            h_prev = nz * out[rows, prev][:, sl]
            c_prev = nz * cell[rows, prev][:, sl]
            g = x[rows, pos] @ p.wx + h_prev @ p.wh + p.b
            i_s, j_t = torch.sigmoid(g[:, :h]), torch.tanh(g[:, h:2 * h])
            f_s = torch.sigmoid(g[:, 2 * h:3 * h] + forget_bias)
            o_s = torch.sigmoid(g[:, 3 * h:])
            tanh_c = torch.tanh(cell[rows, pos][:, sl])
            dh_in = dh.clone()
            if g_out is not None:
                dh_in = dh_in + g_out[rows, pos][:, sl]
            if g_fin is not None:
                dh_in = dh_in + (step == ln - 1)[:, None] * g_fin[:, sl]
            dc_tot = dc + dh_in * o_s * (1 - tanh_c * tanh_c)
            dg = torch.cat([dc_tot * j_t * i_s * (1 - i_s), dc_tot * i_s * (1 - j_t * j_t),
                            dc_tot * c_prev * f_s * (1 - f_s),
                            dh_in * tanh_c * o_s * (1 - o_s)], dim=-1)
            dg = torch.where(live, dg, 0.0)
            d = dgates[rows, torch.where(live[:, 0], pos, step)]
            d[:, 4 * h * k:4 * h * (k + 1)] = dg
            dgates[rows, torch.where(live[:, 0], pos, step)] = d
            dh = torch.where(live, dg @ p.wh.t(), dh)
            dc = torch.where(live, dc_tot * f_s, dc)
    return dgates


# ---- CPU emulations of the Hopper route: lstm_proj, lstm_rec, lstm_rec_bwd -----
# The same launch structure and layouts: the projection writes xg [N, T, 8H] at
# the original positions (NaN where a row has ended: the kernel may leave those
# unwritten, and nothing may read them), the recurrence reads xg[t] (backward
# direction: xg[L-1-t]) and, under grad, overwrites it with the full
# pre-activations, which the backward reads instead of recomputing.

def proj_emulated(x, lengths, p_fw, p_bw):
    xg = torch.cat([x @ p.wx + p.b for p in (p_fw, p_bw)], dim=-1)
    dead = torch.arange(x.shape[1])[None, :] >= lengths.long()[:, None]
    return xg.masked_fill(dead[..., None], float("nan"))


def rec_emulated(xg, lengths, p_fw, p_bw, forget_bias, emit_out, emit_cell=False,
                 write_preact=False):
    n, t, _ = xg.shape
    h = p_fw.wh.shape[0]
    rows = torch.arange(n)
    ln = lengths.long()
    out = xg.new_zeros(n, t, 2 * h)
    cell = xg.new_zeros(n, t, 2 * h)
    fin = xg.new_zeros(n, 2 * h)
    for k, p in enumerate((p_fw, p_bw)):
        hh, c = xg.new_zeros(n, h), xg.new_zeros(n, h)
        sl, gl = slice(k * h, (k + 1) * h), slice(4 * k * h, 4 * (k + 1) * h)
        for step in range(t):
            live = step < ln
            pos = torch.where(live, ln - 1 - step if k else torch.full_like(ln, step),
                              torch.full_like(ln, step))
            gates = xg[rows, pos][:, gl] + hh @ p.wh
            i, j, f, o = torch.chunk(torch.where(live[:, None], gates, 0.0), 4, dim=-1)
            nc = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
            nh = torch.tanh(nc) * torch.sigmoid(o)
            if write_preact:
                g = xg[rows[live], pos[live]]
                g[:, gl] = gates[live]
                xg[rows[live], pos[live]] = g
            hh = torch.where(live[:, None], nh, hh)
            c = torch.where(live[:, None], nc, c)
            o_ = out[rows, pos]
            o_[:, sl] = torch.where(live[:, None], nh, 0.0)
            out[rows, pos] = o_
            cc = cell[rows, pos]
            cc[:, sl] = c
            cell[rows, pos] = cc
        fin[:, sl] = hh
    return (out if emit_out else None), fin, (cell if emit_cell else None)


def rec_bwd_emulated(pre, lengths, p_fw, p_bw, cell, g_out, g_fin, forget_bias):
    n, t, _ = pre.shape
    h = p_fw.wh.shape[0]
    rows = torch.arange(n)
    ln = lengths.long()
    dgates = pre.new_zeros(n, t, 8 * h)
    for k, p in enumerate((p_fw, p_bw)):
        sl, gl = slice(k * h, (k + 1) * h), slice(4 * k * h, 4 * (k + 1) * h)
        dh, dc = pre.new_zeros(n, h), pre.new_zeros(n, h)
        for step in range(t - 1, -1, -1):
            live = (step < ln)[:, None]
            pos = (ln - 1 - step if k else torch.full_like(ln, step)).clamp(0, t - 1)
            prev = (pos + 1 if k else pos - 1).clamp(0, t - 1)
            c_prev = (1.0 if step > 0 else 0.0) * cell[rows, prev][:, sl]
            g = torch.where(live, pre[rows, pos][:, gl], 0.0)   # saved, not recomputed
            i_s, j_t = torch.sigmoid(g[:, :h]), torch.tanh(g[:, h:2 * h])
            f_s = torch.sigmoid(g[:, 2 * h:3 * h] + forget_bias)
            o_s = torch.sigmoid(g[:, 3 * h:])
            tanh_c = torch.tanh(cell[rows, pos][:, sl])
            dh_in = dh.clone()
            if g_out is not None:
                dh_in = dh_in + g_out[rows, pos][:, sl]
            if g_fin is not None:
                dh_in = dh_in + (step == ln - 1)[:, None] * g_fin[:, sl]
            dc_tot = dc + dh_in * o_s * (1 - tanh_c * tanh_c)
            dg = torch.cat([dc_tot * j_t * i_s * (1 - i_s), dc_tot * i_s * (1 - j_t * j_t),
                            dc_tot * c_prev * f_s * (1 - f_s),
                            dh_in * tanh_c * o_s * (1 - o_s)], dim=-1)
            dg = torch.where(live, dg, 0.0)
            at = torch.where(live[:, 0], pos, step)
            d = dgates[rows, at]
            d[:, gl] = dg
            dgates[rows, at] = d
            dh = torch.where(live, dg @ p.wh.t(), dh)
            dc = torch.where(live, dc_tot * f_s, dc)
    return dgates


def hopper_emulated(monkeypatch):
    """Swap the emulations in for the Hopper route's launchers and the old
    kernels' launchers for traps: the shapes these tests use route to the
    Hopper kernels."""
    def trap(*a, **k):
        raise AssertionError("the old kernels must not launch on the Hopper route")

    def k1(x, lengths, p_fw, p_bw, forget_bias, emit_out, emit_cell=False, write_preact=False):
        pre = proj_emulated(x, lengths, p_fw, p_bw)
        return (pre, *rec_emulated(pre, lengths, p_fw, p_bw, forget_bias, emit_out, emit_cell,
                                   write_preact))

    for name, fn in (("lstm_proj", proj_emulated), ("lstm_rec", rec_emulated), ("lstm_k1", k1),
                     ("lstm_rec_bwd", rec_bwd_emulated), ("lstm_fwd", trap),
                     ("lstm_bwd", trap)):
        monkeypatch.setattr(lstm_fused, name, fn)


# ---- CPU: the route ----------------------------------------------------------------
# (rows, T, D, H) → (kernels, cluster, rows per tile). chip_smoke's K1_SHAPES
# (serving: photo titles 768 x 10, encoders 64 x 12 / 24, question 8 x 30,
# choices 32 x 8), K1B_SHAPES (train: 3072 / 2688 x 10, encoders 256 x 12 / 24,
# question 64 x 30, choices 256 x 8), the grouped shapes' routing edge, the video
# bilstm (frames 8 x 1024 at D = 200, the CLI's 16 x 1024 at D = 116, its
# question 16 x 30, choices 80 x 8), the CLI's small widths (H = 16, 8) and the
# tests' small odd shapes; then the cluster and tile thresholds, and widths past
# the largest cluster (→ the L2-streaming kernels).
NEW, OLD = lstm_fused.REC_KERNELS, lstm_fused.OLD_KERNELS
ROUTES = [
    ((768, 10, 200, 100), (NEW, 2, 8)), ((64, 12, 200, 100), (NEW, 8, 8)),
    ((64, 24, 200, 100), (NEW, 8, 8)), ((8, 30, 200, 100), (NEW, 8, 8)),
    ((32, 8, 200, 100), (NEW, 8, 8)), ((3072, 10, 200, 100), (NEW, 1, 16)),
    ((2688, 10, 200, 100), (NEW, 1, 16)), ((256, 12, 200, 100), (NEW, 2, 8)),
    ((256, 24, 200, 100), (NEW, 2, 8)), ((64, 30, 200, 100), (NEW, 8, 8)),
    ((256, 8, 200, 100), (NEW, 2, 8)), ((1024, 2, 200, 100), (NEW, 2, 8)),
    ((1023, 2, 200, 100), (NEW, 2, 8)), ((8, 1024, 200, 100), (NEW, 8, 8)),
    ((16, 1024, 116, 100), (NEW, 8, 8)), ((16, 30, 116, 100), (NEW, 8, 8)),
    ((80, 8, 116, 100), (NEW, 4, 8)), ((8, 30, 32, 16), (NEW, 2, 8)),
    ((8, 6, 24, 8), (NEW, 1, 8)), ((12, 7, 10, 5), (NEW, 1, 8)),
    ((64, 5, 200, 100), (NEW, 8, 8)), ((65, 5, 200, 100), (NEW, 4, 8)),
    ((264, 5, 200, 100), (NEW, 2, 8)), ((265, 5, 200, 100), (NEW, 2, 8)),
    ((1056, 3, 200, 100), (NEW, 2, 8)), ((1057, 3, 200, 100), (NEW, 1, 16)),
    ((16, 5, 24, 256), (NEW, 8, 8)), ((16, 5, 24, 300), (OLD, 1, 8)),
    ((3072, 10, 200, 320), (OLD, 1, 8)),
]


@pytest.mark.parametrize("shape,expected", ROUTES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
def test_route_maps_shapes_to_kernels_cluster_and_rows(shape, expected):
    route = lstm_fused.lstm_route(*shape)
    assert (route.kernels, route.cluster, route.rows) == expected
    if route.kernels == NEW:
        threads, fwd, bwd = lstm_fused.rec_geometry(shape[3], route.cluster, route.rows,
                                                    route.split)
        assert max(fwd, bwd) <= build.SMEM_LIMIT and 32 <= threads <= 512
        # beyond clusters of 2, a cluster grows only while it keeps one CTA per SM
        blocks = 2 * -(-shape[0] // route.rows) * route.cluster
        assert route.cluster <= 2 or blocks <= lstm_fused.SM_COUNT


def test_route_is_old_exactly_past_the_largest_cluster():
    hs = range(4, 400, 4)
    new = [h for h in hs if lstm_fused.lstm_route(8, 4, 200, h).kernels == NEW]
    assert new == [h for h in hs if h <= max(new)]      # one contiguous range from the bottom
    assert 100 <= max(new) < 300


# ---- CPU: the autograd Function with emulated kernels --------------------------

def old_route(monkeypatch):
    """Route every shape to the L2-streaming kernels, emulated (K1 with cells,
    K1b recomputing the pre-activations), as the card does past the largest
    cluster; the Hopper launchers become traps."""
    def trap(*a, **k):
        raise AssertionError("the Hopper kernels must not launch on the old route")

    monkeypatch.setattr(lstm_fused, "lstm_route",
                        lambda *shape: lstm_fused.LSTMRoute(OLD, 1, 8, 0))
    for name, fn in (("lstm_fwd", k1_emulated), ("lstm_bwd", k1b_emulated),
                     ("lstm_proj", trap), ("lstm_rec", trap), ("lstm_k1", trap),
                     ("lstm_rec_bwd", trap)):
        monkeypatch.setattr(lstm_fused, name, fn)


def bilstm_fn_grads(x, mask, p_fw, p_bw, final_only, seed=4):
    """(out, fin) and the gradients of <out, g_out> + <fin, g_fin> through
    autograd of bilstm_ref and through `_BiLSTMFn`, with N(0, 1) cotangents."""
    n, t, _ = x.shape
    h = p_fw.wh.shape[0]
    rng = np.random.default_rng(seed)
    g_out = torch.from_numpy(rng.normal(0, 1, (n, t, 2 * h)).astype(np.float32))
    g_fin = torch.from_numpy(rng.normal(0, 1, (n, 2 * h)).astype(np.float32))
    leaves = [x, *p_fw, *p_bw]

    def grads(run):
        ins = [a.clone().requires_grad_() for a in leaves]
        out, fin = run(ins[0], lstm_ref.LSTMParams(*ins[1:4]), lstm_ref.LSTMParams(*ins[4:]))
        loss = (fin * g_fin).sum() + (0 if final_only else (out * g_out).sum())
        return [a.detach() for a in (out, fin)], torch.autograd.grad(loss, ins)

    return (grads(lambda xx, pf, pb: lstm_ref.bilstm_ref(pf, pb, xx, mask)),
            grads(lambda xx, pf, pb: lstm_fused._BiLSTMFn.apply(
                xx, mask.sum(1, dtype=torch.int32), 1.0, *pf, *pb)))


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("n,t,d,h", [(12, 7, 10, 5), (9, 11, 33, 16)])
def test_bilstm_fn_with_hopper_emulation_matches_plain_autograd(monkeypatch, final_only,
                                                                n, t, d, h):
    hopper_emulated(monkeypatch)
    assert lstm_fused.lstm_route(n, t, d, h).kernels == NEW
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=3)
    ((out_r, fin_r), ref), ((out_k, fin_k), got) = bilstm_fn_grads(x, mask, p_fw, p_bw,
                                                                   final_only)
    torch.testing.assert_close(out_k, out_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fin_k, fin_r, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"), got, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
    assert not got[0][~mask].any()


@pytest.mark.parametrize("n,t,d,h", [(12, 7, 10, 5), (9, 11, 33, 16)])
def test_emulated_saved_preactivations_equal_plain_gates(n, t, d, h):
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=7)
    lengths = mask.sum(1, dtype=torch.int32)
    xg = proj_emulated(x, lengths, p_fw, p_bw)
    out, fin, cell = rec_emulated(xg, lengths, p_fw, p_bw, 1.0, True, emit_cell=True,
                                  write_preact=True)
    gates = lstm_ref.bilstm_gates_ref(p_fw, p_bw, x, mask)
    torch.testing.assert_close(xg[mask], gates[mask], rtol=1e-5, atol=1e-6)
    assert torch.isnan(xg[~mask]).all()      # nothing wrote (or needed) the dead positions
    torch.testing.assert_close(cell, lstm_ref.bilstm_cells_ref(p_fw, p_bw, x, mask),
                               rtol=1e-5, atol=1e-6)
    out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
    torch.testing.assert_close(out, out_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fin, fin_r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("n,t,d,h", [(12, 7, 10, 5), (4, 11, 33, 7)])
def test_bilstm_fn_with_emulated_kernels_matches_plain_autograd(monkeypatch, final_only,
                                                                n, t, d, h):
    old_route(monkeypatch)
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=3)
    ((out_r, fin_r), ref), ((out_k, fin_k), got) = bilstm_fn_grads(x, mask, p_fw, p_bw,
                                                                   final_only)
    torch.testing.assert_close(out_k, out_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fin_k, fin_r, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
    assert not got[0][~mask].any()              # no gradient into padded steps


def test_emulated_cells_match_plain_carried_cells():
    x, mask, p_fw, p_bw = lstm_case(9, 6, 7, 4, seed=6)
    _, _, cell = k1_emulated(x, mask.sum(1, dtype=torch.int32), p_fw, p_bw, 1.0, False, True)
    torch.testing.assert_close(cell, lstm_ref.bilstm_cells_ref(p_fw, p_bw, x, mask),
                               rtol=1e-6, atol=1e-7)


# ---- CPU emulations of K4, K5 and K6 -------------------------------------------
# As the kernels decompose the work: time chunks of fvta_stats.TCH steps, each
# chunk's local stats combined in chunk order (K4); per-chunk tie counts summed
# (K5); per-chunk dC, dh rows and partial sums, then dq = dC^T h and the dw sums
# in chunk order (K6). One correlation routine serves all three, so the tie
# tests compare like with like, as the kernels' shared fvta_corr.cuh does.
# Swapped in for the launches, they let the CPU run `fvta_stats._StatsFn`.

NEG = -1e30


def _corr_emulated(h, q, wx, wy, wxy):
    sx = (h * wx).sum(-1)[..., None]                                  # [N,S,T,1]
    sy = (q * wy).sum(-1)[:, None, None, :]                           # [N,1,1,J]
    return torch.einsum("nstd,njd->nstj", h * wxy, q) + sx + sy


def _chunks(t):
    return [(t0, min(t0 + fvta_stats.TCH, t)) for t0 in range(0, t, fvta_stats.TCH)]


def k4_emulated(h, cm_f, q, qm_f, wx, wy, wxy):
    c = _corr_emulated(h, q, wx, wy, wxy)
    e = torch.amax(c + (1.0 - qm_f)[:, None, None, :] * NEG, dim=-1) + (1.0 - cm_f) * NEG
    cs = c + (1.0 - cm_f)[..., None] * NEG
    parts = []
    for t0, t1 in _chunks(h.shape[2]):
        ec = e[:, :, t0:t1]
        mc = ec.amax(-1)
        p = torch.exp(ec - mc[..., None])
        parts.append((mc, p.sum(-1), torch.einsum("nst,nstd->nsd", p, h[:, :, t0:t1]),
                      cs[:, :, t0:t1].amax(dim=(1, 2))))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    den = sum(pt[1] * torch.exp(pt[0] - m) for pt in parts)
    v = sum(pt[2] * torch.exp(pt[0] - m)[..., None] for pt in parts)
    eq = torch.stack([pt[3] for pt in parts]).amax(0)
    return m, den, v, eq, e


def k5_emulated(h, cm_f, q, wx, wy, wxy, eq):
    cs = _corr_emulated(h, q, wx, wy, wxy) + (1.0 - cm_f)[..., None] * NEG
    hits = (cs == eq[:, None, None, :]).to(torch.int32)
    return sum(hits[:, :, t0:t1].sum(dim=(1, 2)) for t0, t1 in _chunks(h.shape[2])).float()


def k6_emulated(h, cm_f, q, qm_f, wx, wy, wxy, de, geq, eq, qcnt, e, m, gv):
    c = _corr_emulated(h, q, wx, wy, wxy)
    cq = c + (1.0 - qm_f)[:, None, None, :] * NEG
    tie_j = cq == cq.amax(-1, keepdim=True)
    dc = torch.where(tie_j, (de / tie_j.sum(-1))[..., None], 0.0)
    tie_q = c + (1.0 - cm_f)[..., None] * NEG == eq[:, None, None, :]
    dc = dc + torch.where(tie_q, (geq / torch.clamp(qcnt, min=1.0))[:, None, None, :], 0.0)
    rowsum = dc.sum(-1)
    p = torch.exp(e - m[..., None])
    dh = (torch.einsum("nstj,njd->nstd", dc, q * wxy) + rowsum[..., None] * wx
          + p[..., None] * gv[:, :, None, :])
    dwx = sum(torch.einsum("nst,nstd->nd", rowsum[:, :, t0:t1], h[:, :, t0:t1])
              for t0, t1 in _chunks(h.shape[2]))
    colsum = sum(dc[:, :, t0:t1].sum(dim=(1, 2)) for t0, t1 in _chunks(h.shape[2]))
    tmp = torch.einsum("nstj,nstd->njd", dc, h)
    return (dh, tmp * wxy + colsum[..., None] * wy, dwx,
            torch.einsum("nj,njd->nd", colsum, q), (tmp * q).sum(1))


def emulated_kernels(device):
    return k4_emulated, k5_emulated, k6_emulated


STATS_CASES = {  # name: (n, s, t, j, d, what is masked)
    "plain": (2, 3, 70, 5, 6, None),
    "s1_long": (3, 1, 130, 4, 8, None),
    "dead_sequence": (2, 3, 40, 5, 6, "dead"),
    "all_masked_example": (2, 2, 64, 5, 6, "example"),
    "all_masked_question": (2, 2, 64, 5, 6, "question"),
}


def stats_case(name, seed=0, device="cpu"):
    n, s, t, j, d, what = STATS_CASES[name]
    h, cm, q, qm, p = fvta_case(n, s, t, j, d, seed, device=device)
    if what == "dead":
        cm[:, 0] = False
    elif what == "example":
        cm[0] = False
    elif what == "question":
        qm[0] = False
    return h * cm[..., None], cm, q, qm, p


def stats_grads(fn, h, cm, q, qm, p):
    """Gradients of the JAX suite's stats loss (test_fvta_pallas.py
    TestFVTAStreamingBackward) w.r.t. h, q, w_x, w_y, w_xy."""
    leaves = [a.clone().requires_grad_() for a in (h, q, p["w_x"], p["w_y"], p["w_xy"])]
    m, den, v, eq, e = fn(leaves[0], cm, leaves[1], qm, "trilinear",
                          dict(zip(("w_x", "w_y", "w_xy"), leaves[2:])))
    loss = ((v ** 2).sum() + torch.log(den).sum() + (eq * 0.1).sum() + (m * 0.03).sum()
            + torch.where(cm, e, 0.0).sum() * 1e-3)
    return (m, den, v, eq, e), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", list(STATS_CASES))
def test_stats_fn_with_emulated_kernels_matches_plain_autograd(monkeypatch, name):
    h, cm, q, qm, p = stats_case(name, seed=31)
    out_r, ref = stats_grads(fvta_ref.focal_local_stats, h, cm, q, qm, p)
    monkeypatch.setattr(fvta_stats, "_kernels", emulated_kernels)
    out_k, got = stats_grads(fvta_stats.fvta_stats_fused, h, cm, q, qm, p)
    for field, a, b in zip(("m", "den", "v", "eq", "e"), out_k, out_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=field)
    for field, a, b in zip(("h", "q", "w_x", "w_y", "w_xy"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=field)


@pytest.mark.parametrize("name", ["all_masked_example", "s1_long"])
def test_emulated_tie_counts_equal_plain(name):
    h, cm, q, qm, p = stats_case(name, seed=32)
    args = (h, cm.float(), q, p["w_x"], p["w_y"], p["w_xy"])
    eq = k4_emulated(h, cm.float(), q, qm.float(), p["w_x"], p["w_y"], p["w_xy"])[3]
    eq_r = fvta_stats.stats_fwd_ref(h, cm.float(), q, qm.float(), p["w_x"], p["w_y"],
                                    p["w_xy"])[3]
    got, ref = k5_emulated(*args, eq), fvta_stats.qcnt_ref(*args, eq_r)
    assert torch.equal(got, ref)
    assert (got >= 1).all()          # every max is reached somewhere, masked or not


def test_streaming_branch_is_chosen_by_shape(monkeypatch):
    calls = []
    real = fvta_fused.fvta_stats_fused
    monkeypatch.setattr(fvta_fused, "fvta_stats_fused",
                        lambda *a: calls.append(a[0].shape[2]) or real(*a))
    for t in (24, fvta_fused.STREAM_MIN_T - 1, fvta_fused.STREAM_MIN_T):
        h, cm, q, qm, p = fvta_case(1, 1, t, 3, 4, seed=33)
        out = fvta_fused.fvta_attention_fused(h, cm, q, qm, "trilinear", p)
        ref = fvta_ref.fvta_attention(h, cm, q, qm,
                                      fvta_ref.similarity_tensor(h, q, "trilinear", p))
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert calls == [fvta_fused.STREAM_MIN_T]


def test_stats_wrappers_refuse_cpu_tensors():
    h, cm, q, qm, p = fvta_case(2, 1, 40, 3, 4, seed=34)
    w = (p["w_x"], p["w_y"], p["w_xy"])
    m, den, v, eq, e = fvta_stats.stats_fwd_ref(h, cm.float(), q, qm.float(), *w)
    with pytest.raises(ValueError, match="CUDA"):
        fvta_stats.stats_fwd(h, cm.float(), q, qm.float(), *w)
    with pytest.raises(ValueError, match="CUDA"):
        fvta_stats.qcnt(h, cm.float(), q, *w, eq)
    with pytest.raises(ValueError, match="CUDA"):
        fvta_stats.stats_bwd(h, cm.float(), q, qm.float(), *w, e, eq, eq, eq, e, m, v)
    with pytest.raises(ValueError, match="CUDA"):
        fvta_stats.stats_bwd_twopass(h, cm.float(), q, qm.float(), *w, e, eq, eq, eq, e, m, v)


# ---- CPU emulation of K2's decomposition ----------------------------------------
# K2 (csrc/fvta_fwd.cu) splits each example's S x T rows over the CTAs of a
# cluster: sequence chunks ("segments") of chunk_len steps, `segs` of them per
# CTA, staged in blocks of `rows` rows; each CTA keeps per-segment softmax
# statistics (online across its blocks) and its question-side maxima, and the
# cluster combines them in a fixed order. `k2_plan` restates the geometry of
# csrc/fvta_fwd.cuh (tests/test_torch_k2.py holds the two together with the
# host compiler) and `k2_emulated` walks the same decomposition in torch for a
# given plan, so the CPU checks the split, the merges and the combine that only
# the card runs.

K2Plan = namedtuple("K2Plan", "cluster chunks chunk_len segs rows bufs qtile smem route",
                    defaults=(0,))
K2_WARPS, K2_SUB, K2_JT = 8, 32, 32
K2_RESIDENT_ROWS, K2_STREAM_ROWS, K2_MAX_CLUSTER = 96, 32, 16


def _cdiv(a, b):
    return -(-a // b)


def _round4(v):
    return _cdiv(v, 4) * 4


def k2_vec_stride(d):
    s = _cdiv(d, 4) * 4
    return s if (s // 4) % 2 else s + 4


def k2_smem(j, d, cluster, segs, rows, bufs, qtile, global_=False):
    """Bytes of fvta_fwd.cuh's layout() (global_: the global route's)."""
    ds, jc, g = 0 if global_ else k2_vec_stride(d), _cdiv(j + 1, K2_JT) * K2_JT, _round4(segs)
    qsl = 0 if qtile or global_ else _round4(j * _cdiv(d, cluster))
    floats = (bufs * rows * ds + _round4(bufs * rows) + (K2_JT if qtile else jc) * ds + 2 * ds
              + qsl + _round4(K2_SUB * (K2_JT + 1))
              + 2 * K2_SUB + _round4(rows) + (4 + K2_WARPS) * jc + segs * ds
              + _round4(cluster * _cdiv(d, cluster)) + 8 * g + 4)
    return 4 * floats


def k2_plan(n, s, t, j, d, sms, smem_max, cmax, force_global=False):
    """fvta_fwd.cuh's plan(): the cluster, the segments, the staging, the route."""
    c = 1
    while c < cmax and n * c < sms:
        c *= 2
    c = min(c, cmax)
    while True:
        if s >= c:
            chunks, chunk_len, segs = 1, t, _cdiv(s, c)
            cluster = _cdiv(s, segs)
        else:
            chunk_len = _cdiv(t, min(c // s, t))
            chunks, segs = _cdiv(t, chunk_len), 1
            cluster = s * chunks
        span = segs * chunk_len
        natural = ((1, _cdiv(span, K2_SUB) * K2_SUB) if span <= K2_RESIDENT_ROWS
                   else (2, K2_STREAM_ROWS))
        for qtile in () if force_global else (0, 1):
            for bufs, rows in (natural, (2, K2_STREAM_ROWS), (1, K2_SUB)):
                smem = k2_smem(j, d, cluster, segs, rows, bufs, qtile)
                if smem <= smem_max:
                    return K2Plan(cluster, chunks, chunk_len, segs, rows, bufs, qtile, smem)
        if c >= cmax or force_global:
            smem = k2_smem(j, d, cluster, segs, K2_STREAM_ROWS, 1, 1, True)
            return K2Plan(cluster, chunks, chunk_len, segs, K2_STREAM_ROWS, 1, 1, smem, 1)
        c *= 2


def k2_emulated(h, cm_f, q, qm_f, wx, wy, wxy, plan):
    """K2's function, computed as its CTAs and its cluster combine compute it
    under `plan` (K2Plan; bufs, qtile and smem, which change only where the
    operands wait, are not read)."""
    n_, s_, t_, d_ = h.shape
    C, P, L, G, RB = plan.cluster, plan.chunks, plan.chunk_len, plan.segs, plan.rows
    nseg = s_ * P
    assert _cdiv(nseg, G) == C and all(min((k + 1) * L, t_) > k * L for k in range(P))
    start = lambda seg: (seg // P) * t_ + (seg % P) * L
    end = lambda seg: (seg // P) * t_ + min((seg % P + 1) * L, t_)
    out = (h.new_zeros(n_, d_), h.new_zeros(n_, d_), h.new_zeros(n_, s_ * t_),
           h.new_zeros(n_, s_))
    for n in range(n_):
        hn, cmn, qmn = h[n].reshape(s_ * t_, d_), cm_f[n].reshape(s_ * t_), qm_f[n]
        qw, sy = q[n] * wxy, q[n] @ wy
        m, den, cmx = h.new_empty(nseg), h.new_empty(nseg), h.new_empty(nseg)
        v, e_raw = h.new_zeros(nseg, d_), h.new_empty(s_ * t_)
        qmx_cta = []
        for r in range(C):                        # each CTA: its rows, block by block
            mine = range(r * G, min(r * G + G, nseg))
            r0, r1 = start(mine[0]), end(mine[-1])
            qmx = torch.full_like(sy, -math.inf)
            for b0 in range(r0, r1, RB):
                b1 = min(b0 + RB, r1)
                hb, cb = hn[b0:b1], cmn[b0:b1]
                c = hb @ qw.T + (hb @ wx)[:, None] + sy[None, :]
                e = (c + (1.0 - qmn) * NEG).amax(1) + (1.0 - cb) * NEG
                qmx = torch.maximum(qmx, (c + ((1.0 - cb) * NEG)[:, None]).amax(0))
                e_raw[b0:b1] = e
                for seg in mine:                  # the time softmax, online per block
                    lo, hi = max(start(seg), b0), min(end(seg), b1)
                    if lo >= hi:
                        continue
                    eb, mb, cmb = e[lo - b0:hi - b0], e[lo - b0:hi - b0].max(), \
                        cb[lo - b0:hi - b0].max()
                    first = start(seg) >= b0
                    m_new = mb if first else torch.maximum(m[seg], mb)
                    scale = 0.0 if first else torch.exp(m[seg] - m_new)
                    p = torch.exp(eb - m_new)
                    den[seg] = p.sum() if first else den[seg] * scale + p.sum()
                    cmx[seg] = cmb if first else torch.maximum(cmx[seg], cmb)
                    v[seg] = v[seg] * scale + p @ hn[lo:hi]
                    m[seg] = m_new
            qmx_cta.append(qmx)
        # the cluster combine: chunks of a sequence in order, then sequences
        mc, dc, cc = m.view(s_, P), den.view(s_, P), cmx.view(s_, P)
        big_m = mc.amax(1)
        valid = (cc.amax(1) > 0.5).to(h.dtype)
        g = big_m + (1.0 - valid) * NEG
        eg = torch.exp(g - g.max())
        b = eg / eg.sum()
        den_s = (dc * torch.exp(mc - big_m[:, None])).sum(1)
        inv = 1.0 / torch.clamp(den_s, min=1e-30)
        w = (b * inv)[:, None] * torch.exp(mc - big_m[:, None])          # [S, P]
        wv = w.reshape(nseg)[:, None] * v
        out[0][n] = sum(wv[r * G:min(r * G + G, nseg)].sum(0) for r in range(C))
        qv = torch.stack(qmx_cta).amax(0) + (1.0 - qmn) * NEG
        out[1][n] = torch.softmax(qv, 0) @ q[n]
        seq = torch.arange(s_ * t_) // t_
        out[2][n] = torch.where(valid[seq] > 0.5, torch.exp(e_raw - big_m[seq]) * inv[seq], 0.0)
        out[3][n] = b * valid
    return AttentionOutput(out[0], out[1], out[2].view(n_, s_, t_), out[3])


# ---- CPU emulation of K4's and K5's runs of chunks --------------------------------
# K4 (csrc/fvta_stats.cu) and K5 (csrc/fvta_bwd.cu) give each (run of `cpc`
# chunks of 32 steps, sequence, example) one CTA, which walks its run in passes
# of `rows` rows: K4 carries (m, den, v) online across its run's passes and the
# column maxima of the ctx-masked C, then a merge combines each sequence's
# `per` partials in slot order; K5 adds up its run's tie counts.
# `k45_geometry` restates csrc/fvta_corr.cuh's run_geometry
# (tests/test_torch_k45.py holds the two together with the host compiler);
# `k4_run_emulated` and `k5_run_emulated` walk the same decomposition in torch
# for a given geometry, with C from the plain version, so the CPU checks the
# split, the online merges and the combine that only the card runs.

RunGeometry = namedtuple("RunGeometry", "per cpc rows nbuf smem scratch route",
                         defaults=(0,))
RUN_WARPS = 8
RUN_STAGING = ((64, 2), (32, 2), (64, 1), (32, 1))   # (rows per pass, h buffers)


def run_smem(j, d, rows, nbuf, global_=False):
    """Bytes of fvta_corr.cuh's run_layout() (global_: the global route's)."""
    ds, jp = 0 if global_ else k2_vec_stride(d), _cdiv(j, 32) * 32
    return 4 * ((nbuf * rows * ds + nbuf * rows) + rows * ds + 32 * ds + 3 * ds + 3 * jp
                + rows + rows + (rows + 4) + RUN_WARPS * jp + ds)


def k45_geometry(n, s, t, j, d, sms, smem_max, force_global=False):
    """fvta_corr.cuh's run_geometry(): CTAs per sequence, chunks per CTA, rows
    per pass, h buffers, shared memory per CTA, K4's scratch floats, route (1:
    global, where no staging fits or forced)."""
    chunks, ns = _cdiv(t, 32), n * s
    per = sms // ns if sms // ns > 1 else 1
    cpc = _cdiv(chunks, per)
    per = _cdiv(chunks, cpc)
    for rows, nbuf in RUN_STAGING:
        smem = run_smem(j, d, rows, nbuf)
        if smem <= smem_max:
            break
    route = int(force_global or smem > smem_max)
    if route:
        rows, nbuf, smem = 64, 1, run_smem(j, d, 64, 1, True)
    return RunGeometry(per, cpc, rows, nbuf, smem, ns * per * (2 + d + j), route)


K6Geometry = namedtuple("K6Geometry", "per cpc nbuf acc_smem smem scratch route")


def k6_smem(j, d, nbuf, acc_smem, global_=False):
    """Bytes of fvta_bwd.cu's fused_layout() (global_: the global route's)."""
    ds, jp = 0 if global_ else k2_vec_stride(d), _cdiv(j, 32) * 32
    return 4 * (nbuf * 32 * ds + 32 * ds + 32 * ds + (32 * ds if acc_smem else 0) + 32 * jp
                + 5 * ds + 5 * jp + 5 * 32)


def k6_geometry(n, s, t, j, d, sms, smem_max, force_global=False):
    """fvta_bwd.cu's fused_geometry(): CTAs per sequence, chunks per CTA, h
    buffers, dC^T h in shared memory, shared memory per CTA, scratch floats,
    route (1: global, where no staging fits or forced)."""
    chunks, ns = _cdiv(t, 32), n * s
    per = sms // ns if sms // ns > 1 else 1
    cpc = _cdiv(chunks, per)
    per = _cdiv(chunks, cpc)
    jp = _cdiv(j, 32) * 32
    nbuf, acc = 1, False
    for b in (2, 1):
        a = jp == 32 and k6_smem(j, d, b, True) <= smem_max
        if k6_smem(j, d, b, a) <= smem_max:
            nbuf, acc = b, a
            break
    smem = k6_smem(j, d, nbuf, acc)
    route = int(force_global or smem > smem_max)
    if route:
        nbuf, acc, smem = 1, False, k6_smem(j, d, 1, False, True)
    scratch = ns * per * (jp * k2_vec_stride(d) + jp + k2_vec_stride(d))
    return K6Geometry(per, cpc, nbuf, acc, smem, scratch, route)


def run_chunks(t, geo):
    """Each CTA's chunks, in slot order."""
    chunks = _cdiv(t, 32)
    return [list(range(p * geo.cpc, min(p * geo.cpc + geo.cpc, chunks)))
            for p in range(geo.per)]


def run_passes(t, geo):
    """Each CTA's passes, as (t0, t1) row ranges: `geo.rows` rows at most,
    within the CTA's run and T."""
    out = []
    for run in run_chunks(t, geo):
        end = min((run[-1] + 1) * 32, t)
        out.append([(t0, min(t0 + geo.rows, end)) for t0 in range(run[0] * 32, end, geo.rows)])
    return out


def _plain_c(h, q, wx, wy, wxy):
    return fvta_ref.similarity_tensor(h, q, "trilinear", {"w_x": wx, "w_y": wy, "w_xy": wxy})


def k4_run_emulated(h, cm_f, q, qm_f, wx, wy, wxy, geo):
    """K4's function, computed as its CTAs and its merge compute it under `geo`
    (RunGeometry; nbuf, smem and scratch change only where the operands wait):
    per CTA the passes of its run in order, (m, den, v) updated online after
    each, the ctx-masked column maxima carried; then each sequence's slots
    merged in slot order."""
    c = _plain_c(h, q, wx, wy, wxy)
    e = (c + (1.0 - qm_f)[:, None, None, :] * NEG).amax(-1) + (1.0 - cm_f) * NEG
    cs = c + (1.0 - cm_f)[..., None] * NEG
    slots = []
    for run in run_passes(h.shape[2], geo):
        for k, (t0, t1) in enumerate(run):
            ec = e[:, :, t0:t1]
            mc = ec.amax(-1)
            m_new = mc if k == 0 else torch.maximum(m, mc)
            scale = torch.zeros_like(mc) if k == 0 else torch.exp(m - m_new)
            p = torch.exp(ec - m_new[..., None])
            den = (0.0 if k == 0 else den * scale) + p.sum(-1)
            pv = torch.einsum("nst,nstd->nsd", p, h[:, :, t0:t1])
            v = pv if k == 0 else v * scale[..., None] + pv
            colmax = cs[:, :, t0:t1].amax(2)
            eq = colmax if k == 0 else torch.maximum(eq, colmax)
            m = m_new
        slots.append((m, den, v, eq))
    m = torch.stack([sl[0] for sl in slots]).amax(0)
    den, v = torch.zeros_like(m), torch.zeros_like(slots[0][2])
    for m_p, den_p, v_p, _ in slots:
        w = torch.exp(m_p - m)
        den = den + den_p * w
        v = v + v_p * w[..., None]
    eq = torch.stack([sl[3] for sl in slots]).amax(0).amax(1)
    return m, den, v, eq, e


def k5_run_emulated(h, cm_f, q, wx, wy, wxy, eq, geo):
    """K5's function as its CTAs compute it under `geo`: each CTA's tie counts
    over its run's passes, added up over the CTAs."""
    cs = _plain_c(h, q, wx, wy, wxy) + (1.0 - cm_f)[..., None] * NEG
    hits = (cs == eq[:, None, None, :]).to(torch.int32)
    cnt = torch.zeros(eq.shape, dtype=torch.int32)
    for run in run_passes(h.shape[2], geo):
        cnt += sum(hits[:, :, t0:t1].sum(dim=(1, 2)) for t0, t1 in run)
    return cnt.to(h.dtype)


# ---- CPU: dispatch contract ---------------------------------------------------

def test_cpu_path_runs_plain_versions_without_a_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    x, mask, p_fw, p_bw = lstm_case(6, 5, 8, 4, seed=0)
    before = lstm_fused.lstm_fwd.launches
    fvta_before = fvta_fused.fvta_fwd.launches
    out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
    ref_out, ref_fin = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
    assert torch.equal(out, ref_out) and torch.equal(fin, ref_fin)
    h, cm, q, qm, p = fvta_case(2, 3, 5, 4, 6, seed=1)
    att = fvta_fused.fvta_attention_fused(h, cm, q, qm, "trilinear", p)
    ref = fvta_ref.fvta_attention(h, cm, q, qm,
                                  fvta_ref.similarity_tensor(h, q, "trilinear", p))
    assert all(torch.equal(a, b) for a, b in zip(att, ref))
    # a backward on the CPU: autograd through the plain versions, still no build
    bwd_before = lstm_fused.lstm_bwd.launches
    xg = x.clone().requires_grad_()
    hg = h.clone().requires_grad_()
    _, fin = lstm_fused.bilstm_fused(p_fw, p_bw, xg, mask)
    att = fvta_fused.fvta_attention_fused(hg, cm, q, qm, "trilinear", p)
    (fin.sum() + att.context.sum()).backward()
    assert xg.grad is not None and hg.grad is not None
    assert lstm_fused.lstm_fwd.launches == before
    assert lstm_fused.lstm_bwd.launches == bwd_before
    assert fvta_fused.fvta_fwd.launches == fvta_before


def test_lstm_kernel_wrapper_refuses_cpu_tensors():
    x, mask, p_fw, p_bw = lstm_case(6, 5, 8, 4, seed=2)
    lengths = mask.sum(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_fwd(x, lengths, p_fw, p_bw, 1.0, True)
    out = torch.zeros(6, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_bwd(x, lengths, p_fw, p_bw, out, out, None, None, 1.0)


def test_hopper_lstm_wrappers_refuse_cpu_tensors(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a refused CPU tensor must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    x, mask, p_fw, p_bw = lstm_case(6, 5, 8, 4, seed=2)
    lengths = mask.sum(1, dtype=torch.int32)
    xg = torch.zeros(6, 5, 32)
    cell = torch.zeros(6, 5, 8)
    before = (lstm_fused.lstm_proj.launches, lstm_fused.lstm_rec.launches,
              lstm_fused.lstm_rec_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_proj(x, lengths, p_fw, p_bw)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_rec(xg, lengths, p_fw, p_bw, 1.0, True, True, True)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_rec_bwd(xg, lengths, p_fw, p_bw, cell, cell, None, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fused.lstm_k1(x, lengths, p_fw, p_bw, 1.0, True, True, True)
    assert (lstm_fused.lstm_proj.launches, lstm_fused.lstm_rec.launches,
            lstm_fused.lstm_rec_bwd.launches) == before


def test_fvta_kernel_wrapper_refuses_cpu_tensors():
    h, cm, q, qm, p = fvta_case(2, 3, 5, 4, 6, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        fvta_fused.fvta_fwd(h, cm.float(), q, qm.float(), p["w_x"], p["w_y"], p["w_xy"])


def grouped_case(g, n, t, h, seed, device="cpu"):
    """x_proj [G, N, T, 4H] at the scale x.Wx + b has on the main path, int32
    lengths [G, N] with a full and an empty row, wh [G, H, 4H]."""
    rng = np.random.default_rng(seed)
    xp = rng.normal(0, 1, (g, n, t, 4 * h)).astype(np.float32)
    lens = rng.integers(0, t + 1, (g, n)).astype(np.int32)
    lens[:, 0], lens[:, min(1, n - 1)] = t, 0
    lim = np.sqrt(6.0 / (5 * h))
    wh = rng.uniform(-lim, lim, (g, h, 4 * h)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (xp, lens, wh))


def grouped_wh_global(h, cluster, rows, split):
    """csrc/lstm_gscan.cuh's wh_global restated: whether K7 and K8 at (cluster,
    rows, split) read Wh from device memory at width h, because the resident
    K8 exceeds its thread limit or the shared memory."""
    threads = lstm_fused.rec_geometry(h, cluster, rows, split)[0]
    return (threads > lstm_fused._MAX_THREADS[rows]
            or lstm_grouped.grouped_smem(h, cluster, rows, split, True) > build.SMEM_LIMIT)


def test_grouped_wrappers_refuse_cpu_tensors():
    xp, lens, wh = grouped_case(2, 4, 3, 5, seed=20)
    for wrapper in (lstm_grouped.scan_grouped, lstm_grouped.scan_stream,
                    lstm_grouped.scan_grouped_rowtile, lstm_grouped.scan_stream_rowtile):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(xp, lens, wh, 1.0)


def test_build_targets_track_source_hash():
    src = sorted(build.CSRC_DIR.glob("*.cu"))
    # the projection (lstm_proj.cuh) is built into lstm_rec's library, not its own
    assert {"fvta_fwd", "lstm_fwd", "lstm_bwd", "lstm_grouped", "lstm_stream",
            "lstm_rec", "lstm_rec_bwd"} <= {s.stem for s in src}
    assert "lstm_proj" not in {s.stem for s in src}
    targets = [build._target(s) for s in src]
    assert all(t.parent == build.BUILD_DIR and t.name.startswith(s.stem + "-")
               for s, t in zip(src, targets))
    assert len(set(targets)) == len(src)


# ---- CPU: the route's geometry against the CUDA sources -------------------------
# lstm_route's shared-memory sizes (rec_geometry), lane splits (_SPLITS) and
# thread limits (_MAX_THREADS) restate what csrc/lstm_rec.cuh computes and what
# lstm_rec.cu / lstm_rec_bwd.cu instantiate; these tests hold the two copies
# together without a card.

REC_SOURCES = [("lstm_rec.cu", "LSTM_REC_CASE"), ("lstm_rec_bwd.cu", "LSTM_REC_BWD_CASE")]


@pytest.mark.parametrize("source,macro", REC_SOURCES)
def test_route_splits_and_thread_limits_match_the_instantiations(source, macro):
    text = (build.CSRC_DIR / source).read_text()
    pairs = {(int(r), int(s)) for r, s in re.findall(rf"^\s*{macro}\((\d+), (\d+)\)", text, re.M)}
    assert pairs == {(r, s) for r, splits in lstm_fused._SPLITS.items() for s in splits}
    bounds = re.findall(r"__launch_bounds__\(ROWS == 16 \? (\d+) : (\d+)\)", text)
    assert len(bounds) == 1
    assert {16: int(bounds[0][0]), 8: int(bounds[0][1])} == lstm_fused._MAX_THREADS


GEOMETRY_MAIN = r'''
#include <cstdio>
int main() {
  const int hs[] = {5, 7, 8, 16, 36, 100, 116, 128, 200, 256, 300};
  const int splits[] = {4, 8, 16};
  for (int h : hs)
    for (int c = 1; c <= 8; c *= 2)
      for (int rows = 8; rows <= 16; rows *= 2)
        for (int s : splits) {
          const lrec::Geometry f = lrec::fwd_geometry(h, c, rows, s);
          const lrec::Geometry b = lrec::bwd_geometry(h, c, rows, s);
          std::printf("%d %d %d %d %d %zu %zu\n", h, c, rows, s, f.threads, f.smem, b.smem);
        }
  return 0;
}
'''


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_rec_geometry_matches_the_cuda_header(tmp_path):
    """rec_geometry against lstm_rec.cuh's own fwd_geometry / bwd_geometry,
    compiled for the host from the header's text (the device code around them
    needs nvcc)."""
    header = (build.CSRC_DIR / "lstm_rec.cuh").read_text()
    start = header.index("__host__ __device__ inline bool conflict_free")
    end = header.index("inline cudaError_t active_clusters")
    prog = tmp_path / "geometry.cc"
    prog.write_text("#include <cstddef>\n#define __host__\n#define __device__\nnamespace lrec {\n"
                    + header[start:end] + "}\n" + GEOMETRY_MAIN)
    exe = tmp_path / "geometry"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.split("\n")
    rows = [tuple(map(int, line.split())) for line in lines if line]
    assert len(rows) == 11 * 4 * 2 * 3
    for h, c, r, s, threads, fwd, bwd in rows:
        assert lstm_fused.rec_geometry(h, c, r, s) == (threads, fwd, bwd), (h, c, r, s)


# ---- card: kernel vs plain version --------------------------------------------

LSTM_KERNELS = NEW + OLD


def lstm_launches() -> dict:
    return {k: getattr(lstm_fused, k).launches for k in LSTM_KERNELS}


def launched_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in lstm_launches().items()}


def expected_launches(n, t, d, h, backward: bool) -> dict:
    """One launch of each kernel of the shape's route (the backward's too under
    grad), none of the other route's."""
    kernels = lstm_fused.lstm_route(n, t, d, h).kernels
    if not backward:
        kernels = kernels[:-1]
    return {k: int(k in kernels) for k in LSTM_KERNELS}

# The video bilstm encoder's frames: 8 x 1024 at D = 200 (the full-width step)
# and `cli video`'s 16 x 1024 at D = 116, both on clusters of 8 CTAs walking
# 1024 serial steps forward and back (double-buffered h exchange, backward
# positions L-1-t, carried c and dh over the whole scan).
LONG_SHAPES = [(8, 1024, 200, 100), (16, 1024, 116, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("emit_out", [True, False])
@pytest.mark.parametrize("n,t,d,h", [(12, 7, 10, 5), (4, 11, 33, 7), (768, 10, 200, 100),
                                     (64, 24, 200, 100), (8, 30, 200, 100),
                                     (32, 8, 200, 100), *LONG_SHAPES])
def test_lstm_kernel_matches_plain_on_card(cuda, emit_out, n, t, d, h):
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=5, device=cuda)
    with torch.no_grad():
        out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
        before = lstm_launches()
        if emit_out:
            out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
        else:
            fin = lstm_fused.bilstm_fused_final(p_fw, p_bw, x, mask)
        torch.cuda.synchronize()
    assert launched_since(before) == expected_launches(n, t, d, h, backward=False)
    torch.testing.assert_close(fin, fin_r, **LSTM_TOL)
    assert not fin[~mask.any(1)].any()          # length-0 rows: fin = 0
    if emit_out:
        torch.testing.assert_close(out, out_r, **LSTM_TOL)
        assert not out[~mask].any()


# The train step's bi-LSTM shapes at batch 64, A = 4 (H = 100): photo titles
# 256·12 × 10 fin-only (2688 under dedup), time encoders 256 × 12 / 24, the
# question 64 × 30, the choices 256 × 8 fin-only; plus two small odd shapes and
# the video frames (LONG_SHAPES).
K1B_SHAPES = [(12, 7, 10, 5, False), (4, 11, 33, 7, True), (3072, 10, 200, 100, True),
              (2688, 10, 200, 100, True), (256, 12, 200, 100, False),
              (256, 24, 200, 100, False), (64, 30, 200, 100, False),
              (256, 8, 200, 100, True), *((*shape, False) for shape in LONG_SHAPES)]
# K1b + products vs autograd through the plain version on the card: the JAX
# suite's gradient tolerance (tests/test_lstm_fused.py), with N(0, 1) / 64
# cotangents, above every |cotangent| a train step gives these shapes
# (chip_smoke.py reads them and fails if one is larger). The binding check of
# the long dW sums is the unit-scale float64 witness below.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
COTANGENT_SCALE = 1.0 / 64


def k1b_case(n, t, d, h, fin_only, device, scale):
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=12, device=device)
    rng = np.random.default_rng(13)
    g_fin = torch.from_numpy((rng.normal(0, 1, (n, 2 * h)) * scale).astype(np.float32))
    g_out = None if fin_only else torch.from_numpy(
        (rng.normal(0, 1, (n, t, 2 * h)) * scale).astype(np.float32)).to(device)
    return x, mask, p_fw, p_bw, g_out, g_fin.to(device)


def fused(mask, fin_only):
    if fin_only:
        return lambda pf, pb, xx: (None, lstm_fused.bilstm_fused_final(pf, pb, xx, mask))
    return lambda pf, pb, xx: lstm_fused.bilstm_fused(pf, pb, xx, mask)


def lstm_grads(fn, x, p_fw, p_bw, g_out, g_fin):
    leaves = [a.clone().requires_grad_() for a in (x, *p_fw, *p_bw)]
    out, fin = fn(lstm_ref.LSTMParams(*leaves[1:4]), lstm_ref.LSTMParams(*leaves[4:]),
                  leaves[0])
    loss = (fin * g_fin).sum() + (0 if g_out is None else (out * g_out).sum())
    return torch.autograd.grad(loss, leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h,fin_only", K1B_SHAPES)
def test_lstm_bwd_kernel_matches_plain_autograd_on_card(cuda, n, t, d, h, fin_only):
    x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, h, fin_only, cuda, COTANGENT_SCALE)
    ref = lstm_grads(lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask),
                     x, p_fw, p_bw, g_out, g_fin)
    before = lstm_launches()
    got = lstm_grads(fused(mask, fin_only), x, p_fw, p_bw, g_out, g_fin)
    torch.cuda.synchronize()
    assert launched_since(before) == expected_launches(n, t, d, h, backward=True)
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"),
                          got, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    assert not got[0][~mask].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h,fin_only", K1B_SHAPES)
def test_lstm_bwd_kernel_rounding_at_unit_cotangents(cuda, n, t, d, h, fin_only):
    """Unit-scale cotangents: the dW sums over N*T rows put both K1b and the
    float32 plain version ~3e-5 from float64. K1b is at most 2x as far from the
    float64 plain version as the float32 one is, plus 4 ulps of the largest
    entry."""
    x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, h, fin_only, cuda, 1.0)
    plain = lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask)
    d64 = lambda p: lstm_ref.LSTMParams(*(a.double() for a in p))
    ref = lstm_grads(plain, x, p_fw, p_bw, g_out, g_fin)
    ref64 = lstm_grads(plain, x.double(), d64(p_fw), d64(p_bw),
                       None if g_out is None else g_out.double(), g_fin.double())
    got = lstm_grads(fused(mask, fin_only), x, p_fw, p_bw, g_out, g_fin)
    err = lambda a, b: float((a.double() - b).abs().max())
    for a, b, c in zip(got, ref, ref64):
        assert err(a, c) <= 2.0 * err(b, c) + 4 * 2.0 ** -23 * float(c.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h", [(12, 7, 10, 5), (256, 24, 200, 100)])
def test_lstm_fwd_cell_output_matches_plain_carried_cells(cuda, n, t, d, h):
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=14, device=cuda)
    with torch.no_grad():
        out, fin, cell = lstm_fused.lstm_fwd(x, mask.sum(1, dtype=torch.int32), p_fw, p_bw,
                                             1.0, True, emit_cell=True)
        ref = lstm_ref.bilstm_cells_ref(p_fw, p_bw, x, mask)
    torch.testing.assert_close(cell, ref, **LSTM_TOL)


# Edges of the Hopper route, (rows, T, D, H, all lengths 0): H = 100 split
# unevenly over clusters of 8 and 4 (13 and 25 units a CTA), rows just below and
# above the cluster and 16-row thresholds (not multiples of the tile), T = 1,
# an odd width, all rows empty; then a width past the largest cluster, which
# takes the L2-streaming kernels.
EDGE_SHAPES = [(64, 5, 200, 100, False), (65, 5, 200, 100, False), (264, 4, 200, 100, False),
               (265, 4, 200, 100, False), (1056, 3, 200, 100, False),
               (1057, 3, 200, 100, False), (64, 1, 200, 100, False), (20, 9, 40, 36, False),
               (24, 6, 200, 100, True), (16, 5, 24, 300, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h,empty", EDGE_SHAPES)
def test_lstm_route_edges_match_plain_on_card(cuda, n, t, d, h, empty):
    x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, h, False, cuda, COTANGENT_SCALE)
    if empty:
        mask = torch.zeros_like(mask)
        x = x * 0.0
    with torch.no_grad():
        out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
        before = lstm_launches()
        out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
        torch.cuda.synchronize()
    assert launched_since(before) == expected_launches(n, t, d, h, backward=False)
    torch.testing.assert_close(out, out_r, **LSTM_TOL)
    torch.testing.assert_close(fin, fin_r, **LSTM_TOL)
    assert not out[~mask].any() and not fin[~mask.any(1)].any()
    ref = lstm_grads(lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask),
                     x, p_fw, p_bw, g_out, g_fin)
    before = lstm_launches()
    got = lstm_grads(fused(mask, False), x, p_fw, p_bw, g_out, g_fin)
    torch.cuda.synchronize()
    assert launched_since(before) == expected_launches(n, t, d, h, backward=True)
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"), got, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h", [(64, 30, 200, 100), (256, 24, 200, 100),
                                     (3072, 10, 200, 100), (33, 7, 40, 36), *LONG_SHAPES])
def test_lstm_rec_cells_and_preactivations_match_plain_on_card(cuda, n, t, d, h):
    x, mask, p_fw, p_bw = lstm_case(n, t, d, h, seed=15, device=cuda)
    lengths = mask.sum(1, dtype=torch.int32)
    with torch.no_grad():
        xg = lstm_fused.lstm_proj(x, lengths, p_fw, p_bw)
        proj_r = torch.cat([x @ p.wx + p.b for p in (p_fw, p_bw)], dim=-1)
        torch.testing.assert_close(xg[mask], proj_r[mask], **LSTM_TOL)
        out, fin, cell = lstm_fused.lstm_rec(xg, lengths, p_fw, p_bw, 1.0, True,
                                             emit_cell=True, write_preact=True)
        cells_r = lstm_ref.bilstm_cells_ref(p_fw, p_bw, x, mask)
        gates_r = lstm_ref.bilstm_gates_ref(p_fw, p_bw, x, mask)
        torch.cuda.synchronize()
    torch.testing.assert_close(cell, cells_r, **LSTM_TOL)
    torch.testing.assert_close(xg[mask], gates_r[mask], **LSTM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,d,h", [(64, 30, 200, 100), (256, 12, 200, 100),
                                     (3072, 10, 200, 100), (8, 1024, 200, 100)])
def test_lstm_kernels_repeat_bitwise_on_card(cuda, n, t, d, h):
    x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, d, h, False, cuda, 1.0)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
        runs.append([out, fin, *lstm_grads(fused(mask, False), x, p_fw, p_bw, g_out, g_fin)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_fvta_grad_on_card_is_plain_grad(cuda):
    h, cm, q, qm, p = fvta_case(8, 24, 24, 30, 200, seed=15, device=cuda, dead=True)
    rng = np.random.default_rng(16)
    g = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(cuda)
         for s in ((8, 200), (8, 200), (8, 24, 24), (8, 24))]

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (h, q, p["w_x"], p["w_y"], p["w_xy"])]
        out = fn(leaves[0], leaves[1], dict(zip(("w_x", "w_y", "w_xy"), leaves[2:])))
        return torch.autograd.grad(sum((o * gg).sum() for o, gg in zip(out, g)), leaves)

    ref = grads(lambda hh, qq, pp: fvta_ref.fvta_attention(
        hh, cm, qq, qm, fvta_ref.similarity_tensor(hh, qq, "trilinear", pp)))
    before = fvta_fused.fvta_fwd.launches
    got = grads(lambda hh, qq, pp: fvta_fused.fvta_attention_fused(hh, cm, qq, qm,
                                                                   "trilinear", pp))
    assert fvta_fused.fvta_fwd.launches == before + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dead", [((8, 24, 24, 30, 200), False),
                                        ((8, 24, 24, 30, 200), True),
                                        ((2, 6, 512, 30, 200), False),
                                        ((3, 1, 7, 40, 16), True)])
@pytest.mark.parametrize("kind", ["trilinear", "dot"])
def test_fvta_kernel_matches_plain_on_card(cuda, shape, dead, kind):
    h, cm, q, qm, p = fvta_case(*shape, seed=7, device=cuda, dead=dead)
    p = p if kind == "trilinear" else {}
    with torch.no_grad():
        ref = fvta_ref.fvta_attention(h, cm, q, qm, fvta_ref.similarity_tensor(h, q, kind, p))
        before = fvta_fused.fvta_fwd.launches
        out = fvta_fused.fvta_attention_fused(h, cm, q, qm, kind, p)
        torch.cuda.synchronize()
    assert fvta_fused.fvta_fwd.launches == before + 1
    for x, y, field in zip(out, ref, FIELDS):
        assert torch.isfinite(x).all(), field
        torch.testing.assert_close(x, y, **FVTA_TOL, msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["trilinear", "dot"])
def test_fvta_kernel_rounding_on_unbounded_inputs(cuda, kind):
    """Unbounded h, q (|C| ~ 40, sharp softmaxes): K2 is about as close to the
    float64 plain version as the float32 plain version is."""
    h, cm, q, qm, p = fvta_case(8, 24, 24, 30, 200, seed=11, device=cuda, bounded=False)
    p = p if kind == "trilinear" else {}
    p64 = {k: v.double() for k, v in p.items()}
    with torch.no_grad():
        out = fvta_fused.fvta_attention_fused(h, cm, q, qm, kind, p)
        ref = fvta_ref.fvta_attention(h, cm, q, qm, fvta_ref.similarity_tensor(h, q, kind, p))
        ref64 = fvta_ref.fvta_attention(h.double(), cm, q.double(), qm,
                                        fvta_ref.similarity_tensor(h.double(), q.double(),
                                                                   kind, p64))
    err = lambda a, b: max(float((x.double() - y).abs().max()) for x, y in zip(a, b))
    assert err(out, ref64) <= 2.0 * err(ref, ref64)


# ---- card: K2 at the main paths' shapes, and the serial K2 beside it ----------
# (n, s, t, j, d): an answer step for 1 and 8 requests, the train step (N = 64)
# and an evaluation batch (N = 128), all at S = T = 24; S = 1 at the video
# lengths, which `fvta_attention_fused` sends to the streaming form but the
# crossover and the streaming-vs-K2 check run through K2.
K2_MAIN_SHAPES = [(1, 24, 24, 30, 200), (8, 24, 24, 30, 200), (64, 24, 24, 30, 200),
                  (128, 24, 24, 30, 200)]
K2_LONG_SHAPES = [(8, 1, 1024, 30, 200), (8, 1, 4096, 30, 200)]


def _k2_args(shape, seed, device, dead=False, bounded=True):
    h, cm, q, qm, p = fvta_case(*shape, seed=seed, device=device, dead=dead, bounded=bounded)
    args = (h, cm.float(), q, qm.float(), p["w_x"], p["w_y"], p["w_xy"])
    ref = fvta_ref.fvta_attention(h, cm, q, qm, fvta_ref.similarity_tensor(h, q, "trilinear", p))
    return args, ref


def _k2_launches():
    return fvta_fused.fvta_fwd.launches, fvta_fused.fvta_fwd_serial.launches


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K2_MAIN_SHAPES + K2_LONG_SHAPES)
@pytest.mark.parametrize("dead", [False, True])
def test_k2_matches_plain_at_main_path_shapes_on_card(cuda, shape, dead):
    """One launch of K2 and none of the serial K2 per call; every field within
    1e-5 / 1e-5 of plain, with and without a dead sequence, an all-masked
    question and an example with no valid context."""
    with torch.no_grad():
        args, ref = _k2_args(shape, 50, cuda, dead=dead)
        before = _k2_launches()
        out = fvta_fused.fvta_fwd(*args)
        torch.cuda.synchronize()
    new, old = _k2_launches()
    assert (new - before[0], old - before[1]) == (1, 0)
    for x, y, field in zip(out, ref, FIELDS):
        assert torch.isfinite(x).all(), field
        torch.testing.assert_close(x, y, **FVTA_TOL, msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K2_MAIN_SHAPES + K2_LONG_SHAPES + [
    (2, 6, 512, 30, 200), (3, 1, 7, 40, 16), (8, 24, 24, 200, 200), (200, 300, 3, 30, 200)])
def test_k2_geometry_is_the_plan_and_schedulable_on_card(cuda, shape):
    """The library's geometry is fvta_fwd.cuh's plan (k2_plan) at the cluster
    cap it settled on, schedulable, within a CTA's shared memory."""
    geo = fvta_fused.geometry(*shape)
    assert fvta_fused.geometry(*shape) is geo          # read once per device and shape
    plan = k2_plan(*shape, geo["sms"], build.SMEM_LIMIT, geo["cluster_cap"])
    assert tuple(geo[k] for k in K2Plan._fields[:-1]) == tuple(plan)[:-1]
    assert geo["route"] == fvta_fused.ROUTES[plan.route]
    assert geo["active_clusters"] >= 1 and 1 <= geo["cluster"] <= K2_MAX_CLUSTER
    assert geo["smem"] <= build.SMEM_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K2_MAIN_SHAPES + [(8, 1, 4096, 30, 200),
                                                    (2, 6, 512, 30, 200), (3, 1, 7, 40, 16),
                                                    (8, 24, 24, 200, 200)])
def test_k2_repeats_bitwise_and_matches_the_serial_kernel_on_card(cuda, shape):
    """Two launches equal bit for bit; within 1e-5 / 1e-5 of the serial K2
    (J = 200 stages q in tiles of 32 columns)."""
    with torch.no_grad():
        args, ref = _k2_args(shape, 51, cuda, dead=True)
        before = _k2_launches()
        a = fvta_fused.fvta_fwd(*args)
        b = fvta_fused.fvta_fwd(*args)
        old = fvta_fused.fvta_fwd_serial(*args)
        torch.cuda.synchronize()
    new, old_n = _k2_launches()
    assert (new - before[0], old_n - before[1]) == (2, 1)
    for x, y, z, field in zip(a, b, old, FIELDS):
        assert torch.equal(x, y), field
        torch.testing.assert_close(x, z, **FVTA_TOL, msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 24, 24, 30, 200), (2, 1, 1025, 30, 200),
                                   (3, 1, 7, 40, 16), (2, 6, 33, 5, 18)])
def test_k2_takes_h_off_a_16_byte_boundary_on_card(cuda, shape):
    """A contiguous h one float past its storage's start: K2 copies its rows 4
    bytes at a time there (16 where D % 4 == 0 and h is 16-byte aligned) and
    gives the aligned launch's outputs bit for bit."""
    with torch.no_grad():
        args, ref = _k2_args(shape, 52, cuda, dead=True)
        h = args[0]
        store = torch.empty(h.numel() + 1, dtype=h.dtype, device=cuda)
        h_off = store[1:].view(h.shape)
        h_off.copy_(h)
        assert h_off.is_contiguous() and h_off.data_ptr() % 16 != 0
        a = fvta_fused.fvta_fwd(*args)
        b = fvta_fused.fvta_fwd(h_off, *args[1:])
        torch.cuda.synchronize()
    for x, y, z, field in zip(a, b, ref, FIELDS):
        assert torch.equal(x, y), field
        torch.testing.assert_close(y, z, **FVTA_TOL, msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K2_MAIN_SHAPES + K2_LONG_SHAPES)
def test_k2_rounding_on_unbounded_inputs_at_main_path_shapes(cuda, shape):
    """Unbounded h, q at the main paths' shapes: K2 is at most 2x as far from
    the float64 plain version as the float32 plain version is."""
    with torch.no_grad():
        args, ref = _k2_args(shape, 53, cuda, dead=True, bounded=False)
        h, cm, q, qm = args[0], args[1] > 0.5, args[2], args[3] > 0.5
        p64 = dict(zip(("w_x", "w_y", "w_xy"), (w.double() for w in args[4:])))
        ref64 = fvta_ref.fvta_attention(h.double(), cm, q.double(), qm,
                                        fvta_ref.similarity_tensor(h.double(), q.double(),
                                                                   "trilinear", p64))
        out = fvta_fused.fvta_fwd(*args)
    err = lambda a, b: max(float((x.double() - y).abs().max()) for x, y in zip(a, b))
    assert all(torch.isfinite(x).all() for x in out)
    assert err(out, ref64) <= 2.0 * err(ref, ref64)


@pytest.mark.gpu
def test_wrappers_check_inputs_on_card(cuda):
    x, mask, p_fw, p_bw = lstm_case(6, 5, 8, 4, seed=8, device=cuda)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            lstm_fused.bilstm_fused(p_fw, p_bw, x.double(), mask)
        with pytest.raises(ValueError, match="contiguous"):
            lstm_fused.lstm_fwd(x.transpose(0, 1), mask.sum(1, dtype=torch.int32),
                                p_fw, p_bw, 1.0, True)
    # under grad the wrappers run K1 with cells, then K1b in the backward
    p_grad = lstm_ref.LSTMParams(*(a.clone().requires_grad_() for a in p_fw))
    before = lstm_launches()
    lstm_fused.bilstm_fused(p_grad, p_bw, x, mask)[0].sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in p_grad)
    assert launched_since(before) == expected_launches(6, 5, 8, 4, backward=True)
    h, cm, q, qm, p = fvta_case(2, 3, 5, 4, 6, seed=9, device=cuda)
    with pytest.raises(ValueError, match="q_mask"):
        fvta_fused.fvta_fwd(h, cm.float(), q, qm.float()[:, :2], p["w_x"], p["w_y"],
                            p["w_xy"])


# ---- card: K4, K5, K6 vs their plain versions ----------------------------------
# (n, s, t, j, d): the video train step (S = 1, T = 4096 at D = 200, cut to N = 2
# here), MemexQA-like S = 24 at T = 24, and small odd shapes past a chunk edge.
STATS_SHAPES = [(2, 1, 4096, 30, 200), (4, 24, 24, 30, 200), (3, 2, 70, 5, 6),
                (2, 3, 33, 40, 16)]
STATS_TOL = dict(rtol=1e-5, atol=1e-5)   # the JAX suite's stats tolerance


def _card_stats_case(shape, seed, device, masked):
    """Bounded states (as the encoders give) and similarity weights at the
    models' initial scale, N(0, 0.1): at N(0, 1) the scores reach |C| ~ 30,
    where float32 rounding alone moves them by ~1e-5."""
    n, s, t, j, d = shape
    h, cm, q, qm, p = fvta_case(n, s, t, j, d, seed, device=device)
    if masked:
        cm[:, 0, : t // 2] = False      # a sequence with a dead first half
        cm[0] = False                   # an example with no valid frame
        qm[min(1, n - 1)] = False       # an all-masked question
    return (h * cm[..., None], cm.float(), q, qm.float(),
            tuple(0.1 * p[k] for k in ("w_x", "w_y", "w_xy")))


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_stats_kernels_match_plain_on_card(cuda, shape, masked):
    h, cm, q, qm, w = _card_stats_case(shape, 40, cuda, masked)
    before = (fvta_stats.stats_fwd.launches, fvta_stats.qcnt.launches,
              fvta_stats.stats_bwd.launches)
    with torch.no_grad():
        got = fvta_stats.stats_fwd(h, cm, q, qm, *w)
        ref = fvta_stats.stats_fwd_ref(h, cm, q, qm, *w)
        for field, a, b in zip(("m", "den", "v", "eq", "e"), got, ref):
            torch.testing.assert_close(a, b, **STATS_TOL, msg=field)
        # K5 from K4's eq, the plain count from the plain eq: equal, and >= 1
        cnt = fvta_stats.qcnt(h, cm, q, *w, got[3])
        cnt_r = fvta_stats.qcnt_ref(h, cm, q, *w, ref[3])
        assert torch.equal(cnt, cnt_r) and (cnt >= 1).all()
        rng = np.random.default_rng(41)
        n, s, t, d = h.shape
        de, geq, gv = (torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(cuda)
                       for sh in ((n, s, t), tuple(qm.shape), (n, s, d)))
        dk = fvta_stats.stats_bwd(h, cm, q, qm, *w, de, geq, got[3], cnt, got[4], got[0], gv)
        dr = fvta_stats.stats_bwd_ref(h, cm, q, qm, *w, de, geq, ref[3], cnt_r, ref[4],
                                      ref[0], gv)
        torch.cuda.synchronize()
    for field, a, b in zip(("dh", "dq", "dwx", "dwy", "dwxy"), dk, dr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=field)
    assert (fvta_stats.stats_fwd.launches, fvta_stats.qcnt.launches,
            fvta_stats.stats_bwd.launches) == tuple(x + 1 for x in before)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STATS_CASES))
def test_stats_grad_on_card_matches_plain_autograd(cuda, name):
    h, cm, q, qm, p = stats_case(name, seed=42, device=cuda)
    out_r, ref = stats_grads(fvta_ref.focal_local_stats, h, cm, q, qm, p)
    before = fvta_stats.stats_bwd.launches
    out_k, got = stats_grads(fvta_stats.fvta_stats_fused, h, cm, q, qm, p)
    assert fvta_stats.stats_bwd.launches == before + 1
    for field, a, b in zip(("m", "den", "v", "eq", "e"), out_k, out_r):
        torch.testing.assert_close(a, b, **STATS_TOL, msg=field)
    for field, a, b in zip(("h", "q", "w_x", "w_y", "w_xy"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=field)


# ---- card: K6 (one pass) at its edges, against plain and the two-pass K6 --------
# T at the chunk edges (1, 31, 32, 33) and past one CTA's range at the video
# step's width (1023, 1025), `cli video`'s call (N = 16 examples of 8 CTAs of
# 4 chunks each), J = 512 (question words in 16 tiles of 32), and D = 500,
# where only one h buffer fits and dC^T h waits in the global slot
CLI_VIDEO_SHAPE = (16, 1, 1024, 30, 200)
K6_EDGE_SHAPES = [(2, 1, 1, 30, 200), (2, 1, 31, 30, 200), (2, 1, 32, 30, 200),
                  (2, 1, 33, 30, 200), (2, 1, 1023, 30, 200), (2, 1, 1025, 30, 200),
                  CLI_VIDEO_SHAPE, (1, 2, 300, 512, 200), (2, 3, 33, 40, 16),
                  (1, 1, 100, 30, 500)]
K6_FIELDS = ("dh", "dq", "dwx", "dwy", "dwxy")


def _k6_args(shape, seed, device, masked=False, geq_only=False):
    """(kernel args, plain args) of K6: eq, e, m and the tie counts from K4 and
    K5 for the kernel, from their plain versions for the plain K6; cotangents
    N(0, 1). geq_only: de = gv = 0, so dC comes from eq's cotangent alone."""
    h, cm, q, qm, w = _card_stats_case(shape, seed, device, masked)
    n, s, t, d = h.shape
    rng = np.random.default_rng(seed + 1)
    de, geq, gv = (torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(device)
                   for sh in ((n, s, t), tuple(qm.shape), (n, s, d)))
    if geq_only:
        de, gv = torch.zeros_like(de), torch.zeros_like(gv)
    with torch.no_grad():
        got = fvta_stats.stats_fwd(h, cm, q, qm, *w)
        ref = fvta_stats.stats_fwd_ref(h, cm, q, qm, *w)
        cnt, cnt_r = (fvta_stats.qcnt(h, cm, q, *w, got[3]),
                      fvta_stats.qcnt_ref(h, cm, q, *w, ref[3]))
    head = (h, cm, q, qm, *w, de, geq)
    return ((*head, got[3], cnt, got[4], got[0], gv), (*head, ref[3], cnt_r, ref[4], ref[0], gv))


def _assert_k6_close(got, ref, exact=None):
    """Each field at 1e-4 / 1e-5; with `exact` (float64 plain outputs), a field
    beyond it passes only on chip_smoke's float64 witness: at most 2x as far
    from float64 as `ref` is, plus 4 float32 ulps of the largest entry (unit
    cotangents over 4096 frames put entries of dwxy near 0 ~1e-5 from float64
    in both kernels)."""
    for i, (field, a, b) in enumerate(zip(K6_FIELDS, got, ref)):
        if exact is None or torch.allclose(a, b, rtol=1e-4, atol=1e-5):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=field)
            continue
        c = exact[i]
        e_a, e_b = float((a.double() - c).abs().max()), float((b.double() - c).abs().max())
        assert e_a <= 2.0 * e_b + 4.0 * 2.0 ** -23 * float(c.abs().max()), (field, e_a, e_b)


def _k6_f64(args_r):
    """The float64 plain K6 on the plain arguments (tie counts recounted in float64)."""
    a64 = [a.double() for a in args_r]
    h, cm, q, qm, wx, wy, wxy = a64[:7]
    r64 = fvta_stats.stats_fwd_ref(h, cm, q, qm, wx, wy, wxy)
    cnt = fvta_stats.qcnt_ref(h, cm, q, wx, wy, wxy, r64[3])
    return fvta_stats.stats_bwd_ref(*a64[:9], r64[3], cnt, r64[4], r64[0], a64[13])


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", K6_EDGE_SHAPES)
def test_k6_edges_match_plain_and_the_two_pass_kernel_on_card(cuda, shape, masked):
    args, args_r = _k6_args(shape, 43, cuda, masked)
    before = (fvta_stats.stats_bwd.launches, fvta_stats.stats_bwd_twopass.launches)
    with torch.no_grad():
        got = fvta_stats.stats_bwd(*args)
        old = fvta_stats.stats_bwd_twopass(*args)
        ref = fvta_stats.stats_bwd_ref(*args_r)
        torch.cuda.synchronize()
    assert (fvta_stats.stats_bwd.launches, fvta_stats.stats_bwd_twopass.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_k6_close(got, ref)
    _assert_k6_close(got, old)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1, 4096, 30, 200), CLI_VIDEO_SHAPE,
                                   (2, 24, 24, 30, 200)])
def test_k6_geq_only_matches_plain_on_card(cuda, shape):
    """de = gv = 0: every entry of dC is a share of eq's cotangent, routed to the
    positions whose recomputed C equals K4's eq bit for bit. A C that differed in
    its last bit would drop the share (max(qcnt, 1) hides the lost tie), far
    outside the tolerance at unit-scale geq."""
    args, args_r = _k6_args(shape, 44, cuda, geq_only=True)
    with torch.no_grad():
        got = fvta_stats.stats_bwd(*args)
        ref = fvta_stats.stats_bwd_ref(*args_r)
        torch.cuda.synchronize()
    assert float(ref[1].abs().max()) > 1e-3    # the shares reach dq, far above atol
    _assert_k6_close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1, 4096, 30, 200), CLI_VIDEO_SHAPE,
                                   (1, 2, 300, 512, 200)])
def test_k6_repeats_bitwise_and_matches_the_two_pass_kernel_on_card(cuda, shape):
    args, args_r = _k6_args(shape, 45, cuda)
    with torch.no_grad():
        a = fvta_stats.stats_bwd(*args)
        b = fvta_stats.stats_bwd(*args)
        old = fvta_stats.stats_bwd_twopass(*args)
        exact = _k6_f64(args_r)
        torch.cuda.synchronize()
    for field, x, y in zip(K6_FIELDS, a, b):
        assert torch.equal(x, y), field
    _assert_k6_close(a, old, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1, 1025, 30, 200), (2, 3, 33, 40, 16)])
def test_k6_takes_h_off_a_16_byte_boundary_on_card(cuda, shape):
    """A contiguous h one float past its storage's start: K6 copies its rows 4
    bytes at a time there (16 where D % 4 == 0 and h is 16-byte aligned) and
    gives the aligned launch's outputs bit for bit."""
    args, args_r = _k6_args(shape, 46, cuda)
    h = args[0]
    store = torch.empty(h.numel() + 1, dtype=h.dtype, device=cuda)
    h_off = store[1:].view(h.shape)
    h_off.copy_(h)
    assert h_off.is_contiguous() and h_off.data_ptr() % 16 != 0
    with torch.no_grad():
        a = fvta_stats.stats_bwd(*args)
        b = fvta_stats.stats_bwd(h_off, *args[1:])
        ref = fvta_stats.stats_bwd_ref(*args_r)
        torch.cuda.synchronize()
    for field, x, y in zip(K6_FIELDS, a, b):
        assert torch.equal(x, y), field
    _assert_k6_close(b, ref)


# ---- card: K4 and K5 (runs of chunks) against plain and the chunked kernels -----
# chip_smoke's K4_SYNTH shapes (the T=4096 step's and `cli video`'s twins,
# MemexQA-like S = 24, the J = 512 long question), then the edges: T at a chunk
# edge (1, 31, 32, 33), past one CTA's run (1023, 1025 in runs of one chunk),
# T below one run (200 examples: one CTA per sequence, a run of 4 chunks, the
# last partial), J = 40 at D = 16, and D = 500 (one h buffer)
K45_SHAPES = [(8, 1, 4096, 30, 200), CLI_VIDEO_SHAPE, (8, 24, 24, 30, 200),
              (2, 8, 16384, 512, 200)]
K45_EDGE_SHAPES = [(2, 1, 1, 30, 200), (2, 1, 31, 30, 200), (2, 1, 32, 30, 200),
                   (2, 1, 33, 30, 200), (2, 1, 1023, 30, 200), (2, 1, 1025, 30, 200),
                   (200, 1, 100, 30, 200), (2, 3, 33, 40, 16), (1, 1, 100, 30, 500)]
K45_STATE = ("stats_fwd", "qcnt", "stats_fwd_chunked", "qcnt_chunked")


def _k45_launches():
    return tuple(getattr(fvta_stats, k).launches for k in K45_STATE)


def _k45_args(shape, seed, device, masked):
    h, cm, q, qm, w = _card_stats_case(shape, seed, device, masked)
    return (h, cm, q, qm, *w)


def _assert_stats_close(got, ref, exact):
    """Each field of K4 at the stats tolerance; a field beyond it passes only
    on chip_smoke's float64 witness (sums over 16 384 frames put v ~1e-4 from
    float64 in both the kernel and the float32 plain version)."""
    for i, (field, a, b) in enumerate(zip(("m", "den", "v", "eq", "e"), got, ref)):
        if torch.allclose(a, b, **STATS_TOL):
            continue
        c = exact[i]
        e_a, e_b = float((a.double() - c).abs().max()), float((b.double() - c).abs().max())
        assert e_a <= 2.0 * e_b + 4.0 * 2.0 ** -23 * float(c.abs().max()), (field, e_a, e_b)


def _k45_check(args):
    """K4 and K5 against plain and the chunked kernels on one case: K4's
    fields at the stats tolerance (or the float64 witness), its maxima (m, eq,
    e) and K5's counts bitwise the chunked kernels', the counts exactly
    qcnt_ref's and >= 1; one launch each. Returns K4's and K5's outputs and the
    chunked ones."""
    h, cm, q, qm, wx, wy, wxy = args
    w = (wx, wy, wxy)
    before = _k45_launches()
    with torch.no_grad():
        got = fvta_stats.stats_fwd(*args)
        cnt = fvta_stats.qcnt(h, cm, q, *w, got[3])
        old = fvta_stats.stats_fwd_chunked(*args)
        cnt_old = fvta_stats.qcnt_chunked(h, cm, q, *w, old[3])
        ref = fvta_stats.stats_fwd_ref(*args)
        cnt_r = fvta_stats.qcnt_ref(h, cm, q, *w, ref[3])
        exact = fvta_stats.stats_fwd_ref(*(a.double() for a in args))
        torch.cuda.synchronize()
    assert _k45_launches() == tuple(x + 1 for x in before)
    _assert_stats_close(got, ref, exact)
    for i in (0, 3, 4):
        assert torch.equal(got[i], old[i]), i
    assert torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_old) and (cnt >= 1).all()
    return got, cnt, old, cnt_old


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", K45_SHAPES + K45_EDGE_SHAPES)
def test_k45_match_plain_and_the_chunked_kernels_on_card(cuda, shape, masked):
    _k45_check(_k45_args(shape, 47, cuda, masked))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K45_SHAPES[:3] + [(200, 1, 100, 30, 200)])
def test_k6_on_k45_outputs_equals_k6_on_the_chunked_outputs_on_card(cuda, shape):
    """K6 fed the new K4's and K5's outputs, and K6 fed the chunked kernels',
    give the same bits (K4's maxima and K5's counts are the chunked ones')."""
    args = _k45_args(shape, 48, cuda, False)
    got, cnt, old, cnt_old = _k45_check(args)
    n, s, t, d = args[0].shape
    rng = np.random.default_rng(49)
    de, geq, gv = (torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(cuda)
                   for sh in ((n, s, t), tuple(args[3].shape), (n, s, d)))
    with torch.no_grad():
        a = fvta_stats.stats_bwd(*args, de, geq, got[3], cnt, got[4], got[0], gv)
        b = fvta_stats.stats_bwd(*args, de, geq, old[3], cnt_old, old[4], old[0], gv)
        torch.cuda.synchronize()
    for field, x, y in zip(K6_FIELDS, a, b):
        assert torch.equal(x, y), field


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K45_SHAPES)
def test_k45_repeat_bitwise_on_card(cuda, shape):
    h, cm, q, qm, wx, wy, wxy = _k45_args(shape, 50, cuda, True)
    with torch.no_grad():
        a, b = (fvta_stats.stats_fwd(h, cm, q, qm, wx, wy, wxy) for _ in range(2))
        c1, c2 = (fvta_stats.qcnt(h, cm, q, wx, wy, wxy, a[3]) for _ in range(2))
        torch.cuda.synchronize()
    for field, x, y in zip(("m", "den", "v", "eq", "e"), a, b):
        assert torch.equal(x, y), field
    assert torch.equal(c1, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1, 1025, 30, 200), (2, 3, 33, 40, 16), CLI_VIDEO_SHAPE])
def test_k45_take_h_and_q_off_a_16_byte_boundary_on_card(cuda, shape):
    """h and q one float past their storage's start: K4 and K5 copy h's rows 4
    bytes at a time there (16 where D % 4 == 0 and h is 16-byte aligned) and give
    the aligned launch's outputs bit for bit."""
    args = _k45_args(shape, 51, cuda, True)
    h, cm, q, qm, wx, wy, wxy = args

    def off(x):
        store = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        y = store[1:].view(x.shape)
        y.copy_(x)
        assert y.is_contiguous() and y.data_ptr() % 16 != 0
        return y

    h_off, q_off = off(h), off(q)
    with torch.no_grad():
        a = fvta_stats.stats_fwd(*args)
        b = fvta_stats.stats_fwd(h_off, cm, q_off, qm, wx, wy, wxy)
        c1 = fvta_stats.qcnt(h, cm, q, wx, wy, wxy, a[3])
        c2 = fvta_stats.qcnt(h_off, cm, q_off, wx, wy, wxy, a[3])
        torch.cuda.synchronize()
    for field, x, y in zip(("m", "den", "v", "eq", "e"), a, b):
        assert torch.equal(x, y), field
    assert torch.equal(c1, c2)
    _k45_check((h_off, cm, q_off, qm, wx, wy, wxy))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K45_SHAPES + K45_EDGE_SHAPES)
def test_k45_geometry_is_the_mirror_on_card(cuda, shape):
    """The geometry the wrappers launch with (and allocate K4's scratch from)
    is run_geometry's Python mirror at this card's SM count and shared-memory
    limit, and fits a CTA."""
    props = torch.cuda.get_device_properties(cuda)
    smem_max = getattr(props, "shared_memory_per_block_optin", build.SMEM_LIMIT)
    with torch.cuda.device(cuda):
        geo = fvta_stats.run_geometry(*shape)
    mirror = k45_geometry(*shape, sms=props.multi_processor_count, smem_max=smem_max)
    assert tuple(geo.values())[:-1] == tuple(mirror)[:-1]
    assert geo["route"] == fvta_stats.ROUTES[mirror.route]
    assert geo["smem"] <= smem_max


@pytest.mark.gpu
def test_stats_fused_launches_the_runs_and_not_the_chunked_kernels_on_card(cuda):
    h, cm, q, qm, p = stats_case("s1_long", seed=52, device=cuda)
    before = _k45_launches()
    stats_grads(fvta_stats.fvta_stats_fused, h, cm, q, qm, p)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _k45_launches())) == (1, 1, 0, 0)


# ---- card: K7, K8 vs their plain version ----------------------------------------
# (g, n, t, h): small odd shapes, and at H = 100 the batch-64 train step's
# bi-LSTM shapes as a G = 2 group (photo titles 3072 x 10, the encoders at 256
# rows, the question 64 x 30, the choices 256 x 8), the routing edge
# n = 1024, t = 2 and n = 1023, and G = 1; then widths past the row-tile kernels'
# limit (~110): H = 128 and H = 200, on clusters of 1 to 8 CTAs, and G = 3.
# K8's ring takes bulk copies where Hc is a multiple of 4 (3072 x 10 at H =
# 100, every H = 128 shape) and 4-byte cp.async elsewhere.
GROUPED_SHAPES = [(1, 12, 7, 5), (2, 9, 11, 7), (2, 3072, 10, 100), (2, 256, 24, 100),
                  (2, 64, 30, 100), (2, 256, 8, 100), (2, 1024, 2, 100), (1, 1023, 12, 100),
                  (2, 256, 12, 128), (2, 1024, 4, 128), (3, 40, 9, 128), (2, 64, 30, 200),
                  (2, 2048, 5, 200)]
ROWTILE_SHAPES = [s for s in GROUPED_SHAPES if s[3] <= 100]   # the row-tile kernels stop at ~110


def _grouped_launches():
    return tuple(getattr(lstm_grouped, k).launches for k in
                 ("scan_grouped", "scan_stream", "scan_grouped_rowtile", "scan_stream_rowtile"))


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", GROUPED_SHAPES)
@pytest.mark.parametrize("kernel", ["scan_grouped", "scan_stream"])
def test_grouped_kernels_match_plain_on_card(cuda, kernel, g, n, t, h):
    xp, lens, wh = grouped_case(g, n, t, h, seed=21, device=cuda)
    wrapper = getattr(lstm_grouped, kernel)
    before = _grouped_launches()
    out, fin = wrapper(xp, lens, wh, 1.0)
    torch.cuda.synchronize()
    launched = [b - a for a, b in zip(before, _grouped_launches())]
    assert launched == ([1, 0, 0, 0] if kernel == "scan_grouped" else [0, 1, 0, 0])
    out_r, fin_r = lstm_grouped.grouped_scan_ref(xp, lens, wh, 1.0)
    torch.testing.assert_close(out, out_r, **LSTM_TOL)
    torch.testing.assert_close(fin, fin_r, **LSTM_TOL)
    dead = torch.arange(t, device=cuda)[None, None, :] >= lens[..., None]
    assert not out[dead].any() and not fin[lens == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", GROUPED_SHAPES)
def test_k7_and_k8_agree_on_card(cuda, g, n, t, h):
    """The same sums in the same order: K7 and K8 agree bit for bit, and each
    repeats its own bits."""
    xp, lens, wh = grouped_case(g, n, t, h, seed=22, device=cuda)
    k7 = lstm_grouped.scan_grouped(xp, lens, wh, 1.0)
    k8 = lstm_grouped.scan_stream(xp, lens, wh, 1.0)
    for a, b, a2, b2 in zip(k7, k8, lstm_grouped.scan_grouped(xp, lens, wh, 1.0),
                            lstm_grouped.scan_stream(xp, lens, wh, 1.0)):
        assert torch.equal(a, b) and torch.equal(a, a2) and torch.equal(b, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", [s for s in GROUPED_SHAPES if s[0] == 2])
def test_grouped_kernels_fed_k1_projection_give_k1_bits_on_card(cuda, g, n, t, h):
    """K1's projection (lstm_proj) as two groups, the backward half flipped to
    the front: K7 and K8 return lstm_rec's out and fin bit for bit (the same
    lane split, so the same sums)."""
    x, mask, p_fw, p_bw = lstm_case(n, t, 2 * h, h, seed=24, device=cuda)
    route = lstm_fused.lstm_route(n, t, 2 * h, h)
    assert lstm_grouped.grouped_route(2, n, t, h).split == route.split
    l32 = mask.sum(1, dtype=torch.int32)
    with torch.no_grad():
        xg = lstm_fused.lstm_proj(x, l32, p_fw, p_bw)
        out_k1, fin_k1, _ = lstm_fused.lstm_rec(xg, l32, p_fw, p_bw, 1.0, emit_out=True)
        xp = torch.stack([xg[..., :4 * h], lstm_ref._flip_to_front(xg[..., 4 * h:], l32)])
        for kernel in (lstm_grouped.scan_grouped, lstm_grouped.scan_stream):
            out, fin = kernel(xp.contiguous(), l32[None].expand(2, -1), (p_fw.wh, p_bw.wh),
                              1.0)
            assert torch.equal(out[0], out_k1[..., :h])
            assert torch.equal(lstm_ref._flip_to_front(out[1], l32), out_k1[..., h:])
            assert torch.equal(torch.cat([fin[0], fin[1]], -1), fin_k1)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", GROUPED_SHAPES[2:])
def test_grouped_kernels_take_wh_and_x_proj_where_they_lie_on_card(cuda, g, n, t, h):
    """Wh as G separate tensors and lengths shared by every group (stride 0)
    give the stacked call's bits; x_proj off a 16-byte boundary sends K8 to its
    4-byte copies, with the same bits."""
    xp, lens, wh = grouped_case(g, n, t, h, seed=25, device=cuda)
    lens[:] = lens[0]
    ref = lstm_grouped.scan_grouped(xp, lens, wh, 1.0)
    # two separate allocations always lie one stride apart; three need not
    apart = [w.clone() for w in wh] if g <= 2 else list(wh.clone().unbind(0))
    shifted = torch.empty(xp.numel() + 1, device=cuda)[1:].view_as(xp)
    shifted.copy_(xp)
    for kernel in (lstm_grouped.scan_grouped, lstm_grouped.scan_stream):
        for a, b in zip(kernel(xp, lens[:1].expand(g, -1), apart, 1.0), ref):
            assert torch.equal(a, b)
        for a, b in zip(kernel(shifted, lens, wh, 1.0), ref):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", ROWTILE_SHAPES)
@pytest.mark.parametrize("kernel", ["scan_grouped_rowtile", "scan_stream_rowtile"])
def test_rowtile_kernels_match_plain_and_the_new_kernels_on_card(cuda, kernel, g, n, t, h):
    """The row-tile kernels, kept beside K7 and K8, still agree with plain and with
    the new kernels (other sum orders: LSTM_TOL)."""
    xp, lens, wh = grouped_case(g, n, t, h, seed=26, device=cuda)
    wrapper = getattr(lstm_grouped, kernel)
    before = wrapper.launches
    got = wrapper(xp, lens, wh, 1.0)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, b, c in zip(got, lstm_grouped.grouped_scan_ref(xp, lens, wh, 1.0),
                       lstm_grouped.scan_grouped(xp, lens, wh, 1.0)):
        torch.testing.assert_close(a, b, **LSTM_TOL)
        torch.testing.assert_close(a, c, **LSTM_TOL)


@pytest.mark.gpu
def test_grouped_wrappers_raise_past_the_largest_cluster_on_card(cuda):
    """Past the largest cluster (H = 400) only the row-tile kernels, which keep
    Wh resident whole, still raise; K7 and K8 read Wh from device memory there
    and match plain."""
    route = lstm_grouped.grouped_route(2, 64, 4, 400)
    assert route.cluster == lstm_fused.MAX_CLUSTER
    assert lstm_grouped.takes_wh_global(2, 64, 4, 400)
    xp, lens, wh = grouped_case(2, 64, 4, 400, seed=27, device=cuda)
    before = _grouped_launches()
    for wrapper in (lstm_grouped.scan_grouped_rowtile, lstm_grouped.scan_stream_rowtile):
        with pytest.raises(ValueError, match="H=400"):
            wrapper(xp, lens, wh, 1.0)
    assert _grouped_launches() == before
    ref = lstm_grouped.grouped_scan_ref(xp, lens, wh, 1.0)
    for wrapper in (lstm_grouped.scan_grouped, lstm_grouped.scan_stream):
        g0 = wrapper.global_launches
        for a, b in zip(wrapper(xp, lens, wh, 1.0), ref):
            torch.testing.assert_close(a, b, **LSTM_TOL)
        assert wrapper.global_launches == g0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", GROUPED_SHAPES)
def test_grouped_route_is_the_mirror_on_card(cuda, g, n, t, h):
    """The libraries' route and shared memory equal the Python mirror's."""
    route = lstm_grouped.grouped_route(g, n, t, h)
    glob = grouped_wh_global(h, *route)
    for stem, stream in (("lstm_grouped", False), ("lstm_stream", True)):
        assert lstm_grouped._route(stem, cuda.index or 0, g, n, t, h) == (route, glob)
        assert (getattr(lstm_grouped._lib(stem), f"{stem}_smem_bytes")(h, *route)
                == lstm_grouped.grouped_smem(h, *route, stream, glob))


@pytest.mark.gpu
@pytest.mark.parametrize("n,t", [(3072, 10), (256, 24), (64, 30), (1024, 2), (1023, 2)])
def test_bilstm_grouped_routes_and_matches_k1_on_card(cuda, n, t):
    x, mask, p_fw, p_bw = lstm_case(n, t, 200, 100, seed=23, device=cuda)
    before = (lstm_grouped.scan_grouped.launches, lstm_grouped.scan_stream.launches)
    with torch.no_grad():
        out, fin = lstm_grouped.bilstm_grouped(p_fw, p_bw, x, mask)
        out_k1, fin_k1 = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
        out_r, fin_r = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
    torch.cuda.synchronize()
    stream = lstm_grouped.uses_stream(n, t)
    assert (lstm_grouped.scan_grouped.launches - before[0],
            lstm_grouped.scan_stream.launches - before[1]) == ((0, 1) if stream else (1, 0))
    for a, b in ((out, out_r), (fin, fin_r), (out, out_k1), (fin, fin_k1)):
        torch.testing.assert_close(a, b, **LSTM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t", [(256, 12), (1024, 3)])
def test_grouped_grads_on_card_match_plain_autograd(cuda, n, t):
    x, mask, p_fw, p_bw, g_out, g_fin = k1b_case(n, t, 200, 100, False, cuda, COTANGENT_SCALE)
    ref = lstm_grads(lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mask),
                     x, p_fw, p_bw, g_out, g_fin)
    got = lstm_grads(lambda pf, pb, xx: lstm_grouped.bilstm_grouped(pf, pb, xx, mask),
                     x, p_fw, p_bw, g_out, g_fin)
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"),
                          got, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)


# ---- card: every width the JAX package takes (the global routes) ----------------
# Each attention and scan kernel past its shared-memory limit reads the operands
# that grow with D (or H) from device memory. The old limits on the H100 (the
# mirrors give them): K4/K5 stage up to D = 572 at J = 30 and 516 at J = 512,
# K6 up to 556 and 380, K2 up to ~812 at S = T = 24, K7/K8 hold Wh up to H =
# 315. Each kernel is held against plain at both sides of its limit and at D =
# 2048 (H = 512 for the scans), the forced global route against the staged one
# bit for bit at D = 200 (H = 100 and 315), and the global routes repeat
# bitwise.

def _smem_max(cuda) -> int:
    props = torch.cuda.get_device_properties(cuda)
    return getattr(props, "shared_memory_per_block_optin", build.SMEM_LIMIT)


def last_staged(geometry, lo: int, hi: int) -> int:
    """The largest D in [lo, hi) whose `geometry(d)` takes the staged route."""
    return max(d for d in range(lo, hi) if not geometry(d).route)


def stats_limits(j: int, sms: int, smem_max: int) -> tuple[int, int]:
    """(K4/K5's, K6's) last staged D at J = j on a card with these limits."""
    k45 = last_staged(lambda d: k45_geometry(1, 1, 100, j, d, sms, smem_max), 100, 2049)
    k6 = last_staged(lambda d: k6_geometry(1, 1, 100, j, d, sms, smem_max), 100, 2049)
    return k45, k6


def _widths_stats_shapes(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shapes = []
    for j, t in ((30, 100), (512, 70)):
        k45, k6 = stats_limits(j, sms, _smem_max(cuda))
        shapes += [(1, 1, t, j, d) for d in (k45, k45 + 1, k6, k6 + 1)]
    return shapes + [(1, 1, 100, 30, 2048)]


def _k456_route_case(args, force_global):
    """K4, K5 (from K4's eq) and K6 (unit cotangents), on the routes the shape
    takes or forced global; returns the outputs and the geometries' routes."""
    h, cm, q, qm, wx, wy, wxy = args
    n, s, t, d = h.shape
    k4, k5, k6 = ((fvta_stats.stats_fwd_global, fvta_stats.qcnt_global,
                   fvta_stats.stats_bwd_global) if force_global else
                  (fvta_stats.stats_fwd, fvta_stats.qcnt, fvta_stats.stats_bwd))
    rng = np.random.default_rng(61)
    de, geq, gv = (torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(h.device)
                   for sh in ((n, s, t), tuple(qm.shape), (n, s, d)))
    with torch.no_grad():
        st = k4(*args)
        cnt = k5(h, cm, q, wx, wy, wxy, st[3])
        dk = k6(*args, de, geq, st[3], cnt, st[4], st[0], gv)
        torch.cuda.synchronize()
    shape = (n, s, t, q.shape[1], d)
    routes = (fvta_stats.run_geometry(*shape, force_global)["route"],
              fvta_stats.bwd_geometry(*shape, force_global)["route"])
    return st, cnt, dk, routes, (de, geq, gv)


@pytest.mark.gpu
def test_stats_kernels_match_plain_at_both_sides_of_each_limit_on_card(cuda):
    """K4, K5 and K6 at the last staged D and the first global D of each (J =
    30 and 512), and at D = 2048: the route the geometry reports, the fields
    against plain (float64 witness for K4's long sums), the counts exactly."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in _widths_stats_shapes(cuda):
        args = _k45_args(shape, 60, cuda, True)
        st, cnt, dk, routes, (de, geq, gv) = _k456_route_case(args, False)
        want = (k45_geometry(*shape, sms, _smem_max(cuda)).route,
                k6_geometry(*shape, sms, _smem_max(cuda)).route)
        assert routes == tuple(fvta_stats.ROUTES[r] for r in want), shape
        h, cm, q, qm, wx, wy, wxy = args
        with torch.no_grad():
            ref = fvta_stats.stats_fwd_ref(*args)
            cnt_r = fvta_stats.qcnt_ref(h, cm, q, wx, wy, wxy, ref[3])
            exact = fvta_stats.stats_fwd_ref(*(a.double() for a in args))
            dr = fvta_stats.stats_bwd_ref(*args, de, geq, ref[3], cnt_r, ref[4], ref[0], gv)
        _assert_stats_close(st, ref, exact)
        assert torch.equal(cnt, cnt_r) and (cnt >= 1).all(), shape
        exact6 = _k6_f64((*args, de, geq, ref[3], cnt_r, ref[4], ref[0], gv))
        _assert_k6_close(dk, dr, exact6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1, 4096, 30, 200), (2, 3, 33, 40, 16),
                                   (1, 2, 300, 512, 200)])
def test_stats_global_route_equals_the_staged_route_bitwise_on_card(cuda, shape):
    """At widths that stage, the forced global route gives K4's fields, K5's
    counts and K6's outputs bit for bit; K6 fed either route's K4/K5 agrees
    bitwise; two launches of the global route are bitwise equal."""
    args = _k45_args(shape, 62, cuda, True)
    st_s, cnt_s, dk_s, routes_s, cot = _k456_route_case(args, False)
    st_g, cnt_g, dk_g, routes_g, _ = _k456_route_case(args, True)
    assert routes_s == ("staged", "staged") and routes_g == ("global", "global")
    for field, a, b in zip(("m", "den", "v", "eq", "e"), st_s, st_g):
        assert torch.equal(a, b), field
    assert torch.equal(cnt_s, cnt_g)
    for field, a, b in zip(K6_FIELDS, dk_s, dk_g):
        assert torch.equal(a, b), field
    with torch.no_grad():
        again = fvta_stats.stats_fwd_global(*args)
        k6_on_global = fvta_stats.stats_bwd(*args, cot[0], cot[1], st_g[3], cnt_g, st_g[4],
                                            st_g[0], cot[2])
        torch.cuda.synchronize()
    for a, b in zip(again, st_g):
        assert torch.equal(a, b)
    for a, b in zip(k6_on_global, dk_s):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_k6_geq_only_where_k45_stage_and_k6_does_not_on_card(cuda):
    """J = 30, D = 560: K4 and K5 stage, K6 takes the global route, and the ties
    K6 finds by exact equality are K4's (every share of geq reaches dq)."""
    shape = (2, 1, 1024, 30, 560)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert k45_geometry(*shape, sms, _smem_max(cuda)).route == 0
    assert k6_geometry(*shape, sms, _smem_max(cuda)).route == 1
    args, args_r = _k6_args(shape, 63, cuda, geq_only=True)
    with torch.no_grad():
        got = fvta_stats.stats_bwd(*args)
        ref = fvta_stats.stats_bwd_ref(*args_r)
        torch.cuda.synchronize()
    assert float(ref[1].abs().max()) > 1e-3
    _assert_k6_close(got, ref)


def k2_limit(n, s, t, j, sms, smem_max) -> int:
    """K2's last staged D at (N, S, T, J) on a card with these limits (the plan
    at the largest cluster cap)."""
    return last_staged(lambda d: k2_plan(n, s, t, j, d, sms, smem_max, K2_MAX_CLUSTER),
                       200, 2049)


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,t,j", [(2, 24, 24, 30), (2, 1, 512, 30), (2, 8, 64, 512)])
def test_k2_matches_plain_at_both_sides_of_its_limit_on_card(cuda, n, s, t, j):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    d_last = k2_limit(n, s, t, j, sms, _smem_max(cuda))
    for d, route in ((d_last, "staged"), (d_last + 1, "global"), (2048, "global")):
        h, cm, q, qm, p = fvta_case(n, s, t, j, d, seed=64, device=cuda, dead=True)
        args = k2_args_of(h, cm, q, qm, p)
        assert fvta_fused.geometry(n, s, t, j, d)["route"] == route, d
        before = fvta_fused.fvta_fwd.global_launches
        with torch.no_grad():
            out = fvta_fused.fvta_fwd(*args)
            ref = fvta_ref.fvta_attention(h, cm, q, qm, fvta_ref.similarity_tensor(
                h, q, "trilinear", {k: 0.1 * v for k, v in p.items()}))
            torch.cuda.synchronize()
        assert fvta_fused.fvta_fwd.global_launches == before + (route == "global")
        for x, y, field in zip(out, ref, FIELDS):
            assert torch.isfinite(x).all(), (d, field)
            torch.testing.assert_close(x, y, **FVTA_TOL, msg=f"D={d} {field}")


def k2_args_of(h, cm, q, qm, p):
    """K2's arguments from fvta_case's outputs, weights at the models' 0.1 scale."""
    return (h, cm.float(), q, qm.float(), *(0.1 * p[k] for k in ("w_x", "w_y", "w_xy")))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 24, 24, 30, 200), (8, 24, 24, 30, 200),
                                   (2, 1, 1024, 30, 200), (3, 1, 7, 40, 16)])
def test_k2_global_route_matches_plain_and_repeats_on_card(cuda, shape):
    """K2 forced to the global route at widths that stage: plain's function,
    the staged route's within tolerance, two launches bitwise equal."""
    h, cm, q, qm, p = fvta_case(*shape, seed=65, device=cuda, dead=True)
    args = k2_args_of(h, cm, q, qm, p)
    with torch.no_grad():
        a = fvta_fused.fvta_fwd_global(*args)
        b = fvta_fused.fvta_fwd_global(*args)
        staged = fvta_fused.fvta_fwd(*args)
        torch.cuda.synchronize()
    assert fvta_fused.geometry(*shape, True)["route"] == "global"
    for x, y, z, field in zip(a, b, staged, FIELDS):
        assert torch.equal(x, y), field
        torch.testing.assert_close(x, z, **FVTA_TOL, msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", [(2, 64, 6, 315), (2, 64, 6, 316), (2, 40, 5, 512),
                                     (1, 17, 3, 1024), (2, 3072, 3, 400)])
def test_grouped_kernels_match_plain_past_the_largest_cluster_on_card(cuda, g, n, t, h):
    """K7 and K8 at H = 315 (the last width whose Wh a cluster holds), 316 (Wh
    global), 512 and 1024: plain's function, K7 == K8 bitwise, repeats
    bitwise, the global launches counted."""
    xp, lens, wh = grouped_case(g, n, t, h, seed=66, device=cuda)
    glob = lstm_grouped.takes_wh_global(g, n, t, h)
    assert glob == grouped_wh_global(h, *lstm_grouped.grouped_route(g, n, t, h)) == (h > 315)
    ref = lstm_grouped.grouped_scan_ref(xp, lens, wh, 1.0)
    outs = []
    for wrapper in (lstm_grouped.scan_grouped, lstm_grouped.scan_stream):
        g0 = wrapper.global_launches
        outs.append(wrapper(xp, lens, wh, 1.0))
        again = wrapper(xp, lens, wh, 1.0)
        torch.cuda.synchronize()
        assert wrapper.global_launches == g0 + 2 * glob
        for a, b, c in zip(outs[-1], ref, again):
            torch.testing.assert_close(a, b, **LSTM_TOL)
            assert torch.equal(a, c)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,t,h", [(2, 256, 12, 100), (2, 3072, 4, 100), (2, 64, 30, 100),
                                     (2, 64, 6, 315)])
def test_grouped_wh_global_equals_the_resident_route_bitwise_on_card(cuda, g, n, t, h):
    """At the resident route's (cluster, rows, split), K7 and K8 reading Wh
    from device memory give the resident kernels' bits."""
    xp, lens, wh = grouped_case(g, n, t, h, seed=67, device=cuda)
    route = lstm_grouped.grouped_route(g, n, t, h)
    assert not lstm_grouped.takes_wh_global(g, n, t, h)
    for resident, forced in ((lstm_grouped.scan_grouped, lstm_grouped.scan_grouped_wh_global),
                             (lstm_grouped.scan_stream, lstm_grouped.scan_stream_wh_global)):
        before = forced.launches
        for a, b in zip(resident(xp, lens, wh, 1.0), forced(xp, lens, wh, 1.0, route)):
            assert torch.equal(a, b)
        assert forced.launches == before + 1
