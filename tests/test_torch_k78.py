"""K7's and K8's Hopper design on the CPU (csrc/lstm_gscan.cuh, shared by
csrc/lstm_grouped.cu and csrc/lstm_stream.cu).

- The route: `lstm_grouped.grouped_route` (the Python mirror) against the
  header's own `gscan::route` and `gscan::smem_bytes`, compiled for the host
  with g++ from the header's text; the (rows, lanes) pairs the two sources
  instantiate; at G = 2 the route is lstm_fused.lstm_route's at every width
  the repo uses.
- The sum order: `gscan_emulated` restates the kernels' arithmetic — S lanes
  each walking every S-th term of a unit's h.Wh in one FMA chain, reduce_rows'
  fixed tree over the lanes, gates = x_proj + the sum, the TF1 cell — and is
  held against the JAX package's grouped and streaming Pallas scans
  (`_pallas_scan`, `_pallas_scan_stream`, interpret mode on the CPU) and,
  swapped in for the kernels, against `bilstm_pallas` / `lstm_scan_pallas` on
  tests/test_lstm_pallas.py's cases, at rtol 1e-5 / atol 1e-6. Inputs come
  from a seed with numpy; the cases cover rows of length 0 and T, N not a
  multiple of the tile, G = 1, 2 and 3, T = 1 and 2, and H = 5, 64 and 100.

The kernels themselves are held against the plain scan, each other and K1 on
the card in tests/test_torch_kernels.py.
"""

import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops.lstm_pallas import (_pallas_scan, _pallas_scan_stream, bilstm_pallas,
                                              lstm_scan_pallas)

from fvta_memexqa_torch.ops import build, lstm_fused, lstm_grouped
from test_torch_grouped import make_case, torch_params
from test_torch_kernels import ROUTES, grouped_wh_global

TOL = dict(rtol=1e-5, atol=1e-6)


# ---- the route against the CUDA header ----------------------------------------

ROUTE_MAIN = r'''
#include <cstdio>
int main() {
  const int gs[] = {1, 2, 3, 8};
  const int ns[] = {1, 8, 9, 64, 65, 256, 264, 265, 1023, 1024, 1056, 1057, 2048, 3072};
  for (int g : gs)
    for (int n : ns)
      for (int h = 1; h <= 330; h += h < 40 ? 1 : 3) {
        const gscan::Route r = gscan::route(g, n, h);
        const size_t k7 = r.split ? gscan::smem_bytes(h, r.cluster, r.rows, r.split, false) : 0;
        const size_t k8 = r.split ? gscan::smem_bytes(h, r.cluster, r.rows, r.split, true) : 0;
        std::printf("%d %d %d %d %d %d %zu %zu\n", g, n, h, r.cluster, r.rows, r.split, k7, k8);
      }
  return 0;
}
'''


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_grouped_route_matches_the_cuda_header(tmp_path):
    """grouped_route and grouped_smem against lstm_gscan.cuh's route and
    smem_bytes over lstm_rec.cuh's fwd_geometry, both compiled for the host from
    the headers' text (the device code around them needs nvcc)."""
    rec = (build.CSRC_DIR / "lstm_rec.cuh").read_text()
    rec = rec[rec.index("__host__ __device__ inline bool conflict_free"):
              rec.index("inline cudaError_t active_clusters")]
    gsc = (build.CSRC_DIR / "lstm_gscan.cuh").read_text()
    gsc = gsc[gsc.index("// ---- the route (host-compilable) ----"):
              gsc.index("// ---- end of the route ----")]
    prog = tmp_path / "route.cc"
    prog.write_text("#include <cstddef>\n#define __host__\n#define __device__\n"
                    "namespace lrec {\n" + rec + "}\nnamespace gscan {\n" + gsc + "}\n"
                    + ROUTE_MAIN)
    exe = tmp_path / "route"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.split("\n")
    rows = [tuple(map(int, line.split())) for line in lines if line]
    assert len(rows) == 4 * 14 * (39 + 97)
    routed = 0
    for g, n, h, c, r, s, k7, k8 in rows:
        route = lstm_grouped.grouped_route(g, n, 4, h)
        if s == 0:
            assert route is None, (g, n, h)
            continue
        routed += 1
        assert route == (c, r, s), (g, n, h)
        glob = grouped_wh_global(h, c, r, s)
        assert (lstm_grouped.grouped_smem(h, c, r, s, False, glob),
                lstm_grouped.grouped_smem(h, c, r, s, True, glob)) == (k7, k8), (g, n, h)
        assert k7 < k8 <= build.SMEM_LIMIT
    assert routed > len(rows) // 2


@pytest.mark.parametrize("source,macro", [("lstm_grouped.cu", "LSTM_GROUPED_CASE"),
                                          ("lstm_stream.cu", "LSTM_STREAM_CASE")])
def test_instantiated_pairs_are_the_route_splits(source, macro):
    """Every (rows, lanes) pair the route can pick is instantiated in each
    source (with Wh resident and with Wh global), and the kernel's thread limits
    are the route's: per tile height with Wh resident, 1024 with Wh global."""
    text = (build.CSRC_DIR / source).read_text()
    pairs = {(int(r), int(s)) for r, s in re.findall(rf"^\s*{macro}\((\d+), (\d+)\)", text, re.M)}
    assert pairs == {(r, s) for r, splits in lstm_fused._SPLITS.items() for s in splits}
    assert re.search(r"return global \? gscan::launch<R, S_, \w+, true>", text)
    header = (build.CSRC_DIR / "lstm_gscan.cuh").read_text()
    bounds = re.findall(r"__launch_bounds__\(WH_GLOBAL \? MAX_THREADS_WH_GLOBAL : "
                        r"\(ROWS == 16 \? (\d+) : (\d+)\)\)", header)
    assert len(bounds) == 1
    assert {16: int(bounds[0][0]), 8: int(bounds[0][1])} == lstm_fused._MAX_THREADS
    wh_global = re.findall(r"constexpr int MAX_THREADS_WH_GLOBAL = (\d+);", header)
    assert [int(v) for v in wh_global] == [lstm_grouped.MAX_THREADS_WH_GLOBAL]


@pytest.mark.parametrize("shape", [s for s, (kernels, *_) in ROUTES
                                   if kernels == lstm_fused.REC_KERNELS and s[3] <= 100],
                         ids=lambda s: "x".join(map(str, s)))
def test_route_at_two_groups_is_k1s_route(shape):
    """At G = 2 the grouped route is lstm_route's (cluster, rows, split) at the
    repo's shapes: K7 and K8 fed K1's projection then give K1's bits."""
    n, t, d, h = shape
    route = lstm_fused.lstm_route(n, t, d, h)
    assert lstm_grouped.grouped_route(2, n, t, h) == (route.cluster, route.rows, route.split)


def test_route_at_two_groups_is_k1s_at_every_width_up_to_100_and_reaches_past_it():
    """Up to H = 100 (every width the repo uses) and at the card tests' 128
    and 200 the G = 2 route is K1's for every row count. Past 100 the two
    rules size different kernels, and they part only where one's choice does
    not fit the other's: K1's leaves no room for K8's ring, or the grouped
    route's does not hold K1b (lstm_route sizes K1's backward too). Every
    width K1's Hopper route takes, K7 and K8 take too."""
    ns = (1, 8, 9, 64, 65, 256, 264, 265, 1023, 1024, 1056, 1057, 3072)
    for h in [*range(1, 101), 128, 200]:
        for n in ns:
            k1 = lstm_fused.lstm_route(n, 4, 200, h)
            assert lstm_grouped.grouped_route(2, n, 4, h) == (k1.cluster, k1.rows, k1.split)
    k1_widths = [h for h in range(4, 400, 4)
                 if lstm_fused.lstm_route(8, 4, 200, h).kernels == lstm_fused.REC_KERNELS]
    ours = [h for h in range(4, 400, 4) if lstm_grouped.grouped_route(2, 8, 4, h) is not None]
    assert set(k1_widths) <= set(ours) and max(ours) > 110
    for h in range(101, 400):
        for n in ns:
            ours, k1 = lstm_grouped.grouped_route(2, n, 4, h), lstm_fused.lstm_route(n, 4, 200, h)
            if ours is None or k1.kernels != lstm_fused.REC_KERNELS:
                continue
            if ours != (k1.cluster, k1.rows, k1.split):
                assert (lstm_grouped._split(h, k1.cluster, k1.rows) != k1.split
                        or lstm_fused._split(h, ours.cluster, ours.rows) != ours.split), (n, h)


# ---- the sum order against the JAX package -------------------------------------

def gscan_emulated(x_proj, lengths, wh, forget_bias, split=None):
    """K7's and K8's arithmetic in float32 on the CPU: lane s of a unit's S
    lanes sums the terms k = s, s + S, ... of h.Wh in one chain of FMAs (each
    FMA rounded once, through float64), reduce_rows adds the lanes pairwise in
    a fixed tree (the upper half of the lanes onto the lower, halving), then
    gates = x_proj + the sum and the TF1 cell with prefix-length masking. S is
    the route's unless given."""
    if not torch.is_tensor(wh):
        wh = torch.stack(list(wh))
    g, n, t, g4 = x_proj.shape
    h = g4 // 4
    if split is None:
        split = lstm_grouped.grouped_route(g, n, t, h).split
    hs = x_proj.new_zeros(g, n, h)
    cs = x_proj.new_zeros(g, n, h)
    out = x_proj.new_zeros(g, n, t, h)
    for step in range(t):
        part = x_proj.new_zeros(split, g, n, g4)
        for k0 in range(0, h, split):
            ks = torch.arange(k0, min(k0 + split, h))
            prod = (hs[:, :, ks].permute(2, 0, 1)[..., None].double()
                    * wh[:, ks].permute(1, 0, 2)[:, :, None, :].double())
            part[:len(ks)] = (prod + part[:len(ks)].double()).float()
        while part.shape[0] > 1:
            half = part.shape[0] // 2
            part = part[:half] + part[half:]
        gates = x_proj[:, :, step] + part[0]
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        nc = cs * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        nh = torch.tanh(nc) * torch.sigmoid(o)
        live = (step < lengths)[..., None]
        hs = torch.where(live, nh, hs)
        cs = torch.where(live, nc, cs)
        out[:, :, step] = torch.where(live, nh, 0.0)
    return out, hs


# (g, n, t, h): G = 1, 2, 3; T = 1 and 2 and longer; H = 5, 64, 100; N below,
# at and past the 8- and 16-row tiles
SCAN_CASES = [(1, 5, 1, 5), (2, 9, 2, 64), (3, 17, 6, 5), (2, 12, 7, 100), (1, 8, 2, 100),
              (3, 3, 4, 64), (2, 33, 5, 100)]


def scan_case(g, n, t, h, seed):
    """numpy x_proj [G, N, T, 4H] at x.Wx + b's scale, lengths [G, N] with a
    full and an empty row in every group, wh [G, H, 4H]."""
    rng = np.random.default_rng(seed)
    xp = rng.normal(0, 1, (g, n, t, 4 * h)).astype(np.float32)
    lens = rng.integers(0, t + 1, (g, n)).astype(np.int32)
    lens[:, 0], lens[:, min(1, n - 1)] = t, 0
    lim = np.sqrt(6.0 / (5 * h))
    wh = rng.uniform(-lim, lim, (g, h, 4 * h)).astype(np.float32)
    return xp, lens, wh


@pytest.mark.parametrize("split", [None, 4, 16])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "g{}n{}t{}h{}".format(*c))
def test_emulated_sum_order_matches_the_pallas_scans(case, stream, split):
    """The emulated kernels (the route's lane split, and 4 and 16 lanes) against
    the JAX package's grouped scan (stream=False) and its streaming scan, both
    in interpret mode, time-major as the JAX package lays them out."""
    g, n, t, h = case
    xp, lens, wh = scan_case(*case, seed=70 + sum(case))
    out, fin = gscan_emulated(torch.from_numpy(xp), torch.from_numpy(lens), torch.from_numpy(wh),
                              1.0, split)
    scan = _pallas_scan_stream if stream else _pallas_scan
    out_j, fin_j = scan(jnp.asarray(np.swapaxes(xp, 1, 2)), jnp.asarray(lens[..., None]),
                        jnp.asarray(wh), 1.0, n, True)
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(out_j), 1, 2), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fin_j), **TOL)
    assert not out.numpy()[np.arange(t)[None, None, :] >= lens[..., None]].any()
    assert not fin.numpy()[lens == 0].any()


@pytest.fixture
def emulated_kernels(monkeypatch):
    """gscan_emulated as both card kernels, counting its launches per route."""
    launches = {"k7": 0, "k8": 0}

    def kernel(name):
        def run(x_proj, lengths, wh, forget_bias):
            launches[name] += 1
            return gscan_emulated(x_proj, lengths, wh, forget_bias)
        return run

    monkeypatch.setattr(lstm_grouped, "_kernels", lambda device: (kernel("k7"), kernel("k8")))
    return launches


# tests/test_lstm_pallas.py's cases: (n, t, d, h, seed, ragged, bidirectional,
# block_b), plus a call at n = 1024, t = 2, which both packages send to their
# streaming kernel
PALLAS_CASES = [(5, 7, 6, 4, 0, True, False, 256), (5, 7, 6, 4, 1, True, False, 256),
                (5, 7, 6, 4, 2, True, False, 256), (6, 9, 6, 4, 3, True, True, 256),
                (5, 7, 6, 4, 4, True, False, 4), (1024, 2, 4, 4, 8, True, False, 256)]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "n{}t{}s{}{}".format(
    c[0], c[1], c[4], "bi" if c[6] else ""))
def test_emulated_kernels_in_the_api_match_lstm_pallas(emulated_kernels, case):
    n, t, d, h, seed, ragged, bi, block_b = case
    x, mask, p_fw, p_bw = make_case(n=n, t=t, d=d, h=h, seed=seed, ragged=ragged)
    tf, tb = torch_params(p_fw, p_bw)
    if bi:
        ref = bilstm_pallas(p_fw, p_bw, jnp.asarray(x), jnp.asarray(mask), 1.0, block_b)
        got = lstm_grouped.bilstm_grouped(tf, tb, torch.from_numpy(x), torch.from_numpy(mask))
    else:
        ref = lstm_scan_pallas(p_fw, jnp.asarray(x), jnp.asarray(mask, jnp.float32), 1.0, block_b)
        got = lstm_grouped.lstm_scan_grouped(tf, torch.from_numpy(x),
                                             torch.from_numpy(mask).float(), 1.0, block_b)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    stream = lstm_grouped.uses_stream(n, t)
    assert emulated_kernels == {"k7": int(not stream), "k8": int(stream)}


def test_emulated_kernels_match_lstm_pallas_on_empty_and_single_step_rows(emulated_kernels):
    """tests/test_lstm_pallas.py's empty and single-step rows, bidirectional."""
    x, _, p_fw, p_bw = make_case(n=3, t=4, seed=6, ragged=False)
    mask = np.asarray([[True, False, False, False], [True, True, True, True],
                       [False, False, False, False]])
    ref = bilstm_pallas(p_fw, p_bw, jnp.asarray(x), jnp.asarray(mask))
    got = lstm_grouped.bilstm_grouped(*torch_params(p_fw, p_bw), torch.from_numpy(x),
                                      torch.from_numpy(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert not got[0][2].any() and not got[1][2].any()
