"""Every width the JAX package takes, on the CPU: the geometries of the port's
attention and scan kernels (csrc/fvta_corr.cuh run_geometry for K4 and K5,
csrc/fvta_bwd.cu fused_geometry for K6, csrc/fvta_fwd.cuh k2::plan for K2,
csrc/lstm_gscan.cuh gscan::route for K7 and K8), compiled for the host with g++
from the sources' own text, over J in {1, 30, 32, 33, 512}, D from 1 to 2048
and H from 1 to 1024:

- each returns a route whose shared memory fits the H100's 232448 B: the
  staged one wherever it fit before, else the global one (h and q, or Wh, read
  from device memory);
- where the rule before the global routes found a staging, the plan is that
  staging, field for field (a copy of the old rule, restated here);
- the Python mirrors the wrappers' tests use (tests/test_torch_kernels.py
  k45_geometry, k6_geometry, k2_plan, grouped_wh_global;
  ops/lstm_grouped.grouped_route and grouped_smem) agree with the headers at
  every point.

The kernels themselves are held against their plain versions, and the routes
against each other bit for bit, on the card (tests/test_torch_kernels.py,
`-m gpu`)."""

import functools
import shutil
import subprocess

import pytest

from fvta_memexqa_torch.ops import build, lstm_fused, lstm_grouped
from test_torch_kernels import (K2_MAX_CLUSTER, K2_RESIDENT_ROWS, K2_STREAM_ROWS, K2_SUB,
                                RUN_STAGING, K2Plan, _cdiv, grouped_wh_global, k2_plan, k2_smem,
                                k45_geometry, k6_geometry, k6_smem, run_smem)

LIMIT = build.SMEM_LIMIT
SMS = 132
JS = (1, 30, 32, 33, 512)
DS = range(1, 2049)
HS = range(1, 1025)
K2_SHAPES = ((1, 24, 24), (64, 24, 24), (2, 1, 512), (2, 8, 64), (128, 24, 24))
GSCAN_SHAPES = ((2, 8), (2, 256), (2, 3072), (1, 17), (3, 1024))

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")


def _run(tmp_path, name: str, source: str) -> list[tuple[int, ...]]:
    prog = tmp_path / f"{name}.cc"
    prog.write_text(source)
    exe = tmp_path / name
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    return [tuple(map(int, line.split())) for line in out.split("\n") if line]


def _between(path, start: str, end: str) -> str:
    text = (build.CSRC_DIR / path).read_text()
    return text[text.index(start):text.index(end)]


STATS_MAIN = r'''
#include <cstdio>
int main() {
  const int js[] = {1, 30, 32, 33, 512};
  for (int j : js)
    for (int d = 1; d <= 2048; ++d) {
      const fvta::RunGeometry r = fvta::run_geometry(1, 1, 100, j, d, 132, 232448);
      const fvta::FusedGeometry f = fvta::fused_geometry(1, 1, 100, j, d, 132, 232448);
      std::printf("%d %d %d %d %d %d %zu %zu %d %d %d %d %d %zu %zu %d\n", j, d, r.per, r.cpc,
                  r.rows, r.nbuf, r.smem, r.scratch, r.route, f.per, f.cpc, f.nbuf,
                  f.acc_smem ? 1 : 0, f.smem, f.scratch, f.route);
    }
  return 0;
}
'''


@functools.cache
def old_run_geometry(j, d):
    """run_geometry before the global route: the first staging that fits, or
    None where none does."""
    for rows, nbuf in RUN_STAGING:
        if run_smem(j, d, rows, nbuf) <= LIMIT:
            return rows, nbuf, run_smem(j, d, rows, nbuf)
    return None


def old_fused_geometry(j, d):
    """fused_geometry before the global route: (nbuf, acc_smem, smem), or None."""
    jp = _cdiv(j, 32) * 32
    for nbuf in (2, 1):
        acc = jp == 32 and k6_smem(j, d, nbuf, True) <= LIMIT
        if k6_smem(j, d, nbuf, acc) <= LIMIT:
            return nbuf, acc, k6_smem(j, d, nbuf, acc)
    return None


@needs_gxx
def test_stats_geometries_always_fit_and_keep_the_staged_plans(tmp_path):
    """K4/K5's run_geometry and K6's fused_geometry at every (J, D): within the
    limit; staged (the old plan, field for field) wherever the old rule found
    a staging, global past it; the mirrors equal the headers."""
    src = (f'#include "{build.CSRC_DIR / "fvta_corr.cuh"}"\n#define __host__\n'
           "#define __device__\nnamespace fvta {\n"
           + _between("fvta_bwd.cu", "constexpr int RB = 8;",
                      "// G: the global route (fused_geometry route 1)")
           + "}\n" + STATS_MAIN)
    rows = _run(tmp_path, "stats", src)
    assert len(rows) == len(JS) * len(DS)
    first_global = {}
    for j, d, *got in rows:
        run, fused = tuple(got[:7]), tuple(got[7:])
        assert run[4] <= LIMIT and fused[4] <= LIMIT, (j, d)
        assert run == tuple(k45_geometry(1, 1, 100, j, d, SMS, LIMIT)), (j, d)
        mirror = k6_geometry(1, 1, 100, j, d, SMS, LIMIT)
        assert fused == (*mirror[:3], int(mirror.acc_smem), *mirror[4:]), (j, d)
        old = old_run_geometry(j, d)
        assert run[6] == (old is None), (j, d)
        if old is not None:
            assert (run[2], run[3], run[4]) == old, (j, d)
        old6 = old_fused_geometry(j, d)
        assert fused[6] == (old6 is None), (j, d)
        if old6 is not None:
            assert (fused[2], bool(fused[3]), fused[4]) == old6, (j, d)
        for k, route in (("k45", run[6]), ("k6", fused[6])):
            if route:
                first_global.setdefault((k, j), d)
            else:
                assert (k, j) not in first_global, "staged again past a global width"
    # the limits of the staged routes on the H100
    assert first_global[("k45", 30)] == 573 and first_global[("k45", 512)] == 517
    assert first_global[("k6", 30)] == 557 and first_global[("k6", 512)] == 381


K2_MAIN = r'''
#include <cstdio>
int main() {
  const int shapes[][3] = {{1, 24, 24}, {64, 24, 24}, {2, 1, 512}, {2, 8, 64}, {128, 24, 24}};
  const int js[] = {1, 30, 32, 33, 512};
  for (const auto& a : shapes)
    for (int j : js)
      for (int d = 1; d <= 2048; d += d < 600 ? 7 : 1) {
        const k2::Plan p = k2::plan(a[0], a[1], a[2], j, d, 132, 232448, 16);
        std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %zu %d %zu\n", a[0], a[1], a[2], j, d,
                    p.cluster, p.chunks, p.chunk_len, p.segs, p.rows, p.bufs, p.qtile, p.smem,
                    p.route, k2::v_scratch(p, a[0], d));
      }
  return 0;
}
'''


def old_k2_plan(n, s, t, j, d):
    """k2::plan before the global route, at the largest cluster cap: the first
    staging that fits (as a K2Plan without route), or None where none does."""
    c = 1
    while c < K2_MAX_CLUSTER and n * c < SMS:
        c *= 2
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
        for qtile in (0, 1):
            for bufs, rows in (natural, (2, K2_STREAM_ROWS), (1, K2_SUB)):
                smem = k2_smem(j, d, cluster, segs, rows, bufs, qtile)
                if smem <= LIMIT:
                    return K2Plan(cluster, chunks, chunk_len, segs, rows, bufs, qtile, smem)
        if c >= K2_MAX_CLUSTER:
            return None
        c *= 2


@needs_gxx
def test_k2_plans_always_fit_and_keep_the_staged_plans(tmp_path):
    """k2::plan at every (shape, J, D) sampled: within the limit; the old plan
    wherever the old rule found a staging, the global route past it (its V
    scratch = N * cluster * segs * D); the mirror equals the header."""
    rows = _run(tmp_path, "k2",
                f'#include "{build.CSRC_DIR / "fvta_fwd.cuh"}"\n' + K2_MAIN)
    ds = [1]
    while ds[-1] + (7 if ds[-1] < 600 else 1) <= 2048:
        ds.append(ds[-1] + (7 if ds[-1] < 600 else 1))
    assert len(rows) == len(K2_SHAPES) * len(JS) * len(ds)
    limits = {}
    for n, s, t, j, d, *got in rows:
        plan, scratch = tuple(got[:9]), got[9]
        assert plan[7] <= LIMIT, (n, s, t, j, d)
        assert plan == tuple(k2_plan(n, s, t, j, d, SMS, LIMIT, K2_MAX_CLUSTER)), (n, s, t, j, d)
        old = old_k2_plan(n, s, t, j, d)
        assert plan[8] == (old is None), (n, s, t, j, d)
        if old is None:
            assert scratch == n * plan[0] * plan[3] * d
            limits.setdefault((n, s, t, j), d)
        else:
            assert plan[:8] == tuple(old)[:8] and scratch == 0, (n, s, t, j, d)
            assert (n, s, t, j) not in limits, "staged again past a global width"
    # the first global D at each shape
    assert limits[(1, 24, 24, 30)] == 813 and limits[(2, 1, 512, 30)] == 829
    assert limits[(2, 8, 64, 512)] == 741


GSCAN_MAIN = r'''
#include <cstdio>
int main() {
  const int shapes[][2] = {{2, 8}, {2, 256}, {2, 3072}, {1, 17}, {3, 1024}};
  for (const auto& a : shapes)
    for (int h = 1; h <= 1024; ++h) {
      const gscan::Route r = gscan::route(a[0], a[1], h);
      const bool g = r.split && gscan::wh_global(h, r.cluster, r.rows, r.split);
      const int threads = r.split ? lrec::fwd_geometry(h, r.cluster, r.rows, r.split).threads : 0;
      const size_t k7 = r.split ? gscan::smem_bytes(h, r.cluster, r.rows, r.split, false) : 0;
      const size_t k8 = r.split ? gscan::smem_bytes(h, r.cluster, r.rows, r.split, true) : 0;
      std::printf("%d %d %d %d %d %d %d %d %zu %zu\n", a[0], a[1], h, r.cluster, r.rows, r.split,
                  g ? 1 : 0, threads, k7, k8);
    }
  return 0;
}
'''


def old_split(h, c, rows):
    """gscan::pick_split before Wh global: the most lanes per unit within the
    resident kernels' thread limit whose K8 (the 128 B header, lstm_rec's
    forward geometry, the two-slot ring) fits; None if none does."""
    for split in lstm_fused._SPLITS[rows]:
        threads, fwd, _ = lstm_fused.rec_geometry(h, c, rows, split)
        ring = 4 * 2 * 4 * rows * (_cdiv(_cdiv(h, c), 4) * 4)
        if threads <= lstm_fused._MAX_THREADS[rows] and 128 + fwd + ring <= LIMIT:
            return split
    return None


def old_grouped_route(g, n, h):
    """gscan::route before Wh global: (cluster, rows, split), or None past the
    largest cluster that holds the Wh slices."""
    fit = next((c for c in (1, 2, 4, 8) if old_split(h, c, 8)), None)
    if fit is None:
        return None
    blocks = g * _cdiv(n, 8)
    if blocks > 2 * SMS:
        if fit == 1 and g * _cdiv(n, 16) >= SMS and old_split(h, 1, 16):
            return 1, 16, old_split(h, 1, 16)
        return fit, 8, old_split(h, fit, 8)
    c = fit
    while (2 * c <= 8 and (c < 2 or blocks * 2 * c <= SMS) and _cdiv(h, 2 * c) >= 8
           and old_split(h, 2 * c, 8)):
        c *= 2
    return c, 8, old_split(h, c, 8)


@needs_gxx
def test_grouped_route_always_fits_and_keeps_the_resident_routes(tmp_path):
    """gscan::route at every H up to 1024: a route whose K8 fits, within 1024
    threads (the resident kernels' own limits where Wh is resident); Wh
    resident and unchanged up to H = 315, Wh global from 316 on at clusters of
    8 with 4 lanes per unit; the mirror equals the header."""
    rec = _between("lstm_rec.cuh", "__host__ __device__ inline bool conflict_free",
                   "inline cudaError_t active_clusters")
    gsc = _between("lstm_gscan.cuh", "// ---- the route (host-compilable) ----",
                   "// ---- end of the route ----")
    rows = _run(tmp_path, "gscan",
                "#include <cstddef>\n#define __host__\n#define __device__\nnamespace lrec {\n"
                + rec + "}\nnamespace gscan {\n" + gsc + "}\n" + GSCAN_MAIN)
    assert len(rows) == len(GSCAN_SHAPES) * len(HS)
    for g, n, h, c, r, s, wh_global, threads, k7, k8 in rows:
        route = lstm_grouped.grouped_route(g, n, 4, h)
        assert route == (c, r, s) and s > 0, (g, n, h)
        assert grouped_wh_global(h, *route) == bool(wh_global) == (h > 315), (g, n, h)
        assert (lstm_grouped.grouped_smem(h, *route, False, wh_global),
                lstm_grouped.grouped_smem(h, *route, True, wh_global)) == (k7, k8)
        assert k7 < k8 <= LIMIT
        assert threads <= (lstm_grouped.MAX_THREADS_WH_GLOBAL if wh_global
                           else lstm_fused._MAX_THREADS[r])
        old = old_grouped_route(g, n, h)
        assert (old is None) == bool(wh_global), (g, n, h)
        if wh_global:
            assert (c, r, s) == (lstm_fused.MAX_CLUSTER, 8, 4)
        else:
            assert (c, r, s) == old, (g, n, h)


@pytest.mark.parametrize("j", JS)
def test_mirrors_take_every_width_within_the_limit(j):
    """The Python mirrors alone, at the video path's and the probe's shapes:
    no width up to 2048 (J = 1 to 512) leaves a kernel without a route that
    fits, and the forced global routes fit too."""
    for d in (1, 199, 200, 201, 556, 557, 572, 573, 812, 813, 1024, 2047, 2048):
        for n, s, t in ((16, 1, 1024), (8, 8, 16384), (64, 24, 24)):
            for force in (False, True):
                assert k45_geometry(n, s, t, j, d, SMS, LIMIT, force).smem <= LIMIT
                assert k6_geometry(n, s, t, j, d, SMS, LIMIT, force).smem <= LIMIT
                assert k2_plan(n, s, t, j, d, SMS, LIMIT, K2_MAX_CLUSTER, force).smem <= LIMIT
