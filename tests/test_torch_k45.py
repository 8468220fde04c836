"""K4's and K5's runs of chunks on the CPU: the port's emulation of the
persistent-CTA kernels (csrc/fvta_stats.cu stats_run_kernel + stats_merge_kernel,
csrc/fvta_bwd.cu qcnt_run_kernel; `k4_run_emulated` / `k5_run_emulated` in
tests/test_torch_kernels.py: runs of chunks per CTA, (m, den, v) online per CTA,
the fixed-order merge of the partials, tie counts per CTA summed over the CTAs)
against the JAX package's fvta_stats_pallas (Pallas in interpret mode on the
CPU) and the port's plain version at the JAX suite's stats tolerance 1e-5 /
1e-5, and the counts exactly against qcnt_ref, under several geometries: one
CTA per sequence, the geometry the H100 (132 SMs) gets, one chunk per CTA, and
runs of uneven length. Inputs come from a seed with numpy and carry ragged
masks, a run with a fully masked chunk, an example with no valid frame, an
all-masked question, T past a chunk edge and J > 32. Also: every geometry
covers each chunk exactly once, the geometry's Python mirror against
csrc/fvta_corr.cuh compiled for the host, the autograd Function with the
emulated runs swapped in for the kernels, and the wrappers' refusal of CPU
tensors. The kernels themselves are held against plain and the chunked
kernels on the card in tests/test_torch_kernels.py."""

import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops.fvta_pallas import fvta_stats_pallas

from fvta_memexqa_torch.ops import build, fvta_ref, fvta_stats
from test_torch_kernels import (RunGeometry, _cdiv, k4_run_emulated, k5_run_emulated,
                                k45_geometry, run_chunks, run_passes, run_smem, stats_case,
                                stats_grads)

STATS = ("m", "den", "v", "eq", "e")
TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_fvta_pallas.py's stats tolerance
H100 = dict(sms=132, smem_max=build.SMEM_LIMIT)
# (n, s, t, j, d): T <= 64 for the interpret-mode runs; S = 1 as on the video
# path, T past a chunk edge with J > 32 (two question tiles), several sequences,
# T below one chunk
JAX_SHAPES = [(2, 1, 64, 5, 6), (3, 1, 40, 40, 8), (2, 3, 56, 7, 16), (1, 2, 64, 33, 12),
              (4, 2, 24, 30, 20)]
# longer runs against the plain version only: 7 and 35 chunks, the last partial
LONG_SHAPES = [(2, 1, 200, 6, 10), (1, 2, 1100, 34, 8)]
VARIANTS = ("ragged", "masked_chunk", "empty_example", "masked_question")


@functools.cache
def k45_case(shape, variant, seed=90):
    """numpy inputs at `shape`: N(0, 1) states, question and trilinear weights
    (the JAX suite's scale), ragged masks, and per variant: the second chunk
    (steps 32-63) of sequence 0 fully masked in every example with step 0
    kept valid ("masked_chunk"), example 0 without a valid frame, or example
    0's question all masked."""
    n, s, t, j, d = shape
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (n, s, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (n, j, d)).astype(np.float32)
    cm = np.arange(t)[None, None, :] < rng.integers(1, t + 1, (n, s))[..., None]
    qm = np.arange(j)[None, :] < rng.integers(1, j + 1, n)[:, None]
    if variant == "masked_chunk":
        cm[:, 0, 0] = True
        cm[:, 0, 32:64] = False
    elif variant == "empty_example":
        cm[0] = False
    elif variant == "masked_question":
        qm[0] = False
    h, q = h * cm[..., None], q * qm[..., None]
    w = {k: rng.normal(0, 1, d).astype(np.float32) for k in ("w_x", "w_y", "w_xy")}
    return h, cm, q, qm, w


def torch_case(shape, variant):
    h, cm, q, qm, w = k45_case(shape, variant)
    t = torch.from_numpy
    return t(h), t(cm).float(), t(q), t(qm).float(), t(w["w_x"]), t(w["w_y"]), t(w["w_xy"])


@functools.cache
def jax_stats(shape, variant):
    h, cm, q, qm, w = k45_case(shape, variant)
    out = fvta_stats_pallas(jnp.asarray(h), jnp.asarray(cm), jnp.asarray(q), jnp.asarray(qm),
                            "trilinear", {k: jnp.asarray(v) for k, v in w.items()}, tblock=8)
    return [np.asarray(a) for a in out]


def geometries(shape) -> dict:
    n, s, t, j, d = shape
    chunks = _cdiv(t, 32)
    return {
        "one_cta_per_sequence": k45_geometry(*shape, sms=1, smem_max=build.SMEM_LIMIT),
        "h100": k45_geometry(*shape, **H100),
        "one_chunk_per_cta": RunGeometry(chunks, 1, 64, 2, run_smem(j, d, 64, 2), 0),
        "passes_of_32_rows": RunGeometry(*k45_geometry(*shape, sms=1,
                                                       smem_max=build.SMEM_LIMIT)[:2],
                                         32, 2, run_smem(j, d, 32, 2), 0),
        "uneven_runs": k45_geometry(*shape, sms=3 * n * s, smem_max=build.SMEM_LIMIT),
    }


def check_against_plain(args, geo):
    """The emulated runs against stats_fwd_ref (1e-5 / 1e-5; e, m and eq, all
    maxima, equal) and the counts exactly against qcnt_ref; returns K4's
    emulated outputs."""
    h, cm, q, qm, wx, wy, wxy = args
    with torch.no_grad():
        got = k4_run_emulated(*args, geo)
        ref = fvta_stats.stats_fwd_ref(*args)
        cnt = k5_run_emulated(h, cm, q, wx, wy, wxy, got[3], geo)
        cnt_r = fvta_stats.qcnt_ref(h, cm, q, wx, wy, wxy, ref[3])
    for field, a, b in zip(STATS, got, ref):
        assert torch.isfinite(a).all(), field
        torch.testing.assert_close(a, b, **TOL, msg=f"{field} vs plain")
    for i in (0, 3, 4):
        assert torch.equal(got[i], ref[i]), STATS[i]
    assert torch.equal(cnt, cnt_r) and (cnt >= 1).all()
    return got


@pytest.mark.parametrize("geometry", ["one_cta_per_sequence", "h100", "one_chunk_per_cta"])
@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_k45_emulation_matches_jax_and_plain(shape, geometry):
    geo = geometries(shape)[geometry]
    for variant in VARIANTS:
        got = check_against_plain(torch_case(shape, variant), geo)
        for field, a, c in zip(STATS, got, jax_stats(shape, variant)):
            np.testing.assert_allclose(a.numpy(), c, **TOL, err_msg=f"{variant} {field} vs JAX")


@pytest.mark.parametrize("geometry", ["one_cta_per_sequence", "h100", "one_chunk_per_cta",
                                      "uneven_runs", "passes_of_32_rows"])
@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_k45_emulation_matches_plain_over_long_runs(shape, geometry):
    geo = geometries(shape)[geometry]
    runs = -(-_cdiv(shape[2], 32) // geo.cpc)
    assert runs == geo.per
    for variant in VARIANTS:
        check_against_plain(torch_case(shape, variant), geo)


def test_uneven_runs_end_short():
    """The uneven geometry of the long shapes gives runs of several chunks, the
    last one shorter (7 chunks in runs of 3, 3, 1; 35 in runs of 12, 12, 11),
    and runs of an odd number of chunks end in a pass of one chunk."""
    for shape in LONG_SHAPES:
        geo = geometries(shape)["uneven_runs"]
        lengths = [len(run) for run in run_chunks(shape[2], geo)]
        assert geo.cpc > 1 and lengths[:-1] == [geo.cpc] * (geo.per - 1)
        assert 0 < lengths[-1] < geo.cpc
    geo = geometries(LONG_SHAPES[0])["uneven_runs"]
    assert run_passes(200, geo) == [[(0, 64), (64, 96)], [(96, 160), (160, 192)],
                                    [(192, 200)]]


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_run_geometries_cover_every_chunk_once(sms):
    """Every geometry a card with `sms` SMs could be given: the runs tile the
    chunks in order, each exactly once, no CTA's run is empty, the grid stays
    within one CTA per SM where N*S is below the SM count (one CTA per
    sequence beyond it), and every shape up to D = 500 fits a CTA's shared
    memory (passes of 64 rows and two h buffers up to D = 240)."""
    for n in (1, 2, 3, 8, 16, 64, 200):
        for s, t in ((1, 1), (1, 31), (1, 32), (1, 33), (1, 1024), (1, 4096), (24, 24),
                     (8, 16384), (3, 70)):
            for j, d in ((30, 200), (512, 200), (5, 6), (40, 500), (1, 400)):
                geo = k45_geometry(n, s, t, j, d, sms, build.SMEM_LIMIT)
                runs = run_chunks(t, geo)
                assert [c for run in runs for c in run] == list(range(_cdiv(t, 32)))
                assert all(runs) and len(runs) == geo.per
                passes = [p for run in run_passes(t, geo) for p in run]
                assert [t0 for t0, _ in passes[1:]] == [t1 for _, t1 in passes[:-1]]
                assert passes[0][0] == 0 and passes[-1][1] == t
                assert all(0 < t1 - t0 <= geo.rows for t0, t1 in passes)
                assert n * s * geo.per <= max(sms, n * s)
                assert geo.smem <= build.SMEM_LIMIT
                assert (geo.rows, geo.nbuf) == (64, 2) or d > 240
                assert geo.scratch == n * s * geo.per * (2 + d + j)


GEOMETRY_MAIN = r'''
#include <cstdio>
int main() {
  const int ns[] = {1, 3, 8, 16, 64, 200};
  const int st[][2] = {{1, 1}, {1, 33}, {1, 1024}, {1, 4096}, {24, 24}, {8, 16384}, {3, 70}};
  const int jd[][2] = {{30, 200}, {512, 200}, {5, 6}, {40, 600}, {1, 1}, {33, 500}};
  const int sms[] = {132, 114, 16};
  const size_t smem[] = {232448, 100000};
  for (int n : ns)
    for (const auto& a : st)
      for (const auto& b : jd)
        for (int m : sms)
          for (size_t sm : smem) {
            const fvta::RunGeometry g = fvta::run_geometry(n, a[0], a[1], b[0], b[1], m, sm);
            std::printf("%d %d %d %d %d %d %zu %d %d %d %d %zu %zu %d\n", n, a[0], a[1],
                        b[0], b[1], m, sm, g.per, g.cpc, g.rows, g.nbuf, g.smem, g.scratch,
                        g.route);
          }
  return 0;
}
'''


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_run_geometry_matches_the_cuda_header(tmp_path):
    """k45_geometry (and its shared-memory sizes) against fvta_corr.cuh's own
    run_geometry(), compiled for the host from the header itself."""
    prog = tmp_path / "geometry.cc"
    prog.write_text(f'#include "{build.CSRC_DIR / "fvta_corr.cuh"}"\n' + GEOMETRY_MAIN)
    exe = tmp_path / "geometry"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.split("\n")
    rows = [tuple(map(int, line.split())) for line in lines if line]
    assert len(rows) == 6 * 7 * 6 * 3 * 2
    for n, s, t, j, d, m, sm, *got in rows:
        assert tuple(k45_geometry(n, s, t, j, d, m, sm)) == tuple(got), (n, s, t, j, d, m, sm)


@pytest.mark.parametrize("name", ["plain", "s1_long", "dead_sequence", "all_masked_example",
                                  "all_masked_question"])
def test_stats_fn_with_emulated_runs_matches_plain_autograd(monkeypatch, name):
    """_StatsFn (the autograd Function the card runs) with K4 and K5 as the H100's
    runs of chunks and K6's plain version (all three from one C, as on the card,
    where the tie tests need it bit for bit): outputs and gradients as autograd
    through the plain statistics."""
    h, cm, q, qm, p = stats_case(name, seed=91)
    out_r, ref = stats_grads(fvta_ref.focal_local_stats, h, cm, q, qm, p)

    def kernels(device):
        def k4(h, cm_f, q, qm_f, wx, wy, wxy):
            geo = k45_geometry(*h.shape[:3], *q.shape[1:], **H100)
            return k4_run_emulated(h, cm_f, q, qm_f, wx, wy, wxy, geo)

        def k5(h, cm_f, q, wx, wy, wxy, eq):
            geo = k45_geometry(*h.shape[:3], *q.shape[1:], **H100)
            return k5_run_emulated(h, cm_f, q, wx, wy, wxy, eq, geo)

        return k4, k5, fvta_stats.stats_bwd_ref

    monkeypatch.setattr(fvta_stats, "_kernels", kernels)
    out_k, got = stats_grads(fvta_stats.fvta_stats_fused, h, cm, q, qm, p)
    for field, a, b in zip(STATS, out_k, out_r):
        torch.testing.assert_close(a, b, **TOL, msg=field)
    for field, a, b in zip(("h", "q", "w_x", "w_y", "w_xy"), got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=field)


def test_k45_wrappers_refuse_cpu_tensors(monkeypatch):
    """K4, K5 and the chunked K4 and K5 raise on CPU tensors, build nothing and
    count no launch."""
    def no_build(*a, **k):
        raise AssertionError("a refused CPU tensor must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    h, cm, q, qm, wx, wy, wxy = torch_case(JAX_SHAPES[1], "ragged")
    eq = fvta_stats.stats_fwd_ref(h, cm, q, qm, wx, wy, wxy)[3]
    wrappers = (fvta_stats.stats_fwd, fvta_stats.stats_fwd_chunked, fvta_stats.qcnt,
                fvta_stats.qcnt_chunked)
    before = [w.launches for w in wrappers]
    for wrapper in wrappers[:2]:
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(h, cm, q, qm, wx, wy, wxy)
    for wrapper in wrappers[2:]:
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(h, cm, q, wx, wy, wxy, eq)
    assert [w.launches for w in wrappers] == before


def test_cpu_stats_path_launches_no_k4_or_k5(monkeypatch):
    """fvta_stats_fused on CPU tensors, forward and backward, runs the plain
    versions: no build, no launch of K4, K5 or the chunked kernels."""
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    h, cm, q, qm, wx, wy, wxy = torch_case(JAX_SHAPES[0], "masked_chunk")
    wrappers = (fvta_stats.stats_fwd, fvta_stats.stats_fwd_chunked, fvta_stats.qcnt,
                fvta_stats.qcnt_chunked)
    before = [w.launches for w in wrappers]
    hg = h.clone().requires_grad_()
    p = {"w_x": wx, "w_y": wy, "w_xy": wxy}
    out = fvta_stats.fvta_stats_fused(hg, cm > 0.5, q, qm > 0.5, "trilinear", p)
    out[2].sum().backward()
    assert hg.grad is not None and torch.isfinite(hg.grad).all()
    for field, a, c in zip(STATS, out, jax_stats(JAX_SHAPES[0], "masked_chunk")):
        np.testing.assert_allclose(a.detach().numpy(), c, **TOL, err_msg=field)
    assert [w.launches for w in wrappers] == before
