"""K2's decomposition on the CPU: the port's emulation of the cluster kernel
(csrc/fvta_fwd.cu; `k2_emulated` in tests/test_torch_kernels.py: segments of
sequence chunks per CTA, blocks with an online time softmax, the fixed-order
cluster combine) against the JAX package's fvta_attention_pallas (Pallas in
interpret mode on the CPU, its plain path at S < 8) and against the port's plain
version, at the JAX suite's forward tolerance 1e-5 / 1e-5, at the main paths'
widths and at odd edges, each under three geometries: one CTA per example, the
plan the H100 runs, and each sequence's T split into chunks (one of them padded
steps only) with CTAs holding chunks across sequence boundaries. Inputs come
from a seed with numpy and carry a dead sequence, an all-masked question and
an example with no valid context. Also: the plan's Python mirror against
csrc/fvta_fwd.cuh compiled for the host, and the wrappers' refusal of CPU
tensors. The kernel itself is held against plain on the card in
tests/test_torch_kernels.py."""

import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops.fvta_pallas import fvta_attention_pallas

from fvta_memexqa_torch.ops import build, fvta_fused, fvta_ref
from test_torch_kernels import K2Plan, _cdiv, k2_emulated, k2_plan

FIELDS = ("context", "question", "time_attn", "seq_attn")
TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_fvta_pallas.py's forward tolerance
H100 = dict(sms=132, smem_max=build.SMEM_LIMIT)
SHAPES = [(8, 24, 24, 30, 200), (1, 24, 24, 30, 200), (2, 1, 512, 30, 200), (3, 1, 7, 40, 16),
          (2, 6, 33, 5, 18)]
VARIANTS = ("dead_sequence", "empty_example", "masked_question")


@functools.cache
def k2_case(shape, variant, seed=80):
    """numpy inputs at `shape`: bounded states (bi-LSTM outputs, |h| < 1),
    N(0, 1) trilinear weights, ragged masks, and per variant: a dead sequence
    in every example plus a live sequence with only its first step valid
    ("dead_sequence"; a T split then has chunks of padded steps only), example
    0 without valid context, or example 0's question all masked."""
    n, s, t, j, d = shape
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.normal(0, 1, (n, s, t, d))).astype(np.float32)
    q = np.tanh(rng.normal(0, 1, (n, j, d))).astype(np.float32)
    cm = np.arange(t)[None, None, :] < rng.integers(1, t + 1, (n, s))[..., None]
    qm = np.arange(j)[None, :] < rng.integers(1, j + 1, n)[:, None]
    if variant == "dead_sequence":
        if s > 1:
            cm[:, min(3, s - 1), :] = False
        cm[n - 1, 0, :] = False
        cm[n - 1, 0, 0] = True
    elif variant == "empty_example":
        cm[0] = False
    else:
        qm[0] = False
    h, q = h * cm[..., None], q * qm[..., None]
    w = {k: rng.normal(0, 1, d).astype(np.float32) for k in ("w_x", "w_y", "w_xy")}
    return h, cm, q, qm, w


@functools.cache
def jax_out(shape, variant):
    h, cm, q, qm, w = k2_case(shape, variant)
    out = fvta_attention_pallas(jnp.asarray(h), jnp.asarray(cm), jnp.asarray(q),
                                jnp.asarray(qm), "trilinear",
                                {k: jnp.asarray(v) for k, v in w.items()})
    return [np.asarray(a) for a in out]


def geometries(shape) -> dict:
    n, s, t, j, d = shape
    chunks = min(t, 3)
    chunk_len = _cdiv(t, chunks)
    chunks = _cdiv(t, chunk_len)
    segs = _cdiv(s * chunks, 16)
    return {
        "one_cta": k2_plan(*shape, cmax=1, **H100),
        "h100_plan": k2_plan(*shape, cmax=16, **H100),
        "t_split": K2Plan(_cdiv(s * chunks, segs), chunks, chunk_len, segs, 32, 2, 0, 0),
    }


@pytest.mark.parametrize("geometry", ["one_cta", "h100_plan", "t_split"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_emulation_matches_jax_and_plain(shape, geometry):
    plan = geometries(shape)[geometry]
    assert plan.cluster <= 16
    for variant in VARIANTS:
        h, cm, q, qm, w = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                           {k: torch.from_numpy(v) for k, v in a.items()}
                           for a in k2_case(shape, variant))
        with torch.no_grad():
            got = k2_emulated(h, cm.float(), q, qm.float(), w["w_x"], w["w_y"], w["w_xy"],
                              plan)
            plain = fvta_ref.fvta_attention(h, cm, q, qm,
                                            fvta_ref.similarity_tensor(h, q, "trilinear", w))
        for field, a, b, c in zip(FIELDS, got, plain, jax_out(shape, variant)):
            assert torch.isfinite(a).all(), (variant, field)
            np.testing.assert_allclose(a.numpy(), c, **TOL, err_msg=f"{variant} {field} vs JAX")
            torch.testing.assert_close(a, b, **TOL, msg=f"{variant} {field} vs plain")


def test_k2_plans_cover_every_row():
    """Every plan the H100 could be given: each CTA owns at least one segment,
    each segment at least one row, the chunks tile T, the cluster stays within
    its cap, blocks are whole 32-row passes, and with the cap at 16 every shape
    fits a CTA's shared memory (S = 300 at a cap of 1 does not)."""
    for n in (1, 3, 8, 64, 128, 500):
        for s, t in ((24, 24), (1, 7), (1, 1024), (1, 4096), (6, 512), (6, 33), (2, 1),
                     (300, 3), (17, 5)):
            for cmax in (16, 8, 4, 2, 1):
                p = k2_plan(n, s, t, 30, 200, cmax=cmax, **H100)
                nseg = s * p.chunks
                assert 1 <= p.cluster <= cmax and _cdiv(nseg, p.segs) == p.cluster
                assert (p.chunks - 1) * p.chunk_len < t <= p.chunks * p.chunk_len
                assert p.rows % 32 == 0 and p.bufs in (1, 2) and p.qtile in (0, 1)
                assert p.smem <= build.SMEM_LIMIT or cmax < 16


PLAN_MAIN = r'''
#include <cstdio>
int main() {
  const int ns[] = {1, 3, 8, 64, 128, 500};
  const int st[][2] = {{24, 24}, {1, 7}, {1, 1024}, {1, 4096}, {6, 512}, {6, 33}, {2, 1},
                       {300, 3}, {17, 5}};
  const int jd[][2] = {{30, 200}, {40, 16}, {5, 18}, {1, 1}, {512, 500}};
  const int sms[] = {132, 16};
  const size_t smem[] = {232448, 60000};
  for (int n : ns)
    for (const auto& a : st)
      for (const auto& b : jd)
        for (int m : sms)
          for (size_t sm : smem)
            for (int c = 16; c >= 1; c /= 2) {
              const k2::Plan p = k2::plan(n, a[0], a[1], b[0], b[1], m, sm, c);
              std::printf("%d %d %d %d %d %d %zu %d %d %d %d %d %d %d %d %zu %d\n", n,
                          a[0], a[1], b[0], b[1], m, sm, c, p.cluster, p.chunks, p.chunk_len,
                          p.segs, p.rows, p.bufs, p.qtile, p.smem, p.route);
            }
  return 0;
}
'''


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_k2_plan_matches_the_cuda_header(tmp_path):
    """k2_plan (and its shared-memory sizes) against fvta_fwd.cuh's own plan(),
    compiled for the host from the header itself."""
    prog = tmp_path / "plan.cc"
    prog.write_text(f'#include "{build.CSRC_DIR / "fvta_fwd.cuh"}"\n' + PLAN_MAIN)
    exe = tmp_path / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.split("\n")
    rows = [tuple(map(int, line.split())) for line in lines if line]
    assert len(rows) == 6 * 9 * 5 * 2 * 2 * 5
    for n, s, t, j, d, m, sm, c, *got in rows:
        assert tuple(k2_plan(n, s, t, j, d, m, sm, c)) == tuple(got), (n, s, t, j, d, m, sm, c)


def test_k2_wrappers_refuse_cpu_tensors(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a refused CPU tensor must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    h, cm, q, qm, w = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                       {k: torch.from_numpy(v) for k, v in a.items()}
                       for a in k2_case((2, 6, 33, 5, 18), "dead_sequence"))
    args = (h, cm.float(), q, qm.float(), w["w_x"], w["w_y"], w["w_xy"])
    before = (fvta_fused.fvta_fwd.launches, fvta_fused.fvta_fwd_serial.launches)
    for wrapper in (fvta_fused.fvta_fwd, fvta_fused.fvta_fwd_serial):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*args)
    assert (fvta_fused.fvta_fwd.launches, fvta_fused.fvta_fwd_serial.launches) == before


def test_k2_cpu_path_launches_neither_kernel(monkeypatch):
    """fvta_attention_fused on CPU tensors, with and without grad, runs the
    plain version: no build, no launch of either K2."""
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build kernels")

    monkeypatch.setattr(build, "build_all", no_build)
    shape = (2, 6, 33, 5, 18)
    h, cm, q, qm, w = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                       {k: torch.from_numpy(v) for k, v in a.items()}
                       for a in k2_case(shape, "dead_sequence"))
    before = (fvta_fused.fvta_fwd.launches, fvta_fused.fvta_fwd_serial.launches)
    with torch.no_grad():
        out = fvta_fused.fvta_attention_fused(h, cm, q, qm, "trilinear", w)
    hg = h.clone().requires_grad_()
    fvta_fused.fvta_attention_fused(hg, cm, q, qm, "trilinear", w).context.sum().backward()
    assert hg.grad is not None and torch.isfinite(hg.grad).all()
    for field, a, c in zip(FIELDS, out, jax_out(shape, "dead_sequence")):
        np.testing.assert_allclose(a.numpy(), c, **TOL, err_msg=field)
    assert (fvta_fused.fvta_fwd.launches, fvta_fused.fvta_fwd_serial.launches) == before
