// K5 and K6: the backward of the streaming FVTA statistics (trilinear; dot =
// wx=wy=0, wxy=1).
//
// K5 (fvta_qcnt) replaces fvta_memexqa_tpu/ops/fvta_pallas.py:_qcnt_kernel: for
// each (n, j), the number of positions (s, t) whose ctx-masked correlation
// C + (1-cm)*NEG equals eq[n, j] exactly. eq's cotangent is split evenly among
// them, as JAX's reduce_max VJP splits it, and they can lie anywhere in T (every
// fully masked position is exactly -1e30), so the count runs over the whole
// time axis before K6 uses it.
//
// K6 (fvta_stats_bwd) replaces :_bwd_kernel. From the time-score cotangent de
// [N,S,T] (the prologue in ops/fvta_stats.py forms it from the stats'
// cotangents) and eq's cotangent geq [N,J], it routes
//   dC[s,t,j] = tie_j * de[s,t] / #tie_j  +  tie_q * geq[j] / max(qcnt[j], 1)
// with tie_j = (C + (1-qm_j)*NEG == its max over j) and tie_q = (C + (1-cm)*NEG
// == eq[j]), and turns dC into
//   dh[s,t]  = sum_j dC (q_j*wxy) + rowsum*wx + exp(e - m) gv[s]   (gv: v's cotangent)
//   dq[j]    = (sum_{s,t} dC h) * wxy + colsum_j * wy
//   dwx, dwy, dwxy per example (summed over N by the caller, as the JAX package does).
//
// C is recomputed by the routine K4 uses (fvta_corr.cuh), bit for bit, so the
// exact-equality tie tests find the positions K4's maxima came from.
//
// K5 (fvta_qcnt, qcnt_run_kernel): K4's run of chunks (fvta_corr.cuh
// run_geometry / walk_run: one CTA per run of chunks, about one per SM, passes
// of 64 rows double-buffered with cp.async, C in 4 x 2 register tiles), each C
// element tested against eq[j] with the ctx mask; the counts carried in shared
// memory per (warp, j) across the run, summed in warp order and added into an
// int32 [N,J] once per (CTA, j) with integer atomics (exact, so the order of
// the CTAs does not matter). The chunked K5 (fvta_qcnt_chunked, qcnt_chunk_kernel),
// kept to be timed and checked beside it: one block per (chunk, sequence,
// example), C with corr(), one serial chain per element.
//
// Bound on the H100 (the video train step: N=8, S=1, T=4096, J=30, D=200). K5
// must read h (26 MB, 7.8 us) and do 2*N*S*T*J*D FLOPs (5.9 us): bytes. K6 must
// read h and de, e and write dh (52 MB, 16 us) and does ~6*N*S*T*J*D FLOPs
// (18 us at 67 TFLOP/s FP32): about even. Both recompute C, one dependent
// 200-term FMA chain per (t, j) element; K5, which does little else, sets the
// floor a K6 that recomputes C the same way cannot go far below.
//
// K6 (fvta_stats_bwd), one pass persistent over a run of chunks, then a small
// fixed-order combine:
// - bwd_fused_kernel: one CTA per (range of chunks, sequence, example), the
//   ranges sized so the grid is about one CTA per SM (N*S*P <= SMs where
//   N*S < SMs; 8 x 16 CTAs of 256 rows at the video step). The CTA stages its
//   question rows once (J <= 32; a larger J is restaged per tile of 32) and
//   copies the next chunk's h rows into the second of two shared buffers with
//   cp.async while it computes the current one. Per chunk: C in 2 x 2 register
//   tiles (fvta_corr.cuh serial_dot_2x2: float4 operands feed four chains, each
//   chain the serial order of K4's), dC in shared memory as before, then dh as
//   an [8 rows x 4 columns] register-tiled product over J from shared memory
//   (no global load in the inner loop), written once; dq's sum dC^T h, the
//   column sums and dwx's sum are carried across the whole range, dC^T h in
//   shared memory (J <= 32) or in the CTA's own partial slot (larger J), each
//   element in one thread in a fixed order. dC never leaves the chip.
// - bwd_combine_kernel: one block per (32 columns of D, example) sums the
//   CTAs' partials [N, S*P, J, D] in order and forms dq, dwy, dwxy and dwx.
// No float atomics; every sum has a fixed order, so two launches on one card
// are bitwise equal. The partials are ~3 MB at the video step, where the
// two-pass K6 below wrote dC (3.9 MB) and read it back once per 32 columns of D
// with h again (~27 MB).
//
// The two-pass K6 (fvta_stats_bwd_twopass), kept to be timed and checked beside
// it: pass 1, one block per (chunk, sequence, example), recomputes C with corr(),
// forms dC, writes dh, dC and the chunk's partial sums; pass 2, one block per (32
// columns of D, example), walks (s, t) in order for dq = dC^T h and the dw sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fvta_corr.cuh"

namespace {

using namespace fvta;

struct BwdLayout {
  size_t hs, hw, qs, sx, sy, cmv, cbuf, rowsum, pt, wc, total;
};

// cbuf holds the chunk's C, then its dC ([TCH, J]); wc the per-warp tie counts.
__host__ __device__ inline BwdLayout bwd_layout(int J, int D) {
  BwdLayout l;
  const size_t d1 = odd_stride(D);
  size_t o = 0;
  l.hs = o;     o += TCH * d1;
  l.hw = o;     o += TCH * d1;
  l.qs = o;     o += QT * d1;
  l.sx = o;     o += TCH;
  l.sy = o;     o += QT;
  l.cmv = o;    o += TCH;
  l.cbuf = o;   o += (size_t)TCH * J;
  l.rowsum = o; o += TCH;
  l.pt = o;     o += TCH;
  l.wc = o;     o += WARPS * QT;
  l.total = o * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(THREADS)
qcnt_chunk_kernel(const float* __restrict__ h, const float* __restrict__ cm,
            const float* __restrict__ q, const float* __restrict__ wx,
            const float* __restrict__ wy, const float* __restrict__ wxy,
            const float* __restrict__ eq, int* __restrict__ cnt, int S, int T, int J, int D) {
  extern __shared__ float smem[];
  const BwdLayout l = bwd_layout(0, D);   // no cbuf
  float *hs = smem + l.hs, *hw = smem + l.hw, *qs = smem + l.qs, *sx = smem + l.sx;
  float *sy = smem + l.sy, *cmv = smem + l.cmv;
  int* wc = reinterpret_cast<int*>(smem + l.wc);
  const int d1 = odd_stride(D);
  const int c = blockIdx.x, s = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * TCH, rows = min(TCH, T - t0);
  const size_t seq = (size_t)n * S + s;

  for (int r = tid; r < TCH; r += THREADS) cmv[r] = r < rows ? cm[seq * T + t0 + r] : 0.0f;
  stage_rows(h + seq * T * D, wx, wxy, t0, rows, D, hs, hw, sx);
  for (int j0 = 0; j0 < J; j0 += QT) {
    stage_qtile(q + (size_t)n * J * D, wy, j0, J, D, qs, sy);
    const bool valid_j = j0 + lane < J;
    const float eqv = valid_j ? eq[(size_t)n * J + j0 + lane] : 0.0f;
    int hits = 0;
    if (valid_j) {
      for (int r = warp; r < rows; r += WARPS) {
        const float cv = corr(hw + r * d1, qs + lane * d1, sx[r], sy[lane], D);
        hits += masked(cv, cmv[r]) == eqv;
      }
    }
    wc[warp * QT + lane] = hits;
    __syncthreads();
    if (tid < QT && j0 + tid < J) {
      int total = 0;
      for (int w = 0; w < WARPS; ++w) total += wc[w * QT + tid];
      if (total) atomicAdd(cnt + (size_t)n * J + j0 + tid, total);
    }
    __syncthreads();
  }
}

// K5: one CTA per (run of chunks, sequence, example) of run_geometry; G: the
// global route (walk_run_global).
template <bool G>
__global__ void __launch_bounds__(THREADS, 1)
qcnt_run_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                const float* __restrict__ q, const float* __restrict__ wx,
                const float* __restrict__ wy, const float* __restrict__ wxy,
                const float* __restrict__ eq, int* __restrict__ cnt, int S, int T, int J,
                int D, int cpc, int rows_max, int nbuf, int vec) {
  extern __shared__ __align__(16) float smem_r[];
  float* smem = smem_r;
  const RunLayout l = run_layout(J, D, rows_max, nbuf, G);
  int* wc = reinterpret_cast<int*>(smem + l.wq);   // tie counts per (warp, word)
  const float* eqv = smem + l.eqv;
  const int p = blockIdx.x, s = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, jq = tid % 16;
  const int jp = round_j(J), chunks = (T + TCH - 1) / TCH;
  const size_t seq = (size_t)n * S + s;
  for (int i = tid; i < WARPS * jp; i += THREADS) wc[i] = 0;
  const RunArgs a{h + seq * T * D, cm + seq * T, q + (size_t)n * J * D, nullptr,
                  eq + (size_t)n * J, wx, wy, wxy, T, J, D, p * cpc,
                  min(p * cpc + cpc, chunks), rows_max, nbuf, vec};
  auto tile = [&](int jt, int, int rows, const float* cmv, const int (&row)[4],
                  const float (&c)[4][2]) {
        int hits[2] = {0, 0};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int j = jt * QT + jq + 16 * b;
            if (row[r] < rows && j < J) hits[b] += masked(c[r][b], cmv[row[r]]) == eqv[j];
          }
#pragma unroll
        for (int b = 0; b < 2; ++b) hits[b] += __shfl_xor_sync(0xffffffffu, hits[b], 16);
        if (lane < 16)   // each (warp, word) slot has this one writer
          for (int b = 0; b < 2; ++b) wc[warp * jp + jt * QT + jq + 16 * b] += hits[b];
      };
  auto pass = [](int, int, int, const float*, int) {};
  if constexpr (G)
    walk_run_global(a, smem, tile, pass);
  else
    walk_run(a, smem, tile, pass);
  for (int j = tid; j < J; j += THREADS) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += wc[w * jp + j];
    if (total) atomicAdd(cnt + (size_t)n * J + j, total);
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_chunk_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                 const float* __restrict__ q, const float* __restrict__ qm,
                 const float* __restrict__ wx, const float* __restrict__ wy,
                 const float* __restrict__ wxy, const float* __restrict__ de,
                 const float* __restrict__ geq, const float* __restrict__ eq,
                 const float* __restrict__ qcnt, const float* __restrict__ e,
                 const float* __restrict__ m, const float* __restrict__ gv,
                 float* __restrict__ dh, float* __restrict__ dc_out,
                 float* __restrict__ dwx_p, float* __restrict__ colsum_p,
                 int S, int T, int J, int D) {
  extern __shared__ float smem[];
  const BwdLayout l = bwd_layout(J, D);
  float *hs = smem + l.hs, *hw = smem + l.hw, *qs = smem + l.qs, *sx = smem + l.sx;
  float *sy = smem + l.sy, *cmv = smem + l.cmv, *cbuf = smem + l.cbuf;
  float *rowsum = smem + l.rowsum, *pt = smem + l.pt;
  const int d1 = odd_stride(D);
  const int c = blockIdx.x, s = blockIdx.y, n = blockIdx.z, C = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * TCH, rows = min(TCH, T - t0);
  const size_t seq = (size_t)n * S + s;
  const size_t part = seq * C + c;
  const float* qn = q + (size_t)n * J * D;

  for (int r = tid; r < rows; r += THREADS) {
    cmv[r] = cm[seq * T + t0 + r];
    // the v-path factor p = exp(e - m) from the saved forward scores
    pt[r] = expf(e[seq * T + t0 + r] - m[seq]);
  }
  stage_rows(h + seq * T * D, wx, wxy, t0, rows, D, hs, hw, sx);
  for (int j0 = 0; j0 < J; j0 += QT) {
    stage_qtile(qn, wy, j0, J, D, qs, sy);
    if (j0 + lane < J) {
      for (int r = warp; r < rows; r += WARPS)
        cbuf[r * J + j0 + lane] = corr(hw + r * d1, qs + lane * d1, sx[r], sy[lane], D);
    }
    __syncthreads();
  }

  // dC, one warp per row: de through the max over j, geq through the max over (s, t)
  for (int r = warp; r < rows; r += WARPS) {
    float* crow = cbuf + r * J;
    float emax = -INFINITY;
    for (int j = lane; j < J; j += 32) emax = fmaxf(emax, masked(crow[j], qm[(size_t)n * J + j]));
    emax = warp_max(emax);
    float ties = 0.0f;
    for (int j = lane; j < J; j += 32) ties += masked(crow[j], qm[(size_t)n * J + j]) == emax;
    ties = warp_sum(ties);
    const float share = de[seq * T + t0 + r] / ties;
    float rsum = 0.0f;
    for (int j = lane; j < J; j += 32) {
      const size_t nj = (size_t)n * J + j;
      const float cv = crow[j];
      float dcv = masked(cv, qm[nj]) == emax ? share : 0.0f;
      if (masked(cv, cmv[r]) == eq[nj]) dcv += geq[nj] / fmaxf(qcnt[nj], 1.0f);
      crow[j] = dcv;
      dc_out[(seq * T + t0 + r) * J + j] = dcv;
      rsum += dcv;
    }
    rsum = warp_sum(rsum);
    if (lane == 0) rowsum[r] = rsum;
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float* crow = cbuf + r * J;
    float acc = 0.0f;
    for (int j = 0; j < J; ++j) acc = fmaf(crow[j], qn[(size_t)j * D + d] * wxy[d], acc);
    acc = fmaf(rowsum[r], wx[d], acc);
    dh[(seq * T + t0 + r) * D + d] = fmaf(pt[r], gv[seq * D + d], acc);
  }
  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = fmaf(rowsum[r], hs[r * d1 + d], acc);
    dwx_p[part * D + d] = acc;
  }
  for (int j = tid; j < J; j += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += cbuf[r * J + j];
    colsum_p[part * J + j] = acc;
  }
}

constexpr int RT = 32;   // rows of (s, t) per staged tile in the reduction

__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ h, const float* __restrict__ q,
                  const float* __restrict__ wy, const float* __restrict__ wxy,
                  const float* __restrict__ dc, const float* __restrict__ dwx_p,
                  const float* __restrict__ colsum_p, float* __restrict__ dq,
                  float* __restrict__ dwx, float* __restrict__ dwy, float* __restrict__ dwxy,
                  int S, int T, int C, int J, int D) {
  __shared__ float ct[RT][QT + 1];     // dC tile: rows x question words
  __shared__ float ht[RT][32 + 1];     // h tile: rows x columns
  __shared__ float red[2][QT][32 + 1]; // tmp*q and colsum*q before the sum over j
  __shared__ float cs[QT];
  const int d0 = blockIdx.x * 32, n = blockIdx.y;
  const int tid = threadIdx.x;
  const int dl = tid % 32, jl0 = tid / 32;   // this thread: column dl, words jl0 + 8k
  const int d = d0 + dl;
  const int st_total = S * T;
  const float* hn = h + (size_t)n * st_total * D;
  const float* dcn = dc + (size_t)n * st_total * J;
  float acc_wy = 0.0f, acc_wxy = 0.0f;

  for (int j0 = 0; j0 < J; j0 += QT) {
    float acc[QT / WARPS] = {};
    for (int r0 = 0; r0 < st_total; r0 += RT) {
      const int rows = min(RT, st_total - r0);
      for (int i = tid; i < RT * QT; i += THREADS) {
        const int r = i / QT, jl = i % QT;
        ct[r][jl] = (r < rows && j0 + jl < J) ? dcn[(size_t)(r0 + r) * J + j0 + jl] : 0.0f;
        ht[r][jl] = (r < rows && d0 + jl < D) ? hn[(size_t)(r0 + r) * D + d0 + jl] : 0.0f;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        const float hv = ht[r][dl];
#pragma unroll
        for (int k = 0; k < QT / WARPS; ++k) acc[k] = fmaf(ct[r][jl0 + WARPS * k], hv, acc[k]);
      }
      __syncthreads();
    }
    if (tid < QT) {
      float v = 0.0f;
      if (j0 + tid < J)
        for (int sc = 0; sc < S * C; ++sc) v += colsum_p[((size_t)n * S * C + sc) * J + j0 + tid];
      cs[tid] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < QT / WARPS; ++k) {
      const int jl = jl0 + WARPS * k, j = j0 + jl;
      float a = 0.0f, b = 0.0f;
      if (j < J && d < D) {
        const float qv = q[((size_t)n * J + j) * D + d];
        dq[((size_t)n * J + j) * D + d] = acc[k] * wxy[d] + cs[jl] * wy[d];
        a = acc[k] * qv;
        b = cs[jl] * qv;
      }
      red[0][jl][dl] = a;
      red[1][jl][dl] = b;
    }
    __syncthreads();
    if (tid < 32) {
      for (int jl = 0; jl < QT; ++jl) {
        acc_wxy += red[0][jl][tid];
        acc_wy += red[1][jl][tid];
      }
    }
    __syncthreads();
  }
  if (tid < 32 && d < D) {
    float v = 0.0f;
    for (int sc = 0; sc < S * C; ++sc) v += dwx_p[((size_t)n * S * C + sc) * D + d];
    dwx[(size_t)n * D + d] = v;
    dwy[(size_t)n * D + d] = acc_wy;
    dwxy[(size_t)n * D + d] = acc_wxy;
  }
}

// ---- K6: one pass over a run of chunks per CTA, then a fixed-order combine ----

constexpr int RB = 8;   // rows (dh) or question words (dq) per thread item

struct FusedLayout {
  size_t hbuf, hw, qs, acc, cbuf, wxs, wys, wxys, gvs, dwxacc, syv, qmv, eqv, gsh, colacc,
      sx, cmv, pt, der, rowsum, total;
};

// nbuf h buffers (2: the next chunk is copied while this one computes);
// acc_smem: dC^T h carried in shared memory (only when J <= QT). Every array
// starts on a 16-byte boundary. global: the global route's layout, with no
// array that grows with D (h, q and the weights read from device memory, dwx
// carried in the CTA's own slot).
__host__ __device__ inline FusedLayout fused_layout(int J, int D, int nbuf, bool acc_smem,
                                                    bool global = false) {
  FusedLayout l;
  const size_t ds = global ? 0 : vec_stride(D), jp = round_j(J);
  size_t o = 0;
  l.hbuf = o;   o += (size_t)nbuf * TCH * ds;
  l.hw = o;     o += TCH * ds;
  l.qs = o;     o += QT * ds;
  l.acc = o;    o += acc_smem ? QT * ds : 0;
  l.cbuf = o;   o += TCH * jp;
  l.wxs = o;    o += ds;
  l.wys = o;    o += ds;
  l.wxys = o;   o += ds;
  l.gvs = o;    o += ds;
  l.dwxacc = o; o += ds;
  l.syv = o;    o += jp;
  l.qmv = o;    o += jp;
  l.eqv = o;    o += jp;
  l.gsh = o;    o += jp;
  l.colacc = o; o += jp;
  l.sx = o;     o += TCH;
  l.cmv = o;    o += TCH;
  l.pt = o;     o += TCH;
  l.der = o;    o += TCH;
  l.rowsum = o; o += TCH;
  l.total = o * sizeof(float);
  return l;
}

// The launch geometry, in one place for the launch and for the wrapper that
// allocates the scratch: per = CTAs per sequence, cpc = chunks per CTA, the
// shared-memory layout and the scratch size in floats. route 1 (global): no
// staging fits (D = 556 at J = 30, 380 at J = 512 on the H100), so h, q, the
// weights and dC^T h are read from device memory, cbuf and the per-row and
// per-word arrays stay in shared memory; force_global takes it at any width.
struct FusedGeometry {
  int per, cpc, nbuf;
  bool acc_smem;
  size_t smem, scratch;
  int route;
};

__host__ __device__ inline FusedGeometry fused_geometry(int n, int s, int t, int j, int d,
                                                        int sms, size_t smem_max,
                                                        bool force_global = false) {
  FusedGeometry g;
  const int chunks = (t + TCH - 1) / TCH, ns = n * s;
  g.per = sms / ns > 1 ? sms / ns : 1;
  g.cpc = (chunks + g.per - 1) / g.per;
  g.per = (chunks + g.cpc - 1) / g.cpc;
  g.nbuf = 1;
  g.acc_smem = false;
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    const bool acc = round_j(j) == QT && fused_layout(j, d, nbuf, true).total <= smem_max;
    if (fused_layout(j, d, nbuf, acc).total <= smem_max) {
      g.nbuf = nbuf;
      g.acc_smem = acc;
      break;
    }
  }
  g.smem = fused_layout(j, d, g.nbuf, g.acc_smem).total;
  g.route = force_global || g.smem > smem_max ? 1 : 0;
  if (g.route) {
    g.nbuf = 1;
    g.acc_smem = false;
    g.smem = fused_layout(j, d, 1, false, true).total;
  }
  const size_t slots = (size_t)ns * g.per, ds = vec_stride(d), jp = round_j(j);
  g.scratch = slots * (jp * ds + jp + ds);   // dC^T h, column sums, dwx per slot
  return g;
}

// G: the global route (fused_geometry route 1). Every sum keeps the staged
// route's order over the same nonzero terms (the staged zero padding of h, q
// and dC adds exactly nothing: no accumulator here is ever -0), so both routes
// give the same bits.
template <bool G>
__global__ void __launch_bounds__(THREADS, 1)
bwd_fused_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                 const float* __restrict__ q, const float* __restrict__ qm,
                 const float* __restrict__ wx, const float* __restrict__ wy,
                 const float* __restrict__ wxy, const float* __restrict__ de,
                 const float* __restrict__ geq, const float* __restrict__ eq,
                 const float* __restrict__ qcnt, const float* __restrict__ e,
                 const float* __restrict__ m, const float* __restrict__ gv,
                 float* __restrict__ dh, float* __restrict__ part,
                 float* __restrict__ colpart, float* __restrict__ dwxpart, int S, int T,
                 int J, int D, int per, int cpc, int nbuf, int acc_smem, int vec) {
  extern __shared__ __align__(16) float smem_v[];
  float* smem = smem_v;
  const FusedLayout l = fused_layout(J, D, nbuf, acc_smem, G);
  float *hbuf = smem + l.hbuf, *hw = smem + l.hw, *qs = smem + l.qs, *cbuf = smem + l.cbuf;
  float *wxs = smem + l.wxs, *wys = smem + l.wys, *wxys = smem + l.wxys, *gvs = smem + l.gvs;
  float *syv = smem + l.syv, *qmv = smem + l.qmv, *eqv = smem + l.eqv, *gsh = smem + l.gsh;
  float *colacc = smem + l.colacc, *dwxacc = smem + l.dwxacc, *sx = smem + l.sx;
  float *cmv = smem + l.cmv, *pt = smem + l.pt, *der = smem + l.der, *rowsum = smem + l.rowsum;
  const int ds = vec_stride(D), jp = round_j(J), ntiles = jp / QT, dv = (D + 3) / 4;
  const int p = blockIdx.x, s = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t seq = (size_t)n * S + s, slot = seq * per + p;
  const int chunks = (T + TCH - 1) / TCH, c0 = p * cpc, c1 = min(c0 + cpc, chunks);
  const float* h_seq = h + seq * T * D;
  const float* q_n = q + (size_t)n * J * D;
  float* acc_g = part + slot * jp * ds;   // this CTA's dC^T h partial [jp, ds]
  float* acc = acc_smem ? smem + l.acc : acc_g;
  if constexpr (G) {   // the weights where they lie; dwx in the CTA's own slot
    wxs = const_cast<float*>(wx);
    wys = const_cast<float*>(wy);
    wxys = const_cast<float*>(wxy);
    gvs = const_cast<float*>(gv + seq * D);
    dwxacc = dwxpart + slot * ds;
    for (int c = tid; c < ds; c += THREADS) dwxacc[c] = 0.0f;
  } else {
    // the first chunk's rows fly while the CTA stages everything else
    for (int i = tid; i < nbuf * TCH; i += THREADS)
      for (int c = D; c < ds; ++c) hbuf[i * ds + c] = 0.0f;
    issue_rows(hbuf, h_seq, c0 * TCH, min(TCH, T - c0 * TCH), D, ds, vec);
    cp_async_commit();
    for (int c = tid; c < ds; c += THREADS) {
      const bool v = c < D;
      wxs[c] = v ? wx[c] : 0.0f;
      wys[c] = v ? wy[c] : 0.0f;
      wxys[c] = v ? wxy[c] : 0.0f;
      gvs[c] = v ? gv[seq * D + c] : 0.0f;
      dwxacc[c] = 0.0f;
    }
  }
  for (int j = tid; j < jp; j += THREADS) {
    const bool v = j < J;
    const size_t nj = (size_t)n * J + j;
    qmv[j] = v ? qm[nj] : 0.0f;
    eqv[j] = v ? eq[nj] : 0.0f;
    gsh[j] = v ? geq[nj] / fmaxf(qcnt[nj], 1.0f) : 0.0f;
    colacc[j] = 0.0f;
  }
  if (acc_smem)
    for (int i = tid; i < QT * ds; i += THREADS) acc[i] = 0.0f;
  // sy = <wy, q_j>, serial as K4 computes it (stage_qtile), tile by tile; with
  // one tile, qs keeps it for every chunk
  if constexpr (G) {
    for (int j = tid; j < jp; j += THREADS)
      syv[j] = j < J ? serial_dot(q_n + (size_t)j * D, wy, D) : 0.0f;
  } else {
    for (int jt = 0; jt < ntiles; ++jt) {
      __syncthreads();
      stage_q(qs, q_n, jt * QT, J, D, ds);
      __syncthreads();
      if (tid < QT) syv[jt * QT + tid] = serial_dot(qs + tid * ds, wys, D);
    }
  }

  const int rp = tid / 16, jq = tid % 16;   // C tile: rows rp, rp+16; words jq, jq+16
  for (int c = c0; c < c1; ++c) {
    const int k = c - c0, buf = nbuf == 2 ? (k & 1) : 0, t0 = c * TCH;
    const int rows = min(TCH, T - t0);
    if constexpr (!G) {
      if (nbuf == 2) {
        if (c + 1 < c1)
          issue_rows(hbuf + (buf ^ 1) * TCH * ds, h_seq, t0 + TCH, min(TCH, T - t0 - TCH), D,
                     ds, vec);
        cp_async_commit();   // an empty group on the last chunk keeps the count uniform
        cp_async_wait<1>();
      } else {
        if (k > 0) issue_rows(hbuf, h_seq, t0, rows, D, ds, vec);
        cp_async_commit();
        cp_async_wait<0>();
      }
    }
    __syncthreads();
    // this chunk's rows of h: staged (stride ds), or where they lie (stride D)
    const float* hs = G ? h_seq + (size_t)t0 * D : hbuf + buf * TCH * ds;
    const int ld = G ? D : ds;

    // (a) hw = h*wxy as K4 stages it (formed per term on the global route), and
    // the rows' scalars
    if constexpr (!G)
      for (int i = tid; i < TCH * ds; i += THREADS) hw[i] = __fmul_rn(hs[i], wxys[i % ds]);
    for (int r = tid; r < TCH; r += THREADS) {
      const bool v = r < rows;
      const size_t st = seq * T + t0 + r;
      cmv[r] = v ? cm[st] : 0.0f;
      pt[r] = v ? expf(e[st] - m[seq]) : 0.0f;   // the v-path factor exp(e - m)
      der[r] = v ? de[st] : 0.0f;
    }
    __syncthreads();

    // (b) C into cbuf in 2 x 2 register tiles, warp 0 also carrying the rows' sx
    for (int jt = 0; jt < ntiles; ++jt) {
      if (!G && ntiles > 1) {
        stage_q(qs, q_n, jt * QT, J, D, ds);
        __syncthreads();
      }
      float dot[2][2];
      if constexpr (G) {   // rows past the chunk and words past J: values ignored
        const float* a0 = hs + (size_t)min(rp, rows - 1) * D;
        const float* a1 = hs + (size_t)min(rp + 16, rows - 1) * D;
        const float* b0 = q_n + (size_t)min(jt * QT + jq, J - 1) * D;
        const float* b1 = q_n + (size_t)min(jt * QT + jq + 16, J - 1) * D;
        if (warp == 0 && jt == 0)
          serial_dot_2x2_global<true>(a0, a1, b0, b1, wxy, D, dot,
                                      hs + (size_t)min(lane, rows - 1) * D, wx, sx + lane);
        else
          serial_dot_2x2_global<false>(a0, a1, b0, b1, wxy, D, dot);
      } else {
        const float *a0 = hw + rp * ds, *a1 = hw + (rp + 16) * ds;
        const float *b0 = qs + jq * ds, *b1 = qs + (jq + 16) * ds;
        if (warp == 0 && jt == 0)
          serial_dot_2x2<true>(a0, a1, b0, b1, ds, dot, hs + lane * ds, wxs, sx + lane);
        else
          serial_dot_2x2<false>(a0, a1, b0, b1, ds, dot);
      }
      __syncthreads();   // sx written; every read of qs done
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r = rp + 16 * a, j = jt * QT + jq + 16 * b;
          cbuf[r * jp + j] = __fadd_rn(__fadd_rn(dot[a][b], sx[r]), syv[j]);
        }
    }
    __syncthreads();

    // (c) dC, one warp per row: de through the max over j, geq through the max
    // over (s, t); zero past J and past the chunk's rows
    for (int r = warp; r < TCH; r += WARPS) {
      float* crow = cbuf + r * jp;
      if (r >= rows) {
        for (int j = lane; j < jp; j += 32) crow[j] = 0.0f;
        if (lane == 0) rowsum[r] = 0.0f;
        continue;
      }
      float emax = -INFINITY;
      for (int j = lane; j < J; j += 32) emax = fmaxf(emax, masked(crow[j], qmv[j]));
      emax = warp_max(emax);
      float ties = 0.0f;
      for (int j = lane; j < J; j += 32) ties += masked(crow[j], qmv[j]) == emax;
      ties = warp_sum(ties);
      const float share = der[r] / ties;
      float rsum = 0.0f;
      for (int j = lane; j < jp; j += 32) {
        float dcv = 0.0f;
        if (j < J) {
          const float cv = crow[j];
          dcv = masked(cv, qmv[j]) == emax ? share : 0.0f;
          if (masked(cv, cmv[r]) == eqv[j]) dcv += gsh[j];
        }
        crow[j] = dcv;
        rsum += dcv;
      }
      rsum = warp_sum(rsum);
      if (lane == 0) rowsum[r] = rsum;
    }
    __syncthreads();

    // (d) per tile of question words: dh's sum over j (RB rows x 4 columns a
    // thread) and dC^T h carried in acc (RB words x 4 columns a thread), both
    // from shared memory only
    for (int jt = 0; jt < ntiles; ++jt) {
      if (!G && ntiles > 1) {
        __syncthreads();
        stage_q(qs, q_n, jt * QT, J, D, ds);
        __syncthreads();
      }
      const bool last = jt == ntiles - 1;
      const int jn = min(QT, J - jt * QT);   // the tile's words (the global route's terms)
      for (int i = tid; i < (TCH / RB) * dv; i += THREADS) {
        const int r0 = (i / dv) * RB, c = 4 * (i % dv);
        float a[RB][4];
#pragma unroll
        for (int rr = 0; rr < RB; ++rr)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // with several tiles, the running sum waits in dh between them
            const int r = r0 + rr, cc = c + kk;
            a[rr][kk] = (jt > 0 && r < rows && cc < D) ? dh[(seq * T + t0 + r) * D + cc]
                                                       : 0.0f;
          }
        for (int j = 0; j < (G ? jn : QT); ++j) {
          float4 qv;
          if constexpr (G) {
            const float* qr = q_n + (size_t)(jt * QT + j) * D + c;
            qv = make_float4(c < D ? __ldg(qr) : 0.0f, c + 1 < D ? __ldg(qr + 1) : 0.0f,
                             c + 2 < D ? __ldg(qr + 2) : 0.0f, c + 3 < D ? __ldg(qr + 3) : 0.0f);
          } else {
            qv = *reinterpret_cast<const float4*>(qs + j * ds + c);
          }
#pragma unroll
          for (int rr = 0; rr < RB; ++rr) {
            const float dcv = cbuf[(r0 + rr) * jp + jt * QT + j];
            a[rr][0] = fmaf(dcv, qv.x, a[rr][0]);
            a[rr][1] = fmaf(dcv, qv.y, a[rr][1]);
            a[rr][2] = fmaf(dcv, qv.z, a[rr][2]);
            a[rr][3] = fmaf(dcv, qv.w, a[rr][3]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const int r = r0 + rr;
          if (r >= rows) continue;
          float* out = dh + (seq * T + t0 + r) * D;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int cc = c + kk;
            if (cc >= D) continue;
            out[cc] = last ? a[rr][kk] * wxys[cc] + rowsum[r] * wxs[cc] + pt[r] * gvs[cc]
                           : a[rr][kk];
          }
        }
      }
      float* acc_t = acc_smem ? acc : acc + (size_t)jt * QT * ds;
      const bool fresh = !acc_smem && k == 0;   // a global slot starts with the range
      for (int i = tid; i < (QT / RB) * dv; i += THREADS) {
        const int j0 = (i / dv) * RB, c = 4 * (i % dv);
        float4 a[RB];
#pragma unroll
        for (int jj = 0; jj < RB; ++jj)
          a[jj] = fresh ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                        : *reinterpret_cast<const float4*>(acc_t + (j0 + jj) * ds + c);
        for (int r = 0; r < (G ? rows : TCH); ++r) {
          float4 hv;
          if constexpr (G) {
            const float* hr = hs + (size_t)r * D + c;
            hv = make_float4(c < D ? __ldg(hr) : 0.0f, c + 1 < D ? __ldg(hr + 1) : 0.0f,
                             c + 2 < D ? __ldg(hr + 2) : 0.0f, c + 3 < D ? __ldg(hr + 3) : 0.0f);
          } else {
            hv = *reinterpret_cast<const float4*>(hs + r * ds + c);
          }
          const float* dr = cbuf + r * jp + jt * QT + j0;
          const float4 x0 = *reinterpret_cast<const float4*>(dr);
          const float4 x1 = *reinterpret_cast<const float4*>(dr + 4);
          const float dcs[RB] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int jj = 0; jj < RB; ++jj) {
            a[jj].x = fmaf(dcs[jj], hv.x, a[jj].x);
            a[jj].y = fmaf(dcs[jj], hv.y, a[jj].y);
            a[jj].z = fmaf(dcs[jj], hv.z, a[jj].z);
            a[jj].w = fmaf(dcs[jj], hv.w, a[jj].w);
          }
        }
#pragma unroll
        for (int jj = 0; jj < RB; ++jj)
          *reinterpret_cast<float4*>(acc_t + (j0 + jj) * ds + c) = a[jj];
      }
    }
    for (int j = tid; j < jp; j += THREADS) {
      float v = 0.0f;
      for (int r = 0; r < TCH; ++r) v += cbuf[r * jp + j];
      colacc[j] += v;
    }
    for (int c = tid; c < D; c += THREADS) {
      float v = dwxacc[c];
      for (int r = 0; r < (G ? rows : TCH); ++r) v = fmaf(rowsum[r], hs[r * ld + c], v);
      dwxacc[c] = v;
    }
    __syncthreads();   // the buffers are free for the next chunk's copy
  }

  if (acc_smem)
    for (int i = tid; i < QT * ds; i += THREADS) acc_g[i] = acc[i];
  for (int j = tid; j < jp; j += THREADS) colpart[slot * jp + j] = colacc[j];
  if constexpr (!G)
    for (int c = tid; c < ds; c += THREADS) dwxpart[slot * ds + c] = dwxacc[c];
}

// dq, dwx, dwy, dwxy from the CTAs' partials, summed over each example's
// `slots` = S * per slots in slot order: one block per (32 columns of D, example).
__global__ void __launch_bounds__(THREADS)
bwd_combine_kernel(const float* __restrict__ q, const float* __restrict__ wy,
                   const float* __restrict__ wxy, const float* __restrict__ part,
                   const float* __restrict__ colpart, const float* __restrict__ dwxpart,
                   float* __restrict__ dq, float* __restrict__ dwx, float* __restrict__ dwy,
                   float* __restrict__ dwxy, int slots, int J, int D) {
  __shared__ float red[2][WARPS][32 + 1];
  const int ds = vec_stride(D), jp = round_j(J);
  const int n = blockIdx.y, tid = threadIdx.x;
  const int dl = tid % 32, jl = tid / 32, d = blockIdx.x * 32 + dl;
  const float* pn = part + (size_t)n * slots * jp * ds;
  const float* cn = colpart + (size_t)n * slots * jp;
  float a_wxy = 0.0f, a_wy = 0.0f;
  for (int j = jl; j < J; j += WARPS) {
    float cs = 0.0f;
    for (int sp = 0; sp < slots; ++sp) cs += cn[(size_t)sp * jp + j];
    if (d < D) {
      float tmp = 0.0f;
      for (int sp = 0; sp < slots; ++sp) tmp += pn[((size_t)sp * jp + j) * ds + d];
      const size_t njd = ((size_t)n * J + j) * D + d;
      dq[njd] = tmp * wxy[d] + cs * wy[d];
      a_wxy = fmaf(tmp, q[njd], a_wxy);
      a_wy = fmaf(cs, q[njd], a_wy);
    }
  }
  red[0][jl][dl] = a_wxy;
  red[1][jl][dl] = a_wy;
  __syncthreads();
  if (tid < 32 && d < D) {
    float sxy = 0.0f, sy = 0.0f, sx = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      sxy += red[0][w][tid];
      sy += red[1][w][tid];
    }
    for (int sp = 0; sp < slots; ++sp) sx += dwxpart[((size_t)n * slots + sp) * ds + d];
    dwxy[(size_t)n * D + d] = sxy;
    dwy[(size_t)n * D + d] = sy;
    dwx[(size_t)n * D + d] = sx;
  }
}

}  // namespace

extern "C" {

long long fvta_qcnt_chunked_smem_bytes(int d) { return (long long)bwd_layout(0, d).total; }

long long fvta_stats_bwd_twopass_smem_bytes(int j, int d) {
  return (long long)bwd_layout(j, d).total;
}

const char* fvta_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The chunked K5. cnt: int32 [N,J], zeroed by the caller. Returns the
// cudaError_t (0 = success).
int fvta_qcnt_chunked(const float* h, const float* cm, const float* q, const float* wx,
                      const float* wy, const float* wxy, const float* eq, int* cnt, int n,
                      int s, int t, int j, int d, void* stream) {
  const int chunks = (t + TCH - 1) / TCH;
  const size_t smem = bwd_layout(0, d).total;
  cudaError_t err = cudaFuncSetAttribute(qcnt_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  qcnt_chunk_kernel<<<dim3(chunks, s, n), THREADS, smem, (cudaStream_t)stream>>>(
      h, cm, q, wx, wy, wxy, eq, cnt, s, t, j, d);
  return (int)cudaGetLastError();
}

// K5. cnt: int32 [N,J], zeroed by the caller. per, cpc, rows, nbuf, smem and
// route are run_geometry for this shape on the current device
// (fvta_stats_geometry in the K4 library), read once by the caller and passed
// back unchanged; each route's shared-memory limit is raised once per device.
// Returns the cudaError_t (0 = success).
int fvta_qcnt(const float* h, const float* cm, const float* q, const float* wx,
              const float* wy, const float* wxy, const float* eq, int* cnt, int n, int s,
              int t, int j, int d, int per, int cpc, int rows, int nbuf, long long smem,
              int route, void* stream) {
  static long long smem_set[2][64] = {};   // per route and device: the limit set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  const auto kernel = route ? qcnt_run_kernel<true> : qcnt_run_kernel<false>;
  if (smem > smem_set[route != 0][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[route != 0][dev] = smem;
  }
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  kernel<<<dim3(per, s, n), THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      h, cm, q, wx, wy, wxy, eq, cnt, s, t, j, d, cpc, rows, nbuf, vec);
  return (int)cudaGetLastError();
}

// Outputs dh [N,S,T,D], dq [N,J,D], dwx/dwy/dwxy [N,D]; scratch dc [N,S,T,J],
// dwx_p [N,S,C,D], colsum_p [N,S,C,J] with C = ceil(T/32).
int fvta_stats_bwd_twopass(const float* h, const float* cm, const float* q, const float* qm,
                   const float* wx, const float* wy, const float* wxy, const float* de,
                   const float* geq, const float* eq, const float* qcnt, const float* e,
                   const float* m, const float* gv, float* dh, float* dq, float* dwx,
                   float* dwy, float* dwxy, float* dc, float* dwx_p, float* colsum_p,
                   int n, int s, int t, int j, int d, void* stream) {
  const int chunks = (t + TCH - 1) / TCH;
  const size_t smem = bwd_layout(j, d).total;
  cudaError_t err = cudaFuncSetAttribute(bwd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  bwd_chunk_kernel<<<dim3(chunks, s, n), THREADS, smem, st>>>(
      h, cm, q, qm, wx, wy, wxy, de, geq, eq, qcnt, e, m, gv, dh, dc, dwx_p, colsum_p,
      s, t, j, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_reduce_kernel<<<dim3((d + 31) / 32, n), THREADS, 0, st>>>(
      h, q, wy, wxy, dc, dwx_p, colsum_p, dq, dwx, dwy, dwxy, s, t, chunks, j, d);
  return (int)cudaGetLastError();
}

static int fused_geometry_here(int n, int s, int t, int j, int d, bool force_global,
                               FusedGeometry* g) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *g = fused_geometry(n, s, t, j, d, sms, (size_t)smem_max, force_global);
  return g->smem > (size_t)smem_max ? (int)cudaErrorInvalidConfiguration : 0;
}

static int bwd_geometry_out(int n, int s, int t, int j, int d, bool force_global,
                            long long* out) {
  FusedGeometry g;
  const int err = fused_geometry_here(n, s, t, j, d, force_global, &g);
  const long long v[7] = {g.per, g.cpc, (long long)g.smem, (long long)g.scratch, g.nbuf,
                          g.acc_smem ? 1 : 0, g.route};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return err;
}

// K6's geometry on the current device: out = {CTAs per sequence, chunks per CTA,
// shared memory per CTA in bytes, scratch floats, h buffers, dC^T h in shared
// memory (0/1), route (0 staged, 1 global)}. The wrapper allocates the scratch
// from it. Returns the cudaError_t (cudaErrorInvalidConfiguration: the shape
// needs more shared memory than a block has even on the global route; out is
// filled all the same).
int fvta_stats_bwd_geometry(int n, int s, int t, int j, int d, long long* out) {
  return bwd_geometry_out(n, s, t, j, d, false, out);
}

// fvta_stats_bwd_geometry with the global route forced at any width: no
// package path asks for it; the card tests hold the two routes against each
// other with it.
int fvta_stats_bwd_geometry_global(int n, int s, int t, int j, int d, long long* out) {
  return bwd_geometry_out(n, s, t, j, d, true, out);
}

// Outputs dh [N,S,T,D], dq [N,J,D], dwx/dwy/dwxy [N,D]; scratch: the floats
// fvta_stats_bwd_geometry gives (the CTAs' partials, each written before read).
// per, cpc, nbuf, acc_smem, smem and route are that geometry, read once by the
// caller for this shape on the current device and passed back unchanged, so a
// launch queries nothing. Each route's shared-memory limit is raised once per
// device.
int fvta_stats_bwd(const float* h, const float* cm, const float* q, const float* qm,
                   const float* wx, const float* wy, const float* wxy, const float* de,
                   const float* geq, const float* eq, const float* qcnt, const float* e,
                   const float* m, const float* gv, float* dh, float* dq, float* dwx,
                   float* dwy, float* dwxy, float* scratch, int n, int s, int t, int j, int d,
                   int per, int cpc, int nbuf, int acc_smem, long long smem, int route,
                   void* stream) {
  static int smem_set[2][64] = {};   // per route and device: the limit set so far (0: none)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  const auto kernel = route ? bwd_fused_kernel<true> : bwd_fused_kernel<false>;
  if (smem > smem_set[route != 0][dev]) {
    int smem_max = 0;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess && smem > smem_max) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return (int)err;
    smem_set[route != 0][dev] = smem_max;
  }
  const size_t slots = (size_t)n * s * per, ds = vec_stride(d), jp = round_j(j);
  float* part = scratch;
  float* colpart = part + slots * jp * ds;
  float* dwxpart = colpart + slots * jp;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(per, s, n), THREADS, (size_t)smem, st>>>(
      h, cm, q, qm, wx, wy, wxy, de, geq, eq, qcnt, e, m, gv, dh, part, colpart, dwxpart, s,
      t, j, d, per, cpc, nbuf, acc_smem, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_combine_kernel<<<dim3((d + 31) / 32, n), THREADS, 0, st>>>(
      q, wy, wxy, part, colpart, dwxpart, dq, dwx, dwy, dwxy, s * per, j, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
