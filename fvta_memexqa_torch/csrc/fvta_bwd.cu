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
// Design. K5: one block per (time chunk of 32 steps, sequence, example), the
// correlation as in K4, per-chunk tie counts added into an int32 [N,J] with
// integer atomics (exact, so the order does not matter). K6 is two passes. Pass
// 1, one block per (chunk, sequence, example): recompute C for the chunk into
// shared memory, form dC there, write dh for the chunk's rows, and write dC and
// the chunk's partial sums of dwx and of the column sums. Pass 2, one block per
// (32 columns of D, example): walk (s, t) in order and form dq = dC^T h (times
// wxy, plus colsum*wy), dwy and dwxy for its columns, and dwx from the partial
// sums. No float atomics; every sum has a fixed order. Pass 2 reads dC back from
// device memory: dC is [N,S,T,J] floats, J/D of dh's size (15% at J=30, D=200) —
// the TPU kernel kept it in VMEM; doing the same here (dq accumulated per block
// and combined across blocks) is later work.
//
// Bound on the H100 (the video train step: N=8, S=1, T=4096, J=30, D=200). K5
// must read h (26 MB, 7.8 us) and do 2*N*S*T*J*D FLOPs (5.9 us): bytes. K6 must
// read h and de, e and write dh (52 MB, 16 us) and does ~6*N*S*T*J*D FLOPs
// (18 us at 67 TFLOP/s FP32): about even; its design moves dC twice more.

#include <cuda_runtime.h>
#include <math.h>

#include "fvta_corr.cuh"

namespace {

using namespace fvta;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

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
qcnt_kernel(const float* __restrict__ h, const float* __restrict__ cm,
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

}  // namespace

extern "C" {

long long fvta_qcnt_smem_bytes(int d) { return (long long)bwd_layout(0, d).total; }

long long fvta_stats_bwd_smem_bytes(int j, int d) { return (long long)bwd_layout(j, d).total; }

const char* fvta_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cnt: int32 [N,J], zeroed by the caller. Returns the cudaError_t (0 = success).
int fvta_qcnt(const float* h, const float* cm, const float* q, const float* wx,
              const float* wy, const float* wxy, const float* eq, int* cnt, int n, int s,
              int t, int j, int d, void* stream) {
  const int chunks = (t + TCH - 1) / TCH;
  const size_t smem = bwd_layout(0, d).total;
  cudaError_t err = cudaFuncSetAttribute(qcnt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  qcnt_kernel<<<dim3(chunks, s, n), THREADS, smem, (cudaStream_t)stream>>>(
      h, cm, q, wx, wy, wxy, eq, cnt, s, t, j, d);
  return (int)cudaGetLastError();
}

// Outputs dh [N,S,T,D], dq [N,J,D], dwx/dwy/dwxy [N,D]; scratch dc [N,S,T,J],
// dwx_p [N,S,C,D], colsum_p [N,S,C,J] with C = ceil(T/32).
int fvta_stats_bwd(const float* h, const float* cm, const float* q, const float* qm,
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

}  // extern "C"
