// K4: the streaming FVTA statistics pass (trilinear correlation; dot = wx=wy=0,
// wxy=1).
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/fvta_pallas.py:_stats_kernel
// (launched by _fvta_stats_pallas_call). Same function as the plain
// ops/fvta_ref.focal_local_stats, for any S >= 1 and any T:
//   C[s,t,j] = <wx,h> + <wy,q_j> + (h*wxy).q_j             (fvta_corr.cuh, bitwise
//                                                           shared with K5 and K6)
//   e[s,t]   = max over j of (C + (1-qm_j)*NEG), then + (1-cm[s,t])*NEG
//   m[s]     = max_t e,  den[s] = sum_t exp(e - m),  v[s] = sum_t exp(e - m) h[s,t]
//   eq[j]    = max over (s,t) of (C + (1-cm[s,t])*NEG)
//
// Design. The TPU kernel walks the time blocks of one example in order and
// carries (m, den, v) in VMEM; here the blocks run in parallel. Pass 1 gives
// every (time chunk of TCH = 32 steps, sequence, example) its own block: it
// stages the chunk's h rows in shared memory, walks the question in tiles of 32
// words (one per lane), and writes the chunk's scores e, its local stats
// (m_c, den_c, v_c) and its local eq. Pass 2, one block per example, combines the
// chunks in chunk order: m = max_c m_c, den = sum_c den_c exp(m_c - m),
// v = sum_c v_c exp(m_c - m), eq = max. Every sum runs in a fixed order and no
// atomics are used, so the result is deterministic. expf, not __expf.
//
// Bound on the H100. The pass must read h once (N*S*T*D floats: 26 MB at the
// video train step's N=8, S=1, T=4096, D=200, 7.8 us at 3.35 TB/s) and do
// 2*N*S*T*J*D FLOPs (0.39 GFLOP, 5.9 us at 67 TFLOP/s FP32): bytes bound it, and
// the correlation runs on the CUDA cores in FP32 (no tensor cores: the exact
// equality K5/K6 rely on rules out TF32). At S=1, N=8 pass 1 has 1024 blocks, so
// the card is full; pass 2 is N blocks and short.

#include <cuda_runtime.h>
#include <math.h>

#include "fvta_corr.cuh"

namespace {

using namespace fvta;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

struct ChunkLayout {
  size_t hs, hw, qs, sx, sy, qmt, cmv, emax, pr, wq, total;
};

__host__ __device__ inline ChunkLayout chunk_layout(int D) {
  ChunkLayout l;
  const size_t d1 = odd_stride(D);
  size_t o = 0;
  l.hs = o;   o += TCH * d1;
  l.hw = o;   o += TCH * d1;
  l.qs = o;   o += QT * d1;
  l.sx = o;   o += TCH;
  l.sy = o;   o += QT;
  l.qmt = o;  o += QT;
  l.cmv = o;  o += TCH;
  l.emax = o; o += TCH;
  l.pr = o;   o += TCH;
  l.wq = o;   o += WARPS * QT;
  l.total = o * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(THREADS)
stats_chunk_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                   const float* __restrict__ q, const float* __restrict__ qm,
                   const float* __restrict__ wx, const float* __restrict__ wy,
                   const float* __restrict__ wxy, float* __restrict__ e_out,
                   float* __restrict__ m_p, float* __restrict__ den_p,
                   float* __restrict__ v_p, float* __restrict__ eq_p,
                   int S, int T, int J, int D) {
  extern __shared__ float smem[];
  const ChunkLayout l = chunk_layout(D);
  float *hs = smem + l.hs, *hw = smem + l.hw, *qs = smem + l.qs, *sx = smem + l.sx;
  float *sy = smem + l.sy, *qmt = smem + l.qmt, *cmv = smem + l.cmv;
  float *emax = smem + l.emax, *pr = smem + l.pr, *wq = smem + l.wq;
  const int d1 = odd_stride(D);
  const int c = blockIdx.x, s = blockIdx.y, n = blockIdx.z, C = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * TCH, rows = min(TCH, T - t0);
  const size_t seq = (size_t)n * S + s;
  const size_t part = seq * C + c;

  for (int r = tid; r < TCH; r += THREADS) {
    cmv[r] = r < rows ? cm[seq * T + t0 + r] : 0.0f;
    emax[r] = -INFINITY;
  }
  stage_rows(h + seq * T * D, wx, wxy, t0, rows, D, hs, hw, sx);

  for (int j0 = 0; j0 < J; j0 += QT) {
    for (int i = tid; i < QT; i += THREADS)
      qmt[i] = j0 + i < J ? qm[(size_t)n * J + j0 + i] : 0.0f;
    stage_qtile(q + (size_t)n * J * D, wy, j0, J, D, qs, sy);
    const bool valid_j = j0 + lane < J;
    float qcol = -INFINITY;     // this lane's max of the ctx-masked C over the warp's rows
    for (int r = warp; r < rows; r += WARPS) {
      float cq = -INFINITY, cs = -INFINITY;
      if (valid_j) {
        const float cv = corr(hw + r * d1, qs + lane * d1, sx[r], sy[lane], D);
        cq = masked(cv, qmt[lane]);
        cs = masked(cv, cmv[r]);
      }
      const float rmax = warp_max(cq);
      if (lane == 0) emax[r] = fmaxf(emax[r], rmax);
      qcol = fmaxf(qcol, cs);
    }
    wq[warp * QT + lane] = qcol;
    __syncthreads();
    if (tid < QT && j0 + tid < J) {
      float v = -INFINITY;
      for (int w = 0; w < WARPS; ++w) v = fmaxf(v, wq[w * QT + tid]);
      eq_p[part * J + j0 + tid] = v;
    }
    __syncthreads();
  }

  for (int r = tid; r < rows; r += THREADS) {
    const float e = masked(emax[r], cmv[r]);
    e_out[seq * T + t0 + r] = e;
    pr[r] = e;
  }
  __syncthreads();
  if (warp == 0) {   // TCH == 32: one row per lane
    const float ev = lane < rows ? pr[lane] : -INFINITY;
    const float mc = warp_max(ev);
    const float p = lane < rows ? expf(ev - mc) : 0.0f;
    const float den = warp_sum(p);
    pr[lane] = p;
    if (lane == 0) {
      m_p[part] = mc;
      den_p[part] = den;
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = fmaf(pr[r], hs[r * d1 + d], acc);
    v_p[part * D + d] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
stats_combine_kernel(const float* __restrict__ m_p, const float* __restrict__ den_p,
                     const float* __restrict__ v_p, const float* __restrict__ eq_p,
                     float* __restrict__ m_out, float* __restrict__ den_out,
                     float* __restrict__ v_out, float* __restrict__ eq_out,
                     int S, int C, int J, int D) {
  extern __shared__ float ms[];   // [S] the combined max of each sequence
  const int n = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < S; s += WARPS) {
    const size_t base = ((size_t)n * S + s) * C;
    float mx = -INFINITY;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, m_p[base + c]);
    mx = warp_max(mx);
    float den = 0.0f;
    for (int c = lane; c < C; c += 32) den += den_p[base + c] * expf(m_p[base + c] - mx);
    den = warp_sum(den);
    if (lane == 0) {
      ms[s] = mx;
      m_out[(size_t)n * S + s] = mx;
      den_out[(size_t)n * S + s] = den;
    }
  }
  __syncthreads();
  for (int i = tid; i < S * D; i += THREADS) {
    const int s = i / D, d = i % D;
    const size_t base = ((size_t)n * S + s) * C;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(v_p[(base + c) * D + d], expf(m_p[base + c] - ms[s]), acc);
    v_out[((size_t)n * S + s) * D + d] = acc;
  }
  for (int j = tid; j < J; j += THREADS) {
    float v = -INFINITY;
    for (int sc = 0; sc < S * C; ++sc) v = fmaxf(v, eq_p[((size_t)n * S * C + sc) * J + j]);
    eq_out[(size_t)n * J + j] = v;
  }
}

}  // namespace

extern "C" {

long long fvta_stats_smem_bytes(int d) { return (long long)chunk_layout(d).total; }

const char* fvta_stats_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Outputs m, den [N,S], v [N,S,D], eq [N,J], e [N,S,T]; scratch m_p, den_p
// [N,S,C], v_p [N,S,C,D], eq_p [N,S,C,J] with C = ceil(T/32). Returns the
// cudaError_t of the launches (0 = success).
int fvta_stats(const float* h, const float* cm, const float* q, const float* qm,
               const float* wx, const float* wy, const float* wxy, float* m, float* den,
               float* v, float* eq, float* e, float* m_p, float* den_p, float* v_p,
               float* eq_p, int n, int s, int t, int j, int d, void* stream) {
  const int chunks = (t + TCH - 1) / TCH;
  const size_t smem = chunk_layout(d).total;
  cudaError_t err = cudaFuncSetAttribute(stats_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  stats_chunk_kernel<<<dim3(chunks, s, n), THREADS, smem, st>>>(
      h, cm, q, qm, wx, wy, wxy, e, m_p, den_p, v_p, eq_p, s, t, j, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)s * sizeof(float);
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(stats_combine_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  stats_combine_kernel<<<n, THREADS, smem2, st>>>(m_p, den_p, v_p, eq_p, m, den, v, eq,
                                                 s, chunks, j, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
