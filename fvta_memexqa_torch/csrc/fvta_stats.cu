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
// Design (fvta_stats, stats_run_kernel + stats_merge_kernel). The TPU kernel
// walks the time blocks of one example in order and carries (m, den, v) in
// VMEM. Here one CTA per (run of cpc chunks of TCH = 32 steps, sequence,
// example), about one CTA per SM (fvta_corr.cuh run_geometry: 8 x 16 CTAs of 8
// chunks at the video train step, 16 x 8 of 4 at `cli video`'s call), walks its
// run with fvta_corr.cuh's walk_run in passes of 64 rows: the question tile, sy
// and the masks staged once, h and the context mask double-buffered with
// cp.async, C in 4 x 2 register tiles. From each tile it takes the q-masked
// row maxima (e, written once) and the ctx-masked column maxima (eq, per warp
// in shared memory); after each pass it updates (m, den, v) online: m' =
// max(m, max_t e), den' = den exp(m - m') + sum_t exp(e - m'), v' likewise with
// h from shared memory. Every score is finite (NEG = -1e30 for a masked entry),
// so no -inf meets an exp and a fully masked pass merges as exp(-1e30 - m) = 0.
// The CTA writes (m, den, v, eq) into its slot; stats_merge_kernel, one block per (32 columns of D,
// example), combines each sequence's slots in slot order: m = max, den and v
// rescaled by exp(m_p - m) and summed, eq = max. No float atomics, every sum in
// a fixed order, expf (not __expf): two launches on one card are bitwise equal.
//
// Bound on the H100. The pass must read h once (N*S*T*D floats: 26 MB at the
// video train step's N=8, S=1, T=4096, D=200, 7.8 us at 3.35 TB/s) and do
// 2*N*S*T*J*D FLOPs (0.39 GFLOP, 5.9 us at 67 TFLOP/s FP32): bytes bound it, and
// the correlation runs on the CUDA cores in FP32 (no tensor cores: the exact
// equality K5/K6 rely on rules out TF32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fvta_corr.cuh"

namespace {

using namespace fvta;

// K4's pass: one CTA per (run of chunks, sequence, example) of run_geometry;
// writes e and the CTA's partial (m, den, v, eq) into its slot. G: the global
// route (walk_run_global; v carried in the CTA's own slot of v_p instead of
// shared memory, each column by one thread in the same order).
template <bool G>
__global__ void __launch_bounds__(THREADS, 1)
stats_run_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                 const float* __restrict__ q, const float* __restrict__ qm,
                 const float* __restrict__ wx, const float* __restrict__ wy,
                 const float* __restrict__ wxy, float* __restrict__ e_out,
                 float* __restrict__ m_p, float* __restrict__ den_p, float* __restrict__ v_p,
                 float* __restrict__ eq_p, int S, int T, int J, int D, int cpc, int rows_max,
                 int nbuf, int vec) {
  extern __shared__ __align__(16) float smem_r[];
  float* smem = smem_r;
  const RunLayout l = run_layout(J, D, rows_max, nbuf, G);
  const float* qmv = smem + l.qmv;
  float *erow = smem + l.erow, *prow = smem + l.prow, *wq = smem + l.wq;
  const int p = blockIdx.x, s = blockIdx.y, n = blockIdx.z, per = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, jq = tid % 16;
  const int jp = round_j(J), ntiles = jp / QT, chunks = (T + TCH - 1) / TCH;
  const size_t seq = (size_t)n * S + s, slot = seq * per + p;
  float* vacc = G ? v_p + slot * D : smem + l.vacc;
  for (int i = tid; i < WARPS * jp; i += THREADS) wq[i] = -INFINITY;
  float* e_seq = e_out + seq * T;
  float rmax[4];             // this thread's rows' max of the q-masked C over the words so far
  float m = 0.0f, den = 0.0f;   // the run's statistics, held by warp 0
  const RunArgs a{h + seq * T * D, cm + seq * T, q + (size_t)n * J * D, qm + (size_t)n * J,
                  nullptr, wx, wy, wxy, T, J, D, p * cpc, min(p * cpc + cpc, chunks),
                  rows_max, nbuf, vec};
  auto tile = [&](int jt, int t0, int rows, const float* cmv, const int (&row)[4],
                  const float (&c)[4][2]) {
        float col[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (jt == 0) rmax[r] = -INFINITY;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int j = jt * QT + jq + 16 * b;
            if (j < J) {
              rmax[r] = fmaxf(rmax[r], masked(c[r][b], qmv[j]));
              if (row[r] < rows) col[b] = fmaxf(col[b], masked(c[r][b], cmv[row[r]]));
            }
          }
        }
#pragma unroll
        for (int b = 0; b < 2; ++b)
          col[b] = fmaxf(col[b], __shfl_xor_sync(0xffffffffu, col[b], 16));
        if (lane < 16)   // each (warp, word) slot has this one writer
          for (int b = 0; b < 2; ++b) {
            float* w = wq + warp * jp + jt * QT + jq + 16 * b;
            *w = fmaxf(*w, col[b]);
          }
        if (jt == ntiles - 1) {   // the row maxima over every word: e
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
              rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], o));
          if (jq == 0)
            for (int r = 0; r < 4; ++r)
              if (row[r] < rows) {
                const float e = masked(rmax[r], cmv[row[r]]);
                erow[row[r]] = e;
                e_seq[t0 + row[r]] = e;
              }
        }
      };
  auto pass = [&](int k, int, int rows, const float* hs, int ld) {
        __syncthreads();   // erow complete
        if (warp == 0) {   // rows lane and lane + 32
          const float e0 = lane < rows ? erow[lane] : -INFINITY;
          const float e1 = lane + 32 < rows ? erow[lane + 32] : -INFINITY;
          const float mc = warp_max(fmaxf(e0, e1));
          const float m_new = k == 0 ? mc : fmaxf(m, mc);
          const float scale = k == 0 ? 0.0f : expf(m - m_new);
          const float p0 = lane < rows ? expf(e0 - m_new) : 0.0f;
          const float p1 = lane + 32 < rows ? expf(e1 - m_new) : 0.0f;
          den = den * scale + warp_sum(p0 + p1);
          m = m_new;
          prow[lane] = p0;
          if (lane + 32 < rows_max) prow[lane + 32] = p1;
          if (lane == 0) prow[rows_max] = scale;
        }
        __syncthreads();
        const float scale = prow[rows_max];
        for (int d = tid; d < D; d += THREADS) {
          float acc = k == 0 ? 0.0f : vacc[d] * scale;
          for (int r = 0; r < rows; ++r) acc = fmaf(prow[r], hs[r * ld + d], acc);
          vacc[d] = acc;
        }
      };
  if constexpr (G)
    walk_run_global(a, smem, tile, pass);
  else
    walk_run(a, smem, tile, pass);
  if (tid == 0) {
    m_p[slot] = m;
    den_p[slot] = den;
  }
  if constexpr (!G)
    for (int d = tid; d < D; d += THREADS) v_p[slot * D + d] = vacc[d];
  for (int j = tid; j < J; j += THREADS) {
    float v = -INFINITY;
    for (int w = 0; w < WARPS; ++w) v = fmaxf(v, wq[w * jp + j]);
    eq_p[slot * J + j] = v;
  }
}

// K4's combine: one block per (32 columns of D, example) merges each sequence's
// `per` slots in slot order (block 0 also m, den and eq).
__global__ void __launch_bounds__(THREADS)
stats_merge_kernel(const float* __restrict__ m_p, const float* __restrict__ den_p,
                   const float* __restrict__ v_p, const float* __restrict__ eq_p,
                   float* __restrict__ m_out, float* __restrict__ den_out,
                   float* __restrict__ v_out, float* __restrict__ eq_out, int S, int per,
                   int J, int D) {
  const int n = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = blockIdx.x * 32 + lane;
  for (int s = warp; s < S; s += WARPS) {
    const size_t seq = (size_t)n * S + s, base = seq * per;
    float m = m_p[base];
    for (int p = 1; p < per; ++p) m = fmaxf(m, m_p[base + p]);
    if (d < D) {
      float acc = 0.0f;
      for (int p = 0; p < per; ++p)
        acc = fmaf(v_p[(base + p) * D + d], expf(m_p[base + p] - m), acc);
      v_out[seq * D + d] = acc;
    }
    if (blockIdx.x == 0 && lane == 0) {
      float den = 0.0f;
      for (int p = 0; p < per; ++p) den = fmaf(den_p[base + p], expf(m_p[base + p] - m), den);
      m_out[seq] = m;
      den_out[seq] = den;
    }
  }
  if (blockIdx.x == 0)
    for (int j = tid; j < J; j += THREADS) {
      const float* col = eq_p + (size_t)n * S * per * J + j;
      float v = -INFINITY;
      for (int sp = 0; sp < S * per; ++sp) v = fmaxf(v, col[(size_t)sp * J]);
      eq_out[(size_t)n * J + j] = v;
    }
}

}  // namespace

extern "C" {

const char* fvta_stats_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

static int run_geometry_here(int n, int s, int t, int j, int d, bool force_global,
                             long long* out) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const RunGeometry g = run_geometry(n, s, t, j, d, sms, (size_t)smem_max, force_global);
  const long long v[7] = {g.per, g.cpc, g.rows, g.nbuf, (long long)g.smem,
                          (long long)g.scratch, g.route};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return g.smem > (size_t)smem_max ? (int)cudaErrorInvalidConfiguration : 0;
}

// K4's and K5's geometry (fvta_corr.cuh run_geometry) on the current device:
// out = {CTAs per sequence, chunks per CTA, rows per pass, h buffers, shared
// memory per CTA in bytes, K4's scratch floats, route (0 staged, 1 global)}.
// Returns the cudaError_t (cudaErrorInvalidConfiguration: the shape needs more
// shared memory than a block has even on the global route; out is filled all
// the same).
int fvta_stats_geometry(int n, int s, int t, int j, int d, long long* out) {
  return run_geometry_here(n, s, t, j, d, false, out);
}

// fvta_stats_geometry with the global route forced at any width: no package
// path asks for it; the card tests hold the two routes against each other.
int fvta_stats_geometry_global(int n, int s, int t, int j, int d, long long* out) {
  return run_geometry_here(n, s, t, j, d, true, out);
}

// K4. Outputs m, den [N,S], v [N,S,D], eq [N,J], e [N,S,T]; scratch: the floats
// fvta_stats_geometry gives (each CTA's partials, written before read). per,
// cpc, rows, nbuf, smem and route are that geometry, read once by the caller
// for this shape on the current device and passed back unchanged, so a launch
// queries nothing; each route's shared-memory limit is raised once per device.
// Returns the cudaError_t of the launches (0 = success).
int fvta_stats(const float* h, const float* cm, const float* q, const float* qm,
               const float* wx, const float* wy, const float* wxy, float* m, float* den,
               float* v, float* eq, float* e, float* scratch, int n, int s, int t, int j,
               int d, int per, int cpc, int rows, int nbuf, long long smem, int route,
               void* stream) {
  static long long smem_set[2][64] = {};   // per route and device: the limit set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  const auto kernel = route ? stats_run_kernel<true> : stats_run_kernel<false>;
  if (smem > smem_set[route != 0][dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[route != 0][dev] = smem;
  }
  const size_t slots = (size_t)n * s * per;
  float* m_p = scratch;
  float* den_p = m_p + slots;
  float* v_p = den_p + slots;
  float* eq_p = v_p + slots * d;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(per, s, n), THREADS, (size_t)smem, st>>>(
      h, cm, q, qm, wx, wy, wxy, e, m_p, den_p, v_p, eq_p, s, t, j, d, cpc, rows, nbuf, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge_kernel<<<dim3((d + 31) / 32, n), THREADS, 0, st>>>(m_p, den_p, v_p, eq_p, m,
                                                                 den, v, eq, s, per, j, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
