// K2: the fused FVTA attention forward (trilinear correlation; dot = wx=wy=0, wxy=1).
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/fvta_pallas.py:_kernel (launched by
// _fvta_pallas_call). Same function, per example n:
//   C[s,t,j]  = <wx,h> + <wy,q_j> + (h*wxy).q_j
//   E[s,t]    = max over valid j of C, then + (1-cm)*NEG       (NEG = -1e30)
//   time softmax over t of E; V[s] = sum_t softmax * h[s,t]
//   seq_valid = any t of the context mask (not the maximum of E)
//   B         = softmax over s of (max_t E + (1-valid)*NEG);  ctx = sum_s B * V
//   time_attn = the time softmax * valid,  seq_attn = B * valid
//   Eq_j      = max over (s,t) of (C + (1-cm)*NEG);  q~ = softmax_J(Eq + (1-qm)*NEG) . Q
// Denominators are clamped at 1e-30, as in the TPU kernel. An example with no
// valid context gets time_attn = seq_attn = 0 and the uniform mean of its rows
// as ctx, as the plain version does.
//
// Bound on the H100. Per example the kernel must read h (S*T*D floats, 460 KB at
// S=T=24, D=200) and do 2*S*T*J*D FLOPs (~7 MFLOP at J=30): h's bytes are the
// larger term, 1.1 us at N=8 over 3.35 TB/s. So the bound is bytes, and what
// keeps a launch from it at N=1..8 is how few SMs work on it and how long each
// waits on a dependent chain.
//
// Design (k2_cluster_kernel), against each limit of the earlier one-block-per-example
// kernel (kept below as fvta_fwd_serial_kernel, which no path calls):
// - One block per example filled 1 of 132 SMs at N=1. Now one thread-block
//   cluster per example: its CTAs split the example's S x T rows, whole
//   sequences per CTA where S is at least the cluster, chunks of one
//   sequence's T where S is smaller (fvta_fwd.cuh: 12 CTAs at S=T=24 and
//   N<=8, 16 CTAs at S=1). The cluster is as small as fills the card at this
//   N, and the library takes the largest one whose N clusters the card holds
//   at once (cudaOccupancyMaxActiveClusters): 2 CTAs at N=64 and N=128.
// - A serial walk over t with a 200-long FMA chain per lane from shared
//   memory. Now C is a register-tiled FP32 product: 32 rows x 32 columns per
//   pass of 256 threads, 2 x 2 per thread, float4 loads from shared memory,
//   each element eight interleaved chains summed pairwise (its rounding is
//   no worse than the plain version's). q is staged once per CTA as q*w_xy,
//   with w_x as column 0 so that sx comes out of the same product; sy is
//   summed in double. A CTA's rows arrive by cp.async, all at once where they
//   fit (96 rows), else in blocks of 32 with the next block copied while this
//   one computes: 16-byte copies where D % 4 == 0 and the base pointer is
//   16-byte aligned, 4-byte copies otherwise. Where q does not fit whole
//   (large J x D), it is staged 32 columns at a time.
// - Online rescaling at every step. Now a CTA takes the time softmax of a
//   whole block at once (max, then exp, then V = p . h from the rows still in
//   shared memory); only a CTA that walks several blocks rescales, once per
//   block. A segment's first block sets its state, so no -inf ever meets an
//   exp, and every score is finite.
// - Shared memory that grew with S (V for every sequence). Now a CTA holds its
//   own rows, its own segments' state and q. The rest of the example is
//   combined across the cluster through distributed shared memory in a fixed
//   order: after a cluster barrier every CTA reads the segments' maxima and
//   context flags in segment order for the softmax over S, and the CTAs'
//   question-side maxima in rank order; each CTA weighs its own V rows into a
//   partial context and writes each column into the CTA that owns that slice
//   of D, which sums the partials in rank order after a second barrier. The
//   raw scores go to time_attn as they are computed and each CTA normalises
//   its own rows at the end.
// No float atomics and no order that depends on timing: two launches give the
// same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "fvta_fwd.cuh"

namespace cg = cooperative_groups;

// ---- the serial K2, kept to be timed and checked beside K2 --------------------
//
// One block per example. q[n] is staged in shared memory (stride D|1). Each warp
// owns whole sequences and streams them over t: it loads h[s,t,:] once (raw and
// times wxy) into its shared row, lane j computes C[s,t,j], a warp max gives E,
// and the warp keeps the online softmax state of its sequence (its V row in
// shared memory). The raw scores E go straight into the time_attn output and a
// final sweep of the same block normalises them in place.

namespace serial {

constexpr float NEG = -1e30f;
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Layout {
  int d1;                                   // padded q row stride (odd)
  size_t qs, hw, hr, run_v, sy, qms, qmx, run_max, run_den, cmx, bs, wq, total;
};

__host__ __device__ inline Layout layout(int S, int J, int D) {
  Layout l;
  l.d1 = D | 1;
  size_t o = 0;
  l.qs = o;       o += (size_t)J * l.d1;
  l.hw = o;       o += (size_t)WARPS * D;
  l.hr = o;       o += (size_t)WARPS * D;
  l.run_v = o;    o += (size_t)S * D;
  l.sy = o;       o += J;
  l.qms = o;      o += J;
  l.qmx = o;      o += (size_t)WARPS * J;
  l.run_max = o;  o += S;
  l.run_den = o;  o += S;
  l.cmx = o;      o += S;
  l.bs = o;       o += S;
  l.wq = o;       o += J;
  l.total = o * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(THREADS)
fvta_fwd_serial_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                const float* __restrict__ q, const float* __restrict__ qm,
                const float* __restrict__ wx, const float* __restrict__ wy,
                const float* __restrict__ wxy, float* __restrict__ ctx,
                float* __restrict__ qatt, float* __restrict__ ta, float* __restrict__ sa,
                int S, int T, int J, int D) {
  extern __shared__ float smem[];
  const Layout l = layout(S, J, D);
  float* qs = smem + l.qs;
  float* sy = smem + l.sy;
  float* qms = smem + l.qms;
  float* run_v = smem + l.run_v;
  float* run_max = smem + l.run_max;
  float* run_den = smem + l.run_den;
  float* cmx = smem + l.cmx;
  float* bs = smem + l.bs;
  float* wq = smem + l.wq;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* hw = smem + l.hw + (size_t)warp * D;     // this warp's h*wxy row
  float* hr = smem + l.hr + (size_t)warp * D;     // this warp's raw h row
  float* qmx = smem + l.qmx + (size_t)warp * J;   // this warp's question-side max

  const float* qn = q + (size_t)n * J * D;
  for (int i = tid; i < J * D; i += THREADS) qs[(i / D) * l.d1 + i % D] = qn[i];
  for (int j = tid; j < J; j += THREADS) qms[j] = qm[(size_t)n * J + j];
  for (int j = lane; j < J; j += 32) qmx[j] = NEG;
  // sy[j] = <wy, q_j>: one warp per question word, fixed-order reduction
  for (int j = warp; j < J; j += WARPS) {
    float p = 0.0f;
    for (int d = lane; d < D; d += 32) p = fmaf(qn[(size_t)j * D + d], wy[d], p);
    p = warp_sum(p);
    if (lane == 0) sy[j] = p;
  }
  __syncthreads();

  for (int s = warp; s < S; s += WARPS) {
    const size_t seq = (size_t)n * S + s;
    float m = NEG, den = 0.0f, cmax = 0.0f;
    for (int d = lane; d < D; d += 32) run_v[(size_t)s * D + d] = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float* hp = h + (seq * T + t) * D;
      const float cmv = cm[seq * T + t];
      float sxp = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float hv = hp[d];
        hr[d] = hv;
        hw[d] = hv * wxy[d];
        sxp = fmaf(hv, wx[d], sxp);
      }
      const float sx = warp_sum(sxp);
      __syncwarp();
      float emax = -INFINITY;
      for (int j = lane; j < J; j += 32) {
        const float* qj = qs + (size_t)j * l.d1;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc = fmaf(hw[d], qj[d], acc);
        const float c = acc + sx + sy[j];
        emax = fmaxf(emax, c + (1.0f - qms[j]) * NEG);
        qmx[j] = fmaxf(qmx[j], c + (1.0f - cmv) * NEG);
      }
      const float e = warp_max(emax) + (1.0f - cmv) * NEG;
      if (lane == 0) ta[seq * T + t] = e;   // raw score; normalised below
      const float m_new = fmaxf(m, e);
      const float scale = expf(m - m_new);
      const float p = expf(e - m_new);
      den = den * scale + p;
      for (int d = lane; d < D; d += 32) {
        float* v = run_v + (size_t)s * D + d;
        *v = *v * scale + p * hr[d];
      }
      m = m_new;
      cmax = fmaxf(cmax, cmv);
      __syncwarp();
    }
    if (lane == 0) {
      run_max[s] = m;
      run_den[s] = den;
      cmx[s] = cmax;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // softmax over sequences of g = max_t E + (1-valid)*NEG
    float gmax = -INFINITY;
    for (int s = lane; s < S; s += 32) {
      const float valid = cmx[s] > 0.5f ? 1.0f : 0.0f;
      const float g = run_max[s] + (1.0f - valid) * NEG;
      bs[s] = g;
      gmax = fmaxf(gmax, g);
    }
    gmax = warp_max(gmax);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(bs[s] - gmax);
      bs[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      bs[s] = bs[s] / sum;
      sa[(size_t)n * S + s] = cmx[s] > 0.5f ? bs[s] : 0.0f;
    }
  } else if (warp == 1) {
    // question side: softmax over j of the (s,t)-max, masked by the question mask
    float qmax = -INFINITY;
    for (int j = lane; j < J; j += 32) {
      float v = NEG;
      for (int w = 0; w < WARPS; ++w) v = fmaxf(v, smem[l.qmx + (size_t)w * J + j]);
      v = v + (1.0f - qms[j]) * NEG;
      wq[j] = v;
      qmax = fmaxf(qmax, v);
    }
    qmax = warp_max(qmax);
    float sum = 0.0f;
    for (int j = lane; j < J; j += 32) {
      const float e = expf(wq[j] - qmax);
      wq[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < J; j += 32) wq[j] = wq[j] / sum;
  }
  __syncthreads();

  for (int d = tid; d < D; d += THREADS) {
    float c = 0.0f;
    for (int s = 0; s < S; ++s)
      c = fmaf(bs[s], run_v[(size_t)s * D + d] / fmaxf(run_den[s], 1e-30f), c);
    ctx[(size_t)n * D + d] = c;
    float qa = 0.0f;
    for (int j = 0; j < J; ++j) qa = fmaf(wq[j], qs[(size_t)j * l.d1 + d], qa);
    qatt[(size_t)n * D + d] = qa;
  }
  for (int i = tid; i < S * T; i += THREADS) {
    const int s = i / T;
    const size_t idx = (size_t)n * S * T + i;
    const float inv_den = 1.0f / fmaxf(run_den[s], 1e-30f);
    ta[idx] = cmx[s] > 0.5f ? expf(ta[idx] - run_max[s]) * inv_den : 0.0f;
  }
}

}  // namespace serial

// ---- K2 -----------------------------------------------------------------------

namespace {

using k2::JT;
using k2::SUB;
using k2::THREADS;
using k2::WARPS;

constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A cluster barrier in two halves: arrive releases this thread's writes so far
// (shared memory of any CTA of the cluster, global memory), wait acquires the
// others'. Every thread of every CTA takes both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of D floats from src (consecutive rows of h) into dst
// (stride ds) with cp.async; the columns past D were zeroed once.
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ src, int rows,
                                           int D, int ds, bool vec) {
  if (vec) {
    const int dv = D / 4;
    for (int i = threadIdx.x; i < rows * dv; i += THREADS) {
      const int r = i / dv, v = i % dv;
      cp_async16(dst + r * ds + 4 * v, src + (size_t)r * D + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += THREADS) {
      const int r = i / D, c = i % D;
      cp_async4(dst + r * ds + c, src + (size_t)r * D + c);
    }
  }
}

// The rows of segment `seg` (chunk seg % P of sequence seg / P), as example rows.
struct Segs {
  int T, P, L;
  __device__ __forceinline__ int start(int seg) const {
    return (seg / P) * T + (seg % P) * L;
  }
  __device__ __forceinline__ int end(int seg) const {
    const int k = seg % P;
    return (seg / P) * T + ((k + 1) * L < T ? (k + 1) * L : T);
  }
  __device__ __forceinline__ int of(int row) const {
    return (row / T) * P + (row % T) / L;
  }
};

// One float4 step of dot_pass into the accumulators of step parity E.
template <int E>
__device__ __forceinline__ void dot_step(const float* const (&x)[2], const float* const (&y)[2],
                                         int i, float4 (&acc)[2][2][2]) {
  const float4 y0 = *reinterpret_cast<const float4*>(y[0] + i);
  const float4 y1 = *reinterpret_cast<const float4*>(y[1] + i);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(x[r] + i);
    float4 &p = acc[r][0][E], &q = acc[r][1][E];
    p.x = fmaf(v.x, y0.x, p.x); p.y = fmaf(v.y, y0.y, p.y);
    p.z = fmaf(v.z, y0.z, p.z); p.w = fmaf(v.w, y0.w, p.w);
    q.x = fmaf(v.x, y1.x, q.x); q.y = fmaf(v.y, y1.y, q.y);
    q.z = fmaf(v.z, y1.z, q.z); q.w = fmaf(v.w, y1.w, q.w);
  }
}

// One pass of C's dot products: rows rp and rp + 16 of the staged rows a and
// columns jq, jq + 16 of the right-hand side b (rows of stride ds), 2 x 2 a
// thread, float4 loads from shared memory. Each element is eight chains (a
// float4 lane of the even or the odd float4 step each) summed pairwise into
// cbuf: a quarter of a serial chain's length, for rounding no worse than
// the plain version's.
__device__ __forceinline__ void dot_pass(const float* a, const float* b, int ds, float* cbuf,
                                         int cs, int rp, int jq) {
  const float* const x[2] = {a + rp * ds, a + (rp + 16) * ds};
  const float* const y[2] = {b + jq * ds, b + (jq + 16) * ds};
  float4 acc[2][2][2];   // [row][column][even/odd step]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[r][c][0] = acc[r][c][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  int i = 0;
  for (; i + 8 <= ds; i += 8) {
    dot_step<0>(x, y, i, acc);
    dot_step<1>(x, y, i + 4, acc);
  }
  if (i < ds) dot_step<0>(x, y, i, acc);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 u = acc[r][c][0], v = acc[r][c][1];
      cbuf[(rp + 16 * r) * cs + jq + 16 * c] =
          ((u.x + v.x) + (u.y + v.y)) + ((u.z + v.z) + (u.w + v.w));
    }
}

// dot_pass on the global route: rows rp, rp + 16 of a pass (nr valid rows from
// hp, stride D; a row past nr reads the last valid one, its values ignored)
// against columns ct + jq, ct + jq + 16 of C's right-hand side (column 0 w_x,
// column c in 1..J q_{c-1} * w_xy, zero past J), all read from device memory.
// Term d goes to chain d % 8, the chains summed pairwise as dot_pass sums them:
// the staged form's order without its zero padding.
__device__ __forceinline__ void dot_pass_global(const float* hp, int nr, const float* qn,
                                                const float* wx, const float* wxy, int J, int D,
                                                int ct, float* cbuf, int cs, int rp, int jq) {
  const float* const x[2] = {hp + (size_t)min(rp, nr - 1) * D,
                             hp + (size_t)min(rp + 16, nr - 1) * D};
  const float* y[2];
  bool scaled[2], zero[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = ct + jq + 16 * c;
    zero[c] = col > J;
    scaled[c] = col > 0;
    y[c] = col == 0 || zero[c] ? wx : qn + (size_t)(col - 1) * D;
  }
  float acc[2][2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][c][e] = 0.0f;
  auto term = [&](int d, int e) {
    const float w = __ldg(wxy + d);
    float yv[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) yv[c] = scaled[c] ? __fmul_rn(__ldg(y[c] + d), w) : __ldg(y[c] + d);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float xv = __ldg(x[r] + d);
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[r][c][e] = fmaf(xv, yv[c], acc[r][c][e]);
    }
  };
  int i = 0;
  for (; i + 8 <= D; i += 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) term(i + e, e);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (i + e < D) term(i + e, e);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* a = acc[r][c];
      cbuf[(rp + 16 * r) * cs + jq + 16 * c] =
          zero[c] ? 0.0f : ((a[0] + a[4]) + (a[1] + a[5])) + ((a[2] + a[6]) + (a[3] + a[7]));
    }
}

// GLOBAL: the global route (plan route 1): h, q and the weights read from
// device memory, each segment's V row in vscr ([grid, segs, D]).
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS, 2)
k2_cluster_kernel(const float* __restrict__ h, const float* __restrict__ cm,
                  const float* __restrict__ q, const float* __restrict__ qm,
                  const float* __restrict__ wx, const float* __restrict__ wy,
                  const float* __restrict__ wxy, float* __restrict__ ctx,
                  float* __restrict__ qatt, float* __restrict__ ta, float* __restrict__ sa,
                  float* __restrict__ vscr, int S, int T, int J, int D, int C, int P, int L,
                  int G, int RB, int bufs, int qtile, int vec) {
  extern __shared__ __align__(16) float smem_v[];
  float* smem = smem_v;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / C;
  const k2::Layout l = k2::layout(J, D, C, G, RB, bufs, qtile, GLOBAL);
  float *hbuf = smem + l.hbuf, *cmv = smem + l.cmv, *qs = smem + l.qs, *wxys = smem + l.wxys;
  float *wys = smem + l.wys, *qsl = smem + l.qsl, *cbuf = smem + l.cbuf, *eb = smem + l.eb;
  float *sxr = smem + l.sxr, *rowmax = smem + l.rowmax;
  float *sy = smem + l.sy, *qmv = smem + l.qmv, *wqmx = smem + l.wqmx, *qmx = smem + l.qmx;
  float *wq = smem + l.wq, *V = smem + l.v, *pcs = smem + l.pcs, *sm = smem + l.sm;
  float *sden = smem + l.sden, *scm = smem + l.scm, *sscale = smem + l.sscale;
  float *wsl = smem + l.wsl, *my_m = smem + l.my_m, *my_inv = smem + l.my_inv;
  float *my_valid = smem + l.my_valid, *red = smem + l.red;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ds = k2::vec_stride(D), jc = k2::c_cols(J), dv = ds / 4, cs = JT + 1;
  const Segs sg{T, P, L};
  const int nseg = S * P, seg0 = rank * G;
  const int mine = (seg0 + G < nseg ? seg0 + G : nseg) - seg0;   // >= 1 by the plan
  const int R0 = sg.start(seg0), nrows = sg.end(seg0 + mine - 1) - R0;
  const int nblk = (nrows + RB - 1) / RB;
  const size_t ex = (size_t)n * S * T;   // the example's first row
  const float* hx = h + (ex + R0) * D;   // this CTA's first row
  const float* cmx = cm + ex + R0;
  const float* qn = q + (size_t)n * J * D;
  const int dc = (D + C - 1) / C, d0 = rank * dc;   // this CTA's slice of D for ctx and q~
  const int dw = d0 < D ? (d0 + dc < D ? dc : D - d0) : 0;
  // each own segment's V row: in shared memory (stride ds), or on the global
  // route in this CTA's rows of the scratch (stride D)
  float* const Vp = GLOBAL ? vscr + (size_t)blockIdx.x * G * D : V;
  const int vld = GLOBAL ? D : ds;

  // (0) cp.async group 1: the question side (w_x as column 0 and q's rows as
  // columns 1..J of C's right-hand side, w_y, w_xy, q's mask, q's columns of
  // this CTA's slice of D); group 2: the first block's rows of h and of the
  // context mask. Pads are zeroed by plain stores. With qtile, the right-hand
  // side is staged one tile at a time in the loop instead.
  if (!GLOBAL && !qtile) {
    issue_rows(qs + ds, qn, J, D, ds, vec & 2);
    for (int c = tid; c < D; c += THREADS) cp_async4(qs + c, wx + c);
    for (int i = tid; i < J * dw; i += THREADS)
      cp_async4(qsl + i, qn + (size_t)(i / dw) * D + d0 + i % dw);
    for (int i = tid; i < (J + 1) * (ds - D); i += THREADS)
      qs[(i / (ds - D)) * ds + D + i % (ds - D)] = 0.0f;
    for (int i = (J + 1) * ds + tid; i < jc * ds; i += THREADS) qs[i] = 0.0f;
  }
  if constexpr (!GLOBAL) {
    for (int c = tid; c < ds; c += THREADS) {
      if (c < D) {
        cp_async4(wys + c, wy + c);
        cp_async4(wxys + c, wxy + c);
      } else {
        wys[c] = 0.0f;
        wxys[c] = 0.0f;
      }
    }
  }
  for (int i = tid; i < jc; i += THREADS) {
    if (i < J) cp_async4(qmv + i, qm + (size_t)n * J + i);
    else qmv[i] = 0.0f;
  }
  cp_async_commit();
  {
    const int rows = nrows < RB ? nrows : RB;
    if constexpr (!GLOBAL) {
      for (int i = tid; i < bufs * RB * (ds - D); i += THREADS)
        hbuf[(i / (ds - D)) * ds + D + i % (ds - D)] = 0.0f;
      issue_rows(hbuf, hx, rows, D, ds, vec & 1);
    }
    for (int r = tid; r < rows; r += THREADS) cp_async4(cmv + r, cmx + r);
  }
  cp_async_commit();
  for (int i = tid; i < WARPS * jc; i += THREADS) wqmx[i] = -INFINITY;
  for (int i = tid; i < G * vld; i += THREADS) Vp[i] = 0.0f;
  cp_async_wait<1>();   // the question side has landed
  __syncthreads();
  // sy = <wy, q_j> (summed in double, one rounding) and q_j * w_xy in place
  // (q's rows are columns 1..J of the right-hand side), one warp a word, a
  // float4 of columns a lane
  for (int j = warp; j < J; j += WARPS) {
    double p = 0.0;
    if (qtile) {
      for (int c = lane; c < D; c += 32)
        p = __fma_rn((double)qn[(size_t)j * D + c], (double)(GLOBAL ? wy[c] : wys[c]), p);
    } else {
      float4* row = reinterpret_cast<float4*>(qs + (j + 1) * ds);
      for (int c = lane; c < dv; c += 32) {
        float4 v = row[c];
        const float4 y = reinterpret_cast<const float4*>(wys)[c];
        const float4 w = reinterpret_cast<const float4*>(wxys)[c];
        p = __fma_rn((double)v.x, (double)y.x, p);
        p = __fma_rn((double)v.y, (double)y.y, p);
        p = __fma_rn((double)v.z, (double)y.z, p);
        p = __fma_rn((double)v.w, (double)y.w, p);
        v.x *= w.x;
        v.y *= w.y;
        v.z *= w.z;
        v.w *= w.w;
        row[c] = v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) sy[j] = (float)p;
  }

  const int rp = tid / 16, jq = tid % 16;   // C pass: rows rp, rp + 16; columns jq, jq + 16
  for (int b = 0; b < nblk; ++b) {
    const int r0 = b * RB, nr = nrows - r0 < RB ? nrows - r0 : RB;
    const int buf = bufs == 2 ? (b & 1) : 0;
    float* hs = hbuf + buf * RB * ds;
    float* cmb = cmv + buf * RB;
    if (bufs == 2) {
      if (b + 1 < nblk) {
        const int left = nrows - r0 - RB, rows = left < RB ? left : RB;
        issue_rows(hbuf + (buf ^ 1) * RB * ds, hx + (size_t)(r0 + RB) * D, rows, D, ds,
                   vec & 1);
        for (int r = tid; r < rows; r += THREADS)
          cp_async4(cmv + (buf ^ 1) * RB + r, cmx + r0 + RB + r);
      }
      cp_async_commit();   // an empty group on the last block keeps the count uniform
      cp_async_wait<1>();
    } else {
      if (b > 0) {
        if constexpr (!GLOBAL) issue_rows(hs, hx + (size_t)r0 * D, nr, D, ds, vec & 1);
        for (int r = tid; r < nr; r += THREADS) cp_async4(cmb + r, cmx + r0 + r);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();

    // (a) per pass of 32 rows and tile of 32 columns of C: the dot products in
    // register tiles (dot_pass), then one warp per row: the running max over
    // valid words, the ctx-masked question-side maxima (per warp); after the
    // last tile E and the raw score into time_attn
    for (int st = 0; st < nr; st += SUB) {
      for (int ct = 0; ct < jc; ct += JT) {
        if (!GLOBAL && qtile) {   // columns [ct, ct + JT) of the right-hand side
          __syncthreads();
          for (int i = tid; i < JT * ds; i += THREADS) {   // w_x, and zeros past J
            const int col = ct + i / ds, c = i % ds;
            if (col == 0 || col > J) qs[i] = col == 0 && c < D ? wx[c] : 0.0f;
          }
          const int lo = ct == 0 ? 1 : ct, hi = ct + JT < J + 1 ? ct + JT : J + 1;
          if (hi > lo) {
            issue_rows(qs + (lo - ct) * ds, qn + (size_t)(lo - 1) * D, hi - lo, D, ds, vec & 2);
            for (int i = tid; i < (hi - lo) * (ds - D); i += THREADS)
              qs[(lo - ct + i / (ds - D)) * ds + D + i % (ds - D)] = 0.0f;
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          for (int i = (lo - ct) * ds + tid; i < (hi - ct) * ds; i += THREADS)
            qs[i] *= wxys[i % ds];
          __syncthreads();
        }
        if constexpr (GLOBAL) {
          dot_pass_global(hx + (size_t)(r0 + st) * D, nr - st, qn, wx, wxy, J, D, ct, cbuf,
                          cs, rp, jq);
        } else {
          const float* qb = qs + (qtile ? 0 : ct) * ds;
          dot_pass(hs + st * ds, qb, ds, cbuf, cs, rp, jq);
        }
        __syncthreads();
        for (int r = warp; r < SUB && st + r < nr; r += WARPS) {
          const int rl = st + r, j = ct + lane - 1;   // this lane's word (column 0 is w_x)
          const float cmr = cmb[rl];
          const float* crow = cbuf + r * cs;
          const float sx = ct == 0 ? crow[0] : sxr[r];
          float emax = -INFINITY;
          if (j >= 0 && j < J) {
            const float c = (float)(((double)crow[lane] + sx) + sy[j]);
            emax = c + (1.0f - qmv[j]) * NEG;
            float* w = wqmx + warp * jc + j;
            *w = fmaxf(*w, c + (1.0f - cmr) * NEG);
          }
          emax = warp_max(emax);
          if (lane == 0) {
            if (ct > 0) emax = fmaxf(emax, rowmax[r]);
            sxr[r] = sx;
            rowmax[r] = emax;
            if (ct + JT >= jc) {
              const float e = emax + (1.0f - cmr) * NEG;
              eb[rl] = e;
              ta[ex + R0 + r0 + rl] = e;   // raw score; normalised at the end
            }
          }
        }
        __syncthreads();
      }
    }

    // (b) the time softmax of each segment in this block, one warp a segment:
    // the block's max, p = exp(E - m) in place of E, the denominator; a segment
    // that began in an earlier block is rescaled once
    const int xb = R0 + r0;
    const int ga = sg.of(xb) - seg0, gb = sg.of(xb + nr - 1) - seg0;
    for (int g = ga + warp; g <= gb; g += WARPS) {
      const int seg = seg0 + g;
      const int lo = (sg.start(seg) > xb ? sg.start(seg) : xb) - xb;
      const int hi = (sg.end(seg) < xb + nr ? sg.end(seg) : xb + nr) - xb;
      float mb = -INFINITY, cmm = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) {
        mb = fmaxf(mb, eb[r]);
        cmm = fmaxf(cmm, cmb[r]);
      }
      mb = warp_max(mb);
      cmm = warp_max(cmm);
      const bool first = sg.start(seg) >= xb;
      const float m_new = first ? mb : fmaxf(sm[g], mb);
      const float scale = first ? 0.0f : expf(sm[g] - m_new);
      float psum = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) {
        const float p = expf(eb[r] - m_new);
        eb[r] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        sden[g] = first ? psum : fmaf(sden[g], scale, psum);
        scm[g] = first ? cmm : fmaxf(scm[g], cmm);
        sm[g] = m_new;
        sscale[g] = scale;
      }
    }
    __syncthreads();

    // (c) V = V * scale + p . h over the block's rows of each segment, a float4
    // of columns a thread (on the global route a column), rows in order
    if constexpr (GLOBAL) {
      for (int i = tid; i < (gb - ga + 1) * D; i += THREADS) {
        const int g = ga + i / D, c = i % D, seg = seg0 + g;
        const int lo = (sg.start(seg) > xb ? sg.start(seg) : xb) - xb;
        const int hi = (sg.end(seg) < xb + nr ? sg.end(seg) : xb + nr) - xb;
        float* vp = Vp + (size_t)g * D + c;
        float a = *vp;
        a *= sscale[g];
        for (int r = lo; r < hi; ++r) a = fmaf(eb[r], __ldg(hx + (size_t)(r0 + r) * D + c), a);
        *vp = a;
      }
    }
    for (int i = tid; i < (GLOBAL ? 0 : (gb - ga + 1) * dv); i += THREADS) {
      const int g = ga + i / dv, c = 4 * (i % dv), seg = seg0 + g;
      const int lo = (sg.start(seg) > xb ? sg.start(seg) : xb) - xb;
      const int hi = (sg.end(seg) < xb + nr ? sg.end(seg) : xb + nr) - xb;
      float4* vp = reinterpret_cast<float4*>(V + g * ds + c);
      const float sc = sscale[g];
      float4 a = *vp;
      a.x *= sc;
      a.y *= sc;
      a.z *= sc;
      a.w *= sc;
      for (int r = lo; r < hi; ++r) {
        const float p = eb[r];
        const float4 hv = *reinterpret_cast<const float4*>(hs + r * ds + c);
        a.x = fmaf(p, hv.x, a.x);
        a.y = fmaf(p, hv.y, a.y);
        a.z = fmaf(p, hv.z, a.z);
        a.w = fmaf(p, hv.w, a.w);
      }
      *vp = a;
    }
    __syncthreads();   // the buffers are free for the next copy
  }
  for (int j = tid; j < J; j += THREADS) {
    float v = -INFINITY;
    for (int w = 0; w < WARPS; ++w) v = fmaxf(v, wqmx[w * jc + j]);
    qmx[j] = v;
  }
  cluster_arrive();   // publish sm, sden, scm, V and qmx to the cluster
  cluster_wait();

  // (d) the softmax over sequences, read in segment order from the CTAs that
  // hold them: warp 0 takes max_s g and sum_s exp(g - max), every CTA the same
  // bits; warp 1 the question side over the CTAs' maxima in rank order
  auto remote = [&](size_t off, int seg) -> float {
    return *cluster.map_shared_rank(smem + off + seg % G, seg / G);
  };
  // max over chunks of sequence s of E's maximum, and its context flag, the
  // chunks read four at a time (an index past the last chunk repeats it: a
  // max takes a repeat unchanged)
  auto seq_max = [&](int s, float* valid) -> float {
    float m = -INFINITY, c = 0.0f;
    for (int k0 = 0; k0 < P; k0 += 4) {
      float mk[4], ck[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int seg = s * P + (k0 + k < P ? k0 + k : P - 1);
        mk[k] = remote(l.sm, seg);
        ck[k] = remote(l.scm, seg);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m = fmaxf(m, mk[k]);
        c = fmaxf(c, ck[k]);
      }
    }
    *valid = c > 0.5f ? 1.0f : 0.0f;
    return m;
  };
  if (warp == 0) {
    float gmax = -INFINITY, valid, g_lane = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float m = seq_max(s, &valid);
      const float g = m + (1.0f - valid) * NEG;
      if (s == lane) g_lane = g;
      gmax = fmaxf(gmax, g);
    }
    gmax = warp_max(gmax);
    float gsum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      float g = g_lane;
      if (s != lane) {
        const float m = seq_max(s, &valid);
        g = m + (1.0f - valid) * NEG;
      }
      gsum += expf(g - gmax);
    }
    gsum = warp_sum(gsum);
    if (lane == 0) {
      red[0] = gmax;
      red[1] = gsum;
    }
  } else if (warp == 1) {
    float mx = -INFINITY;
    for (int j = lane; j < J; j += 32) {
      float v = -INFINITY;
      for (int r0 = 0; r0 < C; r0 += 4) {
        float vr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          vr[k] = *cluster.map_shared_rank(qmx + j, r0 + k < C ? r0 + k : C - 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) v = fmaxf(v, vr[k]);
      }
      v = v + (1.0f - qmv[j]) * NEG;
      wq[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < J; j += 32) {
      const float e = expf(wq[j] - mx);
      wq[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < J; j += 32) wq[j] = wq[j] / sum;
  }
  __syncthreads();

  // (e) per own segment: its sequence's merged statistics (chunks in order),
  // B, the weight of its V row in ctx, the factors of its time_attn rows, and
  // seq_attn from the CTA that holds chunk 0
  for (int g = tid; g < mine; g += THREADS) {
    const int seg = seg0 + g, s = seg / P;
    float valid;
    const float m = seq_max(s, &valid);
    float den = 0.0f;
    for (int k0 = 0; k0 < P; k0 += 4) {
      float dk[4], mk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int seg = s * P + (k0 + k < P ? k0 + k : P - 1);
        dk[k] = remote(l.sden, seg);
        mk[k] = remote(l.sm, seg);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k0 + k < P) den = fmaf(dk[k], expf(mk[k] - m), den);
    }
    const float b = expf(m + (1.0f - valid) * NEG - red[0]) / red[1];
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    wsl[g] = b * inv * expf(sm[g] - m);
    my_m[g] = m;
    my_inv[g] = inv;
    my_valid[g] = valid;
    if (seg % P == 0) sa[(size_t)n * S + s] = valid > 0.5f ? b : 0.0f;
  }
  __syncthreads();

  // (f) this CTA's partial context over its own V rows (segments in order),
  // each column into slot `rank` of the CTA that owns its slice of D; and q~
  // for this CTA's slice
  for (int c = tid; c < D; c += THREADS) {
    float a = 0.0f;
    for (int g = 0; g < mine; ++g) a = fmaf(wsl[g], Vp[g * vld + c], a);
    *cluster.map_shared_rank(pcs + rank * dc + c % dc, c / dc) = a;
  }
  for (int i = tid; i < dw; i += THREADS) {
    float a = 0.0f;
    for (int j = 0; j < J; ++j)
      a = fmaf(wq[j], qtile ? qn[(size_t)j * D + d0 + i] : qsl[j * dw + i], a);
    qatt[(size_t)n * D + d0 + i] = a;
  }
  cluster_arrive();   // publish pcs
  cluster_wait();

  // (g) ctx for this CTA's slice of D: the CTAs' partials summed in rank order
  for (int i = tid; i < dw; i += THREADS) {
    float a = 0.0f;
    for (int r = 0; r < C; ++r) a += pcs[r * dc + i];
    ctx[(size_t)n * D + d0 + i] = a;
  }
  // (h) this CTA's rows of time_attn, from the raw scores. No CTA reads
  // another's shared memory after the barrier above, so each leaves on its own.
  for (int i = tid; i < nrows; i += THREADS) {
    const int x = R0 + i, g = sg.of(x) - seg0;
    const size_t idx = ex + x;
    ta[idx] = my_valid[g] > 0.5f ? expf(ta[idx] - my_m[g]) * my_inv[g] : 0.0f;
  }
}

// The kernel's attributes, set once per device: the dynamic shared-memory limit
// (the card's opt-in maximum) and clusters past the portable 8.
int prepare_device(int dev) {
  static std::mutex mu;
  static bool done[64] = {false};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return 0;
  int smem_max = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* kernels[2] = {(const void*)k2_cluster_kernel<false>,
                            (const void*)k2_cluster_kernel<true>};
  for (const void* kernel : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

cudaLaunchConfig_t launch_config(int grid, int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

constexpr int CLUSTER_UNSCHEDULABLE = -1;

}  // namespace

extern "C" {

long long fvta_fwd_serial_smem_bytes(int s, int j, int d) {
  return (long long)serial::layout(s, j, d).total;
}

const char* fvta_fwd_error_string(int err) {
  if (err == CLUSTER_UNSCHEDULABLE)
    return "no cluster of K2 can be scheduled (cudaOccupancyMaxActiveClusters = 0)";
  return cudaGetErrorString((cudaError_t)err);
}

// The serial K2. Returns the cudaError_t of the launch (0 = success).
int fvta_fwd_serial(const float* h, const float* cm, const float* q, const float* qm,
                    const float* wx, const float* wy, const float* wxy, float* ctx,
                    float* qatt, float* ta, float* sa, int n, int s, int t, int j, int d,
                    void* stream) {
  const size_t smem = serial::layout(s, j, d).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(serial::fvta_fwd_serial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  serial::fvta_fwd_serial_kernel<<<n, serial::THREADS, smem, (cudaStream_t)stream>>>(
      h, cm, q, qm, wx, wy, wxy, ctx, qatt, ta, sa, s, t, j, d);
  return (int)cudaGetLastError();
}

static int geometry(int n, int s, int t, int j, int d, bool force_global, long long* out) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int err = prepare_device(dev);
  if (err != 0) return err;
  bool found = false;
  for (int cmax = k2::MAX_CLUSTER; cmax >= 1; cmax /= 2) {
    const k2::Plan p = k2::plan(n, s, t, j, d, sms, (size_t)smem_max, cmax, force_global);
    if (p.smem > (size_t)smem_max) {
      if (found) break;
      out[7] = (long long)p.smem;
      return (int)cudaErrorInvalidConfiguration;
    }
    if (p.route && found && !force_global) break;   // a staged plan runs at a larger cap
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(p.cluster, p.cluster, p.smem, 0, attr);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(
        &active, (const void*)(p.route ? k2_cluster_kernel<true> : k2_cluster_kernel<false>),
        &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not sticky: try a smaller cluster
      continue;
    }
    if (active < 1) continue;
    const long long v[13] = {p.cluster, p.chunks, p.chunk_len, p.segs, p.rows, p.bufs,
                             p.qtile, (long long)p.smem, active, sms, cmax, p.route,
                             (long long)k2::v_scratch(p, n, d)};
    for (int i = 0; i < 13; ++i) out[i] = v[i];
    found = true;
    if (n <= active) break;   // one wave
  }
  return found ? 0 : CLUSTER_UNSCHEDULABLE;
}

// K2's geometry on the current device: out = {cluster, chunks per sequence,
// chunk length, segments per CTA, rows per block, buffers, q in tiles (0/1),
// shared memory per CTA (bytes), clusters the card holds at once, SMs, the
// cluster cap the plan was made with, route (0 staged, 1 global), floats of the
// global route's V scratch}. The plan (fvta_fwd.cuh) is tried with a cap of 16,
// then 8, 4, 2, 1; the first whose N clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) is taken, else the last schedulable one; a
// global plan is taken only where no cap gives a staged one. Returns 0, a
// cudaError_t, cudaErrorInvalidConfiguration where the shape needs more shared
// memory than a CTA has even on the global route, or CLUSTER_UNSCHEDULABLE.
int fvta_fwd_geometry(int n, int s, int t, int j, int d, long long* out) {
  return geometry(n, s, t, j, d, false, out);
}

// fvta_fwd_geometry with the global route forced at any width: no package path
// asks for it; the card tests hold the two routes against each other with it.
int fvta_fwd_geometry_global(int n, int s, int t, int j, int d, long long* out) {
  return geometry(n, s, t, j, d, true, out);
}

// K2. cluster .. route are the geometry fvta_fwd_geometry gave for this shape
// on the current device, read once by the caller and passed back unchanged, so
// a launch queries nothing; vscr holds the geometry's V scratch floats (unused,
// may be null, on the staged route). Returns the cudaError_t of the launch (0 =
// success).
int fvta_fwd(const float* h, const float* cm, const float* q, const float* qm, const float* wx,
             const float* wy, const float* wxy, float* ctx, float* qatt, float* ta, float* sa,
             float* vscr, int n, int s, int t, int j, int d, int cluster, int chunks,
             int chunk_len, int segs, int rows, int bufs, int qtile, long long smem, int route,
             void* stream) {
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  const int err = prepare_device(dev);
  if (err != 0) return err;
  const bool d4 = d % 4 == 0;
  const int vec = (d4 && reinterpret_cast<uintptr_t>(h) % 16 == 0 ? 1 : 0) |
                  (d4 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 2 : 0);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(n * cluster, cluster, (size_t)smem, (cudaStream_t)stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, route ? k2_cluster_kernel<true> : k2_cluster_kernel<false>, h, cm, q, qm, wx, wy,
      wxy, ctx, qatt, ta, sa, vscr, s, t, j, d, cluster, chunks, chunk_len, segs, rows, bufs,
      qtile, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
