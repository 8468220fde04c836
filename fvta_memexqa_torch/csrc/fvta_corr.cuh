// The FVTA correlation C[s,t,j] = <wx,h> + <wy,q_j> + (h*wxy).q_j, computed the
// same way, bit for bit, by every kernel that recomputes it: K4 (fvta_stats.cu)
// emits eq = max over (s,t) of the ctx-masked C, and K5/K6 (fvta_bwd.cu) find
// the positions that reach eq by EXACT float equality with their own
// recomputed C. A different rounding anywhere (an FMA contracted in one kernel
// and not in another, another summation order) would make K5 count no tie,
// and max(qcnt, 1) would then silently drop geq's gradient. So every product
// and sum here is an explicit round-to-nearest intrinsic in a fixed serial
// order, which nvcc may neither contract nor reorder.
//
// Layout shared by K4, K5 and the two-pass K6: a time chunk of TCH rows of h is staged
// in shared memory twice (raw, and times wxy), and question rows in tiles of
// QT = 32 (one per lane), all with an odd row stride so that 32 lanes reading
// 32 rows at one column hit 32 banks.

#pragma once

#include <cuda_runtime.h>

namespace fvta {

constexpr float NEG = -1e30f;
constexpr int TCH = 32;   // time steps per chunk (one block's rows)
constexpr int QT = 32;    // question words per tile (one per lane)

__host__ __device__ inline int odd_stride(int d) { return d | 1; }

// sum_d a[d] * b[d], serial from d = 0 with round-to-nearest fused multiply-adds.
__device__ __forceinline__ float serial_dot(const float* a, const float* b, int d) {
  float acc = 0.0f;
  for (int i = 0; i < d; ++i) acc = __fmaf_rn(a[i], b[i], acc);
  return acc;
}

// serial_dot for a 2 x 2 tile of (row, question word) pairs, the register-tiled
// form K6 computes C with: out[a][b] = serial_dot(a_a, b_b, D) bit for bit, and
// with SX also sx = serial_dot(xs, wxs, D). The invariant every kernel keeps: an
// element's chain starts at 0 and takes its terms one __fmaf_rn at a time in the
// order d = 0, 1, ..., D-1; only the thread mapping and the loads may change.
// Here each float4 load feeds four chains, and each chain takes the float4's 4
// terms in order. The rows are 16-byte aligned and zero-padded from D to d4, a
// multiple of 4: a padded term adds __fmaf_rn(0, 0, acc) = acc (acc is never -0:
// it starts at +0, and a zero sum rounds to +0), so the padding changes no bit.
template <bool SX>
__device__ __forceinline__ void serial_dot_2x2(const float* a0, const float* a1,
                                               const float* b0, const float* b1, int d4,
                                               float out[2][2], const float* xs = nullptr,
                                               const float* wxs = nullptr,
                                               float* sx = nullptr) {
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f, cx = 0.0f;
  for (int i = 0; i < d4; i += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + i);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + i);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + i);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + i);
    const float xa[4] = {x0.x, x0.y, x0.z, x0.w}, xb[4] = {x1.x, x1.y, x1.z, x1.w};
    const float ya[4] = {y0.x, y0.y, y0.z, y0.w}, yb[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c00 = __fmaf_rn(xa[k], ya[k], c00);
      c01 = __fmaf_rn(xa[k], yb[k], c01);
      c10 = __fmaf_rn(xb[k], ya[k], c10);
      c11 = __fmaf_rn(xb[k], yb[k], c11);
    }
    if constexpr (SX) {
      const float4 u = *reinterpret_cast<const float4*>(xs + i);
      const float4 w = *reinterpret_cast<const float4*>(wxs + i);
      cx = __fmaf_rn(u.x, w.x, cx);
      cx = __fmaf_rn(u.y, w.y, cx);
      cx = __fmaf_rn(u.z, w.z, cx);
      cx = __fmaf_rn(u.w, w.w, cx);
    }
  }
  out[0][0] = c00;
  out[0][1] = c01;
  out[1][0] = c10;
  out[1][1] = c11;
  if constexpr (SX) *sx = cx;
}

// C from the staged row hw = h*wxy, the question row q_j, sx = <wx,h>, sy = <wy,q_j>.
__device__ __forceinline__ float corr(const float* hw, const float* qj, float sx, float sy,
                                      int d) {
  return __fadd_rn(__fadd_rn(serial_dot(hw, qj, d), sx), sy);
}

// x + (1 - mask) * NEG, the exp_mask of the plain version.
__device__ __forceinline__ float masked(float x, float mask) {
  return __fadd_rn(x, __fmul_rn(__fsub_rn(1.0f, mask), NEG));
}

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

// Stage rows [t0, t0 + rows) of one sequence h_seq [T, D]: hs = h, hw = h*wxy
// (stride odd_stride(D)), and sx[r] = <wx, h_r>. Ends with __syncthreads().
__device__ __forceinline__ void stage_rows(const float* __restrict__ h_seq,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wxy, int t0, int rows,
                                           int D, float* hs, float* hw, float* sx) {
  const int d1 = odd_stride(D);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const float v = h_seq[(size_t)(t0 + r) * D + c];
    hs[r * d1 + c] = v;
    hw[r * d1 + c] = __fmul_rn(v, wxy[c]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) sx[r] = serial_dot(hs + r * d1, wx, D);
  __syncthreads();
}

// Stage question rows [j0, j0 + QT) of q_n [J, D] (rows past J are zero) and
// sy[l] = <wy, q_{j0+l}>. Ends with __syncthreads().
__device__ __forceinline__ void stage_qtile(const float* __restrict__ q_n,
                                            const float* __restrict__ wy, int j0, int J,
                                            int D, float* qs, float* sy) {
  const int d1 = odd_stride(D);
  for (int i = threadIdx.x; i < QT * D; i += blockDim.x) {
    const int l = i / D, c = i % D;
    qs[l * d1 + c] = (j0 + l < J) ? q_n[(size_t)(j0 + l) * D + c] : 0.0f;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < QT; l += blockDim.x) sy[l] = serial_dot(qs + l * d1, wy, D);
  __syncthreads();
}

}  // namespace fvta
