// The device code shared by the first port's row-tile grouped LSTM scans, kept
// beside the Hopper K7 and K8 (lstm_gscan.cuh) as lstm_grouped_rowtile
// (lstm_grouped.cu) and lstm_stream_rowtile (lstm_stream.cu); no path calls
// them. Both compute, for G independent scans over a precomputed
// x_proj [G, N, T, 4H], gates = x_proj[t] + h.Wh in (i, j, f, o) order, the TF1
// cell with forget_bias inside the sigmoid, and prefix-length masking (at t >= L
// a row's h and c stop updating and its output is 0), writing out [G, N, T, H]
// and fin [G, N, H] (the last carried h). They differ only in how x_proj[t]
// reaches the gate phase and in their shared-memory layouts.
//
// A block owns a tile of ROWS rows of one group (grid (ceil(N / ROWS), G)) and
// walks t. In shared memory: Wh [H][4H] resident for the whole scan, h [H][ROWS]
// (so one k is two float4 broadcasts), c [ROWS][H] and the step's gates
// [ROWS][4H]. Every sum runs in a fixed order and there are no atomics, so the
// result is deterministic.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lstm_scan {

constexpr int ROWS = 8;  // batch rows per block (two float4 of h per k)

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

// The tile's lengths into len_s (0 for rows past n); returns the longest, capped
// at T. Ends with a barrier.
__device__ __forceinline__ int load_lengths(int* len_s, const int* __restrict__ lengths,
                                            size_t grow0, int row0, int n, int T, int tid) {
  if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[grow0 + tid] : 0;
  __syncthreads();
  int max_len = 0;
  for (int r = 0; r < ROWS; ++r) max_len = max(max_len, len_s[r]);
  return min(max_len, T);
}

// acc[r] = sum_k h[r][k] . Wh[k][col] for the tile's ROWS rows, k from 0 up.
__device__ __forceinline__ void gate_acc(float (&acc)[ROWS], const float* whs,
                                         const float* hs, int col, int G4, int H) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float w = whs[k * G4 + col];
    const float4 z0 = *reinterpret_cast<const float4*>(hs + k * ROWS);
    const float4 z1 = *reinterpret_cast<const float4*>(hs + k * ROWS + 4);
    acc[0] = fmaf(z0.x, w, acc[0]); acc[1] = fmaf(z0.y, w, acc[1]);
    acc[2] = fmaf(z0.z, w, acc[2]); acc[3] = fmaf(z0.w, w, acc[3]);
    acc[4] = fmaf(z1.x, w, acc[4]); acc[5] = fmaf(z1.y, w, acc[5]);
    acc[6] = fmaf(z1.z, w, acc[6]); acc[7] = fmaf(z1.w, w, acc[7]);
  }
}

// Step t's TF1 cell for the tile, threads over (row, unit): live rows update c
// and h and write h to out[t]; rows past their length write 0.
__device__ __forceinline__ void cell_step(const float* gates, float* hs, float* cs,
                                          const int* len_s, float* __restrict__ out,
                                          size_t grow0, int row0, int n, int T, int t,
                                          int H, float forget_bias, int tid, int nt) {
  const int G4 = 4 * H;
  for (int i = tid; i < ROWS * H; i += nt) {
    const int r = i / H, k = i % H;
    if (row0 + r >= n) continue;
    const size_t o = ((grow0 + r) * T + t) * H + k;
    if (t < len_s[r]) {
      const float* gr = gates + r * G4;
      const float c = cs[i] * sigmoid_(gr[2 * H + k] + forget_bias) +
                      sigmoid_(gr[k]) * tanhf(gr[H + k]);
      const float hh = tanhf(c) * sigmoid_(gr[3 * H + k]);
      cs[i] = c;
      hs[k * ROWS + r] = hh;
      out[o] = hh;
    } else {
      out[o] = 0.0f;
    }
  }
}

// After the last step (and a barrier): zero out[max_len:] and write fin.
__device__ __forceinline__ void finish(const float* hs, float* __restrict__ out,
                                       float* __restrict__ fin, size_t grow0, int row0,
                                       int n, int T, int max_len, int H, int tid, int nt) {
  const size_t tail = (size_t)(T - max_len) * H;
  for (size_t i = tid; i < (size_t)ROWS * tail; i += nt) {
    const int r = (int)(i / tail);
    if (row0 + r < n) out[((grow0 + r) * T + max_len) * H + i % tail] = 0.0f;
  }
  for (int i = tid; i < ROWS * H; i += nt) {
    const int r = i / H, k = i % H;
    if (row0 + r < n) fin[(grow0 + r) * H + k] = hs[k * ROWS + r];
  }
}

using Kernel = void (*)(const float*, const int*, const float*, float*, float*, int, int,
                        int, float);

// Launch `kernel` with `smem` bytes of dynamic shared memory: one block per
// (tile, group), one thread per gate column (a warp multiple in [64, 1024]).
// Returns the cudaError_t of the launch (0 = success).
inline int launch(Kernel kernel, size_t smem, const float* x_proj, const int* lengths,
                  const float* wh, float* out, float* fin, int g, int n, int t, int h,
                  float forget_bias, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((4 * h + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  const dim3 grid((n + ROWS - 1) / ROWS, g);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x_proj, lengths, wh, out, fin, n, t, h,
                                                        forget_bias);
  return (int)cudaGetLastError();
}

}  // namespace lstm_scan
