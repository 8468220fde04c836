// Bi-LSTM input projection for both directions in one launch: the first half of
// the redesigned K1 (the recurrence is lstm_rec.cu, whose library exports this
// kernel as `lstm_proj` and, with the recurrence, as `lstm_k1`).
//
// Replaces the input-projection half of the TPU kernel
// fvta_memexqa_tpu/ops/lstm_fused.py:_fwd_step_kernel, which computes x_t.Wx
// inside its serial step (lstm_fused.py:104). That product does not depend on
// h, so here it leaves the recurrence: one tiled product over all N.T positions
//   xg [N, T, 8H] = x [N.T, D] . [Wx_fw | Wx_bw] + [b_fw | b_bw]
// at the ORIGINAL time positions for both directions (the backward direction's
// recurrence reads position L-1-t itself). Column c of the 8H is direction
// c / 4H, gate column c % 4H of that direction's wx [D, 4H] (gate order i, j, f,
// o, as the model's parameters lie: no stacked copy of the weights).
//
// Design. A classic shared-memory FP32 product: a block computes a BM x BN
// tile of xg with 256 threads, each a TM x TN sub-tile in registers, walking D
// in slabs of BK; the next A/B slabs are loaded into registers while the
// current ones are multiplied. Every output is one fmaf chain over k = 0..D-1
// in order, then + b: deterministic, full FP32. (3xTF32 on the tensor cores was
// tried and dropped: with a fresh accumulator per k = 8 step it still stayed
// ~2e-6 from the plain product at D = 200, beyond 1e-6, since the tensor cores
// align each sum to its largest product and drop the bits below; plain TF32
// keeps ~3 digits.) A tile whose BM positions all lie at or past their rows'
// lengths is skipped (the recurrences never read those positions). The tile
// shapes and the rule between them: `launch` below.
//
// Group axis (ops/lstm_fused.bilstm_fused_grouped): blockIdx.z = m walks K
// bi-LSTMs over one shared batch, each with its own x [N, T, D], lengths [N]
// and xg [N, T, 8H], stacked one after another, and its weights wx_ms / b_ms
// elements past the previous one's in both directions. A grouped launch is K
// launches' work with the same per-output sums; K = 1 is the plain call, and
// launches the instantiation without the offsets (GROUPED = false: the code
// and registers of the kernel before the group axis).
//
// BF16 = true is the bf16 activation variant (ModelConfig.dtype = "bfloat16";
// the JAX package's lstm_ref.lstm_scan_ref(dtype=bfloat16)): x and the weights
// arrive as float32 holding bf16 values, the product still accumulates in
// float32, and x.Wx + b is rounded to bf16 (round to nearest even) before the
// store, as the JAX scan casts x_proj. Storage stays float32. One bi-LSTM only
// (no group axis).
//
// Bound on the H100: 2.D.8H FLOPs per valid position against 4.(D + 8H) bytes,
// about 80 FLOP/B at D = 200, H = 100, so FP32 throughput (67 TFLOP/s) bounds it,
// not HBM. What the design does about it: register tiles of up to 8 x 4 (three
// float4 loads of shared memory feed 32 FMAs), and no work on dead tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lproj {

constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BM, int BN, int BK, int TM, int TN, bool GROUPED, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
lstm_proj_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                 const float* __restrict__ wx_fw, const float* __restrict__ wx_bw,
                 const float* __restrict__ b_fw, const float* __restrict__ b_bw,
                 float* __restrict__ xg, int M, int T, int D, int H, long long wx_ms,
                 long long b_ms) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one sub-tile per thread");
  constexpr int A_PER = BM * BK / THREADS;   // slab elements each thread loads
  constexpr int B_PER = BK * BN / THREADS;
  // A slab, k-major (x transposed); +4 keeps the transposing stores off one bank
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int G4 = 4 * H, G8 = 8 * H;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (GROUPED) {
    const size_t g = blockIdx.z;   // the group's inputs and outputs
    x += g * M * D;
    lengths += g * (M / T);
    xg += g * M * G8;
    wx_fw += g * wx_ms;
    wx_bw += g * wx_ms;
    b_fw += g * b_ms;
    b_bw += g * b_ms;
  }

  // skip a tile of positions that are all past their rows' lengths
  int live = 0;
  for (int i = tid; i < BM; i += THREADS) {
    const int m = m0 + i;
    if (m < M) live |= (m % T) < lengths[m / T];
  }
  if (!__syncthreads_or(live)) return;

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  // a thread's TN columns are TN/4 float4 groups BN*4/TN apart, so the lanes of
  // a quarter-warp read 32 consecutive floats of Bs
  auto col = [&](int j) { return (j / 4) * (BN * 4 / TN) + tx * 4; };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      const int idx = tid + e * THREADS;
      const int m = m0 + idx / BK, k = k0 + idx % BK;
      a_reg[e] = (m < M && k < D) ? x[(size_t)m * D + k] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int idx = tid + e * THREADS;
      const int k = k0 + idx / BN, c = n0 + idx % BN;
      float v = 0.0f;
      if (k < D && c < G8) {
        v = c < G4 ? wx_fw[(size_t)k * G4 + c] : wx_bw[(size_t)k * G4 + (c - G4)];
      }
      b_reg[e] = v;
    }
  };
  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      const int idx = tid + e * THREADS;
      As[idx % BK][idx / BK] = a_reg[e];
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int idx = tid + e * THREADS;
      Bs[idx / BN][idx % BN] = b_reg[e];
    }
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);   // in flight while this slab multiplies
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[k][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[k][col(j)]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // + b, store (8H is a multiple of 8 and c of 4: a float4 is in bounds whole)
#pragma unroll
  for (int j = 0; j < TN; j += 4) {
    const int c = n0 + col(j);
    if (c >= G8) continue;
    float bias[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[q] = c + q < G4 ? b_fw[c + q] : b_bw[c + q - G4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
      const float4 v = make_float4(acc[i][j] + bias[0], acc[i][j + 1] + bias[1],
                                   acc[i][j + 2] + bias[2], acc[i][j + 3] + bias[3]);
      if constexpr (BF16) {
        *reinterpret_cast<float4*>(xg + (size_t)m * G8 + c) =
            make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
      } else {
        *reinterpret_cast<float4*>(xg + (size_t)m * G8 + c) = v;
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, bool BF16>
inline int launch_tiles(const float* x, const int* lengths, const float* wx_fw,
                        const float* wx_bw, const float* b_fw, const float* b_bw, float* xg,
                        int M, int T, int D, int H, int k, long long wx_ms, long long b_ms,
                        cudaStream_t stream) {
  const dim3 grid((8 * H + BN - 1) / BN, (M + BM - 1) / BM, k);
  const auto kernel = k > 1 ? lstm_proj_kernel<BM, BN, BK, TM, TN, true, false>
                            : lstm_proj_kernel<BM, BN, BK, TM, TN, false, BF16>;
  kernel<<<grid, THREADS, 0, stream>>>(x, lengths, wx_fw, wx_bw, b_fw, b_bw, xg, M, T, D, H,
                                       wx_ms, b_ms);
  return (int)cudaGetLastError();
}

// xg [N, T, 8H] from x [N, T, D]: 128 x 64 tiles (8 x 4 per thread, slabs of
// 16) from about half a tile per SM on, else 64 x 64 (4 x 4, slabs of 16). Of
// eight tile shapes timed on the H100 at the repo's bi-LSTM shapes (128 x 128
// with slabs of 8 or 16 and 1 or 2 blocks per SM, 128 x 64, 64 x 128, 64 x 64
// with slabs of 16 or 32), these two were the fastest on their sides of the
// threshold (PERF.md), the tiles of all k groups counted. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for BF16 with k > 1).
template <bool BF16>
inline int launch(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
                  const float* b_fw, const float* b_bw, float* xg, int n, int t, int d, int h,
                  int k, long long wx_ms, long long b_ms, void* stream) {
  const int M = n * t;
  const long long tall_tiles = (long long)k * ((M + 127) / 128) * ((8 * h + 63) / 64);
  cudaStream_t s = (cudaStream_t)stream;
  if (BF16 && k > 1) return (int)cudaErrorInvalidValue;
  if (tall_tiles >= 66) {
    return launch_tiles<128, 64, 16, 8, 4, BF16>(x, lengths, wx_fw, wx_bw, b_fw, b_bw, xg, M,
                                                 t, d, h, k, wx_ms, b_ms, s);
  }
  return launch_tiles<64, 64, 16, 4, 4, BF16>(x, lengths, wx_fw, wx_bw, b_fw, b_bw, xg, M, t, d,
                                              h, k, wx_ms, b_ms, s);
}

}  // namespace lproj
