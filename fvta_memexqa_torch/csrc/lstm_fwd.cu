// Fused bi-LSTM forward (TF1 BasicLSTMCell numerics), both directions in one launch.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_fwd_step_kernel
// (launched by _fused_scan). Same function: gates = x_t.Wx + h.Wh + b with the
// input projection inside the kernel, gate order (i, j, f, o), forget_bias added
// inside the cell, prefix-length masking (past a row's length h and c stop
// updating and the output is 0), fin = the last carried h (0 for a length-0 row),
// an optional per-step output, and an optional per-step cell state (the carried c,
// as emit_cell in the TPU kernel) that the backward kernel (lstm_bwd.cu) reads.
//
// Layout. x [N, T, D], lengths [N] int32, and per direction wx [D, 4H], wh [H, 4H],
// b [4H], passed as one pointer each for the forward and the backward direction
// (the model's parameters as they lie, no stacked copy). out [N, T, 2H] (forward in [:H], backward in
// [H:], both at the ORIGINAL time index), cell [N, T, 2H] in the same layout,
// and fin [N, 2H]. The backward direction reads x at L-1-t at its step t and
// writes its output and cell there, so no flipped copy of x, of the output or of
// the cells is made on the host. Past a row's length (t >= L) out is 0 and cell
// holds the carried c at position t, in both directions.
//
// Group axis (ops/lstm_fused.bilstm_fused_grouped, past the largest cluster):
// K bi-LSTMs over one shared batch in one launch, grid (tiles, 2K), block row y
// running direction y % 2 of bi-LSTM m = y / 2. Bi-LSTM m's x [N, T, D],
// lengths [N], out, cell [N, T, 2H] and fin [N, 2H] follow m - 1's (its rows
// are rows m.N .. m.N + N - 1 of the stacks); its wx, wh and b lie wx_ms,
// wh_ms and b_ms elements past m - 1's in each direction. Each group runs
// exactly the K = 1 kernel's sums. K > 1 launches lstm_fwd_grouped_kernel,
// capped at 64 registers for 1024-thread blocks; K = 1 keeps the one-bi-LSTM
// kernel's code, which the offsets would slow by ~20% under that cap.
//
// The bf16 activation variant (BF16 = true, bf16 != 0; one bi-LSTM): as
// lstm_rec.cu's, x_t.Wx + b is rounded to bf16 before h.Wh (a separate float32
// sum) is added, and c, then h, are rounded after each step's update; x and the
// weights arrive as float32 holding bf16 values.
//
// Design. One block per (tile of ROWS rows, direction); the block loops over t.
// The tile's [x_t; h] lives in shared memory as z[k][r] (k over D+H, r over the
// ROWS rows, so one k is two float4 loads), c in shared memory, and one thread
// per gate column accumulates that column for all ROWS rows, reading the weight
// column from global memory (Wx 320 KB + Wh 160 KB per direction at D=200,
// H=100: L2-resident, shared by every block). A barrier, then threads over
// (row, hidden unit) apply the cell. Sums run in a fixed order: no atomics, the
// result is deterministic.
//
// Bound on the H100. The recurrence is serial in t: every step re-reads the
// weights from L2 and does 2·(D+H)·4H·ROWS FMAs per block, so at serving shapes
// (few rows, T ≤ 30) the kernel is latency-bound on the per-step weight stream,
// far from both the HBM and the FP32 roofline. What this simple design does about
// it: the input projection is fused (x is read once from HBM, no x·Wx slab), and
// rows share each weight load. Weight residency in shared memory (Wh fits,
// Wx does not) and splitting the K loop across more threads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 8;  // batch rows per block (two float4 per k in z)

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct DirWeights {
  const float* wx[2];  // [D, 4H] per direction (0 = forward, 1 = backward)
  const float* wh[2];  // [H, 4H]
  const float* b[2];   // [4H]
};

// One block's work; GROUPED = false is the launch of one bi-LSTM, whose group
// offsets fold away (the code and registers of the kernel before the group axis).
template <bool GROUPED, bool BF16>
__device__ __forceinline__ void fwd_block(const float* __restrict__ x,
                                          const int* __restrict__ lengths, const DirWeights w,
                                          float* __restrict__ out, float* __restrict__ cell,
                                          float* __restrict__ fin, int n, int T, int D, int H,
                                          float forget_bias, long long wx_ms, long long wh_ms,
                                          long long b_ms) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int K = D + H;
  float* z = smem;                  // [K][ROWS]: x_t rows then h rows
  float* gates = z + K * ROWS;      // [ROWS][G]
  float* cst = gates + ROWS * G;    // [ROWS][H]
  __shared__ int len_s[ROWS];

  const int dir = GROUPED ? blockIdx.y & 1 : blockIdx.y;
  const int grp = GROUPED ? blockIdx.y >> 1 : 0;   // the bi-LSTM of this group
  const int mrow = grp * n;          // its first row among the stacked rows
  const int row0 = blockIdx.x * ROWS;
  const float* __restrict__ Wx = (dir ? w.wx[1] : w.wx[0]) + grp * wx_ms;
  const float* __restrict__ Wh = (dir ? w.wh[1] : w.wh[0]) + grp * wh_ms;
  const float* __restrict__ B = (dir ? w.b[1] : w.b[0]) + grp * b_ms;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t out_stride = 2 * (size_t)H;

  if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[mrow + row0 + tid] : 0;
  for (int i = tid; i < ROWS * H; i += nt) {
    const int r = i / H, k = i % H;
    z[(D + k) * ROWS + r] = 0.0f;
    cst[i] = 0.0f;
  }
  __syncthreads();
  int max_len = 0;
  for (int r = 0; r < ROWS; ++r) max_len = max(max_len, len_s[r]);

  for (int t = 0; t < T; ++t) {
    if (t >= max_len) {
      // no row of the tile is live: only the zero outputs (and the carried
      // cells) of position t remain
      if (out != nullptr || cell != nullptr) {
        for (int i = tid; i < ROWS * H; i += nt) {
          const int r = i / H, k = i % H;
          if (row0 + r >= n) continue;
          const size_t o = ((size_t)(mrow + row0 + r) * T + t) * out_stride + dir * H + k;
          if (out != nullptr) out[o] = 0.0f;
          if (cell != nullptr) cell[o] = cst[i];
        }
      }
      continue;
    }
    // 1. x rows of this step (backward direction: position L-1-t)
    for (int i = tid; i < ROWS * D; i += nt) {
      const int r = i / D, k = i % D;
      const int L = len_s[r];
      float v = 0.0f;
      if (t < L) {
        const int pos = dir == 0 ? t : L - 1 - t;
        v = x[((size_t)(mrow + row0 + r) * T + pos) * D + k];
      }
      z[k * ROWS + r] = v;
    }
    __syncthreads();
    // 2. gate pre-activations, one column per thread for all ROWS rows
    for (int col = tid; col < G; col += nt) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float w = __ldg(Wx + (size_t)k * G + col);
        const float4 z0 = *reinterpret_cast<const float4*>(z + k * ROWS);
        const float4 z1 = *reinterpret_cast<const float4*>(z + k * ROWS + 4);
        acc[0] = fmaf(z0.x, w, acc[0]); acc[1] = fmaf(z0.y, w, acc[1]);
        acc[2] = fmaf(z0.z, w, acc[2]); acc[3] = fmaf(z0.w, w, acc[3]);
        acc[4] = fmaf(z1.x, w, acc[4]); acc[5] = fmaf(z1.y, w, acc[5]);
        acc[6] = fmaf(z1.z, w, acc[6]); acc[7] = fmaf(z1.w, w, acc[7]);
      }
      float xp[ROWS];   // BF16: x_t.Wx + b rounded; h.Wh then sums from 0
      if constexpr (BF16) {
        const float bc = B[col];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          xp[r] = round_bf16(acc[r] + bc);
          acc[r] = 0.0f;
        }
      }
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(Wh + (size_t)k * G + col);
        const float4 z0 = *reinterpret_cast<const float4*>(z + (D + k) * ROWS);
        const float4 z1 = *reinterpret_cast<const float4*>(z + (D + k) * ROWS + 4);
        acc[0] = fmaf(z0.x, w, acc[0]); acc[1] = fmaf(z0.y, w, acc[1]);
        acc[2] = fmaf(z0.z, w, acc[2]); acc[3] = fmaf(z0.w, w, acc[3]);
        acc[4] = fmaf(z1.x, w, acc[4]); acc[5] = fmaf(z1.y, w, acc[5]);
        acc[6] = fmaf(z1.z, w, acc[6]); acc[7] = fmaf(z1.w, w, acc[7]);
      }
      if constexpr (BF16) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) gates[r * G + col] = xp[r] + acc[r];
      } else {
        const float bc = B[col];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) gates[r * G + col] = acc[r] + bc;
      }
    }
    __syncthreads();
    // 3. TF1 cell + length mask. Writes only the h part of z and c, which no
    // thread reads before the barrier after the next step's x load.
    for (int i = tid; i < ROWS * H; i += nt) {
      const int r = i / H, k = i % H;
      const int row = row0 + r;
      if (row >= n) continue;
      const int L = len_s[r];
      if (t < L) {
        const float* g = gates + r * G;
        float c = cst[i] * sigmoid_(g[2 * H + k] + forget_bias) +
                  sigmoid_(g[k]) * tanhf(g[H + k]);
        float hh = tanhf(c) * sigmoid_(g[3 * H + k]);
        if constexpr (BF16) {
          c = round_bf16(c);
          hh = round_bf16(hh);
        }
        cst[i] = c;
        z[(D + k) * ROWS + r] = hh;
        const int pos = dir == 0 ? t : L - 1 - t;
        const size_t o = ((size_t)(mrow + row) * T + pos) * out_stride + dir * H + k;
        if (out != nullptr) out[o] = hh;
        if (cell != nullptr) cell[o] = c;
      } else {
        const size_t o = ((size_t)(mrow + row) * T + t) * out_stride + dir * H + k;
        if (out != nullptr) out[o] = 0.0f;
        if (cell != nullptr) cell[o] = cst[i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ROWS * H; i += nt) {
    const int r = i / H, k = i % H;
    if (row0 + r < n) {
      fin[(size_t)(mrow + row0 + r) * out_stride + dir * H + k] = z[(D + k) * ROWS + r];
    }
  }
}

__global__ void lstm_fwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                                const DirWeights w, float* __restrict__ out,
                                float* __restrict__ cell, float* __restrict__ fin, int n,
                                int T, int D, int H, float forget_bias, long long wx_ms,
                                long long wh_ms, long long b_ms) {
  fwd_block<false, false>(x, lengths, w, out, cell, fin, n, T, D, H, forget_bias, wx_ms, wh_ms,
                         b_ms);
}

// the bf16 activation variant, at most 64 registers a thread like the grouped
// kernel below (1024-thread blocks)
__global__ void __launch_bounds__(1024)
lstm_fwd_bf16_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                     const DirWeights w, float* __restrict__ out,
                     float* __restrict__ cell, float* __restrict__ fin, int n,
                     int T, int D, int H, float forget_bias, long long wx_ms,
                     long long wh_ms, long long b_ms) {
  fwd_block<false, true>(x, lengths, w, out, cell, fin, n, T, D, H, forget_bias, wx_ms, wh_ms,
                         b_ms);
}

// at most 64 registers a thread: the block has up to 1024 threads (4H columns),
// and the group offsets would take the one-bi-LSTM kernel past 64
__global__ void __launch_bounds__(1024)
lstm_fwd_grouped_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                        const DirWeights w, float* __restrict__ out, float* __restrict__ cell,
                        float* __restrict__ fin, int n, int T, int D, int H, float forget_bias,
                        long long wx_ms, long long wh_ms, long long b_ms) {
  fwd_block<true, false>(x, lengths, w, out, cell, fin, n, T, D, H, forget_bias, wx_ms, wh_ms,
                         b_ms);
}

size_t smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)(D + H) * ROWS + (size_t)ROWS * 4 * H + (size_t)ROWS * H);
}

template <bool BF16>
int fwd(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
        const float* wh_fw, const float* wh_bw, const float* b_fw, const float* b_bw, float* out,
        float* cell, float* fin, int n, int t, int d, int h, float forget_bias, int k,
        long long wx_ms, long long wh_ms, long long b_ms, void* stream) {
  const DirWeights w{{wx_fw, wx_bw}, {wh_fw, wh_bw}, {b_fw, b_bw}};
  if (BF16 && k > 1) return (int)cudaErrorInvalidValue;
  const auto kernel = k > 1 ? lstm_fwd_grouped_kernel
                            : (BF16 ? lstm_fwd_bf16_kernel : lstm_fwd_kernel);
  const size_t smem = smem_bytes(d, h);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((4 * h + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  const dim3 grid((n + ROWS - 1) / ROWS, 2 * k);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x, lengths, w, out, cell, fin, n, t, d,
                                                       h, forget_bias, wx_ms, wh_ms, b_ms);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long lstm_fwd_smem_bytes(int d, int h) { return (long long)smem_bytes(d, h); }

const char* lstm_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the cudaError_t of the launch (0 = success). out and cell may be null.
// k bi-LSTMs over one batch in one launch (the group axis above); k = 1 is one
// bi-LSTM and the strides are then unread. bf16 != 0: the BF16 instantiation
// (k = 1 only; cudaErrorInvalidValue otherwise).
int lstm_fwd(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
             const float* wh_fw, const float* wh_bw, const float* b_fw, const float* b_bw,
             float* out, float* cell, float* fin, int n, int t, int d, int h,
             float forget_bias, int k, long long wx_ms, long long wh_ms, long long b_ms,
             int bf16, void* stream) {
  return (bf16 ? fwd<true> : fwd<false>)(x, lengths, wx_fw, wx_bw, wh_fw, wh_bw, b_fw, b_bw, out,
                                         cell, fin, n, t, d, h, forget_bias, k, wx_ms, wh_ms,
                                         b_ms, stream);
}

}  // extern "C"
