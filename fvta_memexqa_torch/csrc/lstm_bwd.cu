// Fused bi-LSTM backward (TF1 BasicLSTMCell numerics): per-step gate cotangents.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_bwd_step_kernel
// (launched by _fused_scan_bwd). Same function: a reverse-time recurrence over
// each row that recomputes the gate pre-activations from [x_t; h_{t-1}] (the
// product K1 does), applies the TF1 cell's derivatives under the prefix-length
// mask m = t < L, and writes dgates[t] = (di, dj, df, do). The carried
// cotangents follow the TPU kernel exactly:
//   dh_in   = dh_carry + m * g_out[t] + [t == L-1] * g_fin
//   dh_carry <- dgates . Wh^T + (1 - m) * dh_in
//   dc_carry <- dc_total * f + (1 - m) * dc_in
// dX, dWx, dWh and db are plain matrix products of dgates outside the kernel
// (ops/lstm_fused.py), as the JAX package leaves them to XLA.
//
// Layout. x [N, T, D], lengths [N] int32; per direction wx [D, 4H], wh [H, 4H],
// wh^T [4H, H] (the wrapper's transposed copy, so the dh product reads it
// coalesced as the gate product reads wh), b [4H]. out and cell [N, T, 2H] are
// K1's training outputs (forward in [:H], backward in [H:], both at the
// ORIGINAL time index); g_out [N, T, 2H] and g_fin [N, 2H] are the incoming
// cotangents (either may be null = zero).
// dgates [N, T, 8H] (forward gates in [:4H], backward in [4H:]) is written at
// the original time index too, so x and h_{t-1} line up with it without a flip:
// in the backward direction, step t sits at position p = L-1-t and its h_{t-1},
// c_{t-1} at p+1. Every position is written (zeros past a row's length), so a
// row of length 0 gets zero dgates.
//
// Group axis (ops/lstm_fused.bilstm_fused_grouped, past the largest cluster):
// as lstm_fwd.cu's, grid (tiles, 2K), block row y running direction y % 2 of
// bi-LSTM y / 2; bi-LSTM m's x, lengths, out, cell, g_out, g_fin and dgates
// follow m - 1's (rows m.N .. m.N + N - 1 of the stacks), its wx, wh (and
// wh^T) and b lie wx_ms, wh_ms and b_ms elements past m - 1's in each
// direction. K > 1 launches lstm_bwd_grouped_kernel (at most 64 registers);
// K = 1 keeps the one-bi-LSTM kernel's code.
//
// Design. One block per (tile of ROWS rows, direction); the block walks t from
// the tile's longest row down to 0. Per step: (1) the tile's [x_t; h_{t-1}] goes
// to shared memory as z[k][r]; (2) one thread per gate column accumulates the
// pre-activation for all ROWS rows, reading the weight column from L2 (as K1);
// (3) threads over (row, hidden unit) apply the cell derivatives, write dgates
// to global memory and over the gates in shared memory; (4) threads over
// (hidden unit, row pair) form dgates . Wh^T for the carried dh. Sums run in a
// fixed order and there are no atomics: the result is deterministic, which
// bitwise resume of training needs.
//
// The bf16 activation variant (BF16 = true, bf16 != 0; one bi-LSTM): the
// backward of lstm_fwd.cu's BF16 forward, straight through its roundings (as
// lstm_rec_bwd.cu's): x_t.Wx + b is recomputed and rounded as the forward
// rounded it, and tanh(c_t) is taken of the unrounded cell, recomputed from the
// gates and the saved (rounded, hence exact) c_{t-1}.
//
// Bound on the H100. Like K1 the recurrence is serial in t, and each step
// streams Wx, Wh (for the pre-activations) and Wh^T (for dh) from L2 — about
// 3 (D+H)·4H + 4H·H floats per direction per step for ROWS rows — so it is
// latency-bound on that stream, far from the HBM and FP32 rooflines; of HBM
// traffic it must move x, out, cell and g_out once and write dgates (4x the
// hidden width per step) once. What this simple design does about it: rows
// share every weight load, the pre-activations are recomputed rather than
// stored by the forward (no [N, T, 8H] slab written there), and the big
// products over the batch run outside the kernel on cuBLAS. Weight residency in
// shared memory and a split K loop are later work.

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
  const float* wx[2];   // [D, 4H] per direction (0 = forward, 1 = backward)
  const float* wh[2];   // [H, 4H]
  const float* wht[2];  // [4H, H] (wh transposed)
  const float* b[2];    // [4H]
};

// One block's work; GROUPED = false is the launch of one bi-LSTM, whose group
// offsets fold away (the code and registers of the kernel before the group axis).
template <bool GROUPED, bool BF16>
__device__ __forceinline__ void bwd_block(const float* __restrict__ x,
                                          const int* __restrict__ lengths, const DirWeights w,
                                          const float* __restrict__ hseq,
                                          const float* __restrict__ cseq,
                                          const float* __restrict__ g_out,
                                          const float* __restrict__ g_fin,
                                          float* __restrict__ dgates, int n, int T, int D, int H,
                                          float forget_bias, long long wx_ms, long long wh_ms,
                                          long long b_ms) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int K = D + H;
  float* z = smem;                  // [K][ROWS]: x_t rows then h_{t-1} rows
  float* gates = z + K * ROWS;      // [ROWS][G]: pre-activations, then dgates
  float* dh_c = gates + ROWS * G;   // [ROWS][H]: carried dh
  float* dc_c = dh_c + ROWS * H;    // [ROWS][H]: carried dc
  __shared__ int len_s[ROWS];

  const int dir = GROUPED ? blockIdx.y & 1 : blockIdx.y;
  const int grp = GROUPED ? blockIdx.y >> 1 : 0;   // the bi-LSTM of this group
  const int mrow = grp * n;          // its first row among the stacked rows
  const int row0 = blockIdx.x * ROWS;
  const float* __restrict__ Wx = (dir ? w.wx[1] : w.wx[0]) + grp * wx_ms;
  const float* __restrict__ Wh = (dir ? w.wh[1] : w.wh[0]) + grp * wh_ms;
  const float* __restrict__ WhT = (dir ? w.wht[1] : w.wht[0]) + grp * wh_ms;
  const float* __restrict__ B = (dir ? w.b[1] : w.b[0]) + grp * b_ms;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t hstride = 2 * (size_t)H;   // row stride of out / cell / g_out / g_fin
  const size_t gstride = 2 * (size_t)G;   // row stride of dgates

  if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[mrow + row0 + tid] : 0;
  for (int i = tid; i < ROWS * H; i += nt) {
    dh_c[i] = 0.0f;
    dc_c[i] = 0.0f;
  }
  __syncthreads();
  int max_len = 0;
  for (int r = 0; r < ROWS; ++r) max_len = max(max_len, len_s[r]);

  for (int t = T - 1; t >= 0; --t) {
    if (t >= max_len) {
      // no row of the tile is live at this step: zero dgates at position t
      for (int i = tid; i < ROWS * G; i += nt) {
        const int r = i / G, k = i % G;
        if (row0 + r < n) {
          dgates[((size_t)(mrow + row0 + r) * T + t) * gstride + dir * G + k] = 0.0f;
        }
      }
      continue;
    }
    // 1. [x_t; h_{t-1}] rows of this step (backward direction: position L-1-t,
    //    its previous state at L-t); zero for rows past their length or at t = 0
    for (int i = tid; i < ROWS * K; i += nt) {
      const int r = i / K, k = i % K;
      const int L = len_s[r];
      float v = 0.0f;
      if (t < L) {
        const int pos = dir == 0 ? t : L - 1 - t;
        const size_t rowbase = (size_t)(mrow + row0 + r) * T;
        if (k < D) {
          v = x[(rowbase + pos) * D + k];
        } else if (t > 0) {
          const int prev = dir == 0 ? pos - 1 : pos + 1;
          v = hseq[(rowbase + prev) * hstride + dir * H + (k - D)];
        }
      }
      z[k * ROWS + r] = v;
    }
    __syncthreads();
    // 2. gate pre-activations, one column per thread for all ROWS rows
    for (int col = tid; col < G; col += nt) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      float xp[ROWS];   // BF16: x_t.Wx + b rounded, as the forward formed it
      for (int k = 0; k < K; ++k) {
        if (BF16 && k == D) {
          const float bc = B[col];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            xp[r] = round_bf16(acc[r] + bc);
            acc[r] = 0.0f;
          }
        }
        // [Wx; Wh] column col, read coalesced across the warp's columns
        const float wv = k < D ? __ldg(Wx + (size_t)k * G + col)
                               : __ldg(Wh + (size_t)(k - D) * G + col);
        const float4 z0 = *reinterpret_cast<const float4*>(z + k * ROWS);
        const float4 z1 = *reinterpret_cast<const float4*>(z + k * ROWS + 4);
        acc[0] = fmaf(z0.x, wv, acc[0]); acc[1] = fmaf(z0.y, wv, acc[1]);
        acc[2] = fmaf(z0.z, wv, acc[2]); acc[3] = fmaf(z0.w, wv, acc[3]);
        acc[4] = fmaf(z1.x, wv, acc[4]); acc[5] = fmaf(z1.y, wv, acc[5]);
        acc[6] = fmaf(z1.z, wv, acc[6]); acc[7] = fmaf(z1.w, wv, acc[7]);
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
    // 3. TF1 cell derivatives under the length mask; dgates overwrite the gates
    //    (each thread reads and writes the same four entries)
    for (int i = tid; i < ROWS * H; i += nt) {
      const int r = i / H, k = i % H;
      const int row = row0 + r;
      const int L = len_s[r];   // 0 for the tile's rows past n
      const size_t rowbase = (size_t)(mrow + row) * T;
      float* g = gates + r * G;
      float* dg_out = dgates + rowbase * gstride + dir * G + k;
      if (t >= L) {
        // past the row's length: no gradient flows, the carries stay as they are
        // (zero: nothing has entered them yet)
        g[k] = g[H + k] = g[2 * H + k] = g[3 * H + k] = 0.0f;
        if (row < n) {
          float* o = dg_out + (size_t)t * gstride;
          o[0] = o[H] = o[2 * H] = o[3 * H] = 0.0f;
        }
        continue;
      }
      const int pos = dir == 0 ? t : L - 1 - t;
      const float i_s = sigmoid_(g[k]);
      const float j_t = tanhf(g[H + k]);
      const float f_s = sigmoid_(g[2 * H + k] + forget_bias);
      const float o_s = sigmoid_(g[3 * H + k]);
      const size_t hix = (rowbase + pos) * hstride + dir * H + k;
      const float c_t = cseq[hix];
      float c_prev = 0.0f;
      if (t > 0) {
        const int prev = dir == 0 ? pos - 1 : pos + 1;
        c_prev = cseq[(rowbase + prev) * hstride + dir * H + k];
      }
      // BF16: c_t was saved rounded; the forward took tanh of the cell before that
      const float tanh_c = tanhf(BF16 ? c_prev * f_s + i_s * j_t : c_t);
      float dh_in = dh_c[i];
      if (g_out != nullptr) dh_in += g_out[hix];
      if (g_fin != nullptr && t == L - 1) {
        dh_in += g_fin[(size_t)(mrow + row) * hstride + dir * H + k];
      }
      const float dc_in = dc_c[i];
      // m = 1 here: dnh = dh_in, dc_total = dc_in + dnh * o * (1 - tanh(c)^2)
      const float dc_tot = dc_in + dh_in * o_s * (1.0f - tanh_c * tanh_c);
      const float d_o = dh_in * tanh_c * o_s * (1.0f - o_s);
      const float d_i = dc_tot * j_t * i_s * (1.0f - i_s);
      const float d_j = dc_tot * i_s * (1.0f - j_t * j_t);
      const float d_f = dc_tot * c_prev * f_s * (1.0f - f_s);
      g[k] = d_i;
      g[H + k] = d_j;
      g[2 * H + k] = d_f;
      g[3 * H + k] = d_o;
      float* o = dg_out + (size_t)pos * gstride;
      o[0] = d_i;
      o[H] = d_j;
      o[2 * H] = d_f;
      o[3 * H] = d_o;
      dc_c[i] = dc_tot * f_s;   // (1 - m) * dc_in = 0
      dh_c[i] = 0.0f;           // (1 - m) * dh_in = 0; step 4 adds dgates . Wh^T
    }
    __syncthreads();
    // 4. carried dh = dgates . Wh^T, one hidden unit and a pair of rows per item;
    //    rows past their length keep dh = 0 (their dgates are 0)
    for (int i = tid; i < H * (ROWS / 2); i += nt) {
      const int k = i % H, r = 2 * (i / H);
      const float* g0 = gates + r * G;
      const float* g1 = g0 + G;
      float a0 = 0.0f, a1 = 0.0f;
      for (int col = 0; col < G; ++col) {
        const float wv = __ldg(WhT + (size_t)col * H + k);
        a0 = fmaf(g0[col], wv, a0);
        a1 = fmaf(g1[col], wv, a1);
      }
      dh_c[r * H + k] += a0;
      dh_c[(r + 1) * H + k] += a1;
    }
    // the next step's step 1 writes only z; its barrier orders step 4's reads of
    // the dgates before step 2 overwrites them
  }
}

__global__ void lstm_bwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                                const DirWeights w, const float* __restrict__ hseq,
                                const float* __restrict__ cseq,
                                const float* __restrict__ g_out,
                                const float* __restrict__ g_fin, float* __restrict__ dgates,
                                int n, int T, int D, int H, float forget_bias, long long wx_ms,
                                long long wh_ms, long long b_ms) {
  bwd_block<false, false>(x, lengths, w, hseq, cseq, g_out, g_fin, dgates, n, T, D, H,
                          forget_bias, wx_ms, wh_ms, b_ms);
}

// the bf16 activation variant, at most 64 registers a thread like the grouped
// kernel below (1024-thread blocks)
__global__ void __launch_bounds__(1024)
lstm_bwd_bf16_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                     const DirWeights w, const float* __restrict__ hseq,
                     const float* __restrict__ cseq,
                     const float* __restrict__ g_out,
                     const float* __restrict__ g_fin, float* __restrict__ dgates,
                     int n, int T, int D, int H, float forget_bias, long long wx_ms,
                     long long wh_ms, long long b_ms) {
  bwd_block<false, true>(x, lengths, w, hseq, cseq, g_out, g_fin, dgates, n, T, D, H,
                         forget_bias, wx_ms, wh_ms, b_ms);
}

// at most 64 registers a thread: the block has up to 1024 threads (4H columns),
// and the group offsets would take the one-bi-LSTM kernel past 64
__global__ void __launch_bounds__(1024)
lstm_bwd_grouped_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                        const DirWeights w, const float* __restrict__ hseq,
                        const float* __restrict__ cseq, const float* __restrict__ g_out,
                        const float* __restrict__ g_fin, float* __restrict__ dgates, int n,
                        int T, int D, int H, float forget_bias, long long wx_ms,
                        long long wh_ms, long long b_ms) {
  bwd_block<true, false>(x, lengths, w, hseq, cseq, g_out, g_fin, dgates, n, T, D, H,
                         forget_bias, wx_ms, wh_ms, b_ms);
}

size_t smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)(D + H) * ROWS + (size_t)ROWS * 4 * H + 2 * (size_t)ROWS * H);
}

template <bool BF16>
int bwd(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
        const float* wh_fw, const float* wh_bw, const float* wht_fw, const float* wht_bw,
        const float* b_fw, const float* b_bw, const float* out, const float* cell,
        const float* g_out, const float* g_fin, float* dgates, int n, int t, int d, int h,
        float forget_bias, int k, long long wx_ms, long long wh_ms, long long b_ms,
        void* stream) {
  const DirWeights w{{wx_fw, wx_bw}, {wh_fw, wh_bw}, {wht_fw, wht_bw}, {b_fw, b_bw}};
  if (BF16 && k > 1) return (int)cudaErrorInvalidValue;
  const auto kernel = k > 1 ? lstm_bwd_grouped_kernel
                            : (BF16 ? lstm_bwd_bf16_kernel : lstm_bwd_kernel);
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
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x, lengths, w, out, cell, g_out, g_fin,
                                                       dgates, n, t, d, h, forget_bias, wx_ms,
                                                       wh_ms, b_ms);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long lstm_bwd_smem_bytes(int d, int h) { return (long long)smem_bytes(d, h); }

const char* lstm_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the cudaError_t of the launch (0 = success). g_out and g_fin may be null.
// k bi-LSTMs over one batch in one launch (the group axis above; wh^T with wh's
// stride); k = 1 is one bi-LSTM and the strides are then unread. bf16 != 0:
// the backward of lstm_fwd's BF16 instantiation, straight through its roundings
// (k = 1 only; cudaErrorInvalidValue otherwise).
int lstm_bwd(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
             const float* wh_fw, const float* wh_bw, const float* wht_fw, const float* wht_bw,
             const float* b_fw, const float* b_bw,
             const float* out, const float* cell, const float* g_out, const float* g_fin,
             float* dgates, int n, int t, int d, int h, float forget_bias, int k,
             long long wx_ms, long long wh_ms, long long b_ms, int bf16, void* stream) {
  return (bf16 ? bwd<true> : bwd<false>)(x, lengths, wx_fw, wx_bw, wh_fw, wh_bw, wht_fw, wht_bw,
                                         b_fw, b_bw, out, cell, g_out, g_fin, dgates, n, t, d, h,
                                         forget_bias, k, wx_ms, wh_ms, b_ms, stream);
}

}  // extern "C"
