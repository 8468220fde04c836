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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 8;  // batch rows per block (two float4 per k in z)

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

struct DirWeights {
  const float* wx[2];  // [D, 4H] per direction (0 = forward, 1 = backward)
  const float* wh[2];  // [H, 4H]
  const float* b[2];   // [4H]
};

__global__ void lstm_fwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                                const DirWeights w, float* __restrict__ out,
                                float* __restrict__ cell, float* __restrict__ fin, int n,
                                int T, int D, int H,
                                float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int K = D + H;
  float* z = smem;                  // [K][ROWS]: x_t rows then h rows
  float* gates = z + K * ROWS;      // [ROWS][G]
  float* cst = gates + ROWS * G;    // [ROWS][H]
  __shared__ int len_s[ROWS];

  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const float* __restrict__ Wx = dir ? w.wx[1] : w.wx[0];
  const float* __restrict__ Wh = dir ? w.wh[1] : w.wh[0];
  const float* __restrict__ B = dir ? w.b[1] : w.b[0];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t out_stride = 2 * (size_t)H;

  if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[row0 + tid] : 0;
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
          const size_t o = ((size_t)(row0 + r) * T + t) * out_stride + dir * H + k;
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
        v = x[((size_t)(row0 + r) * T + pos) * D + k];
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
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(Wh + (size_t)k * G + col);
        const float4 z0 = *reinterpret_cast<const float4*>(z + (D + k) * ROWS);
        const float4 z1 = *reinterpret_cast<const float4*>(z + (D + k) * ROWS + 4);
        acc[0] = fmaf(z0.x, w, acc[0]); acc[1] = fmaf(z0.y, w, acc[1]);
        acc[2] = fmaf(z0.z, w, acc[2]); acc[3] = fmaf(z0.w, w, acc[3]);
        acc[4] = fmaf(z1.x, w, acc[4]); acc[5] = fmaf(z1.y, w, acc[5]);
        acc[6] = fmaf(z1.z, w, acc[6]); acc[7] = fmaf(z1.w, w, acc[7]);
      }
      const float bc = B[col];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) gates[r * G + col] = acc[r] + bc;
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
        const float c = cst[i] * sigmoid_(g[2 * H + k] + forget_bias) +
                        sigmoid_(g[k]) * tanhf(g[H + k]);
        const float hh = tanhf(c) * sigmoid_(g[3 * H + k]);
        cst[i] = c;
        z[(D + k) * ROWS + r] = hh;
        const int pos = dir == 0 ? t : L - 1 - t;
        const size_t o = ((size_t)row * T + pos) * out_stride + dir * H + k;
        if (out != nullptr) out[o] = hh;
        if (cell != nullptr) cell[o] = c;
      } else {
        const size_t o = ((size_t)row * T + t) * out_stride + dir * H + k;
        if (out != nullptr) out[o] = 0.0f;
        if (cell != nullptr) cell[o] = cst[i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ROWS * H; i += nt) {
    const int r = i / H, k = i % H;
    if (row0 + r < n) fin[(size_t)(row0 + r) * out_stride + dir * H + k] = z[(D + k) * ROWS + r];
  }
}

size_t smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)(D + H) * ROWS + (size_t)ROWS * 4 * H + (size_t)ROWS * H);
}

}  // namespace

extern "C" {

long long lstm_fwd_smem_bytes(int d, int h) { return (long long)smem_bytes(d, h); }

const char* lstm_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the cudaError_t of the launch (0 = success). out and cell may be null.
int lstm_fwd(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
             const float* wh_fw, const float* wh_bw, const float* b_fw, const float* b_bw,
             float* out, float* cell, float* fin, int n, int t, int d, int h,
             float forget_bias, void* stream) {
  const DirWeights w{{wx_fw, wx_bw}, {wh_fw, wh_bw}, {b_fw, b_bw}};
  const size_t smem = smem_bytes(d, h);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((4 * h + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 64) threads = 64;
  const dim3 grid((n + ROWS - 1) / ROWS, 2);
  lstm_fwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, lengths, w, out, cell, fin, n, t, d, h, forget_bias);
  return (int)cudaGetLastError();
}

}  // extern "C"
