// Grouped LSTM scan over a precomputed input projection (TF1 BasicLSTMCell
// numerics): kernel K7.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_pallas.py:_grouped_kernel
// (launched by _pallas_scan). Same function: for each of G independent scans,
// gates = x_proj[t] + h.Wh with the gates in (i, j, f, o) order, forget_bias added
// inside the cell, prefix-length masking (at t >= L a row's h and c stop updating
// and its output is 0), fin = the last carried h (0 for a length-0 row).
//
// Layout. x_proj [G, N, T, 4H] (batch-major, as x.Wx + b comes out of the matmul:
// no transposed copy), lengths [G, N] int32, wh [G, H, 4H]; out [G, N, T, H] and
// fin [G, N, H]. Every element of out and fin for the N rows is written.
//
// Design (the code shared with K8 is in lstm_scan.cuh). One block per (tile of
// ROWS rows, group); the block walks t. Wh of the group stays resident in shared
// memory for the whole scan (the TPU kernel keeps wh_ref in VMEM): 4H.H floats,
// 160 000 B at H = 100. h ([H][ROWS], so one k is
// two float4 broadcasts), c and the step's gates live in shared memory too. Each
// step: one thread per gate column accumulates h.Wh for all ROWS rows in a fixed
// k order and adds x_proj[t] of the tile, read from global memory at that step
// (coalesced over the columns); a barrier; threads over (row, unit) apply the
// cell and write the output; a barrier. No atomics: the result is deterministic.
//
// Bound on the H100. Serial in t, and each step is 2.ROWS.H.4H FMAs per block over
// Wh from shared memory: at the model's widths (H = 100, tens to thousands of rows,
// T <= 30) the kernel is latency-bound on that per-step chain, far from both the
// HBM and the FP32 roofline. What the design does about it: Wh is read from device
// memory once per block (not once per step, as K1 does from L2), and each Wh load
// from shared memory serves ROWS rows. K8 (lstm_stream.cu) also takes the x_proj
// read off the step's critical path.
//
// lstm_grouped_wh_global launches the same kernel with Wh read from global
// memory (through L2) at every step, as K1 reads its weights: the same sums in
// the same order, so the same bits. Nothing in the package calls it; it exists
// to measure what residency alone is worth at the same chain length.

#include <cuda_runtime.h>

#include "lstm_scan.cuh"

namespace {

using lstm_scan::ROWS;

template <bool WH_RESIDENT>
__global__ void lstm_grouped_kernel(const float* __restrict__ x_proj,
                                    const int* __restrict__ lengths,
                                    const float* __restrict__ wh, float* __restrict__ out,
                                    float* __restrict__ fin, int n, int T, int H,
                                    float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int G4 = 4 * H;
  float* hs = smem + (WH_RESIDENT ? H * G4 : 0);  // [H][ROWS], after Wh [H][4H] if
                                                  // resident (16-byte aligned either way)
  float* gates = hs + H * ROWS;      // [ROWS][4H]
  float* cs = gates + ROWS * G4;     // [ROWS][H]
  __shared__ int len_s[ROWS];

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* __restrict__ W = wh + (size_t)g * H * G4;
  const float* whs = WH_RESIDENT ? smem : W;
  const size_t grow0 = (size_t)g * n + row0;   // first row of the tile in [G*N]

  const int max_len = lstm_scan::load_lengths(len_s, lengths, grow0, row0, n, T, tid);
  if (WH_RESIDENT) {
    for (int i = tid; i < H * G4; i += nt) smem[i] = W[i];
  }
  for (int i = tid; i < ROWS * H; i += nt) {
    hs[i] = 0.0f;
    cs[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < max_len; ++t) {
    // 1. gate pre-activations, one column per thread for all ROWS rows; x_proj[t]
    //    of the tile straight from global memory
    for (int col = tid; col < G4; col += nt) {
      float xv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xv[r] = (t < len_s[r]) ? x_proj[((grow0 + r) * T + t) * G4 + col] : 0.0f;
      }
      float acc[ROWS];
      lstm_scan::gate_acc(acc, whs, hs, col, G4, H);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) gates[r * G4 + col] = xv[r] + acc[r];
    }
    __syncthreads();
    // 2. TF1 cell + length mask
    lstm_scan::cell_step(gates, hs, cs, len_s, out, grow0, row0, n, T, t, H, forget_bias,
                         tid, nt);
    __syncthreads();
  }
  lstm_scan::finish(hs, out, fin, grow0, row0, n, T, max_len, H, tid, nt);
}

size_t smem_bytes(int H) {
  return sizeof(float) * ((size_t)H * 4 * H + (size_t)H * ROWS + (size_t)ROWS * 4 * H +
                          (size_t)ROWS * H);
}

}  // namespace

extern "C" {

long long lstm_grouped_smem_bytes(int h) { return (long long)smem_bytes(h); }

const char* lstm_grouped_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the cudaError_t of the launch (0 = success).
int lstm_grouped(const float* x_proj, const int* lengths, const float* wh, float* out,
                 float* fin, int g, int n, int t, int h, float forget_bias, void* stream) {
  return lstm_scan::launch(lstm_grouped_kernel<true>, smem_bytes(h), x_proj, lengths, wh, out,
                           fin, g, n, t, h, forget_bias, stream);
}

// The same with Wh read from global memory at every step (see the header). It
// takes K7's shared memory all the same, so that as many blocks share an SM.
int lstm_grouped_wh_global(const float* x_proj, const int* lengths, const float* wh,
                           float* out, float* fin, int g, int n, int t, int h,
                           float forget_bias, void* stream) {
  return lstm_scan::launch(lstm_grouped_kernel<false>, smem_bytes(h), x_proj, lengths, wh, out,
                           fin, g, n, t, h, forget_bias, stream);
}

}  // extern "C"
