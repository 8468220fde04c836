// Streaming grouped LSTM scan over a precomputed input projection (TF1
// BasicLSTMCell numerics): kernel K8.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_pallas.py:_stream_kernel
// (launched by _pallas_scan_stream). The same function and interface as K7
// (lstm_grouped.cu), with the same gate, cell and write code (lstm_scan.cuh):
// G independent scans, gates = x_proj[t] + h.Wh in (i, j, f, o) order,
// forget_bias inside the cell, prefix-length masking, fin = the last carried h.
// x_proj [G, N, T, 4H], lengths [G, N] int32, wh [G, H, 4H] → out
// [G, N, T, H], fin [G, N, H].
//
// What differs from K7 is how x_proj arrives, which is what the TPU kernel is
// about: there x_proj stays in HBM and each step's tile is DMA'd into a two-slot
// VMEM buffer while the previous step computes. Here the block copies x_proj[t+1]
// of its ROWS rows with cp.async (16-byte pieces, .cg: through L2, not L1) into a
// two-slot ring in shared memory while step t computes, and waits on slot t
// (cp.async.wait_group 1, then a barrier) before it reads it. The copy of step
// t+1 is issued at the top of step t, so it overlaps step t's h.Wh chain; the
// slot it fills was last read by step t-1's gate phase, which ended before step
// t's first barrier. Outputs go straight to global memory: a GPU store does not
// stall the step the way a TPU output DMA does, so the TPU kernel's output ring
// has no counterpart.
//
// Shared memory, at H = 100 and ROWS = 8: Wh resident 4H.H.4 = 160 000 B; the
// ring 2 slots . ROWS . 4H . 4 = 25 600 B (two slots: one being read by the
// step, one being filled for the next; a third would only help if one step's
// copy took longer than a step's compute); the gates ROWS.4H.4 = 12 800 B; h and
// c 2.ROWS.H.4 = 6 400 B: 204 800 B of the 232 448 a block may use.
//
// Bound on the H100: as K7's, latency of the serial per-step chain; x_proj's
// read is off that chain here. Rows past a tile's lengths are not copied.

#include <cuda_runtime.h>

#include "lstm_scan.cuh"

namespace {

using lstm_scan::ROWS;

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of x_proj[t] for the tile's live rows into `slot`.
__device__ __forceinline__ void prefetch(float* slot, const float* __restrict__ x_proj,
                                        const int* len_s, size_t grow0, int t, int T,
                                        int G4, int tid, int nt) {
  const int per_row = G4 / 4;   // 16-byte pieces per row (4H floats: always whole)
  for (int i = tid; i < ROWS * per_row; i += nt) {
    const int r = i / per_row, q = i % per_row;
    if (t < len_s[r]) {
      cp_async16(slot + r * G4 + 4 * q, x_proj + ((grow0 + r) * T + t) * G4 + 4 * q);
    }
  }
}

__global__ void lstm_stream_kernel(const float* __restrict__ x_proj,
                                   const int* __restrict__ lengths,
                                   const float* __restrict__ wh, float* __restrict__ out,
                                   float* __restrict__ fin, int n, int T, int H,
                                   float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int G4 = 4 * H;
  float* whs = smem;                  // [H][4H]
  float* ring = whs + H * G4;         // [2][ROWS][4H] (16-byte aligned: 4H.H floats before)
  float* gates = ring + 2 * ROWS * G4;  // [ROWS][4H]
  float* hs = gates + ROWS * G4;      // [H][ROWS]
  float* cs = hs + H * ROWS;          // [ROWS][H]
  __shared__ int len_s[ROWS];

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* __restrict__ W = wh + (size_t)g * H * G4;
  const size_t grow0 = (size_t)g * n + row0;

  const int max_len = lstm_scan::load_lengths(len_s, lengths, grow0, row0, n, T, tid);

  // step 0's tile is in flight while Wh loads
  if (max_len > 0) prefetch(ring, x_proj, len_s, grow0, 0, T, G4, tid, nt);
  cp_async_commit();
  for (int i = tid; i < H * G4; i += nt) whs[i] = W[i];
  for (int i = tid; i < ROWS * H; i += nt) {
    hs[i] = 0.0f;
    cs[i] = 0.0f;
  }

  for (int t = 0; t < max_len; ++t) {
    float* cur = ring + (t & 1) * ROWS * G4;
    if (t + 1 < max_len) {
      prefetch(ring + ((t + 1) & 1) * ROWS * G4, x_proj, len_s, grow0, t + 1, T, G4, tid, nt);
    }
    cp_async_commit();   // an empty group on the last step keeps the count uniform
    cp_async_wait_1();   // this thread's copies of step t have landed
    __syncthreads();     // everyone's have; and step t-1's h and c are written
    // 1. gate pre-activations, one column per thread for all ROWS rows
    for (int col = tid; col < G4; col += nt) {
      float acc[ROWS];
      lstm_scan::gate_acc(acc, whs, hs, col, G4, H);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (t < len_s[r]) gates[r * G4 + col] = cur[r * G4 + col] + acc[r];
      }
    }
    __syncthreads();
    // 2. TF1 cell + length mask (reads the gates, not the ring)
    lstm_scan::cell_step(gates, hs, cs, len_s, out, grow0, row0, n, T, t, H, forget_bias,
                         tid, nt);
  }
  __syncthreads();
  lstm_scan::finish(hs, out, fin, grow0, row0, n, T, max_len, H, tid, nt);
}

size_t smem_bytes(int H) {
  return sizeof(float) * ((size_t)H * 4 * H + 2 * (size_t)ROWS * 4 * H +
                          (size_t)ROWS * 4 * H + 2 * (size_t)ROWS * H);
}

}  // namespace

extern "C" {

long long lstm_stream_smem_bytes(int h) { return (long long)smem_bytes(h); }

const char* lstm_stream_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Returns the cudaError_t of the launch (0 = success). x_proj must be 16-byte
// aligned (the wrapper checks it).
int lstm_stream(const float* x_proj, const int* lengths, const float* wh, float* out,
                float* fin, int g, int n, int t, int h, float forget_bias, void* stream) {
  return lstm_scan::launch(lstm_stream_kernel, smem_bytes(h), x_proj, lengths, wh, out, fin,
                           g, n, t, h, forget_bias, stream);
}

}  // extern "C"
