// Streaming grouped LSTM scan over a precomputed input projection (TF1
// BasicLSTMCell numerics): kernel K8.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_pallas.py:_stream_kernel
// (launched by _pallas_scan_stream). The same function and interface as K7
// (lstm_grouped.cu): G independent scans, gates = x_proj[t] + h.Wh in (i, j, f,
// o) order, forget_bias inside the cell, prefix-length masking, fin = the last
// carried h. x_proj [G, N, T, 4H], lengths [G, N] int32 (group stride 0 shares
// one row), group g's Wh [H, 4H] at wh + g . wh_stride floats → out [G, N, T, H],
// fin [G, N, H].
//
// Design (lstm_gscan.cuh): K7's recurrence, cluster split and sum order, so
// the two give the same bits; what differs is how x_proj arrives, which is what
// the TPU kernel is about (x_proj stays in HBM and each step's tile is DMA'd
// into a two-slot VMEM buffer while the previous step computes). Here each CTA
// keeps a two-slot ring of the ROWS x 4 x Hc slice of x_proj its units read:
// at the top of step t one warp fills step t + 1's slot with 1-D bulk async
// copies (one run of Hc floats per live row and gate; the slot's mbarrier
// counts the bytes), and the lanes wait on that mbarrier after step t + 1's
// dot products, so the copies fly under a whole step. Where the runs are not
// 16-byte aligned (H or Hc not a multiple of 4, or x_proj off a 16-byte
// boundary) every thread starts 4-byte cp.async copies instead and arrives on
// the mbarrier when they land. Outputs go straight to global memory between
// the cluster barrier's arrive and wait: a GPU store does not stall the step
// the way a TPU output DMA does, so the TPU kernel's output ring has no
// counterpart.
//
// Shared memory at H = 100: a one-CTA cluster with tiles of 16 rows (the route
// of the photo titles, 3072 x 10) holds Wh 4 . 100 . 416 floats (166 400 B), h
// 2 x 100 x 16 (12 800 B), the ring 2 x 16 x 4 x 100 (51 200 B) and a 128-byte
// header: 230 528 of the 232 448 bytes a CTA may use.
//
// Bound on the H100: as K7's, the latency of the serial per-step chain; the
// ring takes the x_proj loads off the lanes. Rows past their lengths are not
// copied.
//
// The first port's kernel stays as lstm_stream_rowtile (one block per 8-row
// tile and group, 16-byte cp.async into a ring with a block-wide wait each
// step, lstm_scan.cuh): no path calls it; it is timed and held against this
// one.

#include <cuda_runtime.h>

#include "lstm_gscan.cuh"
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

// The row-tile K8: one block per (tile of ROWS rows, group), Wh resident whole; the
// block copies x_proj[t + 1] of its rows with 16-byte cp.async into a two-slot
// ring while step t computes, then waits (cp.async.wait_group 1 and a barrier).
__global__ void rowtile_kernel(const float* __restrict__ x_proj, const int* __restrict__ lengths,
                               const float* __restrict__ wh, float* __restrict__ out,
                               float* __restrict__ fin, int n, int T, int H, float forget_bias) {
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

size_t rowtile_smem_bytes(int H) {
  return sizeof(float) * ((size_t)H * 4 * H + 2 * (size_t)ROWS * 4 * H +
                          (size_t)ROWS * 4 * H + 2 * (size_t)ROWS * H);
}

}  // namespace

// K8 with clusters of c CTAs, tiles of `rows` rows and `split` lanes per
// unit, Wh resident or read from device memory (gscan::wh_global; force:
// from device memory at any width).
static int launch_scan(const float* x_proj, const int* lengths, long long len_stride,
                       const float* wh, long long wh_stride, float* out, float* fin, int g,
                       int n, int t, int h, int c, int rows, int split, float forget_bias,
                       void* stream, bool force) {
  const bool global = force || gscan::wh_global(h, c, rows, split);
#define LSTM_STREAM_CASE(R, S_)                                                                   \
  if (rows == R && split == S_)                                                                   \
    return global ? gscan::launch<R, S_, true, true>(x_proj, lengths, len_stride, wh,             \
                                                       wh_stride, out, fin, g, n, t, h, c,        \
                                                       forget_bias, stream)                       \
                  : gscan::launch<R, S_, true, false>(x_proj, lengths, len_stride, wh,            \
                                                        wh_stride, out, fin, g, n, t, h, c,       \
                                                        forget_bias, stream);
  LSTM_STREAM_CASE(8, 4)
  LSTM_STREAM_CASE(8, 8)
  LSTM_STREAM_CASE(8, 16)
  LSTM_STREAM_CASE(16, 4)
#undef LSTM_STREAM_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// As lstm_grouped_route (the same route: it already sizes K8's ring).
int lstm_stream_route(int g, int n, int t, int h, int* cluster, int* rows, int* split,
                      int* wh_global) {
  (void)t;
  return gscan::route_c(g, n, h, cluster, rows, split, wh_global);
}

long long lstm_stream_smem_bytes(int h, int c, int rows, int split) {
  return (long long)gscan::smem_bytes(h, c, rows, split, true);
}

const char* lstm_stream_error_string(int err) { return lrec::error_string(err); }

// K8, arguments as lstm_grouped's with clusters of c CTAs, tiles of
// `rows` rows and `split` lanes per unit (lstm_stream_route; Wh global where the
// route's rule says so). Returns the cudaError_t of the launch, -1 when the
// cluster cannot be scheduled, or 22 (cudaErrorInvalidValue) for a (rows,
// split) pair with no instantiation.
int lstm_stream(const float* x_proj, const int* lengths, long long len_stride, const float* wh,
                long long wh_stride, float* out, float* fin, int g, int n, int t, int h, int c,
                int rows, int split, float forget_bias, void* stream) {
  return launch_scan(x_proj, lengths, len_stride, wh, wh_stride, out, fin, g, n, t, h, c, rows,
                     split, forget_bias, stream, false);
}

// lstm_stream with Wh read from device memory at any width: no package path calls
// it; the card tests hold it against the resident route at the same (c, rows,
// split), bit for bit.
int lstm_stream_wh_global(const float* x_proj, const int* lengths, long long len_stride,
                          const float* wh, long long wh_stride, float* out, float* fin, int g,
                          int n, int t, int h, int c, int rows, int split, float forget_bias,
                          void* stream) {
  return launch_scan(x_proj, lengths, len_stride, wh, wh_stride, out, fin, g, n, t, h, c, rows,
                     split, forget_bias, stream, true);
}

long long lstm_stream_rowtile_smem_bytes(int h) { return (long long)rowtile_smem_bytes(h); }

// The row-tile K8 on x_proj [G, N, T, 4H] (16-byte aligned), lengths [G, N], wh
// [G, H, 4H] (contiguous). Returns the cudaError_t of the launch.
int lstm_stream_rowtile(const float* x_proj, const int* lengths, const float* wh, float* out,
                        float* fin, int g, int n, int t, int h, float forget_bias,
                        void* stream) {
  return lstm_scan::launch(rowtile_kernel, rowtile_smem_bytes(h), x_proj, lengths, wh, out, fin,
                           g, n, t, h, forget_bias, stream);
}

}  // extern "C"
