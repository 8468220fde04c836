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
// no transposed copy), lengths [G, N] int32 (a group stride of 0 shares one
// row), group g's Wh [H, 4H] at wh + g . wh_stride floats; out [G, N, T, H] and
// fin [G, N, H]. Every element of out and fin for the N rows is written.
//
// Design (lstm_gscan.cuh, shared with K8): K1's Hopper recurrence over G
// groups. A cluster of C CTAs shares a tile of rows of one group, each CTA
// owning ceil(H / C) hidden units with their Wh columns resident in shared
// memory for all the tiles it walks; S lanes split each unit's dot product and
// meet in a fixed shuffle tree; h goes to the cluster's CTAs through
// distributed shared memory, one split cluster barrier a step. x_proj reaches a
// step as the TPU kernel's resident block does: each lane loads step t + 1's
// values for its own rows and unit into registers at the top of step t.
//
// Bound on the H100. The serial chain of T steps: each step is a dot product of
// ceil(H / S) shared-memory terms per lane, a shuffle tree, the cell and a
// cluster barrier, at every width the repo uses far below both the FP32 and the
// HBM roofline (x_proj is read once, out written once). What the design does:
// the chain per step is a fraction of the row-tile kernel's (one thread walks
// all H terms per gate column, with two block barriers a step), the cluster
// spreads a thin grid over more SMs, and persistent CTAs read Wh once.
//
// The first port's kernel stays as lstm_grouped_rowtile (one block per 8-row
// tile and group, Wh resident whole, lstm_scan.cuh): no path calls it; it is
// timed and held against this one.

#include <cuda_runtime.h>

#include "lstm_gscan.cuh"
#include "lstm_scan.cuh"

namespace {

using lstm_scan::ROWS;

// The row-tile K7: one block per (tile of ROWS rows, group); one thread per gate
// column accumulates h.Wh for the tile's rows (Wh resident), then threads over
// (row, unit) apply the cell; two block barriers a step.
__global__ void rowtile_kernel(const float* __restrict__ x_proj, const int* __restrict__ lengths,
                               const float* __restrict__ wh, float* __restrict__ out,
                               float* __restrict__ fin, int n, int T, int H, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int G4 = 4 * H;
  float* hs = smem + H * G4;         // [H][ROWS], after Wh [H][4H]
  float* gates = hs + H * ROWS;      // [ROWS][4H]
  float* cs = gates + ROWS * G4;     // [ROWS][H]
  __shared__ int len_s[ROWS];

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* __restrict__ W = wh + (size_t)g * H * G4;
  const size_t grow0 = (size_t)g * n + row0;   // first row of the tile in [G*N]

  const int max_len = lstm_scan::load_lengths(len_s, lengths, grow0, row0, n, T, tid);
  for (int i = tid; i < H * G4; i += nt) smem[i] = W[i];
  for (int i = tid; i < ROWS * H; i += nt) {
    hs[i] = 0.0f;
    cs[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < max_len; ++t) {
    for (int col = tid; col < G4; col += nt) {
      float xv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        xv[r] = (t < len_s[r]) ? x_proj[((grow0 + r) * T + t) * G4 + col] : 0.0f;
      }
      float acc[ROWS];
      lstm_scan::gate_acc(acc, smem, hs, col, G4, H);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) gates[r * G4 + col] = xv[r] + acc[r];
    }
    __syncthreads();
    lstm_scan::cell_step(gates, hs, cs, len_s, out, grow0, row0, n, T, t, H, forget_bias,
                         tid, nt);
    __syncthreads();
  }
  lstm_scan::finish(hs, out, fin, grow0, row0, n, T, max_len, H, tid, nt);
}

size_t rowtile_smem_bytes(int H) {
  return sizeof(float) * ((size_t)H * 4 * H + (size_t)H * ROWS + (size_t)ROWS * 4 * H +
                          (size_t)ROWS * H);
}

}  // namespace

// K7 with clusters of c CTAs, tiles of `rows` rows and `split` lanes per
// unit, Wh resident or read from device memory (gscan::wh_global; force:
// from device memory at any width).
static int launch_scan(const float* x_proj, const int* lengths, long long len_stride,
                       const float* wh, long long wh_stride, float* out, float* fin, int g,
                       int n, int t, int h, int c, int rows, int split, float forget_bias,
                       void* stream, bool force) {
  const bool global = force || gscan::wh_global(h, c, rows, split);
#define LSTM_GROUPED_CASE(R, S_)                                                                  \
  if (rows == R && split == S_)                                                                   \
    return global ? gscan::launch<R, S_, false, true>(x_proj, lengths, len_stride, wh,            \
                                                       wh_stride, out, fin, g, n, t, h, c,        \
                                                       forget_bias, stream)                       \
                  : gscan::launch<R, S_, false, false>(x_proj, lengths, len_stride, wh,           \
                                                        wh_stride, out, fin, g, n, t, h, c,       \
                                                        forget_bias, stream);
  LSTM_GROUPED_CASE(8, 4)
  LSTM_GROUPED_CASE(8, 8)
  LSTM_GROUPED_CASE(8, 16)
  LSTM_GROUPED_CASE(16, 4)
#undef LSTM_GROUPED_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// The (cluster, rows per tile, lanes per unit) for g groups of n rows at hidden
// width h (gscan::route; t does not change it; past the largest cluster that
// holds the Wh slices, Wh global), and in *wh_global whether the launch at that
// route reads Wh from device memory: 0, or -1 when the shape cannot run.
int lstm_grouped_route(int g, int n, int t, int h, int* cluster, int* rows, int* split,
                       int* wh_global) {
  (void)t;
  return gscan::route_c(g, n, h, cluster, rows, split, wh_global);
}

long long lstm_grouped_smem_bytes(int h, int c, int rows, int split) {
  return (long long)gscan::smem_bytes(h, c, rows, split, false);
}

const char* lstm_grouped_error_string(int err) { return lrec::error_string(err); }

// K7 on x_proj [G, N, T, 4H] (layout above) with clusters of c CTAs, tiles of
// `rows` rows and `split` lanes per unit (lstm_grouped_route; Wh global where the
// route's rule says so). Returns the cudaError_t of the launch, -1 when the
// cluster cannot be scheduled, or 22 (cudaErrorInvalidValue) for a (rows,
// split) pair with no instantiation.
int lstm_grouped(const float* x_proj, const int* lengths, long long len_stride, const float* wh,
                 long long wh_stride, float* out, float* fin, int g, int n, int t, int h, int c,
                 int rows, int split, float forget_bias, void* stream) {
  return launch_scan(x_proj, lengths, len_stride, wh, wh_stride, out, fin, g, n, t, h, c, rows,
                     split, forget_bias, stream, false);
}

// lstm_grouped with Wh read from device memory at any width: no package path calls
// it; the card tests hold it against the resident route at the same (c, rows,
// split), bit for bit.
int lstm_grouped_wh_global(const float* x_proj, const int* lengths, long long len_stride,
                           const float* wh, long long wh_stride, float* out, float* fin, int g,
                           int n, int t, int h, int c, int rows, int split, float forget_bias,
                           void* stream) {
  return launch_scan(x_proj, lengths, len_stride, wh, wh_stride, out, fin, g, n, t, h, c, rows,
                     split, forget_bias, stream, true);
}

long long lstm_grouped_rowtile_smem_bytes(int h) { return (long long)rowtile_smem_bytes(h); }

// The row-tile K7 on x_proj [G, N, T, 4H], lengths [G, N], wh [G, H, 4H] (contiguous).
// Returns the cudaError_t of the launch.
int lstm_grouped_rowtile(const float* x_proj, const int* lengths, const float* wh, float* out,
                         float* fin, int g, int n, int t, int h, float forget_bias,
                         void* stream) {
  return lstm_scan::launch(rowtile_kernel, rowtile_smem_bytes(h), x_proj, lengths, wh, out, fin,
                           g, n, t, h, forget_bias, stream);
}

}  // extern "C"
