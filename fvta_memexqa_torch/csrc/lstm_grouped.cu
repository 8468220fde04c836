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
// the chain per step is a fraction of the first port's row-tile kernel's (one
// thread walked all H terms per gate column, with two block barriers a step),
// the cluster spreads a thin grid over more SMs, and persistent CTAs read Wh
// once.

#include <cuda_runtime.h>

#include "lstm_gscan.cuh"

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

}  // extern "C"
