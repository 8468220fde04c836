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

#include <cuda_runtime.h>

#include "lstm_gscan.cuh"

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

}  // extern "C"
