// Bi-LSTM forward recurrence over precomputed input projections (TF1
// BasicLSTMCell numerics): the serial half of the redesigned K1; the projection
// is lstm_proj.cuh, which this library also exports.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_fwd_step_kernel
// (with lstm_proj.cuh). Same function as csrc/lstm_fwd.cu: per step
// gates = xg[t] + h.Wh in (i, j, f, o) order, forget_bias inside the sigmoid,
// prefix-length masking (past a row's length h and c stop updating and the
// output is 0), fin = the last carried h; the backward direction reads
// xg[L-1-t] and writes its outputs there. xg [N, T, 8H] holds x.Wx + b of both
// directions at the original positions (forward in [:4H], backward in [4H:]).
// Outputs: out [N, T, 2H] (optional), cell [N, T, 2H] (optional: the carried c
// at each position, as csrc/lstm_fwd.cu writes it) and fin [N, 2H]. Under grad
// (write_preact) each step's full pre-activation xg[t] + h_{t-1}.Wh is written
// back over xg[t], in place, for the backward (lstm_rec_bwd.cu).
//
// What bounds the old K1 on this card, and what this design does about it
// (geometry and the reduction: lstm_rec.cuh):
// - its per-step chain of D + H = 300 FMAs per gate column, each waiting on a
//   weight from L2: here x.Wx is off the serial path (lstm_proj.cuh), Wh is
//   resident in shared memory for the whole scan, and the H-term dot product of
//   a unit is split over S lanes (4 to 16) whose partial sums meet in warp
//   shuffles, so a step's chain is ceil(H / S) shared-memory terms;
// - its thin grid (one block per 8-row tile and direction): when few tiles
//   would leave SMs idle, a cluster of C CTAs shares a tile, each CTA owning
//   ceil(H / C) hidden units (their 4 gate columns of Wh and their c); the new h
//   of its units goes to every CTA of the cluster through distributed shared
//   memory, and one cluster barrier per step orders it (h is double-buffered,
//   so the next step's writes cannot reach a slot a slower CTA still reads);
//   each step's global stores go between the barrier's arrive and its wait;
// - the latency of each step's xg loads: a lane loads the xg values of step
//   t + 1 for its own rows and unit into registers at the top of step t, so the
//   loads fly under step t's dot products (each value is read by the lane that
//   loads it, so no shared-memory ring, no barrier and no wait are needed).
// The cell state stays in the registers of the lanes that own each (row, unit).

#include "lstm_proj.cuh"
#include "lstm_rec.cuh"

namespace {

using lrec::Lanes;

template <int ROWS, int S>
__global__ void __launch_bounds__(ROWS == 16 ? 416 : 512)
lstm_rec_kernel(float* xg, const int* __restrict__ lengths, const float* __restrict__ wh_fw,
                const float* __restrict__ wh_bw, float* __restrict__ out,
                float* __restrict__ cell, float* __restrict__ fin, int n, int T, int H,
                int hc, int units, int stride, float forget_bias, int write_preact) {
  using LN = Lanes<ROWS, S>;
  constexpr int RP = LN::RP;
  extern __shared__ __align__(16) float smem[];
  float* whs = smem;                  // [H][stride]: Wh[k][g.H + u] at k.stride + 4.v + g
  float* hs = whs + H * stride;       // [2][H][ROWS]: h of every unit, double-buffered
  __shared__ int len_s[ROWS];

  lrec::cg::cluster_group cluster = lrec::cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int u0 = rank * hc;
  const float* __restrict__ Wh = dir ? wh_bw : wh_fw;
  const int G4 = 4 * H, G8 = 8 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32;
  const int s = lane / LN::UPW;
  const int v = (tid / 32) * LN::UPW + lane % LN::UPW;   // unit within the CTA
  const int u = u0 + v;
  const bool unit_ok = v < hc && u < H;
  const bool writes = unit_ok && LN::writer(s);
  const int rlo = LN::row_lo(s);

  // rows (k . 4 + g) of the slice, columns the CTA's units
  lrec::load_resident(
      4 * H, units, tid, nt,
      [&](int r, int w) -> const float* {
        return (w < hc && u0 + w < H) ? Wh + (size_t)(r / 4) * G4 + (r % 4) * H + u0 + w
                                      : nullptr;
      },
      [&](int r, int w) { return whs + (r / 4) * stride + 4 * w + r % 4; });

  const int tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x / C; tile < tiles; tile += gridDim.x / C) {
    const int row0 = tile * ROWS;
    if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[row0 + tid] : 0;
    for (int i = tid; i < H * ROWS; i += nt) hs[i] = 0.0f;
    __syncthreads();
    int max_len = 0;
    for (int r = 0; r < ROWS; ++r) max_len = max(max_len, len_s[r]);
    max_len = min(max_len, T);
    cluster.sync();   // every CTA of the cluster is on this tile, Wh loaded and h zeroed

    float h_reg[RP], c_reg[RP], xv[RP][4], xn[RP][4];
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      h_reg[j] = c_reg[j] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[j][g] = xn[j][g] = 0.0f;
    }
    // xg of step tt for this lane's rows and unit (backward direction: L-1-tt)
    auto load_xg = [&](float (&dst)[RP][4], int tt) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int L = len_s[rlo + j];
        if (unit_ok && tt < L) {
          const int pos = dir ? L - 1 - tt : tt;
          const float* p = xg + ((size_t)(row0 + rlo + j) * T + pos) * G8 + dir * G4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) dst[j][g] = p[g * H];
        }
      }
    };
    load_xg(xv, 0);

    for (int t = 0; t < max_len; ++t) {
      const float* hcur = hs + (t & 1) * H * ROWS;
      float* hnxt = hs + ((t + 1) & 1) * H * ROWS;
      load_xg(xn, t + 1);   // in flight during this step's dot products
      // 1. h.Wh for this lane's k terms, all ROWS rows, the unit's 4 gates
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
#pragma unroll 4
      for (int k = s; k < H; k += S) {
        const float4 w = *reinterpret_cast<const float4*>(whs + k * stride + 4 * v);
#pragma unroll
        for (int r = 0; r < ROWS; r += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hcur + k * ROWS + r);
          const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r + q][0] = fmaf(hr[q], w.x, acc[r + q][0]);
            acc[r + q][1] = fmaf(hr[q], w.y, acc[r + q][1]);
            acc[r + q][2] = fmaf(hr[q], w.z, acc[r + q][2]);
            acc[r + q][3] = fmaf(hr[q], w.w, acc[r + q][3]);
          }
        }
      }
      lrec::reduce_rows<ROWS, S / 2, LN::UPW, ROWS, 4>(acc, s);
      // 2. the TF1 cell of this lane's rows
      float gt[RP][4];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gt[j][g] = xv[j][g] + acc[j][g];
        if (t < len_s[rlo + j]) {   // len_s is 0 for rows past n
          const float c = c_reg[j] * lrec::sigmoid_(gt[j][2] + forget_bias) +
                          lrec::sigmoid_(gt[j][0]) * tanhf(gt[j][1]);
          h_reg[j] = tanhf(c) * lrec::sigmoid_(gt[j][3]);
          c_reg[j] = c;
        }
      }
      // 3. the new h to every CTA of the cluster; the outputs go to global memory
      //    between the barrier's arrive and its wait, off the step's critical path
      if (writes) {
        for (int q = 0; q < C; ++q) {
          float* dst = cluster.map_shared_rank(hnxt, q) + u * ROWS + rlo;
#pragma unroll
          for (int j = 0; j < RP; ++j) dst[j] = h_reg[j];
        }
      }
      lrec::cluster_arrive();
      if (writes) {
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int row = row0 + rlo + j;
          const int L = len_s[rlo + j];
          if (row >= n) continue;
          const int pos = t < L ? (dir ? L - 1 - t : t) : t;
          const size_t o = ((size_t)row * T + pos) * 2 * H + dir * H + u;
          if (out != nullptr) out[o] = t < L ? h_reg[j] : 0.0f;
          if (cell != nullptr) cell[o] = c_reg[j];
          if (write_preact && t < L) {
            float* p = xg + ((size_t)row * T + pos) * G8 + dir * G4 + u;
#pragma unroll
            for (int g = 0; g < 4; ++g) p[g * H] = gt[j][g];
          }
        }
      }
      lrec::cluster_wait();
#pragma unroll
      for (int j = 0; j < RP; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[j][g] = xn[j][g];
    }
    // positions past the tile's longest row: zero outputs, carried cells; fin
    if (writes) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int row = row0 + rlo + j;
        if (row >= n) continue;
        for (int t = max_len; t < T; ++t) {
          const size_t o = ((size_t)row * T + t) * 2 * H + dir * H + u;
          if (out != nullptr) out[o] = 0.0f;
          if (cell != nullptr) cell[o] = c_reg[j];
        }
        fin[(size_t)row * 2 * H + dir * H + u] = h_reg[j];
      }
    }
    __syncthreads();   // len_s and hs are the next tile's
  }
}

template <int ROWS, int S>
int launch(float* xg, const int* lengths, const float* wh_fw, const float* wh_bw, float* out,
           float* cell, float* fin, int n, int t, int h, int c, float forget_bias,
           int write_preact, void* stream) {
  const lrec::Geometry g = lrec::fwd_geometry(h, c, ROWS, S);
  const int tiles = (n + ROWS - 1) / ROWS;
  return lrec::launch_clusters(lstm_rec_kernel<ROWS, S>, tiles, c, g, stream, xg, lengths,
                                   wh_fw, wh_bw, out, cell, fin, n, t, h, g.hc, g.units,
                                   g.stride, forget_bias, write_preact);
}

}  // namespace

extern "C" {

long long lstm_rec_smem_bytes(int h, int c, int rows, int split) {
  return (long long)lrec::fwd_geometry(h, c, rows, split).smem;
}

const char* lstm_rec_error_string(int err) { return lrec::error_string(err); }

// The forward recurrence on xg [N, T, 8H] (lstm_proj's output; overwritten by
// the pre-activations when write_preact != 0), lengths [N] int32 and both
// directions' wh [H, 4H], with clusters of c CTAs, tiles of `rows` rows and
// `split` lanes per unit (ops/lstm_fused.lstm_route). out and cell may be
// null. Returns the cudaError_t of the launch, or -1 when the cluster cannot
// be scheduled; 22 (cudaErrorInvalidValue) for a (rows, split) pair with no
// instantiation.
int lstm_rec(float* xg, const int* lengths, const float* wh_fw, const float* wh_bw, float* out,
             float* cell, float* fin, int n, int t, int h, int c, int rows, int split,
             float forget_bias, int write_preact, void* stream) {
#define LSTM_REC_CASE(R, S_)                                                              \
  if (rows == R && split == S_)                                                           \
    return launch<R, S_>(xg, lengths, wh_fw, wh_bw, out, cell, fin, n, t, h, c,           \
                         forget_bias, write_preact, stream);
  LSTM_REC_CASE(8, 4)
  LSTM_REC_CASE(8, 8)
  LSTM_REC_CASE(8, 16)
  LSTM_REC_CASE(16, 4)
#undef LSTM_REC_CASE
  return (int)cudaErrorInvalidValue;
}

// The projection alone (lstm_proj.cuh): xg [N, T, 8H] (16-byte aligned) from
// x [N, T, D], lengths [N] int32 and both directions' wx [D, 4H], b [4H].
// Returns the cudaError_t of the launch.
int lstm_proj(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
              const float* b_fw, const float* b_bw, float* xg, int n, int t, int d, int h,
              void* stream) {
  return lproj::launch(x, lengths, wx_fw, wx_bw, b_fw, b_bw, xg, n, t, d, h, stream);
}

// K1 on the Hopper route from one host call: lstm_proj's kernel writes xg
// [N, T, 8H] from x [N, T, D] and both directions' wx [D, 4H], b [4H]; then the
// recurrence runs on it as `lstm_rec` does. Returns the first failing launch's
// error (the projection's as is, the recurrence's as lstm_rec returns it).
int lstm_k1(const float* x, const int* lengths, const float* wx_fw, const float* wx_bw,
            const float* b_fw, const float* b_bw, const float* wh_fw, const float* wh_bw,
            float* xg, float* out, float* cell, float* fin, int n, int t, int d, int h, int c,
            int rows, int split, float forget_bias, int write_preact, void* stream) {
  if (n * t > 0) {
    const int err = lproj::launch(x, lengths, wx_fw, wx_bw, b_fw, b_bw, xg, n, t, d, h, stream);
    if (err != 0) return err;
  }
  return lstm_rec(xg, lengths, wh_fw, wh_bw, out, cell, fin, n, t, h, c, rows, split,
                  forget_bias, write_preact, stream);
}

}  // extern "C"
