// Bi-LSTM backward recurrence (TF1 BasicLSTMCell numerics) from saved
// pre-activations: the redesigned K1b, the pair of lstm_proj.cuh + lstm_rec.cu.
//
// Replaces the TPU kernel fvta_memexqa_tpu/ops/lstm_fused.py:_bwd_step_kernel
// (launched by _fused_scan_bwd). Same function as csrc/lstm_bwd.cu: a
// reverse-time walk over each row that applies the TF1 cell's derivatives under
// the prefix-length mask m = t < L and writes dgates[t] = (di, dj, df, do) at
// the original positions, zeros past a row's length, with the TPU kernel's
// carries:
//   dh_in    = dh_carry + m * g_out[t] + [t == L-1] * g_fin
//   dh_carry <- dgates . Wh^T + (1 - m) * dh_in
//   dc_carry <- dc_total * f + (1 - m) * dc_in
// dX, dWx, dWh and db stay the four matrix products of ops/lstm_fused
// (_assemble_bwd), as the JAX package leaves them to XLA.
//
// Inputs: pre [N, T, 8H], the gate pre-activations lstm_rec.cu wrote under grad
// (forward direction in [:4H], backward in [4H:], original positions); cell
// [N, T, 2H], the carried c; g_out [N, T, 2H] and g_fin [N, 2H] (either may be
// null = zero); both directions' wh [H, 4H]. No x, no Wx: nothing is
// recomputed.
//
// What bounds the old K1b on this card, and what this design does about it
// (geometry and the reduction: lstm_rec.cuh):
// - every step it recomputed the pre-activations, a 300-term chain of L2
//   loads: here they are read from `pre`, loaded a step ahead into registers
//   by the lane that uses them (with the cell states and g_out);
// - its 400-term dgates . Wh^T chain, again from L2, and three barriers per
//   step: here Wh is resident in shared memory, transposed on the way in (no
//   wh.t() copy per call), the 4H-term sum of a unit is split over S lanes and
//   met in warp shuffles, and a step has one cluster barrier;
// - its thin grid: the same cluster split by hidden units as the forward. Each
//   CTA computes the dgates of its units and writes them to every CTA of the
//   cluster through distributed shared memory (double-buffered); after one
//   cluster barrier each CTA forms dh for its own units over all 4H columns, in
//   a fixed order.
// The carried dh and dc stay in the registers of the lanes that own each
// (row, unit).

#include "lstm_rec.cuh"

namespace {

using lrec::Lanes;

template <int ROWS, int S>
__global__ void __launch_bounds__(ROWS == 16 ? 416 : 512)
lstm_rec_bwd_kernel(const float* __restrict__ pre, const int* __restrict__ lengths,
                    const float* __restrict__ wh_fw, const float* __restrict__ wh_bw,
                    const float* __restrict__ cseq, const float* __restrict__ g_out,
                    const float* __restrict__ g_fin, float* __restrict__ dgates, int n, int T,
                    int H, int hc, int units, int stride, float forget_bias) {
  using LN = Lanes<ROWS, S>;
  constexpr int RP = LN::RP;
  extern __shared__ __align__(16) float smem[];
  float* wts = smem;                  // [4H][stride]: Wh[u][col] at col.stride + v
  float* dgs = wts + 4 * H * stride;  // [2][4H][ROWS]: dgates of every unit, double-buffered
  __shared__ int len_s[ROWS];

  lrec::cg::cluster_group cluster = lrec::cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;
  const int u0 = rank * hc;
  const float* __restrict__ Wh = dir ? wh_bw : wh_fw;
  const int G4 = 4 * H, G8 = 8 * H;
  const size_t hstride = 2 * (size_t)H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32;
  const int s = lane / LN::UPW;
  const int v = (tid / 32) * LN::UPW + lane % LN::UPW;
  const int u = u0 + v;
  const bool unit_ok = v < hc && u < H;
  const bool writes = unit_ok && LN::writer(s);
  const int rlo = LN::row_lo(s);

  // rows the CTA's units (a row of Wh each), columns the 4H gate columns
  lrec::load_resident(
      units, G4, tid, nt,
      [&](int w, int col) -> const float* {
        return (w < hc && u0 + w < H) ? Wh + (size_t)(u0 + w) * G4 + col : nullptr;
      },
      [&](int w, int col) { return wts + col * stride + w; });

  const int tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x / C; tile < tiles; tile += gridDim.x / C) {
    const int row0 = tile * ROWS;
    if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? lengths[row0 + tid] : 0;
    __syncthreads();
    int max_len = 0;
    for (int r = 0; r < ROWS; ++r) max_len = max(max_len, len_s[r]);
    max_len = min(max_len, T);
    cluster.sync();   // every CTA of the cluster is on this tile with Wh loaded

    // per owned row: pre-activations, g_out and c of step tt (cv: step t, cpv:
    // step t-1 = the c_prev of step t), dc and dh carries, g_fin
    float pv[RP][4], pn[RP][4], gov[RP], gon[RP], cv[RP], cpv[RP], cn[RP];
    float dh_reg[RP], dc_reg[RP], gfin[RP];
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      dh_reg[j] = dc_reg[j] = gfin[j] = gov[j] = gon[j] = cv[j] = cpv[j] = cn[j] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) pv[j][g] = pn[j][g] = 0.0f;
      const int row = row0 + rlo + j;
      if (unit_ok && g_fin != nullptr && row < n) {
        gfin[j] = g_fin[(size_t)row * hstride + dir * H + u];
      }
    }
    auto pos_of = [&](int L, int tt) { return dir ? L - 1 - tt : tt; };
    auto load_step = [&](float (&p)[RP][4], float (&go)[RP], int tt) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int L = len_s[rlo + j];
        if (unit_ok && tt >= 0 && tt < L) {
          const size_t base = (size_t)(row0 + rlo + j) * T + pos_of(L, tt);
          const float* q = pre + base * G8 + dir * G4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) p[j][g] = q[g * H];
          if (g_out != nullptr) go[j] = g_out[base * hstride + dir * H + u];
        }
      }
    };
    auto load_c = [&](float (&c)[RP], int tt) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int L = len_s[rlo + j];
        c[j] = 0.0f;   // c before step 0 is 0
        if (unit_ok && tt >= 0 && tt < L) {
          c[j] = cseq[((size_t)(row0 + rlo + j) * T + pos_of(L, tt)) * hstride + dir * H + u];
        }
      }
    };
    load_step(pv, gov, max_len - 1);
    load_c(cv, max_len - 1);
    load_c(cpv, max_len - 2);

    for (int t = max_len - 1; t >= 0; --t) {
      float* dcur = dgs + (t & 1) * G4 * ROWS;
      load_step(pn, gon, t - 1);   // in flight during this step
      load_c(cn, t - 2);
      // 1. the cell derivatives of this lane's rows
      float dg[RP][4];
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int L = len_s[rlo + j];   // 0 for rows past n
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[j][g] = 0.0f;
        if (t < L) {
          const float i_s = lrec::sigmoid_(pv[j][0]);
          const float j_t = tanhf(pv[j][1]);
          const float f_s = lrec::sigmoid_(pv[j][2] + forget_bias);
          const float o_s = lrec::sigmoid_(pv[j][3]);
          const float tanh_c = tanhf(cv[j]);
          float dh_in = dh_reg[j] + gov[j];
          if (t == L - 1) dh_in += gfin[j];
          // m = 1 here: dc_total = dc_in + dh_in * o * (1 - tanh(c)^2)
          const float dc_tot = dc_reg[j] + dh_in * o_s * (1.0f - tanh_c * tanh_c);
          dg[j][0] = dc_tot * j_t * i_s * (1.0f - i_s);
          dg[j][1] = dc_tot * i_s * (1.0f - j_t * j_t);
          dg[j][2] = dc_tot * cpv[j] * f_s * (1.0f - f_s);
          dg[j][3] = dh_in * tanh_c * o_s * (1.0f - o_s);
          dc_reg[j] = dc_tot * f_s;   // (1 - m) * dc_in = 0
        }
      }
      // the dgates to every CTA of the cluster, then to global memory between the
      // barrier's arrive and its wait, off the step's critical path
      if (writes) {
        for (int q = 0; q < C; ++q) {
          float* dst = cluster.map_shared_rank(dcur, q) + u * ROWS + rlo;
#pragma unroll
          for (int j = 0; j < RP; ++j)
#pragma unroll
            for (int g = 0; g < 4; ++g) dst[g * H * ROWS + j] = dg[j][g];
        }
      }
      lrec::cluster_arrive();
      if (writes) {
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          const int row = row0 + rlo + j;
          const int L = len_s[rlo + j];
          if (row >= n) continue;
          float* o = dgates + ((size_t)row * T + (t < L ? pos_of(L, t) : t)) * G8 + dir * G4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) o[g * H] = dg[j][g];
        }
      }
      lrec::cluster_wait();
      // 2. the carried dh of this CTA's units: dgates . Wh^T over all 4H columns
      //    (rows past their length have zero dgates, so their dh stays 0)
      float acc[ROWS][1];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r][0] = 0.0f;
#pragma unroll 4
      for (int col = s; col < G4; col += S) {
        const float w = wts[col * stride + v];
#pragma unroll
        for (int r = 0; r < ROWS; r += 4) {
          const float4 d = *reinterpret_cast<const float4*>(dcur + col * ROWS + r);
          acc[r][0] = fmaf(d.x, w, acc[r][0]);
          acc[r + 1][0] = fmaf(d.y, w, acc[r + 1][0]);
          acc[r + 2][0] = fmaf(d.z, w, acc[r + 2][0]);
          acc[r + 3][0] = fmaf(d.w, w, acc[r + 3][0]);
        }
      }
      lrec::reduce_rows<ROWS, S / 2, LN::UPW, ROWS, 1>(acc, s);
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        dh_reg[j] = acc[j][0];
        gov[j] = gon[j];
        cv[j] = cpv[j];
        cpv[j] = cn[j];
#pragma unroll
        for (int g = 0; g < 4; ++g) pv[j][g] = pn[j][g];
      }
    }
    // positions past the tile's longest row: zero dgates
    if (writes) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int row = row0 + rlo + j;
        if (row >= n) continue;
        for (int t = max_len; t < T; ++t) {
          float* o = dgates + ((size_t)row * T + t) * G8 + dir * G4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) o[g * H] = 0.0f;
        }
      }
    }
    __syncthreads();   // len_s is the next tile's
  }
}

template <int ROWS, int S>
int launch(const float* pre, const int* lengths, const float* wh_fw, const float* wh_bw,
           const float* cell, const float* g_out, const float* g_fin, float* dgates, int n,
           int t, int h, int c, float forget_bias, void* stream) {
  const lrec::Geometry g = lrec::bwd_geometry(h, c, ROWS, S);
  const int tiles = (n + ROWS - 1) / ROWS;
  return lrec::launch_clusters(lstm_rec_bwd_kernel<ROWS, S>, tiles, c, g, stream, pre,
                                   lengths, wh_fw, wh_bw, cell, g_out, g_fin, dgates, n, t, h,
                                   g.hc, g.units, g.stride, forget_bias);
}

}  // namespace

extern "C" {

long long lstm_rec_bwd_smem_bytes(int h, int c, int rows, int split) {
  return (long long)lrec::bwd_geometry(h, c, rows, split).smem;
}

const char* lstm_rec_bwd_error_string(int err) { return lrec::error_string(err); }

// dgates [N, T, 8H] from the saved pre-activations pre [N, T, 8H], cell
// [N, T, 2H], g_out [N, T, 2H] and g_fin [N, 2H] (either may be null), lengths
// [N] int32 and both directions' wh [H, 4H], with the forward's (c, rows,
// split). Returns as lstm_rec does.
int lstm_rec_bwd(const float* pre, const int* lengths, const float* wh_fw, const float* wh_bw,
                 const float* cell, const float* g_out, const float* g_fin, float* dgates,
                 int n, int t, int h, int c, int rows, int split, float forget_bias,
                 void* stream) {
#define LSTM_REC_BWD_CASE(R, S_)                                                        \
  if (rows == R && split == S_)                                                         \
    return launch<R, S_>(pre, lengths, wh_fw, wh_bw, cell, g_out, g_fin, dgates, n, t,  \
                         h, c, forget_bias, stream);
  LSTM_REC_BWD_CASE(8, 4)
  LSTM_REC_BWD_CASE(8, 8)
  LSTM_REC_BWD_CASE(8, 16)
  LSTM_REC_BWD_CASE(16, 4)
#undef LSTM_REC_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
