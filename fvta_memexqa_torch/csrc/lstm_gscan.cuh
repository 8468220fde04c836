// The grouped LSTM scan shared by K7 (lstm_grouped.cu) and K8 (lstm_stream.cu):
// for G independent scans over a precomputed x_proj [G, N, T, 4H], gates =
// x_proj[t] + h.Wh in (i, j, f, o) order, the TF1 cell with forget_bias inside
// the sigmoid, prefix-length masking (at t >= L a row's h and c stop updating
// and its output is 0), out [G, N, T, H] and fin [G, N, H] (the last carried h).
//
// The recurrence is K1's (lstm_rec.cu, geometry and reduction in lstm_rec.cuh),
// over G groups instead of two directions: a cluster of C CTAs owns a tile of
// ROWS rows of one group at a time (grid (C . clusters, G); clusters walk the
// tiles with the grid's stride, so each CTA loads its Wh slice once); CTA rank q
// owns the hidden units [q.Hc, (q+1).Hc), their four gate columns of Wh resident
// in shared memory, and their c in registers. S lanes share each unit's H terms
// of h.Wh and meet in reduce_rows' fixed shuffle tree; the new h goes to every
// CTA of the cluster through distributed shared memory, double-buffered, with
// one split cluster barrier a step. Every sum runs in K1's order, so a group fed
// K1's projection (its backward half flipped to the front) gives K1's bits.
//
// The two kernels differ only in how x_proj[t] reaches a step, as the TPU
// kernels do (resident block vs DMA ring):
// - K7: each lane loads the x_proj values of step t + 1 for its own rows and
//   unit into registers at the top of step t (no shared ring, no barrier);
// - K8: a two-slot ring in shared memory per CTA holds the ROWS x 4 x Hc slice
//   of x_proj that its units read; at the top of step t one warp fills the slot
//   of step t + 1 with 1-D bulk async copies (one run of Hc floats per row and
//   gate, completion counted in bytes on the slot's mbarrier), and the lanes
//   wait on that mbarrier, not on a block barrier, after step t + 1's dot
//   products. Where a run is not 16-byte aligned (H or Hc not a multiple of 4,
//   or x_proj off a 16-byte boundary) every thread starts 4-byte cp.async
//   copies and arrives on the mbarrier when they land.
//
// `route` below (plain C++: the tests compile it for the host) picks (C, ROWS,
// S) by lstm_fused.lstm_route's rule generalised to G groups, with the grouped
// kernels' own shared memory (K8's ring included, so that K7 and K8 always share
// a route and give the same bits); ops/lstm_grouped.grouped_route mirrors it.
//
// Wh global (WH_GLOBAL; H past the largest cluster, H = 316 and up on the H100):
// where no cluster of at most MAX_CLUSTER holds its Wh slices, the route takes
// clusters of MAX_CLUSTER, 8-row tiles and 4 lanes per unit (a CTA within 1024
// threads up to H = 2048), and each CTA reads its Wh columns from device
// memory (they stay in L2) at every step instead of holding them resident; h
// and K8's ring stay in shared memory. With 4 lanes a warp's load of one gate
// takes 8 adjacent units of 4 rows of Wh, whole 32-byte sectors: at H = 316
// and 512 on the H100 the scan took 0.69 and 1.92 ms against 1.59 and 4.89
// with 16 lanes (G = 2, N = 256, T = 24). The choice is by shape (`wh_global`),
// and the FMA order is the resident kernel's, so at the same (C, ROWS, S) both
// give the same bits.

#pragma once

#include <stdint.h>

#include "lstm_rec.cuh"

namespace gscan {

// ---- the route (host-compilable) ----
constexpr int SM_COUNT = 132;            // streaming multiprocessors of the H100 SXM
constexpr int MAX_CLUSTER = 8;           // the largest portable thread-block cluster
constexpr int MIN_UNITS_PER_CTA = 8;     // a cluster is not split finer than this
constexpr size_t SMEM_LIMIT = 232448;    // shared memory bytes a CTA may use
constexpr size_t HEADER_BYTES = 128;     // the ring's two mbarriers and the tile's lengths

inline int max_threads(int rows) { return rows == 16 ? 416 : 512; }   // __launch_bounds__
constexpr int MAX_THREADS_WH_GLOBAL = 1024;   // the Wh-global kernels' __launch_bounds__

// Floats between the (row, gate) runs of K8's ring: Hc rounded up to 4.
inline int ring_stride(int h, int c) { return ((h + c - 1) / c + 3) / 4 * 4; }

// Dynamic shared memory of K7 (stream = false) or K8 (true) per CTA, with Wh
// resident (global = false) or read from device memory (h alone staged).
inline size_t layout_bytes(int h, int c, int rows, int split, bool stream, bool global) {
  return HEADER_BYTES +
         (global ? sizeof(float) * 2 * (size_t)h * rows
                 : lrec::fwd_geometry(h, c, rows, split).smem) +
         (stream ? sizeof(float) * 2 * 4 * (size_t)rows * ring_stride(h, c) : 0);
}

// Whether (c, rows, split) reads Wh from device memory: its resident K8 does
// not fit the thread limit or the shared memory.
inline bool wh_global(int h, int c, int rows, int split) {
  return lrec::fwd_geometry(h, c, rows, split).threads > max_threads(rows) ||
         layout_bytes(h, c, rows, split, true, false) > SMEM_LIMIT;
}

// Dynamic shared memory per CTA of the kernel (c, rows, split) launches.
inline size_t smem_bytes(int h, int c, int rows, int split, bool stream) {
  return layout_bytes(h, c, rows, split, stream, wh_global(h, c, rows, split));
}

// The most lanes per unit within the thread limit whose K8 fits; 0 if none does.
inline int pick_split(int h, int c, int rows) {
  static const int by8[] = {16, 8, 4};
  static const int by16[] = {4};
  const int* splits = rows == 16 ? by16 : by8;
  const int count = rows == 16 ? 1 : 3;
  for (int i = 0; i < count; ++i) {
    if (!wh_global(h, c, rows, splits[i])) return splits[i];
  }
  return 0;
}

// Wh global at clusters of MAX_CLUSTER and 8-row tiles: 4 lanes per unit where
// the CTA stays within 1024 threads and K8 fits; 0 otherwise (more lanes only
// add threads).
inline int pick_split_wh_global(int h) {
  return lrec::fwd_geometry(h, MAX_CLUSTER, 8, 4).threads <= MAX_THREADS_WH_GLOBAL &&
                 layout_bytes(h, MAX_CLUSTER, 8, 4, true, true) <= SMEM_LIMIT
             ? 4
             : 0;
}

struct Route {
  int cluster, rows, split;   // split 0: the shape cannot run (h does not fit)
};

// With blocks = G . ceil(n / 8): up to 2 . SM_COUNT blocks the cluster is at
// least 2 and doubles while blocks . cluster stays within SM_COUNT and each CTA
// keeps MIN_UNITS_PER_CTA units; past that, one-CTA clusters with tiles of 16
// rows where they fit and fill the card. Where no cluster holds Wh, Wh global
// (clusters of MAX_CLUSTER, 8 rows). T does not change the choice.
inline Route route(int g, int n, int h) {
  int fit = 0;
  for (int c = 1; c <= MAX_CLUSTER && fit == 0; c *= 2) {
    if (pick_split(h, c, 8) != 0) fit = c;
  }
  if (fit == 0) {
    const int s = pick_split_wh_global(h);
    return {s ? MAX_CLUSTER : 0, s ? 8 : 0, s};
  }
  const long long blocks = (long long)g * ((n + 7) / 8);
  if (blocks > 2 * SM_COUNT) {
    if (fit == 1 && (long long)g * ((n + 15) / 16) >= SM_COUNT && pick_split(h, 1, 16) != 0) {
      return {1, 16, pick_split(h, 1, 16)};
    }
    return {fit, 8, pick_split(h, fit, 8)};
  }
  int c = fit;
  while (2 * c <= MAX_CLUSTER && (c < 2 || blocks * 2 * c <= SM_COUNT) &&
         (h + 2 * c - 1) / (2 * c) >= MIN_UNITS_PER_CTA && pick_split(h, 2 * c, 8) != 0) {
    c *= 2;
  }
  return {c, 8, pick_split(h, c, 8)};
}
// ---- end of the route ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the current phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory; completion counted on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Group g's Wh [H, 4H] starts at wh + g . wh_stride floats and its lengths at
// lengths + g . len_stride (0: every group shares one row of lengths). hc,
// units and stride are lrec::fwd_geometry's; hcs = ring_stride; bulk selects
// K8's bulk copies (else 4-byte cp.async). WH_GLOBAL: each lane reads its
// unit's four Wh columns from device memory at every step.
template <int ROWS, int S, bool STREAM, bool WH_GLOBAL>
__global__ void __launch_bounds__(WH_GLOBAL ? MAX_THREADS_WH_GLOBAL : (ROWS == 16 ? 416 : 512))
gscan_kernel(const float* __restrict__ x_proj, const int* __restrict__ lengths,
             long long len_stride, const float* __restrict__ wh, long long wh_stride,
             float* __restrict__ out, float* __restrict__ fin, int n, int T, int H, int hc,
             int units, int stride, int hcs, int bulk, float forget_bias) {
  using LN = lrec::Lanes<ROWS, S>;
  constexpr int RP = LN::RP;
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [2]: K8's ring slots
  int* len_s = reinterpret_cast<int*>(smem) + 4;         // [ROWS]
  float* whs = smem + HEADER_BYTES / sizeof(float);      // [H][stride]: Wh[k][g.H + u] at
                                                         // k.stride + 4.v + g (resident)
  float* hs = whs + (WH_GLOBAL ? 0 : H * stride);        // [2][H][ROWS]: h, double-buffered
  float* ring = hs + 2 * H * ROWS;                       // K8: [2][ROWS][4][hcs]

  lrec::cg::cluster_group cluster = lrec::cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int grp = blockIdx.y;
  const int u0 = rank * hc;
  const int mine = max(0, min(hc, H - u0));   // the CTA's units
  const float* __restrict__ Wh = wh + (long long)grp * wh_stride;
  const int* __restrict__ len_g = lengths + (long long)grp * len_stride;
  const size_t grow = (size_t)grp * n;        // the group's first row in [G . N]
  const int G4 = 4 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32;
  const int s = lane / LN::UPW;
  const int v = (tid / 32) * LN::UPW + lane % LN::UPW;   // unit within the CTA
  const int u = u0 + v;
  const bool unit_ok = v < hc && u < H;
  const bool writes = unit_ok && LN::writer(s);
  const int rlo = LN::row_lo(s);

  // rows (k . 4 + g) of the slice, columns the CTA's units
  if constexpr (!WH_GLOBAL)
    lrec::load_resident(
        4 * H, units, tid, nt,
        [&](int r, int w) -> const float* {
          return (w < hc && u0 + w < H) ? Wh + (size_t)(r / 4) * G4 + (r % 4) * H + u0 + w
                                        : nullptr;
        },
        [&](int r, int w) { return whs + (r / 4) * stride + 4 * w + r % 4; });
  if (STREAM && tid == 0) {
    mbar_init(&full[0], bulk ? 1 : nt);
    mbar_init(&full[1], bulk ? 1 : nt);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  unsigned phase = 0;   // K8: bit q is the parity of ring slot q's next completion
  // K8's 4-byte copies: this thread's first element of a slot and its stride
  const int q0 = mine > 0 ? tid / mine : 0, w0 = mine > 0 ? tid % mine : 0;
  const int dq = mine > 0 ? nt / mine : 0, dw = mine > 0 ? nt % mine : 0;

  // K8: copy x_proj[tt] of the tile's live rows into ring slot `slot`. The
  // slot was last read before the previous step's cluster barrier (or before
  // the tile's cluster.sync), which this thread has passed.
  auto fill = [&](int row0, int tt, int slot) {
    float* dst = ring + slot * ROWS * 4 * hcs;
    if (bulk) {
      if (tid < 32) {
        if (lane == 0) {
          int live = 0;
          for (int r = 0; r < ROWS; ++r) live += tt < len_s[r];
          mbar_arrive_expect(&full[slot], (unsigned)(live * 4 * mine * sizeof(float)));
        }
        __syncwarp();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int i = lane; i < ROWS * 4 && mine > 0; i += 32) {
          const int r = i / 4, g = i % 4;
          if (tt < len_s[r]) {
            bulk_copy(dst + i * hcs, x_proj + ((grow + row0 + r) * T + tt) * G4 + g * H + u0,
                      (unsigned)(mine * sizeof(float)), &full[slot]);
          }
        }
      }
    } else {   // element (q = 4 . row + gate, w) of the slice, stepped by adds
      int q = q0, w = w0;
      for (int i = tid; i < ROWS * 4 * mine; i += nt) {
        if (tt < len_s[q >> 2]) {
          copy4(dst + q * hcs + w,
                x_proj + ((grow + row0 + (q >> 2)) * T + tt) * G4 + (q & 3) * H + u0 + w);
        }
        q += dq;
        w += dw;
        if (w >= mine) {
          w -= mine;
          ++q;
        }
      }
      copies_arrive(&full[slot]);
    }
  };

  const int tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x / C; tile < tiles; tile += gridDim.x / C) {
    const int row0 = tile * ROWS;
    if (tid < ROWS) len_s[tid] = (row0 + tid < n) ? len_g[row0 + tid] : 0;
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
    // K7: x_proj of step tt for this lane's rows and unit, into registers
    auto load_x = [&](float (&dst)[RP][4], int tt) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        if (unit_ok && tt < len_s[rlo + j]) {
          const float* p = x_proj + ((grow + row0 + rlo + j) * T + tt) * G4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) dst[j][g] = p[g * H];
        }
      }
    };
    if (max_len > 0) {
      if (STREAM) {
        fill(row0, 0, 0);
      } else {
        load_x(xv, 0);
      }
    }

    for (int t = 0; t < max_len; ++t) {
      const float* hcur = hs + (t & 1) * H * ROWS;
      float* hnxt = hs + ((t + 1) & 1) * H * ROWS;
      if (t + 1 < max_len) {   // in flight during this step's dot products
        if (STREAM) {
          fill(row0, t + 1, (t + 1) & 1);
        } else {
          load_x(xn, t + 1);
        }
      }
      // 1. h.Wh for this lane's k terms, all ROWS rows, the unit's 4 gates
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      // K7 at 16 rows unrolls 2: its 64 accumulators, x_proj in flight and 4
      // unrolled steps' loads spill more under the 128 registers 13 warps
      // leave a thread (8% slower at 3072 x 10 on the H100); K8 at 16 rows
      // was 7% slower unrolled 2. Each accumulator's FMA order is the same.
#pragma unroll(ROWS == 16 && !STREAM ? 2 : 4)
      for (int k = s; k < H; k += S) {
        float4 w;
        if constexpr (WH_GLOBAL) {   // a padding unit's columns are zero, as resident
          const float* wk = Wh + (size_t)k * G4 + u;
          w = unit_ok ? make_float4(__ldg(wk), __ldg(wk + H), __ldg(wk + 2 * H),
                                    __ldg(wk + 3 * H))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          w = *reinterpret_cast<const float4*>(whs + k * stride + 4 * v);
        }
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
      if (STREAM) {   // K8: step t's slot has landed
        const int slot = t & 1;
        mbar_wait(&full[slot], (phase >> slot) & 1u);
        phase ^= 1u << slot;
        const float* cur = ring + slot * ROWS * 4 * hcs;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          if (unit_ok && t < len_s[rlo + j]) {
#pragma unroll
            for (int g = 0; g < 4; ++g) xv[j][g] = cur[((rlo + j) * 4 + g) * hcs + v];
          }
        }
      }
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
          if (row >= n) continue;
          out[((grow + row) * T + t) * H + u] = t < len_s[rlo + j] ? h_reg[j] : 0.0f;
        }
      }
      lrec::cluster_wait();
      if (!STREAM) {
#pragma unroll
        for (int j = 0; j < RP; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) xv[j][g] = xn[j][g];
      }
    }
    // positions past the tile's longest row: zero outputs; fin
    if (writes) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int row = row0 + rlo + j;
        if (row >= n) continue;
        for (int t = max_len; t < T; ++t) out[((grow + row) * T + t) * H + u] = 0.0f;
        fin[(grow + row) * H + u] = h_reg[j];
      }
    }
    __syncthreads();   // len_s and hs are the next tile's
  }
}

// Launch the kernel for (ROWS, S) with clusters of c CTAs over g groups.
// Returns the cudaError_t of the launch, or lrec::CLUSTER_UNSCHEDULABLE.
template <int ROWS, int S, bool STREAM, bool WH_GLOBAL>
int launch(const float* x_proj, const int* lengths, long long len_stride, const float* wh,
           long long wh_stride, float* out, float* fin, int g, int n, int t, int h, int c,
           float forget_bias, void* stream) {
  lrec::Geometry geo = lrec::fwd_geometry(h, c, ROWS, S);
  geo.smem = layout_bytes(h, c, ROWS, S, STREAM, WH_GLOBAL);
  const int bulk = STREAM && h % 4 == 0 && geo.hc % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x_proj) % 16 == 0;
  const int tiles = (n + ROWS - 1) / ROWS;
  return lrec::launch_groups(gscan_kernel<ROWS, S, STREAM, WH_GLOBAL>, tiles, g, c, geo, stream,
                             x_proj, lengths, len_stride, wh, wh_stride, out, fin, n, t, h,
                             geo.hc, geo.units, geo.stride, ring_stride(h, c), bulk,
                             forget_bias);
}

// The route for the C interface, with whether its launch reads Wh from device
// memory (the launch decides it by `wh_global` on the same (c, rows, split)):
// 0, or -1 when the shape cannot run.
inline int route_c(int g, int n, int h, int* cluster, int* rows, int* split, int* global) {
  const Route r = route(g, n, h);
  *cluster = r.cluster;
  *rows = r.rows;
  *split = r.split;
  *global = r.split != 0 && wh_global(h, r.cluster, r.rows, r.split);
  return r.split == 0 ? -1 : 0;
}

}  // namespace gscan
