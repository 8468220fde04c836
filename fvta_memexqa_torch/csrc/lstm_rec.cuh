// The geometry, reduction and cluster launch shared by the redesigned bi-LSTM
// recurrences: the forward lstm_rec.cu (K1 with lstm_proj.cuh) and the backward
// lstm_rec_bwd.cu (K1b); the grouped scans K7 and K8 (lstm_gscan.cuh) run the
// forward's recurrence over G groups with the same parts.
//
// Work split. A cluster of C CTAs owns one tile of ROWS rows of one direction at
// a time (grid (C . clusters, 2 . K) for K bi-LSTMs over one batch, K = 1 but
// in ops/lstm_fused.bilstm_fused_grouped; a cluster walks tiles with the grid's stride
// when the card cannot hold them all at once); CTA rank q owns the hidden units [q.Hc, (q+1).Hc),
// Hc = ceil(H / C). Inside a CTA, S lanes of one warp share each unit: lane
// l = s . UPW + v (UPW = 32 / S units per warp, v the unit within the warp), and
// lane s walks every S-th term of the unit's dot products. `reduce_rows` then
// combines the S partial sums with warp shuffles in a fixed tree that also
// scatters the rows, so that lane s ends with the whole sums of its own rows
// [row_lo, row_lo + RP). Every sum is taken in one fixed order: two launches
// give the same bits, which bitwise resume of training needs.
//
// ops/lstm_fused.lstm_route picks (C, ROWS, S) and computes the same shared
// memory sizes as `fwd_geometry` / `bwd_geometry` below.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

namespace lrec {

namespace cg = cooperative_groups;

constexpr int CLUSTER_UNSCHEDULABLE = -1;   // returned when no cluster fits on the card

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

// A float32 rounded to the nearest bfloat16 (ties to even), kept as a float32:
// the bf16 activation variant's roundings (lstm_rec.cu, lstm_rec_bwd.cu).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ROWS, int S>
struct Lanes {
  static constexpr int UPW = 32 / S;                  // units per warp
  static constexpr int RP = ROWS >= S ? ROWS / S : 1;  // rows a lane owns after the reduction
  static constexpr int LPR = S > ROWS ? S / ROWS : 1;  // lanes that own the same row
  __device__ __forceinline__ static int row_lo(int s) { return ROWS >= S ? s * RP : s / LPR; }
  // the lane that writes its row's results (the others hold the same values)
  __device__ __forceinline__ static bool writer(int s) { return s % LPR == 0; }
};

// cluster.sync() in two halves: arrive releases this thread's shared-memory
// writes so far (local or in another CTA of the cluster), wait acquires the
// others'. Work between them (global stores) overlaps the wait for slower CTAs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum v over the S lanes of a unit. Each round halves the rows a lane keeps (the
// lane whose s has the round's bit keeps the upper half and receives its
// partner's upper half), until a lane keeps one row; rounds after that add the
// partner's values for that row. After the last round v[0 .. RP) holds the sums
// of rows row_lo(s) + 0 .. RP - 1, identical in every lane that owns them.
template <int CNT, int BIT, int UPW, int ROWS, int V>
__device__ __forceinline__ void reduce_rows(float (&v)[ROWS][V], int s) {
  if constexpr (BIT >= 1) {
    const unsigned mask = BIT * UPW;
    if constexpr (CNT > 1) {
      constexpr int HALF = CNT / 2;
      const bool upper = (s & BIT) != 0;
#pragma unroll
      for (int r = 0; r < HALF; ++r) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float send = upper ? v[r][q] : v[r + HALF][q];
          const float keep = upper ? v[r + HALF][q] : v[r][q];
          v[r][q] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
      }
      reduce_rows<HALF, BIT / 2, UPW, ROWS, V>(v, s);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[0][q] += __shfl_xor_sync(0xffffffffu, v[0][q], mask);
      reduce_rows<1, BIT / 2, UPW, ROWS, V>(v, s);
    }
  }
}

// Copy the resident weight slice, `rows` x `cols` elements, into shared memory
// with LB loads in flight per thread (one dependent L2 round trip per element
// would cost the CTA tens of microseconds before its first step); consecutive
// threads take consecutive columns, and a thread steps its (row, column) by
// adds, not divisions. Element (r, c) comes from src(r, c) (nullptr for a zero)
// and goes to dst(r, c).
template <typename Src, typename Dst>
__device__ __forceinline__ void load_resident(int rows, int cols, int tid, int nt, Src src,
                                              Dst dst) {
  constexpr int LB = 32;
  const int total = rows * cols, drow = nt / cols, dcol = nt % cols;
  int row = tid / cols, col = tid % cols;
  auto step = [&](int& r, int& c) {
    r += drow;
    c += dcol;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  };
  for (int base = tid; base < total; base += nt * LB) {
    float v[LB];
    int r = row, c = col;
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const float* p = base + q * nt < total ? src(r, c) : nullptr;
      v[q] = p != nullptr ? __ldg(p) : 0.0f;
      step(r, c);
    }
    r = row;
    c = col;
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      if (base + q * nt < total) *dst(r, c) = v[q];
      step(r, c);
    }
    row = r;
    col = c;
  }
}

// Whether `blocks` reads of `width` consecutive floats at multiples of `stride`
// (the S / 4 values of s in one quarter-warp) fall on distinct banks.
__host__ __device__ inline bool conflict_free(int stride, int width, int blocks) {
  unsigned used = 0;
  for (int i = 0; i < blocks; ++i) {
    for (int b = 0; b < width; ++b) {
      const unsigned bit = 1u << ((i * stride + b) % 32);
      if (used & bit) return false;
      used |= bit;
    }
  }
  return true;
}

__host__ __device__ inline int pad_stride(int stride, int step, int width, int blocks) {
  while (!conflict_free(stride, width, blocks)) stride += step;
  return stride;
}

struct Geometry {
  int hc;         // units per CTA, ceil(H / C)
  int units;      // hc rounded up to whole warps (padding units hold zero weights)
  int threads;    // units / UPW . 32
  int stride;     // floats between the rows of the resident Wh slice
  size_t smem;    // dynamic shared memory bytes
};

// Forward: Wh slice [H][stride] with a float4 (the 4 gates) per unit; h [2][H][ROWS].
inline Geometry fwd_geometry(int h, int c, int rows, int split) {
  Geometry g;
  const int upw = 32 / split;
  g.hc = (h + c - 1) / c;
  g.units = (g.hc + upw - 1) / upw * upw;
  g.threads = g.units / upw * 32;
  g.stride = pad_stride(4 * g.units, 4, 128 / split, split / 4);
  g.smem = sizeof(float) * ((size_t)h * g.stride + 2 * (size_t)h * rows);
  return g;
}

// Backward: Wh slice transposed [4H][stride] (a float per unit); dgates [2][4H][ROWS].
inline Geometry bwd_geometry(int h, int c, int rows, int split) {
  Geometry g;
  const int upw = 32 / split;
  g.hc = (h + c - 1) / c;
  g.units = (g.hc + upw - 1) / upw * upw;
  g.threads = g.units / upw * 32;
  g.stride = pad_stride(g.units, 1, 32 / split, split / 4);
  g.smem = sizeof(float) * (4 * (size_t)h * g.stride + 2 * 4 * (size_t)h * rows);
  return g;
}

// How many clusters of this configuration the card runs at once, asked of
// cudaOccupancyMaxActiveClusters once per (kernel, cluster, threads, shared
// memory) in the process: the query costs about a millisecond of host time, a
// launch's whole budget at serving shapes. The kernel's dynamic shared-memory
// limit is raised (never lowered) on the way. One card per process.
inline cudaError_t active_clusters(const void* fn, const cudaLaunchConfig_t& cfg, unsigned c,
                                   int* clusters) {
  struct Known { const void* fn; unsigned c, threads; size_t smem; int clusters; };
  struct Raised { const void* fn; size_t smem; };
  static std::mutex mu;
  static std::vector<Known> known;
  static std::vector<Raised> raised;
  std::lock_guard<std::mutex> lock(mu);
  for (const Known& k : known) {
    if (k.fn == fn && k.c == c && k.threads == cfg.blockDim.x && k.smem == cfg.dynamicSmemBytes) {
      *clusters = k.clusters;
      return cudaSuccess;
    }
  }
  size_t have = 48 * 1024;
  for (const Raised& r : raised) {
    if (r.fn == fn) have = r.smem;
  }
  if (cfg.dynamicSmemBytes > have) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
    raised.push_back({fn, cfg.dynamicSmemBytes});
  }
  cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (e != cudaSuccess) return e;
  known.push_back({fn, c, cfg.blockDim.x, cfg.dynamicSmemBytes, *clusters});
  return cudaSuccess;
}

// Launch `kernel` for `tiles` tiles in each of `groups` independent scans (the
// two directions of each of K bi-LSTMs, or the G groups of the grouped scans), clusters
// of c CTAs along x: a grid of (c . min(tiles, clusters the card runs at once /
// groups), groups), each cluster walking tiles with a stride of the grid (so
// that a full grid keeps its Wh slices resident over several tiles). Returns
// the cudaError_t, or CLUSTER_UNSCHEDULABLE when no cluster fits.
template <typename... Params, typename... Args>
int launch_groups(void (*kernel)(Params...), int tiles, int groups, int c, const Geometry& g,
                  void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * c, groups, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t e = active_clusters((const void*)kernel, cfg, (unsigned)c, &clusters);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return CLUSTER_UNSCHEDULABLE;
  const int per = clusters / groups > 0 ? clusters / groups : 1;
  cfg.gridDim.x = c * (tiles < per ? tiles : per);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline const char* error_string(int err) {
  if (err == CLUSTER_UNSCHEDULABLE) {
    return "the thread-block cluster cannot be scheduled (cudaOccupancyMaxActiveClusters = 0)";
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace lrec
