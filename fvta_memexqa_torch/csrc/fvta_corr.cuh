// The FVTA correlation C[s,t,j] = <wx,h> + <wy,q_j> + (h*wxy).q_j, computed the
// same way, bit for bit, by every kernel that recomputes it: K4 (fvta_stats.cu)
// emits eq = max over (s,t) of the ctx-masked C, and K5/K6 (fvta_bwd.cu) find
// the positions that reach eq by EXACT float equality with their own
// recomputed C. A different rounding anywhere (an FMA contracted in one kernel
// and not in another, another summation order) would make K5 count no tie,
// and max(qcnt, 1) would then silently drop geq's gradient. So every product
// and sum here is an explicit round-to-nearest intrinsic in a fixed serial
// order, which nvcc may neither contract nor reorder.
//
// Layout of the chunked kernels (the old K4 and K5, the two-pass K6): a time
// chunk of TCH rows of h is staged in shared memory twice (raw, and times wxy),
// and question rows in tiles of QT = 32 (one per lane), all with an odd row
// stride so that 32 lanes reading 32 rows at one column hit 32 banks.
//
// The run of chunks (K4 and K5; K6 walks its own, the same way): one CTA per
// (run of cpc consecutive chunks, sequence, example), the runs sized so that
// the grid is about one CTA per SM (`run_geometry`). The CTA walks its run in
// passes of `rows` = 64 rows (two chunks; 32 where that does not fit), stages
// the question tile, sy and the masks once (J <= QT; a larger J is restaged
// per tile of 32 at every pass), copies the next pass's rows of h and of the
// context mask with cp.async while it computes the current one, and computes
// C in 4 x 2 register tiles (`serial_dot_4x2`) that `walk_run` hands to the
// kernel's own per-tile and per-pass steps.
//
// The global route (K4 and K5 past the widths whose staged run fits a CTA's
// shared memory: D = 572 at J = 30, 516 at J = 512 on the H100). run_geometry
// chooses it by shape, never after a failed launch. h rows, hw = h*wxy and the
// question rows are read from device memory (they stay in L2), hw formed in
// registers as each term is taken; only the per-row and per-word arrays (the
// pass's context-mask values, sx, syv, qmv, eqv, the kernels' erow, prow and
// wq) stay in shared memory, so its size no longer grows with D. Every C
// element is still one serial __fmaf_rn chain from d = 0 over the same terms
// (the staged route's zero padding adds exactly nothing), so both routes give
// the same bits and K5/K6 find K4's maxima whichever route each of them took.
//
// The geometry is plain C++, so the host compiler checks it against its Python
// mirror (tests/test_torch_k45.py, tests/test_torch_widths.py); the device code
// needs nvcc.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FVTA_HD __host__ __device__
#else
#define FVTA_HD
#endif

namespace fvta {

constexpr float NEG = -1e30f;
constexpr int TCH = 32;   // time steps per chunk (one block's rows)
constexpr int QT = 32;    // question words per tile (one per lane)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RUN_ROWS = 64;   // rows of a run's pass, at most (4 x 2 tiles, 256 threads)

FVTA_HD inline int odd_stride(int d) { return d | 1; }

// Row stride of rows staged for float4 loads and cp.async: D rounded up to 4
// floats, then to an odd number of 16-byte units, so that eight threads
// reading eight consecutive rows at one column hit eight distinct 16-byte bank
// groups.
FVTA_HD inline int vec_stride(int d) {
  const int s = (d + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

FVTA_HD inline int round_j(int j) { return (j + QT - 1) / QT * QT; }

// Shared memory of a run's CTA for passes of `rows` rows, in floats from a
// 16-byte aligned base; every array starts on a 16-byte boundary.
// hbuf/cmbuf: nbuf passes of h rows and context-mask values; hw = h*wxy of the
// current pass; qs one tile of question rows; syv, qmv, eqv per question word;
// sx per row; erow/prow the pass's scores and softmax weights (prow[rows] the
// rescale factor); wq per warp and question word (K4: max of the ctx-masked
// C, K5: tie counts); vacc K4's v.
struct RunLayout {
  size_t hbuf, cmbuf, hw, qs, wxs, wys, wxys, syv, qmv, eqv, sx, erow, prow, wq, vacc, total;
};

// global: the global route's layout, with no array that grows with D.
FVTA_HD inline RunLayout run_layout(int j, int d, int rows, int nbuf, bool global = false) {
  RunLayout l;
  const size_t ds = global ? 0 : vec_stride(d), jp = round_j(j);
  size_t o = 0;
  l.hbuf = o;   o += (size_t)nbuf * rows * ds;
  l.cmbuf = o;  o += (size_t)nbuf * rows;
  l.hw = o;     o += (size_t)rows * ds;
  l.qs = o;     o += QT * ds;
  l.wxs = o;    o += ds;
  l.wys = o;    o += ds;
  l.wxys = o;   o += ds;
  l.syv = o;    o += jp;
  l.qmv = o;    o += jp;
  l.eqv = o;    o += jp;
  l.sx = o;     o += rows;
  l.erow = o;   o += rows;
  l.prow = o;   o += rows + 4;
  l.wq = o;     o += WARPS * jp;
  l.vacc = o;   o += ds;
  l.total = o * sizeof(float);
  return l;
}

// The launch geometry of K4 and K5, in one place for the launches and for the
// wrapper that allocates K4's scratch: per = CTAs per sequence, cpc = chunks
// per CTA (the last CTA's run may be shorter; none is empty), rows per pass
// and h buffers (the first of 64 x 2, 32 x 2, 64 x 1, 32 x 1 that fits), smem
// bytes per CTA, scratch floats (K4's partials: m and den per CTA, then v [D]
// and eq [J] per CTA). N*S*per is about the SM count where N*S is below it;
// per = 1 (a run of all of T) where N*S fills the card. route 1 (global): none
// of the four stagings fits, so h and q are read from device memory in passes
// of 64 rows (one buffer of context-mask values); force_global takes that route
// at any width (the card tests hold the two routes against each other with it).
struct RunGeometry {
  int per, cpc, rows, nbuf;
  size_t smem, scratch;
  int route;
};

FVTA_HD inline RunGeometry run_geometry(int n, int s, int t, int j, int d, int sms,
                                        size_t smem_max, bool force_global = false) {
  RunGeometry g;
  const int chunks = (t + TCH - 1) / TCH, ns = n * s;
  g.per = sms / ns > 1 ? sms / ns : 1;
  g.cpc = (chunks + g.per - 1) / g.per;
  g.per = (chunks + g.cpc - 1) / g.cpc;
  const int staging[4][2] = {{RUN_ROWS, 2}, {TCH, 2}, {RUN_ROWS, 1}, {TCH, 1}};
  for (int k = 0; k < 4; ++k) {
    g.rows = staging[k][0];
    g.nbuf = staging[k][1];
    g.smem = run_layout(j, d, g.rows, g.nbuf).total;
    if (g.smem <= smem_max) break;
  }
  g.route = force_global || g.smem > smem_max ? 1 : 0;
  if (g.route) {
    g.rows = RUN_ROWS;
    g.nbuf = 1;
    g.smem = run_layout(j, d, g.rows, g.nbuf, true).total;
  }
  g.scratch = (size_t)ns * g.per * (2 + d + j);
  return g;
}

#ifdef __CUDACC__

// sum_d a[d] * b[d], serial from d = 0 with round-to-nearest fused multiply-adds.
__device__ __forceinline__ float serial_dot(const float* a, const float* b, int d) {
  float acc = 0.0f;
  for (int i = 0; i < d; ++i) acc = __fmaf_rn(a[i], b[i], acc);
  return acc;
}

// serial_dot for a 2 x 2 tile of (row, question word) pairs, the register-tiled
// form K6 computes C with (K4 and K5: serial_dot_4x2 below): out[a][b] =
// serial_dot(a_a, b_b, D) bit for bit, and with SX also sx = serial_dot(xs,
// wxs, D). The invariant every kernel
// keeps: an element's chain starts at 0 and takes its terms one __fmaf_rn at a
// time in the order d = 0, 1, ..., D-1; only the thread mapping and the loads
// may change. Here each float4 load feeds four chains, and each chain takes the
// float4's 4 terms in order. The rows are 16-byte aligned and zero-padded from
// D to d4, a multiple of 4: a padded term adds __fmaf_rn(0, 0, acc) = acc (acc is
// never -0: it starts at +0, and a zero sum rounds to +0), so the padding
// changes no bit.
template <bool SX>
__device__ __forceinline__ void serial_dot_2x2(const float* a0, const float* a1,
                                               const float* b0, const float* b1, int d4,
                                               float out[2][2], const float* xs = nullptr,
                                               const float* wxs = nullptr,
                                               float* sx = nullptr) {
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f, cx = 0.0f;
  for (int i = 0; i < d4; i += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + i);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + i);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + i);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + i);
    const float xa[4] = {x0.x, x0.y, x0.z, x0.w}, xb[4] = {x1.x, x1.y, x1.z, x1.w};
    const float ya[4] = {y0.x, y0.y, y0.z, y0.w}, yb[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c00 = __fmaf_rn(xa[k], ya[k], c00);
      c01 = __fmaf_rn(xa[k], yb[k], c01);
      c10 = __fmaf_rn(xb[k], ya[k], c10);
      c11 = __fmaf_rn(xb[k], yb[k], c11);
    }
    if constexpr (SX) {
      const float4 u = *reinterpret_cast<const float4*>(xs + i);
      const float4 w = *reinterpret_cast<const float4*>(wxs + i);
      cx = __fmaf_rn(u.x, w.x, cx);
      cx = __fmaf_rn(u.y, w.y, cx);
      cx = __fmaf_rn(u.z, w.z, cx);
      cx = __fmaf_rn(u.w, w.w, cx);
    }
  }
  out[0][0] = c00;
  out[0][1] = c01;
  out[1][0] = c10;
  out[1][1] = c11;
  if constexpr (SX) *sx = cx;
}

// serial_dot for a 4 x 2 tile: out[r][b] = serial_dot(a[r], b_b, D) bit for bit
// (and with SX sx = serial_dot(xs, wxs, D)), each chain in serial_dot_2x2's
// order. Per float4 step it loads 6 operands for 8 chains (the 2 x 2 tile: 4
// for 4), so it reads 0.75 floats from shared memory per FMA instead of 1.
template <bool SX>
__device__ __forceinline__ void serial_dot_4x2(const float* const a[4], const float* b0,
                                               const float* b1, int d4, float out[4][2],
                                               const float* xs = nullptr,
                                               const float* wxs = nullptr,
                                               float* sx = nullptr) {
  float c[4][2] = {}, cx = 0.0f;
  for (int i = 0; i < d4; i += 4) {
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + i);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + i);
    const float ya[4] = {y0.x, y0.y, y0.z, y0.w}, yb[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(a[r] + i);
      const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[r][0] = __fmaf_rn(xa[k], ya[k], c[r][0]);
        c[r][1] = __fmaf_rn(xa[k], yb[k], c[r][1]);
      }
    }
    if constexpr (SX) {
      const float4 u = *reinterpret_cast<const float4*>(xs + i);
      const float4 w = *reinterpret_cast<const float4*>(wxs + i);
      cx = __fmaf_rn(u.x, w.x, cx);
      cx = __fmaf_rn(u.y, w.y, cx);
      cx = __fmaf_rn(u.z, w.z, cx);
      cx = __fmaf_rn(u.w, w.w, cx);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    out[r][0] = c[r][0];
    out[r][1] = c[r][1];
  }
  if constexpr (SX) *sx = cx;
}

// serial_dot_4x2 on the global route: rows a[r] of h and question rows b0, b1
// in device memory (stride D, no alignment), hw = __fmul_rn(h, wxy) formed per
// term: out[r][b] = serial_dot(h_r * wxy, b_b, D) and sx = serial_dot(xs, wx, D)
// bit for bit, each chain in the staged form's order without its zero padding.
template <bool SX>
__device__ __forceinline__ void serial_dot_4x2_global(const float* const a[4], const float* b0,
                                                      const float* b1, const float* wxy, int d,
                                                      float out[4][2],
                                                      const float* xs = nullptr,
                                                      const float* wx = nullptr,
                                                      float* sx = nullptr) {
  float c[4][2] = {}, cx = 0.0f;
  for (int i = 0; i < d; ++i) {
    const float w = __ldg(wxy + i), y0 = __ldg(b0 + i), y1 = __ldg(b1 + i);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = __fmul_rn(__ldg(a[r] + i), w);
      c[r][0] = __fmaf_rn(x, y0, c[r][0]);
      c[r][1] = __fmaf_rn(x, y1, c[r][1]);
    }
    if constexpr (SX) cx = __fmaf_rn(__ldg(xs + i), __ldg(wx + i), cx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    out[r][0] = c[r][0];
    out[r][1] = c[r][1];
  }
  if constexpr (SX) *sx = cx;
}

// serial_dot_2x2 on the global route (K6): serial_dot_4x2_global for rows a0, a1.
template <bool SX>
__device__ __forceinline__ void serial_dot_2x2_global(const float* a0, const float* a1,
                                                      const float* b0, const float* b1,
                                                      const float* wxy, int d, float out[2][2],
                                                      const float* xs = nullptr,
                                                      const float* wx = nullptr,
                                                      float* sx = nullptr) {
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f, cx = 0.0f;
  for (int i = 0; i < d; ++i) {
    const float w = __ldg(wxy + i), y0 = __ldg(b0 + i), y1 = __ldg(b1 + i);
    const float x0 = __fmul_rn(__ldg(a0 + i), w), x1 = __fmul_rn(__ldg(a1 + i), w);
    c00 = __fmaf_rn(x0, y0, c00);
    c01 = __fmaf_rn(x0, y1, c01);
    c10 = __fmaf_rn(x1, y0, c10);
    c11 = __fmaf_rn(x1, y1, c11);
    if constexpr (SX) cx = __fmaf_rn(__ldg(xs + i), __ldg(wx + i), cx);
  }
  out[0][0] = c00;
  out[0][1] = c01;
  out[1][0] = c10;
  out[1][1] = c11;
  if constexpr (SX) *sx = cx;
}

// C from the staged row hw = h*wxy, the question row q_j, sx = <wx,h>, sy = <wy,q_j>.
__device__ __forceinline__ float corr(const float* hw, const float* qj, float sx, float sy,
                                      int d) {
  return __fadd_rn(__fadd_rn(serial_dot(hw, qj, d), sx), sy);
}

// x + (1 - mask) * NEG, the exp_mask of the plain version.
__device__ __forceinline__ float masked(float x, float mask) {
  return __fadd_rn(x, __fmul_rn(__fsub_rn(1.0f, mask), NEG));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [t0, t0 + rows) of one sequence h_seq [T, D]: hs = h, hw = h*wxy
// (stride odd_stride(D)), and sx[r] = <wx, h_r>. Ends with __syncthreads().
__device__ __forceinline__ void stage_rows(const float* __restrict__ h_seq,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wxy, int t0, int rows,
                                           int D, float* hs, float* hw, float* sx) {
  const int d1 = odd_stride(D);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const float v = h_seq[(size_t)(t0 + r) * D + c];
    hs[r * d1 + c] = v;
    hw[r * d1 + c] = __fmul_rn(v, wxy[c]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) sx[r] = serial_dot(hs + r * d1, wx, D);
  __syncthreads();
}

// Stage question rows [j0, j0 + QT) of q_n [J, D] (rows past J are zero) and
// sy[l] = <wy, q_{j0+l}>. Ends with __syncthreads().
__device__ __forceinline__ void stage_qtile(const float* __restrict__ q_n,
                                            const float* __restrict__ wy, int j0, int J,
                                            int D, float* qs, float* sy) {
  const int d1 = odd_stride(D);
  for (int i = threadIdx.x; i < QT * D; i += blockDim.x) {
    const int l = i / D, c = i % D;
    qs[l * d1 + c] = (j0 + l < J) ? q_n[(size_t)(j0 + l) * D + c] : 0.0f;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < QT; l += blockDim.x) sy[l] = serial_dot(qs + l * d1, wy, D);
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [t0, t0 + rows) of h_seq [T, D] into dst (stride ds) with cp.async
// and zero the rows past them up to `cap`, so the buffer holds exactly the
// chunk (its columns past D were zeroed once). vec: 16-byte copies, for D % 4
// == 0 and h on a 16-byte boundary (the host checks both); 4-byte copies
// otherwise.
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ h_seq,
                                           int t0, int rows, int D, int ds, bool vec,
                                           int cap = TCH) {
  if (vec) {
    const int dv = D / 4;
    for (int i = threadIdx.x; i < rows * dv; i += THREADS) {
      const int r = i / dv, v = i % dv;
      cp_async16(dst + r * ds + 4 * v, h_seq + (size_t)(t0 + r) * D + 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += THREADS) {
      const int r = i / D, c = i % D;
      cp_async4(dst + r * ds + c, h_seq + (size_t)(t0 + r) * D + c);
    }
  }
  for (int i = threadIdx.x; i < (cap - rows) * D; i += THREADS)
    dst[(rows + i / D) * ds + i % D] = 0.0f;
}

// Question rows [j0, j0 + QT) of q_n [J, D] into qs (stride ds, zero past J and D).
__device__ __forceinline__ void stage_q(float* qs, const float* __restrict__ q_n, int j0,
                                        int J, int D, int ds) {
  for (int i = threadIdx.x; i < QT * ds; i += THREADS) {
    const int l = i / ds, c = i % ds;
    qs[i] = (j0 + l < J && c < D) ? q_n[(size_t)(j0 + l) * D + c] : 0.0f;
  }
}

// One CTA's run: chunks [c0, c1) of one sequence, in passes of `rows` rows.
// qm_n and eq_n may be null (qmv, eqv then hold zeros).
struct RunArgs {
  const float* h_seq;    // [T, D]
  const float* cm_seq;   // [T]
  const float* q_n;      // [J, D]
  const float* qm_n;     // [J]
  const float* eq_n;     // [J]
  const float *wx, *wy, *wxy;
  int T, J, D, c0, c1, rows, nbuf, vec;
};

// The rows of the pass from chunk c: up to a.rows, within the run and T.
__device__ __forceinline__ int pass_rows(const RunArgs& a, int c) {
  return min(min(a.rows, a.T - c * TCH), (a.c1 - c) * TCH);
}

// The pass's rows and context-mask values into one buffer (rows past the
// pass zero).
__device__ __forceinline__ void issue_pass(float* hdst, float* cmdst, const RunArgs& a, int c,
                                           int ds) {
  const int t0 = c * TCH, rows = pass_rows(a, c);
  issue_rows(hdst, a.h_seq, t0, rows, a.D, ds, a.vec, a.rows);
  for (int r = threadIdx.x; r < a.rows; r += THREADS) {
    if (r < rows)
      cp_async4(cmdst + r, a.cm_seq + t0 + r);
    else
      cmdst[r] = 0.0f;
  }
}

// Walk a run in passes of R = a.rows rows, computing C = hw.q + sx + sy in
// 4 x 2 register tiles: thread tid < 4R holds rows row[k] = tid / 16 + k R / 4
// (k < 4) of the pass and question words jq = tid % 16 and jq + 16 of the tile
// (lanes l and l ^ 16 share jq, the 16 lanes of a half-warp share rows); the
// threads past 4R (R = 32) hold row[k] = R, a row past every pass. Per pass,
// for each tile jt of QT words:
//   tile(jt, t0, rows, cmv, row, c)   c[k][b] = C at row[k], word jt*QT + jq + 16b
// (rows past `rows` and words past J hold values to be ignored); then
//   pass(k, t0, rows, hs, ld)         k = pass index within the run, hs its h rows
//                                     (row stride ld)
// Both are called by every thread, with no barrier after the last tile, so
// pass starts with __syncthreads() where it reads what tile wrote. The walk
// ends with __syncthreads(). smem holds run_layout(J, D, rows, nbuf).
template <class Tile, class Pass>
__device__ __forceinline__ void walk_run(const RunArgs& a, float* smem, Tile&& tile,
                                         Pass&& pass) {
  const int R = a.rows;
  const RunLayout l = run_layout(a.J, a.D, R, a.nbuf);
  float *hbuf = smem + l.hbuf, *cmbuf = smem + l.cmbuf, *hw = smem + l.hw, *qs = smem + l.qs;
  float *wxs = smem + l.wxs, *wys = smem + l.wys, *wxys = smem + l.wxys;
  float *syv = smem + l.syv, *qmv = smem + l.qmv, *eqv = smem + l.eqv, *sx = smem + l.sx;
  const int ds = vec_stride(a.D), jp = round_j(a.J), ntiles = jp / QT, dv = ds / 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, step = R / TCH;

  // the first pass flies while the CTA stages everything else
  for (int i = tid; i < a.nbuf * R; i += THREADS)
    for (int c = a.D; c < ds; ++c) hbuf[i * ds + c] = 0.0f;
  issue_pass(hbuf, cmbuf, a, a.c0, ds);
  cp_async_commit();
  for (int c = tid; c < ds; c += THREADS) {
    const bool v = c < a.D;
    wxs[c] = v ? a.wx[c] : 0.0f;
    wys[c] = v ? a.wy[c] : 0.0f;
    wxys[c] = v ? a.wxy[c] : 0.0f;
  }
  for (int j = tid; j < jp; j += THREADS) {
    const bool v = j < a.J;
    qmv[j] = v && a.qm_n ? a.qm_n[j] : 0.0f;
    eqv[j] = v && a.eq_n ? a.eq_n[j] : 0.0f;
  }
  // sy = <wy, q_j>, serial from d = 0, tile by tile; with one tile, qs keeps it
  for (int jt = 0; jt < ntiles; ++jt) {
    __syncthreads();
    stage_q(qs, a.q_n, jt * QT, a.J, a.D, ds);
    __syncthreads();
    if (tid < QT) syv[jt * QT + tid] = serial_dot(qs + tid * ds, wys, a.D);
  }

  const bool active = tid < 4 * R;   // all 256 threads at R = 64, 128 at R = 32
  const int jq = tid % 16;
  int row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) row[k] = active ? tid / 16 + k * (R / 4) : R;
  for (int c = a.c0; c < a.c1; c += step) {
    const int k = (c - a.c0) / step, buf = a.nbuf == 2 ? (k & 1) : 0, t0 = c * TCH;
    const int rows = pass_rows(a, c);
    if (a.nbuf == 2) {
      if (c + step < a.c1)
        issue_pass(hbuf + (buf ^ 1) * R * ds, cmbuf + (buf ^ 1) * R, a, c + step, ds);
      cp_async_commit();   // an empty group on the last pass keeps the count uniform
      cp_async_wait<1>();
    } else {
      if (k > 0) issue_pass(hbuf, cmbuf, a, c, ds);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hs = hbuf + buf * R * ds;
    const float* cmv = cmbuf + buf * R;

    // hw = h*wxy, as the chunked kernels stage it
    for (int i = tid; i < R * dv; i += THREADS) {
      const float4 x = reinterpret_cast<const float4*>(hs)[i];
      const float4 w = reinterpret_cast<const float4*>(wxys)[i % dv];
      reinterpret_cast<float4*>(hw)[i] = make_float4(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y),
                                                     __fmul_rn(x.z, w.z), __fmul_rn(x.w, w.w));
    }
    __syncthreads();

    for (int jt = 0; jt < ntiles; ++jt) {
      if (ntiles > 1) {
        stage_q(qs, a.q_n, jt * QT, a.J, a.D, ds);
        __syncthreads();
      }
      float dot[4][2];
      if (active) {
        const float* ar[4] = {hw + row[0] * ds, hw + row[1] * ds, hw + row[2] * ds,
                              hw + row[3] * ds};
        const float *b0 = qs + jq * ds, *b1 = qs + (jq + 16) * ds;
        if (jt == 0 && warp < R / 32)   // these warps also carry the rows' sx = <wx, h>
          serial_dot_4x2<true>(ar, b0, b1, ds, dot, hs + (lane + 32 * warp) * ds, wxs,
                               sx + lane + 32 * warp);
        else
          serial_dot_4x2<false>(ar, b0, b1, ds, dot);
      }
      __syncthreads();   // sx written; every read of qs done
      float cv[4][2] = {};
      if (active)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            cv[r][b] = __fadd_rn(__fadd_rn(dot[r][b], sx[row[r]]), syv[jt * QT + jq + 16 * b]);
      tile(jt, t0, rows, cmv, row, cv);
    }
    pass(k, t0, rows, hs, ds);
    __syncthreads();   // the buffers are free for the next pass's copy
  }
}

// walk_run on the global route (run_geometry route 1): the same passes, tiles
// and callbacks, with h and q read from device memory (pass gets hs = the
// pass's rows of h_seq, ld = D). Rows past the pass and words past J read the
// last valid row and word; their values are ignored, as on the staged route.
// smem holds run_layout(J, D, rows, 1, true).
template <class Tile, class Pass>
__device__ __forceinline__ void walk_run_global(const RunArgs& a, float* smem, Tile&& tile,
                                                Pass&& pass) {
  const int R = a.rows, D = a.D;
  const RunLayout l = run_layout(a.J, D, R, 1, true);
  float *cmv = smem + l.cmbuf, *syv = smem + l.syv, *qmv = smem + l.qmv, *eqv = smem + l.eqv;
  float* sx = smem + l.sx;
  const int jp = round_j(a.J), ntiles = jp / QT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, step = R / TCH;
  for (int j = tid; j < jp; j += THREADS) {
    const bool v = j < a.J;
    qmv[j] = v && a.qm_n ? a.qm_n[j] : 0.0f;
    eqv[j] = v && a.eq_n ? a.eq_n[j] : 0.0f;
    // sy = <wy, q_j>, serial from d = 0 (a zero row past J gives +0, as staged)
    syv[j] = v ? serial_dot(a.q_n + (size_t)j * D, a.wy, D) : 0.0f;
  }
  const bool active = tid < 4 * R;
  const int jq = tid % 16;
  int row[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) row[k] = active ? tid / 16 + k * (R / 4) : R;
  for (int c = a.c0; c < a.c1; c += step) {
    const int k = (c - a.c0) / step, t0 = c * TCH, rows = pass_rows(a, c);
    for (int r = tid; r < R; r += THREADS) cmv[r] = r < rows ? a.cm_seq[t0 + r] : 0.0f;
    __syncthreads();
    const float* hs = a.h_seq + (size_t)t0 * D;
    for (int jt = 0; jt < ntiles; ++jt) {
      float dot[4][2];
      if (active) {
        const float* ar[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ar[r] = hs + (size_t)min(row[r], rows - 1) * D;
        const float* b0 = a.q_n + (size_t)min(jt * QT + jq, a.J - 1) * D;
        const float* b1 = a.q_n + (size_t)min(jt * QT + jq + 16, a.J - 1) * D;
        if (jt == 0 && warp < R / 32)   // these warps also carry the rows' sx = <wx, h>
          serial_dot_4x2_global<true>(ar, b0, b1, a.wxy, D, dot,
                                      hs + (size_t)min(lane + 32 * warp, rows - 1) * D, a.wx,
                                      sx + lane + 32 * warp);
        else
          serial_dot_4x2_global<false>(ar, b0, b1, a.wxy, D, dot);
      }
      __syncthreads();   // sx written
      float cv[4][2] = {};
      if (active)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int b = 0; b < 2; ++b)
            cv[r][b] = __fadd_rn(__fadd_rn(dot[r][b], sx[row[r]]), syv[jt * QT + jq + 16 * b]);
      tile(jt, t0, rows, cmv, row, cv);
    }
    pass(k, t0, rows, hs, D);
    __syncthreads();   // cmv and sx are free for the next pass
  }
}

#endif  // __CUDACC__

}  // namespace fvta
