// The geometry of K2 (fvta_fwd.cu): how an example's S x T rows are split over
// the CTAs of its thread-block cluster, how a CTA stages its rows, and the
// shared-memory layout that follows. Plain C++ with no CUDA dependency, so the
// host compiler can check it against its Python mirror (tests/test_torch_k2.py).
//
// Segments. Each sequence is cut into P chunks of L time steps (the last one
// shorter; P = 1 and L = T where S is at least the cluster), and segment
// s * P + k is chunk k of sequence s. CTA r of a cluster of C owns segments
// [r * G, (r + 1) * G), which are consecutive rows of h, so a CTA's rows are
// one contiguous range. Every segment has at least one row and every CTA at
// least one segment.
//
// Blocks. A CTA whose rows fit RESIDENT_ROWS stages them all at once (one
// buffer, no online rescaling); a longer one walks them in blocks of
// STREAM_ROWS rows, the next block copied into the second buffer while this
// one computes, with the time softmax carried online per segment. Where that
// does not fit a CTA's shared memory, q is staged in tiles of JT columns, and
// past that the cluster grows (fewer segments per CTA).
//
// The global route (route 1), past the last staging that fits at the largest
// cluster (D ~ 812 at S = T = 24, J = 30 on the H100): the h blocks, q and w_*
// are read from device memory (they stay in L2) and each segment's V row lives
// in a scratch buffer in device memory ([N * C, segs, D]); the blocks are 32
// rows, one buffer of context-mask values. Nothing left in shared memory grows
// with D but pcs, the cluster's partial contexts over this CTA's slice of D.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define K2_HD __host__ __device__
#else
#define K2_HD
#endif

namespace k2 {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;             // rows of one register-tiled pass (16 x 2 per thread)
constexpr int JT = 32;              // columns of one pass (16 x 2 per thread)
constexpr int RESIDENT_ROWS = 96;   // a CTA with at most this many rows stages them once
constexpr int STREAM_ROWS = 32;     // rows per block past that (two buffers)
constexpr int MAX_CLUSTER = 16;     // 8 is portable; 9-16 need the non-portable attribute

K2_HD inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
K2_HD inline size_t round4(size_t v) { return (v + 3) / 4 * 4; }

// Row stride of the staged rows: D rounded up to 4 floats (16-byte rows for
// float4 loads and cp.async), then to an odd number of 16-byte units, so that
// eight threads reading eight consecutive rows at one column hit eight
// distinct 16-byte bank groups.
K2_HD inline int vec_stride(int d) {
  const int s = (d + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

// Columns of C: w_x (column 0: sx comes out of the product) then the J
// question words, rounded to JT.
K2_HD inline int c_cols(int j) { return ceil_div(j + 1, JT) * JT; }

struct Layout {
  size_t hbuf, cmv, qs, wxys, wys, qsl, cbuf, sxr, rowmax, eb, sy, qmv, wqmx, qmx, wq, v, pcs, sm,
      sden, scm, sscale, wsl, my_m, my_inv, my_valid, red, total;   // floats; total in bytes
};

// Every array starts on a 16-byte boundary. qs holds every column of C's
// right-hand side, or with qtile one tile of JT columns at a time; qsl holds
// q's columns of this CTA's slice of D, ceil(D / cluster) of them, for q~
// (none with qtile: q~ then reads q from device memory). pcs is written by
// every CTA of the cluster: each CTA's partial context over this CTA's slice
// of D.
// global: the global route's layout (no hbuf, qs, wxys, wys, qsl or v).
K2_HD inline Layout layout(int j, int d, int cluster, int segs, int rows, int bufs,
                           int qtile, bool global = false) {
  Layout l;
  const size_t ds = global ? 0 : vec_stride(d), jc = c_cols(j), g = round4(segs);
  size_t o = 0;
  l.hbuf = o;     o += (size_t)bufs * rows * ds;
  l.cmv = o;      o += round4((size_t)bufs * rows);
  l.qs = o;       o += (qtile ? JT : jc) * ds;
  l.wxys = o;     o += ds;
  l.wys = o;      o += ds;
  l.qsl = o;      o += qtile || global ? 0 : round4((size_t)j * ceil_div(d, cluster));
  l.cbuf = o;     o += round4(SUB * (JT + 1));
  l.sxr = o;      o += SUB;
  l.rowmax = o;   o += SUB;
  l.eb = o;       o += round4(rows);
  l.sy = o;       o += jc;
  l.qmv = o;      o += jc;
  l.wqmx = o;     o += WARPS * jc;
  l.qmx = o;      o += jc;
  l.wq = o;       o += jc;
  l.v = o;        o += (size_t)segs * ds;
  l.pcs = o;      o += round4((size_t)cluster * ceil_div(d, cluster));
  l.sm = o;       o += g;
  l.sden = o;     o += g;
  l.scm = o;      o += g;
  l.sscale = o;   o += g;
  l.wsl = o;      o += g;
  l.my_m = o;     o += g;
  l.my_inv = o;   o += g;
  l.my_valid = o; o += g;
  l.red = o;      o += 4;
  l.total = o * sizeof(float);
  return l;
}

struct Plan {
  int cluster;     // C: CTAs per example
  int chunks;      // P: chunks per sequence
  int chunk_len;   // L: time steps per chunk
  int segs;        // G: segments per CTA
  int rows;        // rows of one staged block
  int bufs;        // 1: the CTA's rows staged once (or one pass at a time); 2: double-buffered
  int qtile;       // 1: q staged JT columns at a time (it does not fit whole)
  size_t smem;     // dynamic shared memory per CTA, bytes
  int route;       // 0: staged; 1: global (h, q and V in device memory)
};

// Floats of the global route's V scratch: segs rows of D per CTA of N clusters.
K2_HD inline size_t v_scratch(const Plan& p, int n, int d) {
  return p.route ? (size_t)n * p.cluster * p.segs * d : 0;
}

// The plan for N examples of S x T rows on a card with `sms` SMs, clusters of
// at most `cmax` CTAs and `smem_max` bytes of shared memory per CTA. The
// cluster starts from the smallest power of two (at most cmax) that puts
// N * C at or above the SM count; S >= C splits whole sequences (G =
// ceil(S / C), then C = ceil(S / G)), S < C splits each sequence's T into P =
// C / S chunks. Staging: a CTA's rows at once where they fit RESIDENT_ROWS,
// else blocks of STREAM_ROWS in two buffers, else one pass at a time; q whole,
// else in tiles. Where nothing fits, the cluster doubles (fewer segments per
// CTA) up to cmax, and past that the plan takes the global route at the last
// cluster (force_global: at the first, at any width). smem > smem_max means
// the shape cannot run even there.
K2_HD inline Plan plan(int n, int s, int t, int j, int d, int sms, size_t smem_max, int cmax,
                       bool force_global = false) {
  Plan p;
  p.route = 0;
  int c = 1;
  while (c < cmax && (long long)n * c < sms) c *= 2;
  if (c > cmax) c = cmax;
  for (;;) {
    if (s >= c) {
      p.chunks = 1;
      p.chunk_len = t;
      p.segs = ceil_div(s, c);
      p.cluster = ceil_div(s, p.segs);
    } else {
      const int per = c / s < t ? c / s : t;
      p.chunk_len = ceil_div(t, per);
      p.chunks = ceil_div(t, p.chunk_len);
      p.segs = 1;
      p.cluster = s * p.chunks;
    }
    const int span = p.segs * p.chunk_len;   // most rows a CTA owns
    const int staging[3][2] = {{span <= RESIDENT_ROWS ? 1 : 2,
                                span <= RESIDENT_ROWS ? ceil_div(span, SUB) * SUB : STREAM_ROWS},
                               {2, STREAM_ROWS},
                               {1, SUB}};
    for (int qtile = 0; qtile <= 1 && !force_global; ++qtile) {
      for (int k = 0; k < 3; ++k) {
        p.bufs = staging[k][0];
        p.rows = staging[k][1];
        p.qtile = qtile;
        p.smem = layout(j, d, p.cluster, p.segs, p.rows, p.bufs, qtile).total;
        if (p.smem <= smem_max) return p;
      }
    }
    if (c >= cmax || force_global) {
      p.route = 1;
      p.bufs = 1;
      p.rows = STREAM_ROWS;
      p.qtile = 1;
      p.smem = layout(j, d, p.cluster, p.segs, p.rows, p.bufs, p.qtile, true).total;
      return p;
    }
    c *= 2;
  }
}

}  // namespace k2
