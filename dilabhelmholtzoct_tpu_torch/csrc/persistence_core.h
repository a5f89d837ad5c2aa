// The combinatorial half of the topological loss, written once for two
// builds: the host library (persistence_host.cc, g++) and the card's kernels
// (topology.cu, nvcc for sm_90a). The host library runs sublevel_pairs and
// min_cost_assign below; the kernels run the block-parallel phases of
// persistence_parallel.h on the same orders, costs and roundings, whose
// results equal these two functions' (the same bars in the same order, the
// same matchings).
//
// Replaces nothing written in Pallas. The algorithm is the one of the JAX
// package's host library and of its XLA device pairing
// (dilabhelmholtzoct_tpu/ops/topology_device.py), both of which compute the
// persistence of the T-construction (gudhi's top_dimensional_cells):
//
//   * H0: pixels activated in increasing value (ties by index), 8-connected
//     union-find; when two components meet, the younger (later birth) dies
//     -> bar (birth pixel, merge pixel) (the elder rule).
//   * H1 by Alexander duality: the same union-find on the negated grid,
//     4-connected, with a virtual outside node elder to every pixel and
//     joined to the border; each superlevel bar (q, p) is the H1 bar (p, q).
//   * Zero-persistence bars are dropped.
//   * The matching: the reduced rectangular assignment of the q-Wasserstein
//     partial matching (rows = the smaller diagram, columns = the larger
//     one's bars plus one diagonal slot per row), solved exactly by
//     shortest augmenting paths with f64 dual potentials.
//
// Every function takes its scratch from the caller (no allocation), so it
// compiles for host and device alike. The floating-point operations are
// plain adds, compares and rounded multiplies: nvcc may not contract them
// into FMAs (mul_rn), and the host library is built with -ffp-contract=off,
// so both builds round alike.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <limits>

#if defined(__CUDACC__)
#define DH_HD __host__ __device__
#else
#define DH_HD
#endif

namespace pcore {

DH_HD inline uint32_t float_bits(float x) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(x);
#else
  uint32_t b;
  memcpy(&b, &x, 4);
  return b;
#endif
}

DH_HD inline double inf_d() {
#if defined(__CUDA_ARCH__)
  return __longlong_as_double(0x7ff0000000000000LL);
#else
  return std::numeric_limits<double>::infinity();
#endif
}

// a * b rounded once (never fused into a following add)
DH_HD inline float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// ---------------------------------------------------------------------------
// Total order of the pixels
// ---------------------------------------------------------------------------

// Order-preserving integer key of a float: every bit of a negative flipped,
// only the sign bit of a non-negative. -0.0 takes +0.0's key, so equal
// values tie by index, as numpy's stable argsort ties them.
DH_HD inline uint32_t sort_key(float x) {
  uint32_t b = float_bits(x);
  if (b == 0x80000000u) b = 0u;
  return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

// (key << 32) | index: unique per pixel, so any sort of these codes gives
// the one order "by value, ties by index" (the radix sort below on the
// host, a bitonic sort on the card).
DH_HD inline uint64_t sort_code(float x, int32_t i) {
  return (static_cast<uint64_t>(sort_key(x)) << 32) | static_cast<uint32_t>(i);
}

constexpr int RADIX_BITS = 11;
constexpr int RADIX_BUCKETS = 1 << RADIX_BITS;

// Stable argsort of flat[0:n] by value: LSD radix sort of sort_code over
// its key bits. Scratch: a and tmp n entries each, count RADIX_BUCKETS.
DH_HD inline void radix_argsort(const float* flat, int n, int32_t* order,
                                uint64_t* a, uint64_t* tmp, int32_t* count) {
  for (int i = 0; i < n; ++i) a[i] = sort_code(flat[i], i);
  uint64_t* src = a;
  uint64_t* dst = tmp;
  for (int shift = 32; shift < 64; shift += RADIX_BITS) {
    const int bits = shift + RADIX_BITS > 64 ? 64 - shift : RADIX_BITS;
    const uint64_t mask = (1ull << bits) - 1;
    for (int b = 0; b < (1 << bits); ++b) count[b] = 0;
    for (int i = 0; i < n; ++i) ++count[(src[i] >> shift) & mask];
    int32_t pos = 0;
    for (int b = 0; b < (1 << bits); ++b) {
      const int32_t c = count[b];
      count[b] = pos;
      pos += c;
    }
    for (int i = 0; i < n; ++i) dst[count[(src[i] >> shift) & mask]++] = src[i];
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  for (int i = 0; i < n; ++i)
    order[i] = static_cast<int32_t>(src[i] & 0xFFFFFFFFu);
}

// ---------------------------------------------------------------------------
// Pairing
// ---------------------------------------------------------------------------

// Neighbour k of a pixel: 8-connectivity in row-major order, 4-connectivity
// as up, down, left, right.
DH_HD inline void neighbour(int k, bool eight, int* dy, int* dx) {
  if (eight) {
    const int kk = k < 4 ? k : k + 1;
    *dy = kk / 3 - 1;
    *dx = kk % 3 - 1;
  } else {
    *dy = k == 0 ? -1 : (k == 1 ? 1 : 0);
    *dx = k == 2 ? -1 : (k == 3 ? 1 : 0);
  }
}

DH_HD inline int32_t uf_find(int32_t* parent, int32_t x) {
  int32_t root = x;
  while (parent[root] != root) root = parent[root];
  while (parent[x] != root) {
    const int32_t nxt = parent[x];
    parent[x] = root;
    x = nxt;
  }
  return root;
}

// Most finite bars one pass of an h*w grid can emit: each is born at a
// pixel none of whose neighbours precedes it, and such pixels are never
// 4-adjacent.
DH_HD inline int bar_capacity(int n) { return n / 2 + 2; }

// Sublevel union-find pairing of val (h x w, row-major), pixels activated
// in `order` (by value, ties by index); rank[order[i]] == i. parent and
// birth hold n + 1 entries, -1 on entry (entry n is the outside node, used
// when `outside`). Writes each finite bar of nonzero persistence as
// (bar_b, bar_d) = (birth pixel, death pixel) in the order the merges
// happen, at most cap of them, and returns their count. *essential: the
// birth pixel of the essential class (-1 with `outside`).
DH_HD inline int sublevel_pairs(const float* val, int h, int w, bool eight,
                                bool outside, const int32_t* order,
                                const int32_t* rank, int32_t* parent,
                                int32_t* birth, int32_t* bar_b, int32_t* bar_d,
                                int cap, int32_t* essential) {
  const int n = h * w;
  const int32_t OUT = n;
  if (outside) parent[OUT] = OUT;
  const int nn = eight ? 8 : 4;
  int nbars = 0;
  for (int i = 0; i < n; ++i) {
    const int32_t p = order[i];
    parent[p] = p;
    birth[p] = p;
    const int y = p / w, x = p % w;
    const bool border = y == 0 || x == 0 || y == h - 1 || x == w - 1;
    int32_t rp = p;  // the root of p's component, kept across the unions
    for (int k = (outside && border) ? -1 : 0; k < nn; ++k) {
      int32_t q = OUT;
      if (k >= 0) {
        int dy, dx;
        neighbour(k, eight, &dy, &dx);
        const int ny = y + dy, nx = x + dx;
        if (ny < 0 || nx < 0 || ny >= h || nx >= w) continue;
        q = ny * w + nx;
        if (parent[q] == -1) continue;  // not yet in the filtration
      }
      const int32_t r2 = uf_find(parent, q);
      if (r2 == rp) continue;
      int32_t elder, younger;
      if (rp == OUT || r2 == OUT) {
        elder = OUT;
        younger = rp == OUT ? r2 : rp;
      } else if (rank[birth[rp]] < rank[birth[r2]]) {
        elder = rp;
        younger = r2;
      } else {
        elder = r2;
        younger = rp;
      }
      if (val[birth[younger]] != val[p]) {  // the younger dies at p
        if (nbars < cap) {
          bar_b[nbars] = birth[younger];
          bar_d[nbars] = p;
        }
        ++nbars;
      }
      parent[younger] = elder;
      rp = elder;
    }
  }
  if (essential)
    *essential = outside ? -1 : birth[uf_find(parent, order[0])];
  return nbars;
}

// |val[d] - val[b]|: the same value on the grid and on its negation.
DH_HD inline float persistence(const float* val, int32_t b, int32_t d) {
  return fabsf(val[d] - val[b]);
}

// The order of the bar cap: larger persistence first, equal persistences in
// the order they were emitted. A strict total order, so every build keeps
// the same max_bars bars, in the same order, when a pass emits more.
DH_HD inline bool kept_before(float pa, int ia, float pb, int ib) {
  return pa > pb || (pa == pb && ia < ib);
}

// ---------------------------------------------------------------------------
// Matching
// ---------------------------------------------------------------------------

DH_HD inline float pow_q(float x, float q) {
  if (q == 2.0f) return mul_rn(x, x);
  if (q == 1.0f) return x;
  return powf(x, q);
}

// the distance^q of a bar to the diagonal
DH_HD inline float diag_cost(float b, float d, float q) {
  return pow_q(fabsf(d - b) / 2.0f, q);
}

// the L-inf distance^q of two bars
DH_HD inline float pair_cost(float b0, float d0, float b1, float d1, float q) {
  return pow_q(fmaxf(fabsf(b0 - b1), fabsf(d0 - d1)), q);
}

// One row's working memory: ns <= min(nb, nt) rows, nc = nb + nt columns.
struct MatchScratch {
  double* u;         // ns
  double* v;         // nc
  double* dist;      // nc
  int32_t* row4col;  // nc
  int32_t* path;     // nc
  int32_t* col4row;  // ns
  uint8_t* scanned_row;  // ns
  uint8_t* scanned_col;  // nc
  float* bval;       // nb: the pred bars' values
  float* dval;       // nb
  float* diag_p;     // nb
  float* diag_t;     // nt
};

// The reduced cost matrix, entry by entry (f32 entries, as the JAX
// package's numpy and C++ paths compute them, widened to f64).
struct ReducedCost {
  const MatchScratch* s;
  const float* tb;  // (nt, 2) true bars
  int nb, nt;
  float q;
  bool rows_true;  // rows = true bars (nt <= nb), else rows = pred bars
  DH_HD double operator()(int r, int j) const {
    if (rows_true) {  // columns: pred bars, then one diagonal slot per row
      if (j < nb)
        return static_cast<double>(
            pair_cost(tb[2 * r], tb[2 * r + 1], s->bval[j], s->dval[j], q) -
            s->diag_p[j]);
      return j - nb == r ? static_cast<double>(s->diag_t[r]) : inf_d();
    }
    if (j < nt)  // columns: true bars, then one diagonal slot per row
      return static_cast<double>(
          pair_cost(tb[2 * j], tb[2 * j + 1], s->bval[r], s->dval[r], q) -
          s->diag_t[j]);
    return j - nt == r ? static_cast<double>(s->diag_p[r]) : inf_d();
  }
};

// Exact min-cost rectangular assignment (ns rows, nc >= ns columns, +inf
// forbidden) by successive shortest augmenting paths with dual potentials:
// the Jonker-Volgenant family. Among columns of equal reduced distance the
// first unassigned one is taken, else the first. col4row: the column of
// each row. Returns false only when some row has no finite column (never
// for the reduced Wasserstein matrix: each row owns a finite diagonal slot).
DH_HD inline bool min_cost_assign(const ReducedCost& cost, int ns, int nc,
                                  const MatchScratch& s) {
  const double INF = inf_d();
  for (int r = 0; r < ns; ++r) {
    s.u[r] = 0.0;
    s.col4row[r] = -1;
  }
  for (int j = 0; j < nc; ++j) {
    s.v[j] = 0.0;
    s.row4col[j] = -1;
  }
  for (int cur = 0; cur < ns; ++cur) {
    for (int j = 0; j < nc; ++j) {
      s.dist[j] = INF;
      s.scanned_col[j] = 0;
      s.path[j] = -1;
    }
    for (int r = 0; r < ns; ++r) s.scanned_row[r] = 0;
    int i = cur;
    double min_val = 0.0;
    int sink = -1;
    while (sink == -1) {
      s.scanned_row[i] = 1;
      double lowest = INF;
      int argmin = -1;
      for (int j = 0; j < nc; ++j) {
        if (s.scanned_col[j]) continue;
        const double r = min_val + cost(i, j) - s.u[i] - s.v[j];
        if (r < s.dist[j]) {
          s.dist[j] = r;
          s.path[j] = i;
        }
        if (s.dist[j] < lowest ||
            (s.dist[j] == lowest && argmin != -1 && s.row4col[j] == -1 &&
             s.row4col[argmin] != -1)) {
          lowest = s.dist[j];
          argmin = j;
        }
      }
      if (argmin == -1 || lowest == INF) return false;
      min_val = lowest;
      s.scanned_col[argmin] = 1;
      if (s.row4col[argmin] == -1)
        sink = argmin;
      else
        i = s.row4col[argmin];
    }
    // dual update: reduced costs stay >= 0, matched edges tight
    s.u[cur] += min_val;
    for (int r = 0; r < ns; ++r)
      if (s.scanned_row[r] && r != cur) s.u[r] += min_val - s.dist[s.col4row[r]];
    for (int j = 0; j < nc; ++j)
      if (s.scanned_col[j]) s.v[j] -= min_val - s.dist[j];
    // augment along the alternating path back from the sink
    int j = sink;
    while (true) {
      const int r = s.path[j];
      s.row4col[j] = r;
      const int prev = s.col4row[r];
      s.col4row[r] = j;
      if (r == cur) break;
      j = prev;
    }
  }
  return true;
}

// The optimal partial matching of one row: pred bars (pb, pd) (nb flat
// pixel indices into the grid pg) against nt true bars tb (nt, 2). Every
// bar of the larger diagram pays its diagonal cost unless matched. Writes
// matched[j] = 1 and target[2j:2j+2] = the true bar for each matched pred
// bar j (both zero on entry) and adds the diagonal costs of the unmatched
// true bars, in order, to *const_term (zero on entry).
DH_HD inline void match_row(const float* pg, const int32_t* pb,
                            const int32_t* pd, int nb, const float* tb, int nt,
                            float q, int8_t* matched, float* target,
                            float* const_term, const MatchScratch& s) {
  for (int j = 0; j < nb; ++j) {
    s.bval[j] = pg[pb[j]];
    s.dval[j] = pg[pd[j]];
    s.diag_p[j] = diag_cost(s.bval[j], s.dval[j], q);
  }
  for (int t = 0; t < nt; ++t) s.diag_t[t] = diag_cost(tb[2 * t], tb[2 * t + 1], q);
  if (nt == 0) return;  // no true bar: nothing matched, no constant
  const bool rows_true = nt <= nb;
  const ReducedCost cost{&s, tb, nb, nt, q, rows_true};
  const int ns = rows_true ? nt : nb;
  min_cost_assign(cost, ns, nb + nt, s);
  if (rows_true) {
    for (int r = 0; r < ns; ++r) {
      const int j = s.col4row[r];
      if (j < nb) {
        matched[j] = 1;
        target[2 * j] = tb[2 * r];
        target[2 * j + 1] = tb[2 * r + 1];
      } else {
        *const_term += s.diag_t[r];
      }
    }
    return;
  }
  // rows = pred bars: a true bar is unmatched unless some row took it
  for (int t = 0; t < nt; ++t) s.scanned_col[t] = 0;
  for (int r = 0; r < ns; ++r) {
    const int t = s.col4row[r];
    if (t < nt) {
      s.scanned_col[t] = 1;
      matched[r] = 1;
      target[2 * r] = tb[2 * t];
      target[2 * r + 1] = tb[2 * t + 1];
    }
  }
  for (int t = 0; t < nt; ++t)
    if (!s.scanned_col[t]) *const_term += s.diag_t[t];
}

// Bytes of a MatchScratch for nb pred and nt true bars, carved by
// carve_match_scratch from one 8-byte-aligned block.
DH_HD inline size_t match_scratch_bytes(int nb, int nt) {
  const int ns = nb < nt ? nb : nt;
  const int nc = nb + nt;
  size_t bytes = sizeof(double) * (ns + 2 * nc);
  bytes += sizeof(int32_t) * (2 * nc + ns);
  bytes += sizeof(float) * (3 * nb + nt);
  bytes += ns + nc;
  return (bytes + 7) & ~static_cast<size_t>(7);
}

DH_HD inline MatchScratch carve_match_scratch(void* base, int nb, int nt) {
  const int ns = nb < nt ? nb : nt;
  const int nc = nb + nt;
  MatchScratch s;
  double* d = static_cast<double*>(base);
  s.u = d;
  s.v = d + ns;
  s.dist = d + ns + nc;
  int32_t* i32 = reinterpret_cast<int32_t*>(d + ns + 2 * nc);
  s.row4col = i32;
  s.path = i32 + nc;
  s.col4row = i32 + 2 * nc;
  float* f = reinterpret_cast<float*>(i32 + 2 * nc + ns);
  s.bval = f;
  s.dval = f + nb;
  s.diag_p = f + 2 * nb;
  s.diag_t = f + 3 * nb;
  uint8_t* u8 = reinterpret_cast<uint8_t*>(f + 3 * nb + nt);
  s.scanned_row = u8;
  s.scanned_col = u8 + ns;
  return s;
}

}  // namespace pcore
