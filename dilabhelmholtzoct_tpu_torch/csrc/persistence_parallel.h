// The topological loss's pairing (T1) and matching (T2) as phases that a
// block of threads runs together, written once for two builds: the card's
// kernels (topology.cu, one block per grid or row, barriers between the
// phases) and the host library (persistence_host.cc, the same phases over a
// virtual thread count, one virtual thread after another). Each phase takes
// (tid, nthreads) and its scratch from the caller, as persistence_core.h
// does. Their results equal pcore::sublevel_pairs' and
// pcore::min_cost_assign's, bit for bit and whatever the thread count.
//
// T1, the pairing, in basins. A pixel joins the component of an earlier
// neighbour at its own step, so every pixel sits, from its activation on,
// in the component of the pixel its steepest earlier neighbour leads down
// to: the root of its basin (a pixel with no earlier neighbour; the outside
// node in H1). A pixel whose earlier neighbours all lie in one basin emits
// no bar and joins no two components. So only the merge pixels, whose
// earlier neighbours lie in two or more basins, need the union-find, and it
// runs over the basin roots alone:
//   1. the pass's values; the order is pcore::sort_code's (by value, ties
//      by index), computed where it is compared;
//   2. each pixel's pointer to its lowest-coded earlier neighbour (itself
//      when there is none), by all threads;
//   3. pointer jumping to the basin roots, by all threads, ~log2 of the
//      longest descent rounds;
//   4. the merge pixels flagged and counted per thread over contiguous
//      chunks, an exclusive scan of the counts, and the scatter: the merge
//      pixels in index order, with no atomics;
//   5. a bitonic sort of the merge pixels by code: the filtration's order;
//      then each merge pixel's slots (the outside node, then the neighbours
//      in sublevel_pairs' order): the basin of its earlier neighbour there;
//   6. the walk over the merge pixels in that order, in rounds of 16-25: one
//      lane per slot of each finds the union-find root of the slot's basin,
//      one lane per pixel lists its distinct roots; then one lane replays
//      the elder rule over the roots of each pixel that has two or more and
//      unites them, pixel after pixel;
//   7. the capped emit (the bars in emission order, or the max_bars first
//      under pcore::kept_before).
// The serial part is the replay: one step per merge pixel whose slots hold
// two roots at its round's start (a few hundred for 50x50 noise), where
// sublevel_pairs takes one per pixel and neighbour.
//
// T2, the matching: pcore::min_cost_assign with its column loops spread over
// the threads. Each thread owns the columns j == tid (mod nthreads): it
// initialises them, relaxes them in every Dijkstra step and updates their
// duals. A step's argmin is the least (reduced distance, already assigned,
// column) over the columns not yet scanned, an exact reduction in any order
// (no sum is reordered): the serial loop's rule "the first unassigned
// column of equal distance, else the first". The augmentation back along
// the path stays with one thread.

#pragma once

#include "persistence_core.h"

#if defined(__CUDACC__)
#define PPAR_UNROLL _Pragma("unroll")
#else
#define PPAR_UNROLL
#endif

namespace ppar {

DH_HD inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// [chunk_lo(tid), chunk_lo(tid + 1)): thread tid's contiguous share of n
DH_HD inline int chunk_lo(int n, int tid, int nthreads) {
  const int per = (n + nthreads - 1) / nthreads;
  const int lo = tid * per;
  return lo < n ? lo : n;
}

// ---------------------------------------------------------------------------
// T1: the pairing
// ---------------------------------------------------------------------------

// the outside node, then up to 8 neighbours
constexpr int WALK_SLOTS = 9;

// One pass's arrays (h x w = n pixels; entry n of basin / parent is the
// outside node). Slot is the type of the merge pixels' slots, which hold
// basin ids up to n: int16_t below 2^15 pixels, int32_t from there (the
// kernel's and the host's callers pick it with slot_is_narrow).
template <class Slot>
struct PairBlock {
  int h, w, n;
  bool h1;  // H1: 4-connected with the outside node; else H0, 8-connected
  float* val;        // n: the pass's values
  int32_t* basin;    // n + 1: pointer, then basin root
  int32_t* parent;   // n + 1: the union-find over the basin roots
  uint8_t* flag;     // n: merge pixel
  int32_t* merge;    // pow2_at_least(n): the merge pixels (n pads the sort)
  Slot* slots;       // slot_count(h1) per merge pixel: the slot's basin or -1
  int32_t* bar_b;    // pcore::bar_capacity(n)
  int32_t* bar_d;    // pcore::bar_capacity(n)
  // a walk round's slots, WALK_SLOTS for each of its pixels (slots the
  // pass has not stay -1), and each pixel's distinct roots
  int32_t* roots;    // WALK_ROUND_MAX * WALK_SLOTS: the slot's basin's root,
                     // -1 if none
  int32_t* uroot;    // WALK_ROUND_MAX * WALK_SLOTS: the distinct roots
  uint64_t* ukey;    // WALK_ROUND_MAX * WALK_SLOTS: their keys
  float* uval;       // WALK_ROUND_MAX * WALK_SLOTS: their values
  int32_t* ucount;   // WALK_ROUND_MAX: how many
  int32_t* upix;     // WALK_ROUND_MAX: the pixel
  float* uval_p;     // WALK_ROUND_MAX: its value
};

// Whether an n-pixel grid's basin ids (0..n, n the outside node) fit
// int16_t slots.
DH_HD inline bool slot_is_narrow(int n) { return n < (1 << 15); }

// The pass's slots: [slot_lo, slot_lo + slot_count): H1 the outside node
// and 4 neighbours, H0 8 neighbours.
DH_HD inline int slot_lo(bool h1) { return h1 ? 0 : 1; }
DH_HD inline int slot_count(bool h1) { return h1 ? 5 : 8; }

template <class Slot>
DH_HD inline uint64_t code_of(const PairBlock<Slot>& P, int32_t p) {
  return pcore::sort_code(P.val[p], p);
}

// The neighbour of p in slot j that precedes p in the filtration (slot 0:
// the outside node, for a border pixel in H1), else -1.
template <class Slot>
DH_HD inline int32_t earlier_neighbour(const PairBlock<Slot>& P, int32_t p,
                                       int j) {
  const int y = p / P.w, x = p % P.w;
  if (j == 0) {
    const bool border = y == 0 || x == 0 || y == P.h - 1 || x == P.w - 1;
    return P.h1 && border ? P.n : -1;
  }
  int dy, dx;
  pcore::neighbour(j - 1, !P.h1, &dy, &dx);
  const int ny = y + dy, nx = x + dx;
  if (ny < 0 || nx < 0 || ny >= P.h || nx >= P.w) return -1;
  const int32_t q = ny * P.w + nx;
  return code_of(P, q) < code_of(P, p) ? q : -1;
}

// 1. the pass's values (the grid, or its negation for H1)
template <class Slot>
DH_HD inline void pairs_load(const float* grid, const PairBlock<Slot>& P,
                             int tid, int nthreads) {
  for (int i = tid; i < P.n; i += nthreads)
    P.val[i] = P.h1 ? -grid[i] : grid[i];
}

// 2. each pixel's pointer to its lowest-coded earlier neighbour (the outside
// node before any pixel), itself when it has none; the union-find reset
template <class Slot>
DH_HD inline void pairs_pointers(const PairBlock<Slot>& P, int tid,
                                 int nthreads) {
  const int lo = slot_lo(P.h1), hi = lo + slot_count(P.h1);
  for (int p = tid; p <= P.n; p += nthreads) {
    int32_t best = p;
    uint64_t best_code = 0;
    for (int j = lo; p < P.n && j < hi; ++j) {
      const int32_t q = earlier_neighbour(P, p, j);
      if (q < 0 || best == P.n) continue;
      if (q == P.n) {
        best = q;
        continue;
      }
      const uint64_t c = code_of(P, q);
      if (best == p || c < best_code) {
        best = q;
        best_code = c;
      }
    }
    P.basin[p] = best;
    P.parent[p] = p;
  }
}

// 3. one round of pointer jumping; true when a pointer moved. Run until no
// thread's did: every pointer is then a basin root. (Rounds may read
// pointers another thread moved in the same round: those are ancestors
// too, so the roots are the same.)
template <class Slot>
DH_HD inline bool pairs_jump(const PairBlock<Slot>& P, int tid,
                             int nthreads) {
  bool moved = false;
  for (int p = tid; p < P.n; p += nthreads) {
    const int32_t b = P.basin[p];
    const int32_t bb = P.basin[b];
    if (bb != b) {
      P.basin[p] = bb;
      moved = true;
    }
  }
  return moved;
}

// 4a. flag the merge pixels of thread tid's chunk; returns their count
template <class Slot>
DH_HD inline int pairs_flag_merges(const PairBlock<Slot>& P, int tid,
                                   int nthreads) {
  const int lo = chunk_lo(P.n, tid, nthreads);
  const int hi = chunk_lo(P.n, tid + 1, nthreads);
  const int jlo = slot_lo(P.h1), jhi = jlo + slot_count(P.h1);
  int count = 0;
  for (int p = lo; p < hi; ++p) {
    int32_t first = -1;
    bool merge = false;
    for (int j = jlo; j < jhi && !merge; ++j) {
      const int32_t q = earlier_neighbour(P, p, j);
      if (q < 0) continue;
      const int32_t b = P.basin[q];  // basin[n] == n: the outside node
      if (first < 0)
        first = b;
      else
        merge = b != first;
    }
    P.flag[p] = merge;
    count += merge;
  }
  return count;
}

// 4b. thread tid's merge pixels, in index order, from `offset` on (the
// exclusive scan of the counts of 4a)
template <class Slot>
DH_HD inline void pairs_scatter(const PairBlock<Slot>& P, int offset, int tid,
                                int nthreads) {
  const int lo = chunk_lo(P.n, tid, nthreads);
  const int hi = chunk_lo(P.n, tid + 1, nthreads);
  for (int p = lo; p < hi; ++p)
    if (P.flag[p]) P.merge[offset++] = p;
}

// 5a. the sort's padding: entries [m, pow2_at_least(m)) after every pixel
template <class Slot>
DH_HD inline void pairs_pad(const PairBlock<Slot>& P, int m, int tid,
                            int nthreads) {
  const int p2 = pow2_at_least(m);
  for (int i = m + tid; i < p2; i += nthreads) P.merge[i] = P.n;
}

template <class Slot>
DH_HD inline uint64_t merge_key(const PairBlock<Slot>& P, int32_t p) {
  return p < P.n ? code_of(P, p) : ~0ull;
}

// 5b. one compare-exchange step (k, j) of the bitonic sort of the p2 merge
// entries by code; the codes are unique, so the order is the filtration's
template <class Slot>
DH_HD inline void pairs_bitonic_step(const PairBlock<Slot>& P, int p2, int k,
                                     int j, int tid, int nthreads) {
  for (int i = tid; i < p2; i += nthreads) {
    const int ixj = i ^ j;
    if (ixj <= i) continue;
    const int32_t a = P.merge[i], b = P.merge[ixj];
    if ((merge_key(P, a) > merge_key(P, b)) == ((i & k) == 0)) {
      P.merge[i] = b;
      P.merge[ixj] = a;
    }
  }
}

// 5c. the slots of the sorted merge pixels: the basin of the earlier
// neighbour in each of the pass's slots, -1 where there is none
template <class Slot>
DH_HD inline void pairs_slots(const PairBlock<Slot>& P, int m, int tid,
                              int nthreads) {
  const int lo = slot_lo(P.h1), count = slot_count(P.h1);
  for (int t = tid; t < m; t += nthreads) {
    const int32_t p = P.merge[t];
    for (int e = 0; e < count; ++e) {
      const int32_t q = earlier_neighbour(P, p, lo + e);
      P.slots[t * count + e] = static_cast<Slot>(q < 0 ? -1 : P.basin[q]);
    }
  }
}

// The walk goes in rounds of walk_round(h1) merge pixels, one of
// WALK_THREADS lanes per slot of each (H1 25 pixels of 5 slots, H0 16 of
// 8): the lanes find the slots' roots at once (walk_slot); one lane per
// pixel lists its distinct roots (walk_distinct); then one lane replays the
// unions of the pixels with two or more, pixel after pixel (walk_unite).
constexpr int WALK_THREADS = 128;
constexpr int WALK_ROUND_MAX = WALK_THREADS / 5;
DH_HD inline int walk_round(bool h1) { return WALK_THREADS / slot_count(h1); }

// The root of x's union-find tree, halving the path on the way: every
// write points a node at an ancestor, so lanes that find at once are safe.
DH_HD inline int32_t find_root(int32_t* parent, int32_t x) {
  int32_t up = parent[x];
  while (up != x) {
    const int32_t next = parent[up];
    if (next == up) return up;
    parent[x] = next;
    x = next;
    up = parent[x];
  }
  return x;
}

// The elder rule's order of roots: the outside node first, then by sort
// code. A root is its component's birth pixel.
template <class Slot>
DH_HD inline uint64_t root_key(const PairBlock<Slot>& P, int32_t r) {
  return r == P.n ? 0 : code_of(P, r) + 1;
}

// The value of root r (0 for the outside node).
template <class Slot>
DH_HD inline float root_val(const PairBlock<Slot>& P, int32_t r) {
  return r < P.n ? P.val[r] : 0.0f;
}

// 6a. the walk at the t-th merge pixel, g-th of its round, the pass's e-th
// slot: the union-find root of the slot's basin (-1 for none).
template <class Slot>
DH_HD inline void walk_slot(const PairBlock<Slot>& P, int t, int g, int e) {
  const int count = slot_count(P.h1);
  const int32_t b = P.slots[t * count + e];
  P.roots[g * WALK_SLOTS + slot_lo(P.h1) + e] =
      b < 0 ? -1 : find_root(P.parent, b);
}

// 6b. the g-th pixel of the round (the t-th merge pixel p), by one lane per
// pixel: its slots' distinct roots in slot order, with their keys and
// values, and p's value, for walk_unite; true when there are two or more.
// One root stays one through the round (unions only join components): its
// unite would do nothing.
template <class Slot>
DH_HD inline bool walk_distinct(const PairBlock<Slot>& P, int t, int g) {
  int32_t r[WALK_SLOTS];
  PPAR_UNROLL
  for (int j = 0; j < WALK_SLOTS; ++j) r[j] = P.roots[g * WALK_SLOTS + j];
  const int32_t p = P.merge[t];
  P.upix[g] = p;
  P.uval_p[g] = P.val[p];
  int count = 0;
  PPAR_UNROLL
  for (int j = 0; j < WALK_SLOTS; ++j) {
    bool first = r[j] >= 0;
    PPAR_UNROLL
    for (int i = 0; i < j; ++i) first &= r[i] != r[j];
    if (first) {
      P.uroot[g * WALK_SLOTS + count] = r[j];
      P.ukey[g * WALK_SLOTS + count] = root_key(P, r[j]);
      P.uval[g * WALK_SLOTS + count] = root_val(P, r[j]);
      ++count;
    }
  }
  P.ucount[g] = count;
  return count >= 2;
}

// 6c. sublevel_pairs' unions at the g-th pixel p of the round, over its
// distinct roots in slot order (one lane, pixel after pixel): a root that an
// earlier pixel of the round united is found again; the first root is p's
// component; each later one that differs meets the running one (the least
// key so far), and the younger of the two (the larger key) dies at p: a bar
// unless its birth value equals p's, and its root goes under the elder.
// Appends to bar_b / bar_d (at most cap kept); returns the new bar count.
template <class Slot>
DH_HD inline int walk_unite(const PairBlock<Slot>& P, int g, int nbars,
                            int cap) {
  const int count = P.ucount[g];
  const int32_t p = P.upix[g];
  const float vp = P.uval_p[g];
  int32_t* r = P.uroot + g * WALK_SLOTS;
  uint64_t* k = P.ukey + g * WALK_SLOTS;
  float* v = P.uval + g * WALK_SLOTS;
  for (int u = 0; u < count; ++u) {
    if (P.parent[r[u]] == r[u]) continue;  // parent[n] == n
    r[u] = find_root(P.parent, r[u]);
    k[u] = root_key(P, r[u]);
    v[u] = root_val(P, r[u]);
  }
  int32_t elder = r[0];
  uint64_t elder_key = k[0];
  float elder_val = v[0];
  for (int u = 1; u < count; ++u) {
    bool dup = false;
    for (int i = 0; i < u; ++i) dup |= r[i] == r[u];
    if (dup) continue;
    int32_t younger;
    float younger_val;
    if (k[u] < elder_key) {
      younger = elder;
      younger_val = elder_val;
      elder = r[u];
      elder_key = k[u];
      elder_val = v[u];
    } else {
      younger = r[u];
      younger_val = v[u];
    }
    if (younger_val != vp) {
      if (nbars < cap) {
        P.bar_b[nbars] = younger;
        P.bar_d[nbars] = p;
      }
      ++nbars;
    }
    P.parent[younger] = elder;
  }
  return nbars;
}

// 7a. the cap's persistences (into pers, nbars of them), when nbars >
// max_bars
template <class Slot>
DH_HD inline void pairs_persistence(const PairBlock<Slot>& P, int nbars,
                                    float* pers, int tid, int nthreads) {
  for (int i = tid; i < nbars; i += nthreads)
    pers[i] = pcore::persistence(P.val, P.bar_b[i], P.bar_d[i]);
}

// 7b. the capped emit: the bars in emission order when they fit, else the
// max_bars first under pcore::kept_before, in that order (each bar's place
// counted over all bars); -1 padding; in H1 each (b, d) written as (d, b)
// (the superlevel -> H1 swap). pers from 7a when nbars > max_bars.
template <class Slot>
DH_HD inline void pairs_emit(const PairBlock<Slot>& P, int nbars,
                             const float* pers, int max_bars, int32_t* out_b,
                             int32_t* out_d, int tid, int nthreads) {
  const bool swap = P.h1;
  if (nbars <= max_bars) {
    for (int i = tid; i < max_bars; i += nthreads) {
      const int32_t b = i < nbars ? P.bar_b[i] : -1;
      const int32_t d = i < nbars ? P.bar_d[i] : -1;
      out_b[i] = swap ? d : b;
      out_d[i] = swap ? b : d;
    }
    return;
  }
  for (int i = tid; i < nbars; i += nthreads) {
    const float pi = pers[i];
    int place = 0;
    for (int j = 0; j < nbars && place < max_bars; ++j)
      place += pcore::kept_before(pers[j], j, pi, i);
    if (place < max_bars) {
      out_b[place] = swap ? P.bar_d[i] : P.bar_b[i];
      out_d[place] = swap ? P.bar_b[i] : P.bar_d[i];
    }
  }
}

// ---------------------------------------------------------------------------
// T2: the matching
// ---------------------------------------------------------------------------

constexpr int32_t ASSIGNED = 1 << 30;  // over any column index

// A column of a Dijkstra step: its reduced distance, and key = column |
// ASSIGNED when a row holds it; key -1: none.
struct ColBest {
  double dist;
  int32_t key;
};

// a before b in (distance, assigned, column) order; none after all
DH_HD inline bool col_before(const ColBest& a, const ColBest& b) {
  if (a.key < 0) return false;
  if (b.key < 0) return true;
  return a.dist < b.dist || (a.dist == b.dist && a.key < b.key);
}

// The Dijkstra search of one augmentation, the same in every thread.
struct SearchState {
  int i;           // the row being scanned
  double min_val;  // the distance reached
  int sink;        // the free column reached, -1 while searching
};

// The row's bar values and diagonal costs (pcore::match_row's first loops).
DH_HD inline void match_setup(const float* pg, const int32_t* pb,
                              const int32_t* pd, int nb, const float* tb,
                              int nt, float q, const pcore::MatchScratch& s,
                              int tid, int nthreads) {
  for (int j = tid; j < nb; j += nthreads) {
    s.bval[j] = pg[pb[j]];
    s.dval[j] = pg[pd[j]];
    s.diag_p[j] = pcore::diag_cost(s.bval[j], s.dval[j], q);
  }
  for (int t = tid; t < nt; t += nthreads)
    s.diag_t[t] = pcore::diag_cost(tb[2 * t], tb[2 * t + 1], q);
}

// The duals and the assignment, empty.
DH_HD inline void assign_init(int ns, int nc, const pcore::MatchScratch& s,
                              int tid, int nthreads) {
  for (int r = tid; r < ns; r += nthreads) {
    s.u[r] = 0.0;
    s.col4row[r] = -1;
  }
  for (int j = tid; j < nc; j += nthreads) {
    s.v[j] = 0.0;
    s.row4col[j] = -1;
  }
}

// The start of augmentation `cur`: each thread resets its own columns and
// rows (row cur scanned), so no barrier is needed before its relax.
DH_HD inline SearchState search_init(int cur, int ns, int nc,
                                     const pcore::MatchScratch& s, int tid,
                                     int nthreads) {
  for (int j = tid; j < nc; j += nthreads) {
    s.dist[j] = pcore::inf_d();
    s.scanned_col[j] = 0;
    s.path[j] = -1;
  }
  for (int r = tid; r < ns; r += nthreads) s.scanned_row[r] = r == cur;
  return SearchState{cur, 0.0, -1};
}

// One Dijkstra step over thread tid's columns: relax them from row st.i and
// return the first of them in col_before order (finite distance, not yet
// scanned). The block's first is the least of the threads'.
DH_HD inline ColBest relax_columns(const pcore::ReducedCost& cost,
                                   const SearchState& st, int nc,
                                   const pcore::MatchScratch& s, int tid,
                                   int nthreads) {
  const double INF = pcore::inf_d();
  const double ui = s.u[st.i];
  ColBest best{INF, -1};
  for (int j = tid; j < nc; j += nthreads) {
    if (s.scanned_col[j]) continue;
    const double r = st.min_val + cost(st.i, j) - ui - s.v[j];
    if (r < s.dist[j]) {
      s.dist[j] = r;
      s.path[j] = st.i;
    }
    if (s.dist[j] < INF) {
      const ColBest c{s.dist[j], j | (s.row4col[j] != -1 ? ASSIGNED : 0)};
      if (col_before(c, best)) best = c;
    }
  }
  return best;
}

// Take the block's first column (key >= 0): mark it scanned (its owner) and
// go on from its row, or stop at it when it is free. Row marks by thread 0.
DH_HD inline void take_column(const ColBest& best, SearchState& st,
                              const pcore::MatchScratch& s, int tid,
                              int nthreads) {
  const int j = best.key & (ASSIGNED - 1);
  st.min_val = best.dist;
  if (j % nthreads == tid) s.scanned_col[j] = 1;
  const int r = s.row4col[j];
  if (r == -1) {
    st.sink = j;
  } else {
    st.i = r;
    if (tid == 0) s.scanned_row[r] = 1;
  }
}

// The dual update after augmentation cur's search (min_cost_assign's): rows
// and columns by their owners.
DH_HD inline void dual_update(int cur, double min_val, int ns, int nc,
                              const pcore::MatchScratch& s, int tid,
                              int nthreads) {
  for (int r = tid; r < ns; r += nthreads) {
    if (r == cur)
      s.u[r] += min_val;
    else if (s.scanned_row[r])
      s.u[r] += min_val - s.dist[s.col4row[r]];
  }
  for (int j = tid; j < nc; j += nthreads)
    if (s.scanned_col[j]) s.v[j] -= min_val - s.dist[j];
}

// The augmentation back along the path from the sink (one thread).
DH_HD inline void augment(int cur, int sink, const pcore::MatchScratch& s) {
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

// The row's outputs for all k pred slots (pcore::match_row's): matched[j]
// and target[2j:2j+2], the true bar matched to pred bar j, else zeros.
// `assigned`: false when the row has no true bar (nothing was assigned).
DH_HD inline void match_write(const float* tb, int nb, int nt, int k,
                              bool assigned, const pcore::MatchScratch& s,
                              int8_t* matched, float* target, int tid,
                              int nthreads) {
  const bool rows_true = nt <= nb;
  for (int j = tid; j < k; j += nthreads) {
    int t = -1;
    if (assigned && j < nb) {
      if (rows_true) {
        t = s.row4col[j];
      } else {
        t = s.col4row[j];
        if (t >= nt) t = -1;
      }
    }
    matched[j] = t >= 0;
    target[2 * j] = t >= 0 ? tb[2 * t] : 0.0f;
    target[2 * j + 1] = t >= 0 ? tb[2 * t + 1] : 0.0f;
  }
}

// The diagonal costs of the unmatched true bars, summed in their order (one
// thread: the host library's f32 sum).
DH_HD inline float match_const_term(int nb, int nt,
                                    const pcore::MatchScratch& s) {
  float c = 0.0f;
  const bool rows_true = nt <= nb;
  for (int t = 0; t < nt; ++t) {
    const bool unmatched = rows_true ? s.col4row[t] >= nb : s.row4col[t] == -1;
    if (unmatched) c += s.diag_t[t];
  }
  return c;
}

}  // namespace ppar
