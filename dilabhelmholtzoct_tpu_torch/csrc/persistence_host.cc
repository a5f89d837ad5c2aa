// The host library of the topological loss: batched cubical persistence
// pairing and batched reduced Wasserstein matching over the algorithm of
// persistence_core.h, parallel over grids (rows) on std::threads (not
// OpenMP: a g++ without libgomp builds it too). Loaded with ctypes by
// ops/native.py, which builds it at first use:
//
//   g++ -O3 -fPIC -shared -std=c++17 -pthread -ffp-contract=off
//
// The card's kernels (topology.cu) run the phases of persistence_parallel.h,
// whose results equal these core functions'. The *_parallel entries run
// those phases here, over a virtual thread count, one virtual thread after
// another: the CPU tests hold the kernels' algorithm to the core's with them.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include "persistence_core.h"
#include "persistence_parallel.h"

namespace {

// body(i, state) for every i in [0, n), on up to one thread per core, each
// thread taking the next i and keeping one State for all of its calls.
template <class State, class Body>
void parallel_for(int n, Body body) {
  const int cores = static_cast<int>(std::thread::hardware_concurrency());
  const int workers = std::max(1, std::min(n, cores));
  std::atomic<int> next{0};
  auto run = [&]() {
    State state;
    for (int i; (i = next.fetch_add(1)) < n;) body(i, state);
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < workers; ++t) threads.emplace_back(run);
  run();
  for (auto& t : threads) t.join();
}

struct PairScratch {
  std::vector<int32_t> order, rank, parent, birth, bar_b, bar_d, idx, count;
  std::vector<uint64_t> radix_a, radix_tmp;
  std::vector<float> neg, pers;

  void reserve(int n) {
    order.resize(n);
    rank.resize(n);
    parent.resize(n + 1);
    birth.resize(n + 1);
    bar_b.resize(pcore::bar_capacity(n));
    bar_d.resize(pcore::bar_capacity(n));
    idx.resize(pcore::bar_capacity(n));
    pers.resize(pcore::bar_capacity(n));
    count.resize(pcore::RADIX_BUCKETS);
    radix_a.resize(n);
    radix_tmp.resize(n);
    neg.resize(n);
  }
};

// One pass over val; returns the bar count, bars in S.bar_b / S.bar_d.
int one_pass(const float* val, int h, int w, bool eight, bool outside,
             PairScratch& S, int32_t* essential) {
  const int n = h * w;
  pcore::radix_argsort(val, n, S.order.data(), S.radix_a.data(),
                       S.radix_tmp.data(), S.count.data());
  for (int i = 0; i < n; ++i) S.rank[S.order[i]] = i;
  std::fill(S.parent.begin(), S.parent.end(), -1);
  std::fill(S.birth.begin(), S.birth.end(), -1);
  return pcore::sublevel_pairs(val, h, w, eight, outside, S.order.data(),
                               S.rank.data(), S.parent.data(), S.birth.data(),
                               S.bar_b.data(), S.bar_d.data(),
                               pcore::bar_capacity(n), essential);
}

// The capped emit: all bars in emission order when they fit, else the
// max_bars first under pcore::kept_before, in that order; -1 padding. With
// `swap` each (b, d) is written as (d, b) (the superlevel -> H1 swap).
void emit(const float* val, int nbars, PairScratch& S, int max_bars,
          bool swap, int32_t* births, int32_t* deaths, int32_t* count) {
  int* idx = S.idx.data();
  for (int i = 0; i < nbars; ++i) idx[i] = i;
  if (nbars > max_bars) {
    for (int i = 0; i < nbars; ++i)
      S.pers[i] = pcore::persistence(val, S.bar_b[i], S.bar_d[i]);
    std::partial_sort(idx, idx + max_bars, idx + nbars, [&](int a, int b) {
      return pcore::kept_before(S.pers[a], a, S.pers[b], b);
    });
  }
  *count = std::min(nbars, max_bars);
  for (int i = 0; i < max_bars; ++i) {
    const bool on = i < *count;
    const int32_t b = on ? S.bar_b[idx[i]] : -1;
    const int32_t d = on ? S.bar_d[idx[i]] : -1;
    births[i] = swap ? d : b;
    deaths[i] = swap ? b : d;
  }
}

// T1's phases (persistence_parallel.h) over one pass of a grid, as
// topology.cu's cubical_pairs_kernel runs them, on `nthreads` virtual
// threads; the walk's lanes one after another. The slots are int16_t below
// 2^15 pixels and int32_t from there, as the kernel's.
struct PhasePairScratch {
  std::vector<float> val, pers, uval, uval_p;
  std::vector<uint64_t> ukey;
  std::vector<int32_t> basin, parent, merge, bar_b, bar_d, roots, uroot,
      ucount, upix, offset;
  std::vector<int16_t> slots16;
  std::vector<int32_t> slots32;
  std::vector<uint8_t> flag;

  template <class Slot>
  ppar::PairBlock<Slot> carve(int h, int w, bool h1, int nthreads) {
    const int n = h * w;
    const int cap = pcore::bar_capacity(n);
    val.resize(n);
    pers.resize(cap);
    basin.resize(n + 1);
    parent.resize(n + 1);
    merge.resize(ppar::pow2_at_least(n));
    std::vector<Slot>& slots = slot_vector(Slot{});
    slots.resize(static_cast<size_t>(ppar::slot_count(h1)) * n);
    bar_b.resize(cap);
    bar_d.resize(cap);
    flag.resize(n);
    offset.resize(nthreads + 1);
    const int round_slots = ppar::WALK_ROUND_MAX * ppar::WALK_SLOTS;
    roots.assign(round_slots, -1);
    uroot.assign(round_slots, -1);
    ukey.assign(round_slots, 0);
    uval.assign(round_slots, 0.0f);
    ucount.assign(ppar::WALK_ROUND_MAX, 0);
    upix.assign(ppar::WALK_ROUND_MAX, 0);
    uval_p.assign(ppar::WALK_ROUND_MAX, 0.0f);
    return ppar::PairBlock<Slot>{h, w, n, h1, val.data(), basin.data(),
                                 parent.data(), flag.data(), merge.data(),
                                 slots.data(), bar_b.data(), bar_d.data(),
                                 roots.data(), uroot.data(), ukey.data(),
                                 uval.data(), ucount.data(), upix.data(),
                                 uval_p.data()};
  }

  std::vector<int16_t>& slot_vector(int16_t) { return slots16; }
  std::vector<int32_t>& slot_vector(int32_t) { return slots32; }
};

// Returns the merge pixels' count; bars into out_b / out_d / *count.
template <class Slot>
int pass_in_phases(const float* grid, int h, int w, bool h1, int nthreads,
                   int max_bars, PhasePairScratch& S, int32_t* out_b,
                   int32_t* out_d, int32_t* count) {
  const ppar::PairBlock<Slot> P = S.carve<Slot>(h, w, h1, nthreads);
  const int T = nthreads;
  for (int t = 0; t < T; ++t) ppar::pairs_load(grid, P, t, T);
  for (int t = 0; t < T; ++t) ppar::pairs_pointers(P, t, T);
  for (bool moved = true; moved;) {
    moved = false;
    for (int t = 0; t < T; ++t)
      if (ppar::pairs_jump(P, t, T)) moved = true;
  }
  S.offset[0] = 0;
  for (int t = 0; t < T; ++t)
    S.offset[t + 1] = S.offset[t] + ppar::pairs_flag_merges(P, t, T);
  const int m = S.offset[T];
  for (int t = 0; t < T; ++t) ppar::pairs_scatter(P, S.offset[t], t, T);
  for (int t = 0; t < T; ++t) ppar::pairs_pad(P, m, t, T);
  const int p2 = ppar::pow2_at_least(m);
  for (int k = 2; k <= p2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1)
      for (int t = 0; t < T; ++t) ppar::pairs_bitonic_step(P, p2, k, j, t, T);
  for (int t = 0; t < T; ++t) ppar::pairs_slots(P, m, t, T);
  const int cap = pcore::bar_capacity(P.n);
  const int round = ppar::walk_round(h1), slots = ppar::slot_count(h1);
  int nbars = 0;
  for (int t0 = 0; t0 < m; t0 += round) {
    const int pixels = std::min(round, m - t0);
    for (int g = 0; g < pixels; ++g)
      for (int e = 0; e < slots; ++e) ppar::walk_slot(P, t0 + g, g, e);
    bool unite[ppar::WALK_ROUND_MAX];
    for (int g = 0; g < pixels; ++g)
      unite[g] = ppar::walk_distinct(P, t0 + g, g);
    for (int g = 0; g < pixels; ++g)
      if (unite[g]) nbars = ppar::walk_unite(P, g, nbars, cap);
  }
  if (nbars > max_bars)
    for (int t = 0; t < T; ++t)
      ppar::pairs_persistence(P, nbars, S.pers.data(), t, T);
  for (int t = 0; t < T; ++t)
    ppar::pairs_emit(P, nbars, S.pers.data(), max_bars, out_b, out_d, t, T);
  *count = std::min(nbars, max_bars);
  return m;
}

// T2's phases over one row, as topology.cu's wasserstein_match_kernel runs
// them, on `nthreads` virtual threads; returns the Dijkstra steps taken.
int row_in_phases(const float* pg, const int32_t* pb, const int32_t* pd,
                  int nb, const float* tb, int nt, float q, int k,
                  int nthreads, const pcore::MatchScratch& s, int8_t* matched,
                  float* target, float* const_term) {
  const int T = nthreads;
  for (int t = 0; t < T; ++t)
    ppar::match_setup(pg, pb, pd, nb, tb, nt, q, s, t, T);
  int steps = 0;
  if (nt > 0) {
    const bool rows_true = nt <= nb;
    const int ns = rows_true ? nt : nb;
    const int nc = nb + nt;
    const pcore::ReducedCost cost{&s, tb, nb, nt, q, rows_true};
    for (int t = 0; t < T; ++t) ppar::assign_init(ns, nc, s, t, T);
    for (int cur = 0; cur < ns; ++cur) {
      ppar::SearchState st{};
      for (int t = 0; t < T; ++t) st = ppar::search_init(cur, ns, nc, s, t, T);
      while (st.sink == -1) {
        ppar::ColBest first{pcore::inf_d(), -1};
        for (int t = 0; t < T; ++t) {
          const ppar::ColBest c = ppar::relax_columns(cost, st, nc, s, t, T);
          if (ppar::col_before(c, first)) first = c;
        }
        ++steps;
        if (first.key < 0) break;
        for (int t = 0; t < T; ++t) ppar::take_column(first, st, s, t, T);
      }
      if (st.sink == -1) break;
      for (int t = 0; t < T; ++t)
        ppar::dual_update(cur, st.min_val, ns, nc, s, t, T);
      ppar::augment(cur, st.sink, s);
    }
  }
  for (int t = 0; t < T; ++t)
    ppar::match_write(tb, nb, nt, k, nt > 0, s, matched, target, t, T);
  *const_term = ppar::match_const_term(nb, nt, s);
  return steps;
}

}  // namespace

extern "C" {

// Batched pairing. grids: (n_grids, h, w) f32. Outputs, each (n_grids,
// max_bars): h{0,1}_{birth,death} flat pixel indices (int32, -1 padding);
// counts (n_grids, 2) = [n_h0, n_h1] (at most max_bars); h0_essential
// (n_grids,) the birth pixel of the essential H0 class.
void cubical_pairs_batch(const float* grids, int n_grids, int h, int w,
                         int max_bars, int32_t* h0_birth, int32_t* h0_death,
                         int32_t* h1_birth, int32_t* h1_death,
                         int32_t* counts, int32_t* h0_essential) {
  const int n = h * w;
  parallel_for<PairScratch>(n_grids, [&](int g, PairScratch& S) {
    S.reserve(n);
    const float* flat = grids + static_cast<int64_t>(g) * n;
    const int64_t off = static_cast<int64_t>(g) * max_bars;
    int nb = one_pass(flat, h, w, /*eight=*/true, /*outside=*/false, S,
                      &h0_essential[g]);
    emit(flat, nb, S, max_bars, false, h0_birth + off, h0_death + off,
         &counts[2 * g]);
    for (int i = 0; i < n; ++i) S.neg[i] = -flat[i];
    nb = one_pass(S.neg.data(), h, w, /*eight=*/false, /*outside=*/true, S,
                  nullptr);
    emit(S.neg.data(), nb, S, max_bars, true, h1_birth + off, h1_death + off,
         &counts[2 * g + 1]);
  });
}

// Batched optimal partial matching between pred and true diagrams, per row:
//   grids (n_rows, hw) f32: the pred grids the bar values are read from;
//   p_birth / p_death (n_rows, k) int32 flat pixel indices, p_count (n_rows,);
//   true_bars (total_t, 2) f32, row r owning true_bars[t_off[r]:t_off[r+1]].
// Outputs (zeroed by the caller): matched (n_rows, k) int8, target (n_rows,
// k, 2) f32 (the matched true bar), const_term (n_rows,) f32 (the diagonal
// costs of the unmatched true bars).
void wasserstein_match_batch(const float* grids, int n_rows, int hw,
                             const int32_t* p_birth, const int32_t* p_death,
                             const int32_t* p_count, const float* true_bars,
                             const int64_t* t_off, double q, int k,
                             int8_t* matched, float* target,
                             float* const_term) {
  const float qf = static_cast<float>(q);
  parallel_for<std::vector<uint64_t>>(
      n_rows, [&](int g, std::vector<uint64_t>& scratch) {
        const int nb = std::min(p_count[g], k);
        const int nt = static_cast<int>(t_off[g + 1] - t_off[g]);
        scratch.resize(pcore::match_scratch_bytes(nb, nt) / 8 + 1);
        const pcore::MatchScratch s =
            pcore::carve_match_scratch(scratch.data(), nb, nt);
        const int64_t row = static_cast<int64_t>(g) * k;
        pcore::match_row(grids + static_cast<int64_t>(g) * hw, p_birth + row,
                         p_death + row, nb, true_bars + 2 * t_off[g], nt, qf,
                         matched + row, target + 2 * row, &const_term[g], s);
      });
}

// T1's kernel algorithm on the host (pass_in_phases): grids (n_grids, h, w)
// f32 of up to 65534 cells (the caller checks), the feat_d pass (0: H0,
// 1: H1), on nthreads virtual threads -> birth / death (n_grids, max_bars)
// int32 (-1 padding), count (n_grids,), merges (n_grids,): the merge pixels
// the walk visited.
void cubical_pairs_parallel(const float* grids, int n_grids, int h, int w,
                            int feat_d, int max_bars, int nthreads,
                            int32_t* birth, int32_t* death, int32_t* count,
                            int32_t* merges) {
  const int n = h * w;
  parallel_for<PhasePairScratch>(n_grids, [&](int g, PhasePairScratch& S) {
    const int64_t off = static_cast<int64_t>(g) * max_bars;
    const auto pass = ppar::slot_is_narrow(n) ? pass_in_phases<int16_t>
                                              : pass_in_phases<int32_t>;
    merges[g] = pass(grids + static_cast<int64_t>(g) * n, h, w, feat_d == 1,
                     nthreads, max_bars, S, birth + off, death + off,
                     &count[g]);
  });
}

// T2's kernel algorithm on the host (row_in_phases), in the kernel's layout:
// grids (n_rows, hw) f32, p_birth / p_death (n_rows, k) int32, p_count
// (n_rows,), true_bars (n_rows, t_max, 2) f32, t_count (n_rows,), on
// nthreads virtual threads -> matched (n_rows, k) int8, target (n_rows, k,
// 2) f32, const_term (n_rows,) f32, steps (n_rows,): the Dijkstra steps.
void wasserstein_match_parallel(const float* grids, int n_rows, int hw,
                                const int32_t* p_birth, const int32_t* p_death,
                                const int32_t* p_count, const float* true_bars,
                                const int32_t* t_count, int t_max, double q,
                                int k, int nthreads, int8_t* matched,
                                float* target, float* const_term,
                                int32_t* steps) {
  const float qf = static_cast<float>(q);
  parallel_for<std::vector<uint64_t>>(
      n_rows, [&](int g, std::vector<uint64_t>& scratch) {
        const int nb = std::min(p_count[g], k);
        const int nt = std::min(t_count[g], t_max);
        scratch.resize(pcore::match_scratch_bytes(nb, nt) / 8 + 1);
        const pcore::MatchScratch s =
            pcore::carve_match_scratch(scratch.data(), nb, nt);
        const int64_t row = static_cast<int64_t>(g) * k;
        steps[g] = row_in_phases(
            grids + static_cast<int64_t>(g) * hw, p_birth + row,
            p_death + row, nb, true_bars + 2 * static_cast<int64_t>(g) * t_max,
            nt, qf, k, nthreads, s, matched + row, target + 2 * row,
            &const_term[g]);
      });
}

}  // extern "C"
