// The host library of the topological loss: batched cubical persistence
// pairing and batched reduced Wasserstein matching over the algorithm of
// persistence_core.h, parallel over grids (rows) on std::threads (not
// OpenMP: a g++ without libgomp builds it too). Loaded with ctypes by
// ops/native.py, which builds it at first use:
//
//   g++ -O3 -fPIC -shared -std=c++17 -pthread -ffp-contract=off
//
// The card's kernels (topology.cu) run the same core functions, so the two
// give the same bars and the same matchings.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

#include "persistence_core.h"

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

}  // extern "C"
