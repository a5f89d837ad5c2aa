// The combinatorial half of the topological loss on the card: cubical
// persistence pairing (T1) and the reduced Wasserstein matching (T2).
//
// Neither replaces a Pallas kernel. They replace the JAX package's XLA
// programs in dilabhelmholtzoct_tpu/ops/topology_device.py:
//   * T1 cubical_pairs_kernel: device_cubical_pairs (:305) and its
//     _pairing_pass (:104). The JAX module restructures the union-find for a
//     vector machine (Jacobi basin propagation, sorted edge dedup,
//     lane-lockstep Kruskal) and emits bars in edge-weight order; here the
//     bars are the host library's (persistence_host.cc on
//     pcore::sublevel_pairs), index for index and in its order.
//   * T2 wasserstein_match_kernel: device_wasserstein_match (:333), the
//     lane-lockstep Jonker-Volgenant; here the host library's
//     pcore::min_cost_assign (f64 duals), match for match.
//
// Both run the phases of persistence_parallel.h, which the host library runs
// too over a virtual thread count (its *_parallel entries, for the CPU
// tests), with barriers between them.
//
// T1, one block of T1_THREADS per grid, its arrays in shared memory where
// they fit (~89 KB for a 50x50 grid in H1, ~104 KB in H0; up to 76x76 in
// H0 and 84x84 in H1), else in the grid's slice of a global scratch buffer
// that the wrapper allocates (the global route, up to 65534 cells: ~3.5 MB a
// grid at 255x255 in H0, so ~450 MB for 128 grids; the walk's round arrays
// stay in shared memory). One kernel source, the route a template
// parameter, and so the slots' type: int16_t below 2^15 pixels, int32_t from
// there (on the global route int16_t slots take 2-4% off T1 at 100x100 and
// 128x128 on an H100, PERF.md). The phases: the pass's values;
// steepest-descent pointers and pointer jumping to the basin roots (all
// threads); the merge pixels flagged per thread chunk, a block scan of the
// counts and the scatter (index order, no atomics), a bitonic sort of them
// into the filtration's order, and their slots' basins; the walk over the
// merge pixels in rounds of 25 (H1) or 16 (H0): a lane of warps 0-3 for each
// slot of each pixel finds its root, a lane of warp 0 for each pixel lists
// its distinct roots, and thread 0 replays the elder rule over those of the
// pixels with two or more, which a warp vote picks; the capped emit by all
// threads, H1 bars swapped.
//
// T2, one block of T2_THREADS per row, its scratch in shared memory
// (pcore::match_scratch_bytes: ~40 KB at 512 bars a side): each thread owns
// the columns j == tid (mod T2_THREADS) for the initialisation, every
// Dijkstra step's relaxation and the dual update; a step's argmin is a warp
// shuffle reduction and one barrier over the warps' firsts in (distance,
// assigned, column) order, which every thread then reads; thread 0 walks
// the augmenting path back.
//
// What bounds them: not bytes (a 50x50 grid is 10 KB) nor operations, but
// the serial chain left. T1: thread 0's unions, one pixel after another
// (a few hundred a grid for 50x50 noise and for the step's pred grids; the
// rest of the merge pixels, ~1.4k-1.7k, go by in parallel rounds). T2: the
// Dijkstra steps, each a relaxation of nc / 256 columns a thread, a
// reduction and a barrier (one step a row for the step's rows, with 0-1 true
// bars; tens of thousands a row for two noise diagrams of ~460 bars). All
// grids (rows) of a step run in one launch, a block each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistence_parallel.h"

namespace {

constexpr int T1_THREADS = 512;
constexpr int T2_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // what one block may opt in to on sm_90
// returned for operands whose shared memory exceeds MAX_SMEM (the wrappers
// raise NotImplementedError for it)
constexpr int ERR_SMEM = 1000;

// Opt kernel in to `dynamic` bytes of shared memory beside its static ones:
// cudaSuccess, ERR_SMEM when the two exceed MAX_SMEM, or the CUDA error.
template <class Kernel>
int opt_in_smem(Kernel kernel, size_t dynamic) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dynamic + attr.sharedSizeBytes > MAX_SMEM) return ERR_SMEM;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dynamic)));
}

// The most cells a grid may have: JAX's device pairing's capacity
// (dilabhelmholtzoct_tpu/ops/topology_device.py:_MAXCELLS); ops/native.py
// holds the same number.
constexpr int MAX_CELLS = (1 << 16) - 2;

// Byte offsets of T1's arrays (in dynamic shared memory, or in a grid's
// slice of the global scratch) for an n-cell grid, the pass (H1 or H0: its
// slot count) and the slots' type. The cap's persistences overlay the
// slots, which the walk no longer needs.
struct T1Layout {
  size_t val, basin, parent, merge, bar_b, bar_d, slots, flag, total;
};

template <class Slot>
__host__ __device__ inline T1Layout t1_layout(int n, bool h1) {
  const size_t cap = pcore::bar_capacity(n);
  T1Layout L;
  size_t off = 0;
  L.val = off;
  off += sizeof(float) * n;
  L.basin = off;
  off += sizeof(int32_t) * (n + 1);
  L.parent = off;
  off += sizeof(int32_t) * (n + 1);
  L.merge = off;
  off += sizeof(int32_t) * ppar::pow2_at_least(n);
  L.bar_b = off;
  off += sizeof(int32_t) * cap;
  L.bar_d = off;
  off += sizeof(int32_t) * cap;
  L.slots = off;  // over sizeof(float) * cap bytes: the persistences fit
  off += sizeof(Slot) * ppar::slot_count(h1) * n;
  L.flag = off;
  off += n;
  L.total = off;
  return L;
}

// Exclusive prefix sum of v over the block (T1_THREADS threads, in thread
// order); *total gets the sum. Two barriers.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = T1_THREADS / 32;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < WARPS ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, s, off);
      if (lane >= off) s += y;
    }
    __syncwarp();
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[WARPS - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// T1: kShared keeps the grid's arrays in dynamic shared memory; else they
// are at scratch + blockIdx.x * stride in global memory.
template <bool kShared, class Slot>
__global__ void __launch_bounds__(T1_THREADS)
    cubical_pairs_kernel(const float* __restrict__ grids, int h, int w,
                         int feat_d, int max_bars, int32_t* __restrict__ out_b,
                         int32_t* __restrict__ out_d,
                         int32_t* __restrict__ out_c,
                         unsigned char* __restrict__ scratch, int64_t stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const base =
      kShared ? smem : scratch + static_cast<int64_t>(blockIdx.x) * stride;
  constexpr int ROUND_SLOTS = ppar::WALK_ROUND_MAX * ppar::WALK_SLOTS;
  __shared__ int32_t s_roots[ROUND_SLOTS];  // -1 in slots not the pass's
  __shared__ int32_t s_uroot[ROUND_SLOTS];
  __shared__ uint64_t s_ukey[ROUND_SLOTS];
  __shared__ float s_uval[ROUND_SLOTS];
  __shared__ int32_t s_ucount[ppar::WALK_ROUND_MAX];
  __shared__ int32_t s_upix[ppar::WALK_ROUND_MAX];
  __shared__ float s_uval_p[ppar::WALK_ROUND_MAX];
  __shared__ int s_scan[T1_THREADS / 32];
  __shared__ int s_nbars;
  const int n = h * w;
  const int cap = pcore::bar_capacity(n);
  const bool h1 = feat_d == 1;
  const T1Layout L = t1_layout<Slot>(n, h1);
  ppar::PairBlock<Slot> P;
  P.h = h;
  P.w = w;
  P.n = n;
  P.h1 = h1;
  P.val = reinterpret_cast<float*>(base + L.val);
  P.basin = reinterpret_cast<int32_t*>(base + L.basin);
  P.parent = reinterpret_cast<int32_t*>(base + L.parent);
  P.flag = base + L.flag;
  P.merge = reinterpret_cast<int32_t*>(base + L.merge);
  P.slots = reinterpret_cast<Slot*>(base + L.slots);
  P.bar_b = reinterpret_cast<int32_t*>(base + L.bar_b);
  P.bar_d = reinterpret_cast<int32_t*>(base + L.bar_d);
  P.roots = s_roots;
  P.uroot = s_uroot;
  P.ukey = s_ukey;
  P.uval = s_uval;
  P.ucount = s_ucount;
  P.upix = s_upix;
  P.uval_p = s_uval_p;
  const int tid = threadIdx.x;

  if (tid < ROUND_SLOTS) s_roots[tid] = -1;
  ppar::pairs_load(grids + static_cast<int64_t>(blockIdx.x) * n, P, tid,
                   T1_THREADS);
  __syncthreads();
  ppar::pairs_pointers(P, tid, T1_THREADS);
  __syncthreads();
  while (__syncthreads_or(ppar::pairs_jump(P, tid, T1_THREADS))) {
  }
  int m;
  const int offset = block_exclusive_scan(
      ppar::pairs_flag_merges(P, tid, T1_THREADS), s_scan, &m);
  ppar::pairs_scatter(P, offset, tid, T1_THREADS);
  ppar::pairs_pad(P, m, tid, T1_THREADS);
  __syncthreads();
  const int p2 = ppar::pow2_at_least(m);
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      ppar::pairs_bitonic_step(P, p2, k, j, tid, T1_THREADS);
      __syncthreads();
    }
  }
  ppar::pairs_slots(P, m, tid, T1_THREADS);
  __syncthreads();
  {  // the walk, by warps 0-3 (the block keeps its barriers)
    const int slots = ppar::slot_count(h1), round = ppar::walk_round(h1);
    const int g = tid / slots, e = tid % slots;  // this lane's pixel, slot
    int nbars = 0;
    for (int t0 = 0; t0 < m; t0 += round) {
      if (tid < ppar::WALK_THREADS && g < round && t0 + g < m)
        ppar::walk_slot(P, t0 + g, g, e);
      __syncthreads();
      if (tid < 32) {  // round <= 32: the pixels' lanes are warp 0's
        unsigned todo = __ballot_sync(
            FULL_MASK, tid < round && t0 + tid < m &&
                           ppar::walk_distinct(P, t0 + tid, tid));
        __syncwarp();
        if (tid == 0) {
          for (; todo; todo &= todo - 1)
            nbars = ppar::walk_unite(P, __ffs(todo) - 1, nbars, cap);
        }
        __syncwarp();
      }
      __syncthreads();
    }
    if (tid == 0) s_nbars = nbars;
  }
  __syncthreads();
  const int nbars = s_nbars;
  float* pers = reinterpret_cast<float*>(base + L.slots);
  if (nbars > max_bars) {
    ppar::pairs_persistence(P, nbars, pers, tid, T1_THREADS);
    __syncthreads();
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * max_bars;
  ppar::pairs_emit(P, nbars, pers, max_bars, out_b + row, out_d + row, tid,
                   T1_THREADS);
  if (tid == 0) out_c[blockIdx.x] = nbars < max_bars ? nbars : max_bars;
}

// The block's first column in ppar::col_before order from each thread's
// first: a warp shuffle reduction, then every thread reduces the warps'
// (slots[parity], alternating: a warp may write the next step's slots while
// another still reads this step's). One barrier.
__device__ ppar::ColBest block_first(ppar::ColBest b, ppar::ColBest* slots,
                                     int parity) {
  constexpr int WARPS = T2_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    ppar::ColBest o;
    o.dist = __shfl_down_sync(FULL_MASK, b.dist, off);
    o.key = __shfl_down_sync(FULL_MASK, b.key, off);
    if (ppar::col_before(o, b)) b = o;
  }
  ppar::ColBest* mine = slots + parity * WARPS;
  if (lane == 0) mine[warp] = b;
  __syncthreads();
  ppar::ColBest best = mine[0];
  for (int i = 1; i < WARPS; ++i)
    if (ppar::col_before(mine[i], best)) best = mine[i];
  return best;
}

__global__ void __launch_bounds__(T2_THREADS) wasserstein_match_kernel(
    const float* __restrict__ grids, int hw, const int32_t* __restrict__ p_b,
    const int32_t* __restrict__ p_d, const int32_t* __restrict__ p_count,
    const float* __restrict__ true_bars, const int32_t* __restrict__ t_count,
    int t_max, float q, int k, int8_t* __restrict__ matched,
    float* __restrict__ target, float* __restrict__ const_term) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ppar::ColBest s_first[2 * (T2_THREADS / 32)];
  const int64_t g = blockIdx.x;
  const int64_t row = g * k;
  const int tid = threadIdx.x;
  const int nb = min(p_count[g], k);
  const int nt = min(t_count[g], t_max);
  const float* tb = true_bars + 2 * g * t_max;
  const pcore::MatchScratch s = pcore::carve_match_scratch(smem, nb, nt);
  ppar::match_setup(grids + g * hw, p_b + row, p_d + row, nb, tb, nt, q, s,
                    tid, T2_THREADS);
  if (nt > 0) {  // else nothing is matched and the constant is 0
    const bool rows_true = nt <= nb;
    const int ns = rows_true ? nt : nb;
    const int nc = nb + nt;
    const pcore::ReducedCost cost{&s, tb, nb, nt, q, rows_true};
    ppar::assign_init(ns, nc, s, tid, T2_THREADS);
    __syncthreads();
    int parity = 0;
    for (int cur = 0; cur < ns; ++cur) {
      ppar::SearchState st = ppar::search_init(cur, ns, nc, s, tid,
                                               T2_THREADS);
      while (st.sink == -1) {
        const ppar::ColBest first = block_first(
            ppar::relax_columns(cost, st, nc, s, tid, T2_THREADS), s_first,
            parity);
        parity ^= 1;
        if (first.key < 0) break;  // no finite column: never for this matrix
        ppar::take_column(first, st, s, tid, T2_THREADS);
      }
      if (st.sink == -1) break;
      ppar::dual_update(cur, st.min_val, ns, nc, s, tid, T2_THREADS);
      __syncthreads();
      if (tid == 0) ppar::augment(cur, st.sink, s);
      __syncthreads();
    }
  }
  ppar::match_write(tb, nb, nt, k, nt > 0, s, matched + row, target + 2 * row,
                    tid, T2_THREADS);
  if (tid == 0) const_term[g] = ppar::match_const_term(nb, nt, s);
}

}  // namespace

extern "C" {

// T1's route for one (h, w) grid of the feat_d pass: 0 into *stride when the
// grid takes the shared-memory route (its layout fits beside the kernel's
// static arrays), else the bytes of its slice of the global scratch (a
// multiple of 256). Returns 0 or a CUDA error.
int dhoct_t1_scratch_bytes(int h, int w, int feat_d, int64_t* stride) {
  const int n = h * w;
  if (h < 1 || w < 1 || n > MAX_CELLS || (feat_d != 0 && feat_d != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool h1 = feat_d == 1;
  *stride = 0;
  if (ppar::slot_is_narrow(n)) {
    cudaFuncAttributes attr;
    const cudaError_t e =
        cudaFuncGetAttributes(&attr, cubical_pairs_kernel<true, int16_t>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (t1_layout<int16_t>(n, h1).total + attr.sharedSizeBytes <=
        static_cast<size_t>(MAX_SMEM))
      return 0;
  }
  const size_t bytes = ppar::slot_is_narrow(n)
                           ? t1_layout<int16_t>(n, h1).total
                           : t1_layout<int32_t>(n, h1).total;
  *stride = static_cast<int64_t>((bytes + 255) / 256 * 256);
  return 0;
}

// T1 over n_grids (h, w) f32 grids of up to MAX_CELLS cells: the feat_d pass
// (0: H0, 1: H1) -> birth / death (n_grids, max_bars) int32 flat pixel
// indices (-1 padding) and count (n_grids,) int32. stride: what
// dhoct_t1_scratch_bytes gave for the grids, which picks the route; on the
// global route scratch holds n_grids slices of it, else it is unused.
int dhoct_cubical_pairs(const float* grids, int n_grids, int h, int w,
                        int feat_d, int max_bars, int32_t* birth,
                        int32_t* death, int32_t* count, void* scratch,
                        int64_t stride, void* stream) {
  const int n = h * w;
  if (h < 1 || w < 1 || n > MAX_CELLS || (feat_d != 0 && feat_d != 1) ||
      n_grids < 1 || max_bars < 1 || stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool h1 = feat_d == 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!stride) {
    if (!ppar::slot_is_narrow(n))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = t1_layout<int16_t>(n, h1).total;
    const int err = opt_in_smem(cubical_pairs_kernel<true, int16_t>, smem);
    if (err) return err;
    cubical_pairs_kernel<true, int16_t><<<n_grids, T1_THREADS, smem, st>>>(
        grids, h, w, feat_d, max_bars, birth, death, count, nullptr, 0);
  } else {
    const bool narrow = ppar::slot_is_narrow(n);
    const size_t bytes = narrow ? t1_layout<int16_t>(n, h1).total
                                : t1_layout<int32_t>(n, h1).total;
    if (!scratch || static_cast<size_t>(stride) < bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    auto* buf = static_cast<unsigned char*>(scratch);
    if (narrow)
      cubical_pairs_kernel<false, int16_t><<<n_grids, T1_THREADS, 0, st>>>(
          grids, h, w, feat_d, max_bars, birth, death, count, buf, stride);
    else
      cubical_pairs_kernel<false, int32_t><<<n_grids, T1_THREADS, 0, st>>>(
          grids, h, w, feat_d, max_bars, birth, death, count, buf, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// T2 over n_rows rows: grids (n_rows, hw) f32, p_birth / p_death (n_rows, k)
// int32, p_count (n_rows,), true_bars (n_rows, t_max, 2) f32, t_count
// (n_rows,) -> matched (n_rows, k) int8, target (n_rows, k, 2) f32,
// const_term (n_rows,) f32.
int dhoct_wasserstein_match(const float* grids, int n_rows, int hw,
                            const int32_t* p_birth, const int32_t* p_death,
                            const int32_t* p_count, const float* true_bars,
                            const int32_t* t_count, int t_max, float q, int k,
                            int8_t* matched, float* target, float* const_term,
                            void* stream) {
  if (n_rows < 1 || k < 1 || t_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pcore::match_scratch_bytes(k, t_max);
  const int err = opt_in_smem(wasserstein_match_kernel, smem);
  if (err) return err;
  wasserstein_match_kernel<<<n_rows, T2_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      grids, hw, p_birth, p_death, p_count, true_bars, t_count, t_max, q, k,
      matched, target, const_term);
  return static_cast<int>(cudaGetLastError());
}

const char* dhoct_topology_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
