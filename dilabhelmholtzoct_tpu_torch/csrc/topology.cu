// The combinatorial half of the topological loss on the card: cubical
// persistence pairing (T1) and the reduced Wasserstein matching (T2).
//
// Neither replaces a Pallas kernel. They replace the JAX package's XLA
// programs in dilabhelmholtzoct_tpu/ops/topology_device.py:
//   * T1 cubical_pairs_kernel: device_cubical_pairs (:305) and its
//     _pairing_pass (:104). The JAX module restructures the union-find for a
//     vector machine (Jacobi basin propagation, sorted edge dedup,
//     lane-lockstep Kruskal); here each block runs the sequential union-find
//     of persistence_core.h on one grid, which the host library
//     (persistence_host.cc) runs too, so the bars are the host's, in the
//     host's order.
//   * T2 wasserstein_match_kernel: device_wasserstein_match (:333), the
//     lane-lockstep Jonker-Volgenant; here one block per row runs the core's
//     match_row (f64 duals), the host library's matching.
//
// T1, one block of 256 threads per grid, everything in shared memory
// (~98 KB for a 50x50 grid; opted in above 48 KB):
//   1. the pass's values (the grid for H0, its negation for H1) and one
//      sort code per pixel, (key << 32) | index (persistence_core.h);
//   2. a bitonic sort of the codes over the block: the unique codes give the
//      one order "by value, ties by index" that the host's radix sort gives;
//   3. order and rank, and the union-find arrays set to -1, by all threads;
//   4. thread 0 runs pcore::sublevel_pairs (H0: 8-connected; H1:
//      4-connected with the outside node);
//   5. the capped emit by all threads: the bars in emission order when they
//      fit, else each bar's rank under pcore::kept_before (O(bars) per
//      bar), the first max_bars scattered to their rank. H1 bars swapped.
// T2, one block of 32 threads per row: the threads zero the row's outputs,
//   thread 0 runs pcore::match_row with its scratch in shared memory
//   (pcore::match_scratch_bytes: ~40 KB at 512 bars a side).
//
// What bounds them: neither is bound by bytes (a 50x50 grid is 10 KB) or by
// operations; both are bound by the latency of one thread walking the
// union-find (~2500 pixels x up to 8 neighbours, each a few dependent
// shared-memory loads) or the augmenting paths. The design keeps every
// array of that walk in shared memory and runs all grids of a step (pred
// and true, 2N blocks) in one launch, one block per SM. A simple kernel
// that is right first; its speed is for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistence_core.h"

namespace {

constexpr int T1_THREADS = 256;
constexpr int T2_THREADS = 32;
constexpr int MAX_SMEM = 232448;  // what one block may opt in to on sm_90
// returned for operands whose shared memory exceeds MAX_SMEM (the wrappers
// raise NotImplementedError for it)
constexpr int ERR_SMEM = 1000;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Byte offsets of T1's arrays in dynamic shared memory for an n-cell grid.
struct T1Layout {
  size_t keys, order, val, rank, parent, birth, bar_b, bar_d, pers, total;
};

__host__ __device__ inline T1Layout t1_layout(int n) {
  const size_t cap = pcore::bar_capacity(n);
  T1Layout L;
  size_t off = 0;
  L.keys = off;
  off += sizeof(uint64_t) * pow2_at_least(n);
  L.order = off;
  off += sizeof(int32_t) * n;
  L.val = off;
  off += sizeof(float) * n;
  L.rank = off;
  off += sizeof(int32_t) * n;
  L.parent = off;
  off += sizeof(int32_t) * (n + 1);
  L.birth = off;
  off += sizeof(int32_t) * (n + 1);
  L.bar_b = off;
  off += sizeof(int32_t) * cap;
  L.bar_d = off;
  off += sizeof(int32_t) * cap;
  L.pers = off;
  off += sizeof(float) * cap;
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(T1_THREADS)
    cubical_pairs_kernel(const float* __restrict__ grids, int h, int w,
                         int feat_d, int max_bars, int32_t* __restrict__ out_b,
                         int32_t* __restrict__ out_d,
                         int32_t* __restrict__ out_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nbars;
  const int n = h * w;
  const int p2 = pow2_at_least(n);
  const int cap = pcore::bar_capacity(n);
  const T1Layout L = t1_layout(n);
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + L.keys);
  int32_t* order = reinterpret_cast<int32_t*>(smem + L.order);
  float* val = reinterpret_cast<float*>(smem + L.val);
  int32_t* rank = reinterpret_cast<int32_t*>(smem + L.rank);
  int32_t* parent = reinterpret_cast<int32_t*>(smem + L.parent);
  int32_t* birth = reinterpret_cast<int32_t*>(smem + L.birth);
  int32_t* bar_b = reinterpret_cast<int32_t*>(smem + L.bar_b);
  int32_t* bar_d = reinterpret_cast<int32_t*>(smem + L.bar_d);
  float* pers = reinterpret_cast<float*>(smem + L.pers);
  const bool h1 = feat_d == 1;
  const float* grid = grids + static_cast<int64_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;

  for (int i = tid; i < p2; i += T1_THREADS) {
    if (i < n) {
      const float v = h1 ? -grid[i] : grid[i];
      val[i] = v;
      keys[i] = pcore::sort_code(v, i);
    } else {
      keys[i] = ~0ull;  // after every pixel
    }
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += T1_THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i <= n; i += T1_THREADS) {
    if (i < n) {
      const int32_t p = static_cast<int32_t>(keys[i] & 0xFFFFFFFFu);
      order[i] = p;
      rank[p] = i;
    }
    parent[i] = -1;
    birth[i] = -1;
  }
  __syncthreads();
  if (tid == 0)
    s_nbars = pcore::sublevel_pairs(val, h, w, /*eight=*/!h1, /*outside=*/h1,
                                    order, rank, parent, birth, bar_b, bar_d,
                                    cap, nullptr);
  __syncthreads();
  const int nbars = s_nbars;
  int32_t* ob = out_b + static_cast<int64_t>(blockIdx.x) * max_bars;
  int32_t* od = out_d + static_cast<int64_t>(blockIdx.x) * max_bars;
  if (nbars <= max_bars) {
    for (int i = tid; i < max_bars; i += T1_THREADS) {
      const int32_t b = i < nbars ? bar_b[i] : -1;
      const int32_t d = i < nbars ? bar_d[i] : -1;
      ob[i] = h1 ? d : b;
      od[i] = h1 ? b : d;
    }
  } else {  // the cap: the max_bars first under kept_before, in that order
    for (int i = tid; i < nbars; i += T1_THREADS)
      pers[i] = pcore::persistence(val, bar_b[i], bar_d[i]);
    __syncthreads();
    for (int i = tid; i < nbars; i += T1_THREADS) {
      const float pi = pers[i];
      int r = 0;
      for (int j = 0; j < nbars && r < max_bars; ++j)
        r += pcore::kept_before(pers[j], j, pi, i);
      if (r < max_bars) {
        ob[r] = h1 ? bar_d[i] : bar_b[i];
        od[r] = h1 ? bar_b[i] : bar_d[i];
      }
    }
  }
  if (tid == 0) out_c[blockIdx.x] = nbars < max_bars ? nbars : max_bars;
}

__global__ void __launch_bounds__(T2_THREADS) wasserstein_match_kernel(
    const float* __restrict__ grids, int hw, const int32_t* __restrict__ p_b,
    const int32_t* __restrict__ p_d, const int32_t* __restrict__ p_count,
    const float* __restrict__ true_bars, const int32_t* __restrict__ t_count,
    int t_max, float q, int k, int8_t* __restrict__ matched,
    float* __restrict__ target, float* __restrict__ const_term) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t g = blockIdx.x;
  const int64_t row = g * k;
  for (int j = threadIdx.x; j < k; j += T2_THREADS) {
    matched[row + j] = 0;
    target[2 * (row + j)] = 0.0f;
    target[2 * (row + j) + 1] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int nb = min(p_count[g], k);
  const int nt = min(t_count[g], t_max);
  float c = 0.0f;
  pcore::match_row(grids + g * hw, p_b + row, p_d + row, nb,
                   true_bars + 2 * g * t_max, nt, q, matched + row,
                   target + 2 * row, &c, pcore::carve_match_scratch(smem, nb, nt));
  const_term[g] = c;
}

}  // namespace

extern "C" {

// T1 over n_grids (h, w) f32 grids: the feat_d pass (0: H0, 1: H1) ->
// birth / death (n_grids, max_bars) int32 flat pixel indices (-1 padding)
// and count (n_grids,) int32.
int dhoct_cubical_pairs(const float* grids, int n_grids, int h, int w,
                        int feat_d, int max_bars, int32_t* birth,
                        int32_t* death, int32_t* count, void* stream) {
  if (n_grids < 1 || h < 1 || w < 1 || max_bars < 1 ||
      (feat_d != 0 && feat_d != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = t1_layout(h * w).total;
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      cubical_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cubical_pairs_kernel<<<n_grids, T1_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      grids, h, w, feat_d, max_bars, birth, death, count);
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
  if (smem > MAX_SMEM) return ERR_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      wasserstein_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
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
