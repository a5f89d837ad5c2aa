// K6 in bf16 on Hopper's wgmma and TMA: SAM encoder self-attention with
// decomposed relative-position bias for any head dim, read straight from
// the fused qkv projection (the f32 K6, and the f32 K1, are
// attention_relpos_wgmma_tf32.cu: the same design in split TF32). It serves
// the bf16 encoder of every model whose head dim is not 64: ViT-H's 16
// heads of 80, in the precompute of its decoder fine-tuning (32 launches an
// image: 4 global layers, N = 4096, and 28 windowed, 25 windows of 196).
// It is also the bf16 K1: the global layers (N > 256) of ViT-B and ViT-L
// (12 / 16 heads of 64) in their precompute, full fine-tune and uncached
// training steps, where it writes the rows' logsumexp for K5 as well
// (`lse`, a null pointer for K6). At head dim 64 the two TPU kernels'
// functions are the same bits in bf16: K1's q / 8 before the product and
// K6's score / 8 after it are one exact power-of-two scale, and both round
// the un-normalised p and divide last. And it is the bf16 K2: the windowed
// layers (N <= 256) of ViT-B and ViT-L, with the LSE rows, at the rounding
// point of the JAX route (ops/attention.py: normalised_rounding): on
// SAM's windows (B * 25 of them) and wherever the TPU took its grouped
// window kernel, the NORM instances round the normalised p / l before
// p . v and round the output as it comes (out[q] = sum_k rnd(p / l) v[k]);
// on the other windowed shapes K6's rounding, as the TPU's _packed_kernel.
//
//   qkv   (B, N, 3C) bf16  feature order (3, heads, d); where d is no
//                          multiple of 16, each head padded to DP columns
//                          by the wrapper (B, N, 3 heads DP)
//   rel_h (B, heads, N, H), rel_w (B, heads, N, W)   bias factors
//   out   (B, N, C)
//
//   s[q, k] = f32(q . k) * d^-1/2 + rel_h[q, k / W] + rel_w[q, k % W]
//   out[q]  = (sum_k rnd(exp(s[q, k] - m)) v[k]) / sum_k exp(s[q, k] - m)
//
// It replaces dilabhelmholtzoct_tpu/ops/attention.py flash_attention_relpos
// (_flash_kernel, pallas_call at :132) and, as K1, flash_attention_packed's
// global branch (_packed_kernel, pallas_call at :819) in bf16, as K2 its
// windowed branch (_windowed_group_kernel, pallas_call at :770), with their
// rounding points (relpos_attention_plain, packed_attention_plain): the
// scale multiplies the f32
// score after the product, the bias is added in f32, the un-normalised p is
// rounded to bf16 for the p.v product while the denominator sums the f32
// p, and the division comes last with one rounding of the output.
//
// Bound on an H100 SXM (700 W), ViT-H, B = 1: the global layer 85.9 GFLOP
// over 989 TFLOP/s = 0.087 ms against 0.018 ms of bytes (operation-bound);
// the windowed layer (25 x 196) 4.9 GFLOP = 0.005 ms against 55 MB of
// qkv, bias and output = 0.016 ms (byte-bound); as K1, ViT-B's global
// layer (12 heads of 64, B = 1) 51.5 GFLOP = 0.052 ms against 0.011 ms of
// bytes (operation-bound); as K2, ViT-B's windowed layer (25 x 196, B = 1)
// 33.5 MB = 0.010 ms against 2.9 GFLOP (byte-bound). What this design does
// about it: both products on wgmma (the only way to the tensor cores' full
// rate), their operands landed by TMA with no thread spending registers or
// instructions on the copies, a producer warp keeping the next unit's Q and
// bias rows and the next key tiles in flight while two warpgroups compute,
// persistent blocks so that one unit's tail overlaps the next one's loads.
// A 14 x 14 window at d = 80 is one tile of 224 key slots (the mma.sync
// kernel before it took four 64-key tiles, each with its own rescale, and
// a second block re-reading K and V for the window's last 68 rows of 128;
// here a unit of 128 rows reads K and V once), and its bias comes from
// registers but for one rel_h value per grid row. What stays on the CUDA cores per
// score: the scale and the bias, the exponential, the max and the sum. As
// K2 (d = 64) a 196-token window takes two units of 128 query rows, the
// second with 68 live ones, each over one 224-slot tile: 256 x 224 =
// 57344 score slots paid for 196 x 196 = 38416 (1.49x), and K and V read
// twice.
//

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;
using mma::bf16;

constexpr int MAX_D = 128;  // head dim: a multiple of 4 up to this

// attn_relpos_wgmma_kernel<DP, NK, MODE, NORM>: warp-specialised,
// persistent. A
// unit is 128 query rows of one (batch, head); a block walks units
// blockIdx.x, + gridDim.x, ... with a producer warp and two consumer
// warpgroups of 64 rows each.
//   producer: per unit, Q (128 rows by TMA, rows past N zero) and the
//     rows' bias factors (cp.async, 16-byte pieces of the contiguous
//     (N, H) / (N, W) block) into a ring of u_stages unit stages; per key
//     tile of NK key slots, K and V (TMA) into a ring of kv_stages stages.
//     Each stage has a full and an empty mbarrier. A head's DP columns come
//     in slabs: 64-column ones in the 128-byte swizzle (one 128-byte read a
//     row), then a 32- and a 16-column one where DP % 64 asks for them
//     (ViT-H, d = 80: 64 + 16).
//   consumer warpgroup: S = q . k^T over the tile as one wgmma m64nNKk16
//     chain over the DP / 16 k-steps of the slabs (both operands in shared
//     memory); on the accumulators s = fma(S, d^-1/2, rel_h + rel_w), empty
//     key slots at -inf; the online softmax; p = exp(s - m) rounded to bf16
//     in registers, the A operand of o += p . v (per 16 key slots a wgmma
//     m64nWk16 for each slab of W columns, v the MN-major B through the
//     transpose bit); the denominator sums the f32 p; the division and one
//     rounding at the end. A tile's S and the previous tile's p . v are
//     issued together, and the two warpgroups take turns issuing (named
//     barriers), so that the exponentials of one run beside the products.
// How a tile's key slots map to keys, and their bias, by MODE:
//   GRID (the windowed layers: H <= 14, W <= 16; NK = 224 up to DP = 80):
//     the whole window in one tile, one max over all keys as the TPU
//     kernel's tk = N (past DP = 80, tiles of 7 grid rows: NK = 112). K
//     and V come through a 4-D view (cols, W, H, B) in boxes of 16 x 14 (or
//     7) grid cells, so slot 16 kr + kc holds key (kr, kc) and the slots
//     past W (and past H) are zero rows, masked. Column 8 j + 2 t + e of a
//     lane is grid row j / 2, grid column 8 (j % 2) + 2 t + e: the lane
//     holds its four rel_w values a row in registers for the unit (bf16,
//     -inf past W), and reads one rel_h value per row and grid row.
//   ROW_TILE (W = 64, an even H: the global layers; NK = 128): a tile is
//     two grid rows: two rel_h values a row, the lane's rel_w columns in
//     registers for the unit.
//   GENERIC (NK = 64): slot k0 + c is key k0 + c; each column finds its
//     grid (row, col) by a multiply-high and looks both factors up.
// A head dim that is no multiple of 16 comes in rows whose heads the
// wrapper padded to DP columns with zeros (hs = DP): a slab never reaches
// the next head's columns, and the zero columns add nothing to q . k.
// NORM (K2's rounding point; DP = 64 alone): p / l = exp(s - m) * (1 / l)
// is formed in f32 from the row's final m and l and rounded once into the
// A fragments; o is rounded with no division at the end, L = m + log(l).
// A unit of one tile (GRID's whole window) knows m and l once its scores
// are in. A unit of several tiles (ragged grids) makes two passes
// (`passes`, from the plan): the first issues S alone over its key tiles
// (the producer brings their K, not V) for the rows' m and l; the second
// is the loop below with m fixed, no rescale, and p / l for p . v. No
// online variant: p / l is exact to the rounding, as the TPU's one block.
namespace wg {

constexpr int QROWS = 128;            // query rows of a unit
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int NTH = CONSUMERS + 128;  // and the producer's warpgroup
// registers a thread: 168 at launch (64K over 384 threads, in steps of 8);
// the producer's warpgroup gives back all but 24, the consumers take them
// (240 each: 128 x 24 + 256 x 240 = 384 x 168)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_KV_STAGES = 4, MAX_U_STAGES = 2;
constexpr int TURN = 1;  // named barriers 1, 2: the warpgroups' turns
// elements of slack a unit's bias block takes (its copy starts and ends on
// 16-byte boundaries around the block)
constexpr int REL_PAD = 16;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// the column slabs of DP = 16 k columns: DP / 64 of 64, then one of 32 and
// one of 16 where DP % 64 holds them
__host__ __device__ constexpr int slab_count(int dp) {
  return dp / 64 + (dp & 32 ? 1 : 0) + (dp & 16 ? 1 : 0);
}
__host__ __device__ constexpr int slab_width(int dp, int i) {
  return i < dp / 64 ? 64 : (i == dp / 64 && (dp & 32)) ? 32 : 16;
}
__host__ __device__ constexpr int slab_col(int dp, int i) {
  int c = 0;
  for (int j = 0; j < i; ++j) c += slab_width(dp, j);
  return c;
}
// bytes of slab i of `rows` rows (a multiple of 1024, so every slab base is
// aligned for its swizzle) and its offset in a tile of slabs
__host__ __device__ constexpr int slab_bytes(int dp, int i, int rows) {
  return round_up(rows * slab_width(dp, i) * 2, 1024);
}
__host__ __device__ constexpr int slab_offset(int dp, int i, int rows) {
  int b = 0;
  for (int j = 0; j < i; ++j) b += slab_bytes(dp, j, rows);
  return b;
}

// The shared memory of a launch, from a 1024-aligned base: the unit
// stages' Q slabs (q_bytes each), the K / V stages (kv_bytes; K then V),
// the unit stages' bias rows (rel_bytes: rel_h rows, then rel_w rows at
// rel_w), the mbarriers; SMEM_FIXED + u_stages * (q_bytes + rel_bytes) +
// kv_stages * kv_bytes in all (ops/attention.py: relpos_plan)
constexpr int SMEM_FIXED = 1024 + 128;  // alignment slack, mbarriers
struct Layout {
  int q_bytes, rel_w, rel_bytes, k_bytes, kv_bytes;
  __host__ __device__ Layout(int dp, int nk, int h, int w)
      : q_bytes(slab_offset(dp, slab_count(dp), QROWS)),
        rel_w(round_up(2 * (QROWS * h + REL_PAD), 16)),
        rel_bytes(rel_w + round_up(2 * (QROWS * w + REL_PAD), 16)),
        k_bytes(slab_offset(dp, slab_count(dp), nk)),
        kv_bytes(2 * k_bytes) {}
  __host__ __device__ size_t smem(int u_stages, int kv_stages) const {
    return SMEM_FIXED + (size_t)u_stages * (q_bytes + rel_bytes) +
           (size_t)kv_stages * kv_bytes;
  }
};

// tensor maps of qkv (ld, N, B) for Q (128-row boxes) and K / V (NK rows;
// GRID: the 4-D view (ld, W, H, B), boxes of 16 x 14 cells), one per slab
// width: 64, 32, 16 columns
struct Maps {
  CUtensorMap q[3], kv[3];
};

__host__ __device__ constexpr int width_class(int w) {
  return w == 64 ? 0 : w == 32 ? 1 : 2;
}

enum Mode { GENERIC, ROW_TILE, GRID };
// GRID: grid rows of 16 key slots, a window of at most 14 rows; a tile is
// all 14 rows (224 slots) up to DP = 80, else 7 (the accumulators of a
// whole window and of a wider head would not fit in the registers)
constexpr int GRID_W = 16, GRID_H = 14;
__host__ __device__ constexpr int grid_nk(int dp) {
  return GRID_W * (dp <= 80 ? GRID_H : GRID_H / 2);
}

struct Args {
  const bf16* rel_h;
  const bf16* rel_w;
  bf16* out;
  float* lse;  // null, or (B, heads, N): the rows' logsumexp m + log(l)
  long long rel_h_len, rel_w_len;  // elements of rel_h, rel_w
  int n, heads, d, hs, H, W, qblocks, units, ntiles, kv_stages, u_stages;
  int passes;  // NORM: 2 where a unit has several key tiles, else 1
  unsigned w_magic;  // floor(2^32 / W) + 1: key / W = umulhi(key, w_magic)
  float scale;
};

// elements [e0, e0 + cnt) of src (len elements) -> dst, element e0 at
// dst[e0 % 8]: cp.async 16-byte pieces from e0 rounded down to 8, zero past
// len; by the 32 lanes of a warp
__device__ __forceinline__ void copy_block(unsigned char* dst, const bf16* src,
                                           long long e0, int cnt,
                                           long long len, int lane) {
  const long long a0 = e0 & ~7LL;
  const int pieces = (int)((e0 + cnt - a0 + 7) >> 3);
  for (int i = lane; i < pieces; i += 32) {
    const long long e = a0 + 8LL * i;
    const int bytes = e >= len ? 0 : (int)min(16LL, 2 * (len - e));
    hop::cp_async16_fill(dst + 16 * i, src + (bytes ? e : 0), bytes);
  }
}

// s = q . k^T over the k-steps of slabs I.. (q: the unit's Q slabs, of
// which the warpgroup's 64 rows; k: the tile's K slabs)
template <int DP, int NK, int I>
__device__ __forceinline__ void qk_slabs(float* s, const unsigned char* q,
                                         const unsigned char* k, int wgi) {
  if constexpr (I < slab_count(DP)) {
    constexpr int W = slab_width(DP, I), R = 2 * W;  // row bytes
    constexpr uint32_t LAY = hop::swizzle_layout(R);
    const unsigned char* qs = q + slab_offset(DP, I, QROWS) + wgi * 64 * R;
    const unsigned char* ks = k + slab_offset(DP, I, NK);
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      hop::mma_bf16_ss<NK>(s, hop::desc(qs + 32 * kk, 16, 8 * R, LAY),
                           hop::desc(ks + 32 * kk, 16, 8 * R, LAY),
                           I > 0 || kk > 0);
    qk_slabs<DP, NK, I + 1>(s, q, k, wgi);
  }
}

// o (columns of slabs I..) = (acc ? o : 0) + p . v over the tile's NK / 16
// k16 steps
template <int DP, int NK, int I>
__device__ __forceinline__ void pv_slabs(float* o, const uint32_t (*p)[4],
                                         const unsigned char* v, int acc) {
  if constexpr (I < slab_count(DP)) {
    constexpr int W = slab_width(DP, I), R = 2 * W;
    constexpr uint32_t LAY = hop::swizzle_layout(R);
    const unsigned char* vs = v + slab_offset(DP, I, NK);
#pragma unroll
    for (int k = 0; k < NK / 16; ++k)
      hop::mma_bf16_rs_mn<W>(o + slab_col(DP, I) / 2, p[k],
                             hop::desc(vs + 16 * R * k, 16, 8 * R, LAY),
                             acc || k > 0);
    pv_slabs<DP, NK, I + 1>(o, p, v, acc);
  }
}

template <int DP, int NK, Mode MODE, bool NORM>
__global__ void __launch_bounds__(NTH, 1)
attn_relpos_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using namespace hop;
  using mma::exp2_approx;
  using mma::LOG2E;
  using mma::pack_bf16;
  using mma::quad_max;
  using mma::quad_sum;
  constexpr int NS = slab_count(DP), KSTEPS = NK / 16;
  static_assert(NK % 16 == 0 && (MODE != GRID || NK % GRID_W == 0),
                "key tile");
  const Layout L(DP, NK, a.H, a.W);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~uintptr_t(1023));
  unsigned char* qbase = base;
  unsigned char* kvbase = qbase + a.u_stages * L.q_bytes;
  unsigned char* relbase = kvbase + a.kv_stages * L.kv_bytes;
  uint64_t* ufull =
      reinterpret_cast<uint64_t*>(relbase + a.u_stages * L.rel_bytes);
  uint64_t* uempty = ufull + MAX_U_STAGES;
  uint64_t* kvfull = uempty + MAX_U_STAGES;
  uint64_t* kvempty = kvfull + MAX_KV_STAGES;
  const int C = a.heads * a.hs;  // columns of q (of k, of v) in a row
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.u_stages; ++i) {
      mbar_init(ufull + i, 33);  // the TMA lane's arrive + 32 cp.async ones
      mbar_init(uempty + i, CONSUMERS);
    }
    for (int i = 0; i < a.kv_stages; ++i) {
      mbar_init(kvfull + i, 1);
      mbar_init(kvempty + i, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= CONSUMERS / 32) {  // ------------------------- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > CONSUMERS / 32) return;  // one warp loads
    int it = 0, uu = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
      const int qb = u % a.qblocks, bh = u / a.qblocks;
      const int head = bh % a.heads, b = bh / a.heads, q0 = qb * QROWS;
      const int us = uu % a.u_stages;
      unsigned char* ust = qbase + us * L.q_bytes;
      unsigned char* rst = relbase + us * L.rel_bytes;
      mbar_wait(uempty + us, ((uu / a.u_stages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ufull + us, QROWS * DP * 2);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_3d(ust + slab_offset(DP, s, QROWS),
                      &maps.q[width_class(slab_width(DP, s))], ufull + us,
                      head * a.hs + slab_col(DP, s), q0, b);
      }
      const int nq = min(QROWS, a.n - q0);
      const long long row = (long long)bh * a.n + q0;
      copy_block(rst, a.rel_h, row * a.H, nq * a.H, a.rel_h_len, lane);
      copy_block(rst + L.rel_w, a.rel_w, row * a.W, nq * a.W, a.rel_w_len,
                 lane);
      mbar_arrive_cp_async(ufull + us);
      // NORM over several tiles: the first pass's tiles bring K alone
      const int issued = NORM ? a.passes * a.ntiles : a.ntiles;
      for (int i = 0; i < issued; ++i, ++it) {
        const bool k_only = NORM && i < issued - a.ntiles;
        const int tile = k_only || !NORM ? i : i - (issued - a.ntiles);
        const int ks = it % a.kv_stages;
        unsigned char* kst = kvbase + ks * L.kv_bytes;
        mbar_wait(kvempty + ks, ((it / a.kv_stages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(kvfull + ks, (k_only ? 1 : 2) * NK * DP * 2);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const CUtensorMap* m = &maps.kv[width_class(slab_width(DP, s))];
            const int col = head * a.hs + slab_col(DP, s);
            unsigned char* kd = kst + slab_offset(DP, s, NK);
            if constexpr (MODE == GRID) {
              const int kr0 = tile * (NK / GRID_W);
              tma_load_4d(kd, m, kvfull + ks, C + col, 0, kr0, b);
              if (!k_only)
                tma_load_4d(kd + L.k_bytes, m, kvfull + ks, 2 * C + col, 0,
                            kr0, b);
            } else {
              tma_load_3d(kd, m, kvfull + ks, C + col, tile * NK, b);
              if (!k_only)
                tma_load_3d(kd + L.k_bytes, m, kvfull + ks, 2 * C + col,
                            tile * NK, b);
            }
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = warp >> 2;  // warpgroup: rows 64 wgi.. of the unit
  const int g = lane >> 2, t = lane & 3;
  // the two warpgroups take turns issuing their products: barrier TURN +
  // wgi is this warpgroup's turn, the other arrives on it after each of
  // its issues, so one warpgroup's softmax runs beside the other's wgmma
  // (warpgroup 0 goes first)
  if (wgi == 1) named_arrive(TURN, CONSUMERS);
  const int r0 = 64 * wgi + 16 * (warp & 3) + g;  // the lane's rows r0, r0 + 8
  int it = 0, uu = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
    const int qb = u % a.qblocks, bh = u / a.qblocks;
    const int head = bh % a.heads, b = bh / a.heads, q0 = qb * QROWS;
    const int us = uu % a.u_stages;
    const unsigned char* ust = qbase + us * L.q_bytes;
    const unsigned char* rst = relbase + us * L.rel_bytes;
    const long long row = (long long)bh * a.n + q0;
    const bf16* Rh = reinterpret_cast<const bf16*>(rst) + ((row * a.H) & 7);
    const bf16* Rw =
        reinterpret_cast<const bf16*>(rst + L.rel_w) + ((row * a.W) & 7);
    mbar_wait(ufull + us, (uu / a.u_stages) & 1);
    // the lane's rel_w values for the unit as bf16 pairs (low half first):
    // ROW_TILE its columns 8 j + 2 t, + 1 of a grid row, GRID its grid
    // columns 8 h + 2 t, + 1, -inf past W (the slot is empty)
    uint32_t rw2[2][MODE == ROW_TILE ? 8 : MODE == GRID ? 2 : 1];
    if constexpr (MODE == ROW_TILE) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rw2[r][j] = *reinterpret_cast<const uint32_t*>(
              Rw + (r0 + 8 * r) * a.W + 8 * j + 2 * t);
    } else if constexpr (MODE == GRID) {
      const unsigned short* rw_bits =
          reinterpret_cast<const unsigned short*>(Rw);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * h + 2 * t + e;
            const uint32_t bits =
                kc < a.W ? rw_bits[(r0 + 8 * r) * a.W + kc] : 0xff80u;
            w |= bits << (16 * e);
          }
          rw2[r][h] = w;
        }
    }
    // the f32 value of half e of a bf16 pair
    auto half = [](uint32_t w, int e) {
      return __uint_as_float(e ? w & 0xffff0000u : w << 16);
    };
    // o is first written by the first tile's p . v (no accumulator to
    // hold, or rescale, before it)
    float o[DP / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t p[KSTEPS][4];  // the previous tile's p: the A fragments of p . v

    // s = S * d^-1/2 + bias of the tile
    auto add_bias = [&](float* s, int tile) {
      if constexpr (MODE == ROW_TILE) {  // grid rows 2 tile, 2 tile + 1
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16* rh_row = Rh + (r0 + 8 * r) * a.H + 2 * tile;
          const float rh[2] = {__bfloat162float(rh_row[0]),
                               __bfloat162float(rh_row[1])};
#pragma unroll
          for (int j = 0; j < NK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * r + e];
              x = fmaf(x, a.scale, rh[j / 8] + half(rw2[r][j % 8], e));
            }
        }
      } else if constexpr (MODE == GRID) {  // grid rows GH tile..
        constexpr int GH = NK / GRID_W;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16* rh_row = Rh + (r0 + 8 * r) * a.H;
#pragma unroll
          for (int kr = 0; kr < GH; ++kr) {
            const int row_k = GH * tile + kr;  // -inf past H: empty slots
            const float rh = row_k < a.H
                                 ? __bfloat162float(rh_row[row_k])
                                 : -INFINITY;
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // column 8 (2 kr + i / 2) + ...
              float& x = s[4 * (2 * kr + (i >> 1)) + 2 * r + (i & 1)];
              x = fmaf(x, a.scale, rh + half(rw2[r][i >> 1], i & 1));
            }
          }
        }
      } else {
        const int k0 = tile * NK;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // key k0 + 8 j + 2 t + e at grid (kr, kc), clamped in bounds
            // past N (its score is discarded)
            const int key = k0 + 8 * j + 2 * t + e;
            const int kr = min((int)__umulhi(key, a.w_magic), a.H - 1);
            const int kc = min(key - kr * a.W, a.W - 1);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int q = r0 + 8 * r;
              const float bias = __bfloat162float(Rh[q * a.H + kr]) +
                                 __bfloat162float(Rw[q * a.W + kc]);
              float& x = s[4 * j + 2 * r + e];
              x = key < a.n ? fmaf(x, a.scale, bias) : -INFINITY;
            }
          }
      }
    };
    // add_bias, then p = exp(s - m) in place (in f32) against the row's new
    // running max m; alpha rescales what was summed before, rs sums this
    // tile's p
    auto bias_softmax = [&](float* s, int tile, float* alpha, float* rs) {
      add_bias(s, tile);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        // the tile's first slot is a real key: m_new is finite
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = exp2_approx((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        const float mb = m_new * LOG2E;
        rs[r] = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * r + e];
            x = exp2_approx(fmaf(x, LOG2E, -mb));
            rs[r] += x;  // the denominator sums the f32 p
          }
      }
    };
    // NORM's second pass: add_bias, then p / l = exp(s - m) * (1 / l) in
    // f32 against the row's final max m and sum l, from the first pass
    auto bias_exp_norm = [&](float* s, int tile, const float* rl) {
      add_bias(s, tile);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mb = m[r] * LOG2E;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * r + e];
            x = exp2_approx(fmaf(x, LOG2E, -mb)) * rl[r];
          }
      }
    };
    // o (past the first tile) and l rescaled by alpha, this tile's p
    // added to l
    auto rescale = [&](const float* alpha, const float* rs, bool first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + rs[r];  // the lane's share; quad sum last
        if (!first)
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            o[4 * j + 2 * r] *= alpha[r];
            o[4 * j + 2 * r + 1] *= alpha[r];
          }
      }
    };
    // the tile's p (or p / l) rounded once to bf16: the A fragments of
    // p . v
    auto pack = [&](const float* s) {
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          p[j >> 1][r + 2 * (j & 1)] =
              pack_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
    };
    // NORM over several tiles: a first pass of S alone over the unit's key
    // tiles (their K; the producer brings no V) finds each row's m and l,
    // so that the second pass rounds the normalised p before any p . v
    float rl[2] = {1.f, 1.f};
    if (NORM && a.passes == 2) {
      for (int tile = 0; tile < a.ntiles; ++tile, ++it) {
        const int ks1 = it % a.kv_stages;
        mbar_wait(kvfull + ks1, (it / a.kv_stages) & 1);
        float s[NK / 2], alpha[2], rs[2];
        named_sync(TURN + wgi, CONSUMERS);
        wgmma_fence();
        qk_slabs<DP, NK, 0>(s, ust, kvbase + ks1 * L.kv_bytes, wgi);
        wgmma_commit();
        named_arrive(TURN + (wgi ^ 1), CONSUMERS);
        wgmma_wait<0>();
        fence_operands(s);
        mbar_arrive(kvempty + ks1);  // its K is read
        bias_softmax(s, tile, alpha, rs);
        rescale(alpha, rs, true);  // l alone: o is not written yet
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) rl[r] = __frcp_rn(quad_sum(l[r]));
    }

    // the first tile: S alone
    int ks = it % a.kv_stages;
    unsigned char* kst = kvbase + ks * L.kv_bytes;
    {
      mbar_wait(kvfull + ks, (it / a.kv_stages) & 1);
      float s[NK / 2], alpha[2], rs[2];
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      qk_slabs<DP, NK, 0>(s, ust, kst, wgi);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<0>();
      if (NORM && a.passes == 2) {
        bias_exp_norm(s, 0, rl);
      } else {
        bias_softmax(s, 0, alpha, rs);
        rescale(alpha, rs, true);
        if constexpr (NORM) {  // one tile: the row's m and l are final
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rl[r] = __frcp_rn(quad_sum(l[r]));
#pragma unroll
            for (int j = 0; j < NK / 8; ++j) {
              s[4 * j + 2 * r] *= rl[r];
              s[4 * j + 2 * r + 1] *= rl[r];
            }
          }
        }
      }
      pack(s);
    }
    // each further tile: one turn issues its S and the previous tile's
    // p . v; its bias and softmax run while that p . v does. A GRID tile of
    // all 14 grid rows is the whole window: no further tile (and no
    // registers held for this loop's S beside the previous p and o)
    constexpr bool ONE_TILE = MODE == GRID && NK == GRID_W * GRID_H;
    for (int tile = 1; !ONE_TILE && tile < a.ntiles; ++tile) {
      const int ks_prev = ks;
      const unsigned char* v_prev = kst + L.k_bytes;
      ++it;
      ks = it % a.kv_stages;
      kst = kvbase + ks * L.kv_bytes;
      mbar_wait(kvfull + ks, (it / a.kv_stages) & 1);
      float s[NK / 2], alpha[2], rs[2];
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      qk_slabs<DP, NK, 0>(s, ust, kst, wgi);
      wgmma_commit();
      pv_slabs<DP, NK, 0>(o, p, v_prev, tile > 1);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<1>();  // S is in; the previous p . v may still run
      if constexpr (NORM)
        bias_exp_norm(s, tile, rl);
      else
        bias_softmax(s, tile, alpha, rs);
      wgmma_wait<0>();              // the previous p . v is done
      mbar_arrive(kvempty + ks_prev);  // its K / V stage is read
      if constexpr (!NORM) rescale(alpha, rs, false);
      pack(s);
    }
    // the last tile's p . v
    named_sync(TURN + wgi, CONSUMERS);
    wgmma_fence();
    pv_slabs<DP, NK, 0>(o, p, kst + L.k_bytes, a.ntiles > 1);
    wgmma_commit();
    named_arrive(TURN + (wgi ^ 1), CONSUMERS);
    wgmma_wait<0>();
    mbar_arrive(kvempty + ks);
    ++it;
    mbar_arrive(uempty + us);  // Q and the bias rows are read

    // out = o / l to the nearest f32 (o q ~ o / l, one correction on the
    // residual), rounded once to bf16; NORM's o, of the normalised p, is
    // rounded as it is
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]), q_l = __frcp_rn(lr);
      const int q = q0 + r0 + 8 * r;
      if (q >= a.n) continue;
      // the scaled scores' logsumexp in natural-log units (m is the max of
      // s itself), which K5 reads
      if (a.lse != nullptr && t == 0)
        a.lse[row + r0 + 8 * r] = m[r] + logf(lr);
      bf16* dst =
          a.out + ((size_t)b * a.n + q) * a.heads * a.d + head * a.d + 2 * t;
      auto div = [&](float x) {
        if constexpr (NORM) {
          return x;
        } else {
          const float y = x * q_l;
          return fmaf(fmaf(-lr, y, x), q_l, y);
        }
      };
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (8 * j + 2 * t < a.d)  // d is even: both columns or neither
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(div(o[4 * j + 2 * r]), div(o[4 * j + 2 * r + 1]));
    }
  }
  if (wgi == 0) named_sync(TURN, CONSUMERS);  // warpgroup 1's last arrive
}

}  // namespace wg

template <int DP, int NK, wg::Mode MODE, bool NORM>
int launch_inst(const wg::Maps& maps, const wg::Args& a, size_t smem,
                int blocks, cudaStream_t stream) {
  auto kernel = wg::attn_relpos_wgmma_kernel<DP, NK, MODE, NORM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, wg::NTH, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int DP, bool NORM>
int launch_mode(int nk, const wg::Maps& maps, const wg::Args& a, size_t smem,
                int blocks, cudaStream_t stream) {
  using wg::GENERIC, wg::ROW_TILE, wg::GRID;
  if (nk == wg::grid_nk(DP))
    return launch_inst<DP, wg::grid_nk(DP), GRID, NORM>(maps, a, smem,
                                                        blocks, stream);
  if (nk == 128)
    return launch_inst<DP, 128, ROW_TILE, NORM>(maps, a, smem, blocks,
                                                stream);
  return launch_inst<DP, 64, GENERIC, NORM>(maps, a, smem, blocks, stream);
}

// the NORM instances (K2's rounding point) exist at head dim 64 alone: the
// packed route's, the only one that rounds there
template <int DP>
int launch_dp(int nk, bool norm, const wg::Maps& maps, const wg::Args& a,
              size_t smem, int blocks, cudaStream_t stream) {
  if constexpr (DP == 64) {
    if (norm) return launch_mode<DP, true>(nk, maps, a, smem, blocks, stream);
  }
  if (norm) return (int)cudaErrorInvalidValue;
  return launch_mode<DP, false>(nk, maps, a, smem, blocks, stream);
}

int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out,
           float* lse, int batch, int n, int heads, int d, int h, int w,
           int hs, int nk, int kv_stages, int u_stages, int passes, int norm,
           int blocks, cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16, ld = 3 * heads * hs;
  // the key tile: GRID (224 or 112 slots) a window of at most 14 x 16,
  // 128 (ROW_TILE) two grid rows of 64, else 64
  const bool grid = nk == wg::grid_nk(dp) && h <= wg::GRID_H &&
                    w <= wg::GRID_W;
  const bool row_tile = nk == 128 && w == 64 && h % 2 == 0;
  const int ntiles = grid ? (h + nk / wg::GRID_W - 1) / (nk / wg::GRID_W)
                          : (n + nk - 1) / nk;
  if (d < 4 || d % 4 || d > MAX_D || n < 1 || n != h * w ||
      (hs != d && hs != dp) || ld % 8 || !(grid || row_tile || nk == 64) ||
      (norm != 0 && norm != 1) || passes != (norm && ntiles > 1 ? 2 : 1) ||
      kv_stages < (passes * ntiles > 1 ? 2 : 1) ||
      kv_stages > wg::MAX_KV_STAGES ||
      u_stages < 1 ||
      u_stages > wg::MAX_U_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const wg::Layout L(dp, nk, h, w);
  const size_t smem = L.smem(u_stages, kv_stages);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // qkv as (ld, N, B) bf16, or for GRID's K / V as (ld, W, H, B); boxes of
  // a slab's columns x 128 query rows / NK key slots
  wg::Maps maps = {};
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {2ull * ld, 2ull * ld * n};
  const cuuint64_t dims4[4] = {(cuuint64_t)ld, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)batch};
  const cuuint64_t strides4[3] = {2ull * ld, 2ull * ld * w, 2ull * ld * n};
  const CUtensorMapSwizzle swz[3] = {CU_TENSOR_MAP_SWIZZLE_128B,
                                     CU_TENSOR_MAP_SWIZZLE_64B,
                                     CU_TENSOR_MAP_SWIZZLE_32B};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  for (int s = 0; s < wg::slab_count(dp); ++s) {
    const int wd = wg::slab_width(dp, s), c = wg::width_class(wd);
    const cuuint32_t box_q[3] = {(cuuint32_t)wd, wg::QROWS, 1};
    const cuuint32_t box_kv[3] = {(cuuint32_t)wd, (cuuint32_t)nk, 1};
    const cuuint32_t box_grid[4] = {(cuuint32_t)wd, wg::GRID_W,
                                    (cuuint32_t)(nk / wg::GRID_W), 1};
    if (!hop::tensor_map(&maps.q[c], bf, 3, qkv, dims, strides, box_q,
                         swz[c]) ||
        !(grid ? hop::tensor_map(&maps.kv[c], bf, 4, qkv, dims4, strides4,
                                 box_grid, swz[c])
               : hop::tensor_map(&maps.kv[c], bf, 3, qkv, dims, strides,
                                 box_kv, swz[c])))
      return (int)cudaErrorInvalidValue;
  }
  wg::Args a;
  a.rel_h = static_cast<const bf16*>(rel_h);
  a.rel_w = static_cast<const bf16*>(rel_w);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.rel_h_len = (long long)batch * heads * n * h;
  a.rel_w_len = (long long)batch * heads * n * w;
  a.n = n, a.heads = heads, a.d = d, a.hs = hs, a.H = h, a.W = w;
  a.qblocks = (n + wg::QROWS - 1) / wg::QROWS;
  a.units = batch * heads * a.qblocks;
  a.ntiles = ntiles;
  a.kv_stages = kv_stages, a.u_stages = u_stages, a.passes = passes;
  a.w_magic = (unsigned)(0x100000000ull / (unsigned)w) + 1u;
  a.scale = 1.f / sqrtf((float)d);
  switch (dp / 16) {
#define DHOCT_ND(ND)                                                       \
  case ND:                                                                 \
    return launch_dp<16 * ND>(nk, norm, maps, a, smem, blocks, stream);
    DHOCT_ND(1) DHOCT_ND(2) DHOCT_ND(3) DHOCT_ND(4)
    DHOCT_ND(5) DHOCT_ND(6) DHOCT_ND(7) DHOCT_ND(8)
#undef DHOCT_ND
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (ctypes). The launch plan (ops/attention.py: relpos_plan):
// nk the key tile (224, or 112 past DP = 80: a window of at most 14 x 16
// grid cells, 14 or 7 grid rows a tile; 128: two grid rows of 64; else
// 64), kv_stages (2 at least where a unit issues more than one tile) /
// u_stages the ring depths, passes over a unit's key tiles (2 for norm
// over several tiles, else 1), norm 1 for K2's rounding point (the
// normalised p rounded before p . v; head dim 64), 0 for K6's, blocks the
// persistent blocks; hs the columns of
// a head in qkv's rows (d, or d rounded up to 16 where the wrapper padded
// each head with zeros); lse null, or (B, heads, N) f32 to receive the
// rows' logsumexp (the bf16 K1's rows for K5). Returns the cudaError_t of
// the launch (0 = success); the caller raises on non-zero.
extern "C" {

int dhoct_attn_relpos_bf16(const void* qkv, const void* rel_h,
                           const void* rel_w, void* out, void* lse, int batch,
                           int n, int heads, int d, int h, int w, int hs,
                           int nk, int kv_stages, int u_stages, int passes,
                           int norm, int blocks, void* stream) {
  return launch(qkv, rel_h, rel_w, out, static_cast<float*>(lse), batch, n,
                heads, d, h, w, hs, nk, kv_stages, u_stages, passes, norm,
                blocks, static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
