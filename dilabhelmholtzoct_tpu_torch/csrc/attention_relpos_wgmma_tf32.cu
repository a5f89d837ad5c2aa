// K6 and K1 in f32 on Hopper's wgmma and TMA, every product in split TF32:
// SAM encoder self-attention with decomposed relative-position bias for any
// head dim, read straight from the fused qkv projection (the bf16 twin is
// attention_relpos_wgmma.cu). It is the f32 K6: every layer of a model off
// the packed route (ViT-H: 16 heads of 80, 32 launches an image in serving
// and evaluation: 4 global layers, N = 4096, and 28 windowed, 25 windows of
// 196). It is also the f32 K1: the global layers (N > 256) of ViT-B and
// ViT-L (12 / 16 heads of 64) in serving and in the f32 full fine-tune,
// where it writes the rows' logsumexp for K5 (`lse`, a null pointer for
// K6). In f32 the two TPU kernels compute one function: K1's q / 8 before
// the product and K6's score * d^-1/2 after it are one exact power-of-two
// scale at d = 64, and K6's rounding of the un-normalised p to the input
// type is the identity. It is the f32 K2 too: the windowed layers (N <=
// 256) of ViT-B and ViT-L (25 windows of 196 an image, 12 / 16 heads of
// 64; 8 launches an encode, 16 a full fine-tune step), with the LSE rows,
// where the JAX route's normalised rounding point is again the identity.
//
//   qkv   (B, N, 3C) f32   feature order (3, heads, d); where d is no
//                          multiple of 16, each head padded to DP columns
//                          by the wrapper (B, N, 3 heads DP)
//   rel_h (B, heads, N, H), rel_w (B, heads, N, W)   bias factors
//   out   (B, N, C)
//
//   s[q, k] = (q . k) * d^-1/2 + rel_h[q, k / W] + rel_w[q, k % W]
//   out[q]  = (sum_k exp(s[q, k] - m) v[k]) / sum_k exp(s[q, k] - m)
//
// It replaces dilabhelmholtzoct_tpu/ops/attention.py flash_attention_relpos
// (_flash_kernel, pallas_call at :132) and, as K1 and K2,
// flash_attention_packed's global and windowed branches (_packed_kernel,
// pallas_call at :819; _windowed_group_kernel, pallas_call at :770) in f32:
// every sum in f32, p never rounded, the division last.
//
// Split TF32. f32 has no tensor-core type of its own: each operand x is
// split as x = hi + lo with hi = trunc(x), x with its 13 low bits cleared,
// and lo = x - hi exact in f32 (split_tf32.cuh: lo_trunc), and a product a.b
// is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on wgmma ... .f32.tf32.tf32
// with f32 accumulators. The tensor cores read the top 19 bits of a .tf32
// operand, so the raw f32 of q, of a K tile as TMA landed it and of p in
// registers is its own hi: only lo needs a copy. What the split drops
// (lo_a.lo_b, and the bits of lo past TF32) is about 2^-20 of each product;
// tests/test_torch_split_tf32.py emulates this arithmetic on the CPU.
//
// Bound on an H100 SXM (700 W), B = 1, f32 over split TF32's rate (495 / 3
// = 165 TFLOP/s): ViT-H's global layer 85.9 GFLOP = 0.52 ms against 0.035
// ms of bytes; its windowed layer (25 x 196) 4.9 GFLOP = 0.030 ms against
// 0.033 ms of bytes; as K1, ViT-B's global layer (12 heads of 64) 51.5 GFLOP
// = 0.31 ms against 0.022 ms of bytes; as K2, ViT-B's windowed layer (25 x
// 196, 12 heads) 2.95 GFLOP = 0.018 ms against 0.020 ms of bytes.
// Operation-bound but for the windows.
// What this design does about it: both products on wgmma, its operands
// landed by TMA and split once per block, not once per warp (the mma.sync
// kernel before it split every K and V fragment in each of its 4-8 warps);
// a producer warpgroup keeps the next unit's Q and the next key tiles in
// flight and splits them while two consumer warpgroups compute; persistent
// blocks. What stays on the CUDA cores per score: the scale and the bias,
// the exponential, the max and the sum, and the split of p.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the head-major
// copies of q, k, v and the output, the one-hot selector matmuls that
// expand the bias, whole-N k / v blocks in VMEM.

#include "attention_mma.cuh"
#include "hopper.cuh"
#include "split_tf32.cuh"

namespace {

using namespace attn;

constexpr int MAX_D = 128;  // head dim: a multiple of 4 up to this

// attn_relpos_wgmma_tf32_kernel<DP, MODE>: warp-specialised, persistent.
// A unit is 128 query rows of one (batch, head); a block walks units
// blockIdx.x, + gridDim.x, ... with three roles:
//   TMA warp (warp 8, one lane): per unit Q (128 rows in K-major slabs;
//     rows past N zero) and for ROW_TILE its rel_w rows into a ring of
//     u_stages; per key tile of NK = 32 slots K into the tile's
//     stage of a ring of kv_stages (K-major slabs in TMA's swizzle: the B
//     operand of q . k^T as it lands, read as its own hi), and V into a
//     ring of v_slots landing buffers (rows of DP f32, no swizzle). A
//     head's DP columns come in slabs of 32 (128-byte rows) and one of 16
//     where DP % 32 asks for it (ViT-H: 32 + 32 + 16).
//   transformers (warps 9-11, 96 threads): per key tile, K's lo part
//     (element by element, in K's own layout, beside it in the stage), and
//     V transposed and split into hi and lo, K-major without swizzle (core
//     matrices of 8 head columns x 4 keys, LBO 128 between the two key
//     halves of a k8 step, SBO 256 between 8-column groups: TF32 wgmma reads
//     its shared operands K-major only, and the keys are p . v's K); the
//     keys of a k8 step are stored in the order 0, 2, 4, 6 | 1, 3, 5, 7, so
//     that the score accumulators are p's A fragments as they stand (below).
//     Then a proxy fence and an arrive on the stage's ready barrier.
//   consumers (two warpgroups of 64 rows each): q's lo in registers for
//     the unit (A fragments), its hi too on the global layers (QHR), else
//     the unit's Q slabs as TMA landed them (an SS operand); per tile S =
//     q . k^T as a chain of wgmma m64n32k8, three per k8 step (q_lo.k,
//     q_hi.k_lo, q_hi.k); s = fma(S, d^-1/2, rel_h + rel_w), empty key slots at
//     -inf; the online softmax in f32; p and p's lo as the A fragments of
//     o += p . v, three wgmma m64nDPk8 per k8 step of keys (an accumulator
//     tile's d[4j], d[4j + 2], d[4j + 1], d[4j + 3] are the A fragment of k8
//     step j with its keys in the order above); o / l at the end. But for
//     QHR the two warpgroups take turns issuing their score products
//     (named barriers), so that one's softmax runs beside the other's
//     products.
// How a tile's key slots map to keys and their bias, by MODE:
//   ROW_TILE (W = 64: the global layers): a tile is half a grid row: one
//     rel_h value a row and tile; the unit's rel_w rows come with its Q by
//     TMA (in the 128-byte swizzle) and stay for the unit.
//   GRID (H, W <= 16: the windowed layers): K and V come through a 4-D
//     view (cols, W, H, B) in boxes of 16 x 2 grid cells, so slot 16 kr +
//     kc holds key (kr, kc), and the slots past W (and past H) are zero
//     rows, masked by a -inf rel_w (rel_h). Column 8 j + 2 t + e of a lane
//     is grid row j / 2 of the tile, grid column 8 (j % 2) + 2 t + e: the
//     lane's four rel_w values a row, in registers for the unit (DP 80) or
//     loaded per tile while its score products run (DP 64: rw_per_tile).
//   GENERIC: slot k0 + c is key k0 + c; each score finds its grid (row,
//     col) by a multiply-high and reads both factors.
// Registers and shared-memory bandwidth bound the design. ptxas
// serializes every wgmma of a function (C7511, "insufficient register
// resources for the wgmma pipeline") once one of its pipelines cannot
// keep its operands, and the kernel then runs at half its speed or less
// on an H100; key tiles of 64 (32 more registers for s, 32 for p's lo), a
// turn around p . v as well as around S, __ldg in GENERIC's bias, q_hi in
// registers beside the turns (ROW_TILE) or beside GRID's bias registers
// each tipped the main path's instances (DP = 80, 64) into it, and GRID's
// bias registers alone the f32 K2's (DP 64: 0.142 ms at B = 1 serialized,
// 0.066 with its rel_w per tile and q_hi in registers, NVIDIA H100 80GB
// HBM3 at 700 W, utils/kernel_variants.py). q_hi read
// from shared memory, though, costs each score product's A operand there
// (2 KB a wgmma), the largest of the bytes a tile moves through it.
// A head dim that is no multiple of 16 comes in rows whose heads the
// wrapper padded to DP columns with zeros (hs = DP): the zero columns add
// nothing to q . k, and are not stored.
namespace wt {

constexpr int QROWS = 128;            // query rows of a unit
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int TRANSFORMERS = 96;      // warps 9-11
constexpr int NTH = CONSUMERS + 128;  // and the producer's warpgroup
// registers a thread: 168 at launch (64K over 384 threads, in steps of 8);
// the producer's warpgroup gives back all but 56 (the transformers' loops
// spill below that), the consumers take them (224 each: 128 x 56 + 256 x
// 224 = 64K)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int MAX_KV_STAGES = 4, MAX_V_SLOTS = 2, MAX_U_STAGES = 2;
constexpr int TURN = 1;  // named barriers 1, 2: the warpgroups' turns
constexpr uint32_t TF32_HI = 0xffffe000u;  // the bits a .tf32 operand keeps

enum Mode { GENERIC, ROW_TILE, GRID };
constexpr int GRID_W = 16;  // key slots of a grid row in GRID's tiles

__host__ __device__ constexpr Mode mode_of(int h, int w) {
  return h <= GRID_W && w <= GRID_W ? GRID : w == 64 ? ROW_TILE : GENERIC;
}

constexpr int NK = 32;      // key slots of a tile
constexpr int GH = NK / GRID_W;  // GRID: grid rows of a tile

// q_hi in registers too (all three score products RS, no A operand read
// from shared memory), and no turns: ROW_TILE up to DP = 80, the global
// layers of the main path (ViT-H's K6, ViT-B / L's K1), and GRID up to DP =
// 64 (ViT-B / L's K2); elsewhere q_hi is read by wgmma from the unit's Q
// stage and the warpgroups take turns issuing their score products. GRID's
// rel_w values of a lane: held in registers for the unit, or up to DP = 64
// loaded per tile while its score products run. Each the fastest
// configuration of its instances that ptxas does not serialize (the note
// below; utils/kernel_variants.py times the alternatives).
__host__ __device__ constexpr bool q_hi_in_regs(int dp, Mode mode) {
  return (mode == ROW_TILE && dp <= 80) || (mode == GRID && dp <= 64);
}
__host__ __device__ constexpr bool rw_per_tile(int dp, Mode mode) {
  return mode == GRID && dp <= 64;
}

// the column slabs of DP (a multiple of 16) f32 columns: DP / 32 of 32,
// then one of 16 where DP % 32 holds it; slab i starts at column 32 i
__host__ __device__ constexpr int slab_count(int dp) {
  return dp / 32 + (dp & 16 ? 1 : 0);
}
__host__ __device__ constexpr int slab_width(int dp, int i) {
  return i < dp / 32 ? 32 : 16;
}
// bytes before slab i of a tile of `rows` rows (every slab before it is 32
// wide; a multiple of 1024 for rows a multiple of 16, so every slab base is
// aligned for its swizzle)
__host__ __device__ constexpr int slab_offset(int i, int rows) {
  return 128 * rows * i;
}

// The shared memory of a launch, from a 1024-aligned base: the unit
// stages (u_bytes each: Q, and for ROW_TILE the unit's rel_w rows, 128 x
// 64 f32 in two slabs of 32 columns); the K / V stages (stage_bytes each:
// K, its lo, then V^T hi and lo per k8 step of keys); the V landing slots
// (k_bytes each); the mbarriers. SMEM_FIXED + u_stages u_bytes + kv_stages
// stage_bytes + v_slots k_bytes in all (ops/attention.py: relpos_plan_f32)
constexpr int SMEM_FIXED = 1024 + 256;  // alignment slack, mbarriers
constexpr int RW_BYTES = QROWS * 64 * 4;  // ROW_TILE: a unit's rel_w rows
struct Layout {
  int q_bytes, u_bytes, k_bytes, stage_bytes;
  __host__ __device__ Layout(int dp, Mode mode)
      : q_bytes(QROWS * dp * 4),
        u_bytes(q_bytes + (mode == ROW_TILE ? RW_BYTES : 0)),
        k_bytes(NK * dp * 4), stage_bytes(4 * NK * dp * 4) {}
  __host__ __device__ size_t smem(int u_stages, int kv_stages,
                                  int v_slots) const {
    return SMEM_FIXED + (size_t)u_stages * u_bytes +
           (size_t)kv_stages * stage_bytes + (size_t)v_slots * k_bytes;
  }
};

// tensor maps of qkv (ld, N, B): Q (128-row boxes) and K (NK rows; GRID:
// the 4-D view (ld, W, H, B), boxes of 16 x NK / 16 cells), one per slab
// width (32, 16 columns) in its swizzle; V whole heads of DP columns, no
// swizzle (NK rows; GRID the 4-D view); ROW_TILE's rel_w as (64, B heads
// N), boxes of 32 columns x 128 rows in the 128-byte swizzle
struct Maps {
  CUtensorMap q[2], k[2], v, rw;
};

__host__ __device__ constexpr int width_class(int w) { return w == 32 ? 0 : 1; }

struct Args {
  const float* rel_h;
  const float* rel_w;
  float* out;
  float* lse;  // null, or (B, heads, N): the rows' logsumexp m + log(l)
  int n, heads, d, hs, H, W, qblocks, units, ntiles, kv_stages, v_slots,
      u_stages;
  unsigned w_magic;  // floor(2^32 / W) + 1: key / W = umulhi(key, w_magic)
  float scale;
};

// byte offset of element (row, col) of a Q tile (and, as DP = 64, of the
// rel_w rows): slab col / 32 in its swizzle (the 16-byte chunks of a row
// XORed with row % 8 in 128-byte rows, (row / 2) % 4 in the 64-byte rows of
// a 16-column slab)
template <int DP>
__device__ __forceinline__ int q_offset(int row, int col) {
  const int i = col >> 5, cc = col & 31;
  if (slab_width(DP, i) == 32)
    return slab_offset(i, QROWS) + row * 128 +
           (((cc >> 2) ^ (row & 7)) << 4) + (cc & 3) * 4;
  return slab_offset(i, QROWS) + row * 64 +
         (((cc >> 2) ^ ((row >> 1) & 3)) << 4) + (cc & 3) * 4;
}

// s = q . k^T over the k8 steps of slabs I.. in split TF32: per step
// q_lo.k, q.k_lo, q.k (the small terms first); ql q_lo's A fragments of
// the warpgroup's rows, qh q_hi's (QHR) or q the unit's Q slabs (q_hi as
// an SS operand), k the tile's K slabs, klo their lo
template <int DP, bool QHR, int I>
__device__ __forceinline__ void qk_slabs(float* s, const uint32_t (*ql)[4],
                                         const uint32_t (*qh)[4],
                                         const unsigned char* q,
                                         const unsigned char* k,
                                         const unsigned char* klo, int wgi) {
  if constexpr (I < slab_count(DP)) {
    constexpr int W = slab_width(DP, I), R = 4 * W;  // row bytes
    constexpr uint32_t LAY = hop::swizzle_layout(R);
    // the slab's descriptors; a k8 step is 32 bytes on (2 in the address
    // field, which holds bytes / 16)
    const uint64_t kd = hop::desc(k + slab_offset(I, NK), 16, 8 * R, LAY);
    const uint64_t ld = hop::desc(klo + slab_offset(I, NK), 16, 8 * R, LAY);
    const uint64_t qd = hop::desc(q + slab_offset(I, QROWS) + wgi * 64 * R,
                                  16, 8 * R, LAY);
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      hop::mma_tf32_rs<NK>(s, ql[4 * I + kk], kd + 2 * kk, I > 0 || kk > 0);
      if constexpr (QHR) {
        hop::mma_tf32_rs<NK>(s, qh[4 * I + kk], ld + 2 * kk, 1);
        hop::mma_tf32_rs<NK>(s, qh[4 * I + kk], kd + 2 * kk, 1);
      } else {
        hop::mma_tf32_ss<NK>(s, qd + 2 * kk, ld + 2 * kk, 1);
        hop::mma_tf32_ss<NK>(s, qd + 2 * kk, kd + 2 * kk, 1);
      }
    }
    qk_slabs<DP, QHR, I + 1>(s, ql, qh, q, k, klo, wgi);
  }
}

template <int DP, Mode MODE>
__global__ void __launch_bounds__(NTH, 1)
attn_relpos_wgmma_tf32_kernel(const __grid_constant__ Maps maps,
                              const Args a) {
  using namespace hop;
  using mma::exp2_approx;
  using mma::LOG2E;
  using mma::quad_max;
  using mma::quad_sum;
  using stf32::lo_trunc;
  constexpr int NS = slab_count(DP), KSTEPS = NK / 8, DSTEPS = DP / 8;
  constexpr bool QHR = q_hi_in_regs(DP, MODE), TURNS = !QHR;
  constexpr bool RWT = rw_per_tile(DP, MODE);
  static_assert(DP % 16 == 0, "head columns");
  const Layout L(DP, MODE);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~uintptr_t(1023));
  unsigned char* qbase = base;
  unsigned char* kvbase = qbase + a.u_stages * L.u_bytes;
  unsigned char* vbase = kvbase + a.kv_stages * L.stage_bytes;
  uint64_t* ufull =
      reinterpret_cast<uint64_t*>(vbase + a.v_slots * L.k_bytes);
  uint64_t* uempty = ufull + MAX_U_STAGES;
  uint64_t* kfull = uempty + MAX_U_STAGES;   // K landed
  uint64_t* kready = kfull + MAX_KV_STAGES;  // K lo and V^T written
  uint64_t* kempty = kready + MAX_KV_STAGES;
  uint64_t* vfull = kempty + MAX_KV_STAGES;
  uint64_t* vfree = vfull + MAX_V_SLOTS;
  const int C = a.heads * a.hs;  // columns of q (of k, of v) in a row
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.u_stages; ++i) {
      mbar_init(ufull + i, 1);
      mbar_init(uempty + i, CONSUMERS);
    }
    for (int i = 0; i < a.kv_stages; ++i) {
      mbar_init(kfull + i, 1);
      mbar_init(kready + i, TRANSFORMERS);
      mbar_init(kempty + i, CONSUMERS);
    }
    for (int i = 0; i < a.v_slots; ++i) {
      mbar_init(vfull + i, 1);
      mbar_init(vfree + i, TRANSFORMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= CONSUMERS / 32) {  // ------------------ producer warpgroup ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32) {  // the TMA lane
      if (lane != 0) return;
      int it = 0, uu = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
        const int qb = u % a.qblocks, bh = u / a.qblocks;
        const int head = bh % a.heads, b = bh / a.heads;
        const int us = uu % a.u_stages;
        unsigned char* ust = qbase + us * L.u_bytes;
        mbar_wait(uempty + us, ((uu / a.u_stages) & 1) ^ 1);
        mbar_expect_tx(ufull + us, L.u_bytes);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load_3d(ust + slab_offset(s, QROWS),
                      &maps.q[width_class(slab_width(DP, s))], ufull + us,
                      head * a.hs + 32 * s, qb * QROWS, b);
        if constexpr (MODE == ROW_TILE)  // rows past N: the next ones' or 0
          for (int s = 0; s < 2; ++s)
            tma_load_2d(ust + L.q_bytes + slab_offset(s, QROWS), &maps.rw,
                        ufull + us, 32 * s, bh * a.n + qb * QROWS);
        for (int tile = 0; tile < a.ntiles; ++tile, ++it) {
          const int ks = it % a.kv_stages, vs = it % a.v_slots;
          unsigned char* kst = kvbase + ks * L.stage_bytes;
          mbar_wait(kempty + ks, ((it / a.kv_stages) & 1) ^ 1);
          mbar_expect_tx(kfull + ks, NK * DP * 4);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const CUtensorMap* m = &maps.k[width_class(slab_width(DP, s))];
            const int col = C + head * a.hs + 32 * s;
            if constexpr (MODE == GRID)
              tma_load_4d(kst + slab_offset(s, NK), m, kfull + ks, col, 0,
                          tile * GH, b);
            else
              tma_load_3d(kst + slab_offset(s, NK), m, kfull + ks, col,
                          tile * NK, b);
          }
          unsigned char* vst = vbase + vs * L.k_bytes;
          mbar_wait(vfree + vs, ((it / a.v_slots) & 1) ^ 1);
          mbar_expect_tx(vfull + vs, NK * DP * 4);
          if constexpr (MODE == GRID)
            tma_load_4d(vst, &maps.v, vfull + vs, 2 * C + head * a.hs, 0,
                        tile * GH, b);
          else
            tma_load_3d(vst, &maps.v, vfull + vs, 2 * C + head * a.hs,
                        tile * NK, b);
        }
      }
      return;
    }
    // the transformers: each tile's K lo and V^T hi / lo, once per block
    const int tt = threadIdx.x - CONSUMERS - 32;
    int it = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      for (int tile = 0; tile < a.ntiles; ++tile, ++it) {
        const int ks = it % a.kv_stages, vs = it % a.v_slots;
        unsigned char* kst = kvbase + ks * L.stage_bytes;
        mbar_wait(kfull + ks, (it / a.kv_stages) & 1);
        const float4* k4 = reinterpret_cast<const float4*>(kst);
        float4* l4 = reinterpret_cast<float4*>(kst + L.k_bytes);
        for (int i = tt; i < NK * DP / 4; i += TRANSFORMERS) {
          const float4 x = k4[i];
          l4[i] = make_float4(lo_trunc(x.x), lo_trunc(x.y), lo_trunc(x.z),
                              lo_trunc(x.w));
        }
        mbar_wait(vfull + vs, (it / a.v_slots) & 1);
        const float* v = reinterpret_cast<const float*>(vbase + vs * L.k_bytes);
        unsigned char* vt = kst + 2 * L.k_bytes;
        // item i: head column c, key half h of k8 step j: keys 8 j + 2 e +
        // h (e < 4), the core matrix row of column c
        for (int i = tt; i < KSTEPS * 2 * DP; i += TRANSFORMERS) {
          const int c = i % DP, hj = i / DP, h = hj & 1, j = hj >> 1;
          uint32_t hi[4];
          float lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = v[(8 * j + 2 * e + h) * DP + c];
            hi[e] = __float_as_uint(x) & TF32_HI;
            lo[e] = x - __uint_as_float(hi[e]);
          }
          unsigned char* dst = vt + j * 64 * DP + (c >> 3) * 256 + h * 128 +
                               (c & 7) * 16;
          *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2],
                                                      hi[3]);
          *reinterpret_cast<float4*>(dst + 32 * DP) =
              make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
        mbar_arrive(vfree + vs);  // the V slot is read
        fence_proxy_async();      // our writes -> the wgmma reads
        mbar_arrive(kready + ks);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = warp >> 2;  // warpgroup: rows 64 wgi.. of the unit
  const int g = lane >> 2, t = lane & 3;
  // TURNS: the two warpgroups take turns issuing their score products:
  // barrier TURN + wgi is this warpgroup's turn, the other arrives on it
  // once its own products are in flight (warpgroup 0 goes first)
  if (TURNS && wgi == 1) named_arrive(TURN, CONSUMERS);
  const int r0 = 64 * wgi + 16 * (warp & 3) + g;  // the lane's rows r0, r0 + 8
  int it = 0, uu = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
    const int qb = u % a.qblocks, bh = u / a.qblocks;
    const int head = bh % a.heads, b = bh / a.heads, q0 = qb * QROWS;
    const int us = uu % a.u_stages;
    const unsigned char* ust = qbase + us * L.u_bytes;
    const long long row = (long long)bh * a.n + q0;
    // the bias rows of the lane's two query rows, as element offsets (a
    // row past N reads row N - 1: its scores are computed and dropped)
    int rh_row[2], rw_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = bh * a.n + min(q0 + r0 + 8 * r, a.n - 1);
      rh_row[r] = qr * a.H;
      rw_row[r] = qr * a.W;
    }
    // GRID: the lane's rel_w values, its grid columns 8 h + 2 t + e (-inf
    // past W: the slot is empty), for the unit or (RWT) per tile; ROW_TILE
    // reads them from the unit stage's rel_w rows
    auto load_rw = [&](float (&rw)[2][4]) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = 8 * (i >> 1) + 2 * t + (i & 1);
          rw[r][i] = kc < a.W ? __ldg(a.rel_w + rw_row[r] + kc) : -INFINITY;
        }
    };
    float rwu[2][4];
    if constexpr (MODE == GRID && !RWT) load_rw(rwu);
    mbar_wait(ufull + us, (uu / a.u_stages) & 1);
    // q_lo's (and QHR q_hi's: the raw f32) A fragments: a0 (row g, k t),
    // a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4) of
    // each k8 step
    uint32_t ql[DSTEPS][4], qh[QHR ? DSTEPS : 1][4];
#pragma unroll
    for (int kk = 0; kk < DSTEPS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = *reinterpret_cast<const float*>(
            ust + q_offset<DP>(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1)));
        if constexpr (QHR) qh[kk][i] = __float_as_uint(x);
        ql[kk][i] = __float_as_uint(lo_trunc(x));
      }
    fence_operands(ql);
    if constexpr (QHR) fence_operands(qh);

    float o[DP / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int tile = 0; tile < a.ntiles; ++tile, ++it) {
      const int ks = it % a.kv_stages;
      const unsigned char* kst = kvbase + ks * L.stage_bytes;
      mbar_wait(kfull + ks, (it / a.kv_stages) & 1);
      mbar_wait(kready + ks, (it / a.kv_stages) & 1);
      float s[NK / 2];
      if constexpr (TURNS) named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      qk_slabs<DP, QHR, 0>(s, ql, qh, ust, kst, kst + L.k_bytes, wgi);
      wgmma_commit();
      if constexpr (TURNS) named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      // the tile's bias values, loaded while S runs: rel_h, ROW_TILE one a
      // row (grid row tile / 2), GRID one a row and grid row (-inf past
      // H); GRID's rel_w where RWT
      float rh[2][MODE == GRID ? GH : 1];
      float rwt[2][4];
      if constexpr (RWT) load_rw(rwt);
      if constexpr (MODE == ROW_TILE) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rh[r][0] = __ldg(a.rel_h + rh_row[r] + tile / 2);
      } else if constexpr (MODE == GRID) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int kr = 0; kr < GH; ++kr) {
            const int row_k = GH * tile + kr;
            rh[r][kr] =
                row_k < a.H ? __ldg(a.rel_h + rh_row[r] + row_k) : -INFINITY;
          }
      }
      wgmma_wait<0>();
      fence_operands(s);
      // s = S * d^-1/2 + bias; p = exp(s - m) in f32 against the row's new
      // running max m; o (past the first tile) and l rescaled
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          float2 w2;  // ROW_TILE: rel_w of the two columns, from the stage
          if constexpr (MODE == ROW_TILE)  // grid columns c0 + 8 j + 2 t, + 1
            w2 = *reinterpret_cast<const float2*>(
                ust + L.q_bytes +
                q_offset<64>(r0 + 8 * r, 32 * (tile & 1) + 8 * j + 2 * t));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float bias;
            if constexpr (MODE == ROW_TILE) {
              bias = rh[r][0] + (e ? w2.y : w2.x);
            } else if constexpr (MODE == GRID) {
              if constexpr (RWT)
                bias = rh[r][j >> 1] + rwt[r][2 * (j & 1) + e];
              else
                bias = rh[r][j >> 1] + rwu[r][2 * (j & 1) + e];
            } else {
              // GENERIC: key k0 + 8 j + 2 t + e at grid (kr, kc), clamped in
              // bounds past N (its score is discarded)
              const int key = NK * tile + 8 * j + 2 * t + e;
              const int kr = min((int)__umulhi(key, a.w_magic), a.H - 1);
              const int kc = min(key - kr * a.W, a.W - 1);
              // (plain loads: __ldg's here spilled past DP = 80)
              const float* fh = a.rel_h + rh_row[r];
              const float* fw = a.rel_w + rw_row[r];
              bias = key < a.n ? fh[kr] + fw[kc] : -INFINITY;
            }
            float& x = s[4 * j + 2 * r + e];
            x = fmaf(x, a.scale, bias);
          }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        // every tile holds a real key of the row: m_new is finite
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float alpha = exp2_approx((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        const float mb = m_new * LOG2E;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * r + e];
            x = exp2_approx(fmaf(x, LOG2E, -mb));
            rs += x;  // the denominator sums the f32 p
          }
        l[r] = l[r] * alpha + rs;  // the lane's share; quad sum last
        if (tile > 0)
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            o[4 * j + 2 * r] *= alpha;
            o[4 * j + 2 * r + 1] *= alpha;
          }
      }
      // p's A fragments of k8 step j (keys 8 j + 2 t -> k t, 8 j + 2 t + 1
      // -> k t + 4: V^T's key order): the raw f32 its hi, and its lo
      uint32_t ph[KSTEPS][4], pl[KSTEPS][4];
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
        const float f[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                            s[4 * j + 3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ph[j][i] = __float_as_uint(f[i]);
          pl[j][i] = __float_as_uint(lo_trunc(f[i]));
        }
      }
      fence_operands(ph);
      fence_operands(pl);
      fence_operands(o);
      // o += p . v: per k8 step p_lo.v, p.v_lo, p.v (V^T K-major, no
      // swizzle: LBO 128 between the key halves, SBO 256 between 8-column
      // groups)
      // a k8 step's hi at vd + 4 DP j (64 DP bytes on), its lo 2 DP past
      // it (the descriptor's address field holds bytes / 16)
      const uint64_t vd =
          desc(kst + 2 * L.k_bytes, 128, 256, LAYOUT_NONE);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
        mma_tf32_rs<DP>(o, pl[j], vd + 4 * DP * j, tile > 0 || j > 0);
        mma_tf32_rs<DP>(o, ph[j], vd + 4 * DP * j + 2 * DP, 1);
        mma_tf32_rs<DP>(o, ph[j], vd + 4 * DP * j, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      mbar_arrive(kempty + ks);  // the stage's K, K lo and V^T are read
    }
    mbar_arrive(uempty + us);  // q_hi (and ROW_TILE's rel_w) read

    // out = o / l to the nearest f32 (o q ~ o / l, one correction on the
    // residual); lse = m + log(l), the scaled scores' logsumexp in
    // natural-log units (m is the max of s itself), which K5 reads
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]), q_l = __frcp_rn(lr);
      const int q = q0 + r0 + 8 * r;
      if (q >= a.n) continue;
      if (a.lse != nullptr && t == 0)
        a.lse[row + r0 + 8 * r] = m[r] + logf(lr);
      float* dst =
          a.out + ((size_t)b * a.n + q) * a.heads * a.d + head * a.d + 2 * t;
      auto div = [&](float x) {
        const float y = x * q_l;
        return fmaf(fmaf(-lr, y, x), q_l, y);
      };
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        if (8 * j + 2 * t < a.d)  // d % 4 == 0: both columns or neither
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(div(o[4 * j + 2 * r]), div(o[4 * j + 2 * r + 1]));
    }
  }
  if (TURNS && wgi == 0) named_sync(TURN, CONSUMERS);  // 1's last arrive
}

}  // namespace wt

template <int DP, wt::Mode MODE>
int launch_inst(const wt::Maps& maps, const wt::Args& a, size_t smem,
                int blocks, cudaStream_t stream) {
  auto kernel = wt::attn_relpos_wgmma_tf32_kernel<DP, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, wt::NTH, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(wt::Mode mode, const wt::Maps& maps, const wt::Args& a,
              size_t smem, int blocks, cudaStream_t stream) {
  switch (mode) {
    case wt::GRID:
      return launch_inst<DP, wt::GRID>(maps, a, smem, blocks, stream);
    case wt::ROW_TILE:
      return launch_inst<DP, wt::ROW_TILE>(maps, a, smem, blocks, stream);
    default:
      return launch_inst<DP, wt::GENERIC>(maps, a, smem, blocks, stream);
  }
}

int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out,
           float* lse, int batch, int n, int heads, int d, int h, int w,
           int hs, int kv_stages, int v_slots, int u_stages, int blocks,
           cudaStream_t stream) {
  using wt::NK;
  const int dp = (d + 15) / 16 * 16, ld = 3 * heads * hs;
  const wt::Mode mode = wt::mode_of(h, w);
  // the bias factors are indexed with int offsets
  const long long rel_len = (long long)batch * heads * n * (h > w ? h : w);
  if (d < 4 || d % 4 || d > MAX_D || n < 1 || h < 1 || w < 1 ||
      n != h * w || rel_len >= (1ll << 31) || (hs != d && hs != dp) ||
      ld % 4 || kv_stages < 1 ||
      kv_stages > wt::MAX_KV_STAGES || v_slots < 1 ||
      v_slots > wt::MAX_V_SLOTS || u_stages < 1 ||
      u_stages > wt::MAX_U_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const wt::Layout L(dp, mode);
  const size_t smem = L.smem(u_stages, kv_stages, v_slots);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // qkv as (ld, N, B) f32, or for GRID's K / V as (ld, W, H, B); boxes of a
  // slab's columns (or a head's DP for V) x 128 query rows / NK key slots
  wt::Maps maps = {};
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {4ull * ld, 4ull * ld * n};
  const cuuint64_t dims4[4] = {(cuuint64_t)ld, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)batch};
  const cuuint64_t strides4[3] = {4ull * ld, 4ull * ld * w, 4ull * ld * n};
  const bool grid = mode == wt::GRID;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle swz[2] = {CU_TENSOR_MAP_SWIZZLE_128B,
                                     CU_TENSOR_MAP_SWIZZLE_64B};
  for (int s = 0; s < wt::slab_count(dp); ++s) {
    const int wd = wt::slab_width(dp, s), c = wt::width_class(wd);
    const cuuint32_t box_q[3] = {(cuuint32_t)wd, wt::QROWS, 1};
    const cuuint32_t box_k[3] = {(cuuint32_t)wd, NK, 1};
    const cuuint32_t box_g[4] = {(cuuint32_t)wd, wt::GRID_W, wt::GH, 1};
    if (!hop::tensor_map(&maps.q[c], f32, 3, qkv, dims, strides, box_q,
                         swz[c]) ||
        !(grid ? hop::tensor_map(&maps.k[c], f32, 4, qkv, dims4, strides4,
                                 box_g, swz[c])
               : hop::tensor_map(&maps.k[c], f32, 3, qkv, dims, strides,
                                 box_k, swz[c])))
      return (int)cudaErrorInvalidValue;
  }
  // ROW_TILE's rel_w rows as (64, B heads N) f32
  const cuuint64_t dims_rw[2] = {64, (cuuint64_t)batch * heads * n};
  const cuuint64_t strides_rw[1] = {64 * 4};
  const cuuint32_t box_rw[2] = {32, wt::QROWS};
  if (mode == wt::ROW_TILE &&
      !hop::tensor_map(&maps.rw, f32, 2, rel_w, dims_rw, strides_rw, box_rw,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cuuint32_t box_v[3] = {(cuuint32_t)dp, NK, 1};
  const cuuint32_t box_vg[4] = {(cuuint32_t)dp, wt::GRID_W, wt::GH, 1};
  if (!(grid ? hop::tensor_map(&maps.v, f32, 4, qkv, dims4, strides4, box_vg,
                               CU_TENSOR_MAP_SWIZZLE_NONE)
             : hop::tensor_map(&maps.v, f32, 3, qkv, dims, strides, box_v,
                               CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  wt::Args a;
  a.rel_h = static_cast<const float*>(rel_h);
  a.rel_w = static_cast<const float*>(rel_w);
  a.out = static_cast<float*>(out);
  a.lse = lse;
  a.n = n, a.heads = heads, a.d = d, a.hs = hs, a.H = h, a.W = w;
  a.qblocks = (n + wt::QROWS - 1) / wt::QROWS;
  a.units = batch * heads * a.qblocks;
  a.ntiles = grid ? (h + wt::GH - 1) / wt::GH : (n + NK - 1) / NK;
  a.kv_stages = kv_stages, a.v_slots = v_slots, a.u_stages = u_stages;
  a.w_magic = (unsigned)(0x100000000ull / (unsigned)w) + 1u;
  a.scale = 1.f / sqrtf((float)d);
  switch (dp / 16) {
#define DHOCT_ND(ND)                                                       \
  case ND:                                                                 \
    return launch_dp<16 * ND>(mode, maps, a, smem, blocks, stream);
    DHOCT_ND(1) DHOCT_ND(2) DHOCT_ND(3) DHOCT_ND(4)
    DHOCT_ND(5) DHOCT_ND(6) DHOCT_ND(7) DHOCT_ND(8)
#undef DHOCT_ND
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (ctypes), float32. The launch plan (ops/attention.py:
// relpos_plan_f32): kv_stages / v_slots / u_stages the ring depths, blocks
// the persistent blocks; hs the columns of a head in qkv's rows (d, or d
// rounded up to 16 where the wrapper padded each head with zeros); lse
// null, or (B, heads, N) f32 to receive the rows' logsumexp (the f32 K1's
// rows for K5). Returns the cudaError_t of the launch (0 = success); the
// caller raises on non-zero.
extern "C" {

int dhoct_attn_relpos_f32(const void* qkv, const void* rel_h,
                          const void* rel_w, void* out, void* lse, int batch,
                          int n, int heads, int d, int h, int w, int hs,
                          int kv_stages, int v_slots, int u_stages,
                          int blocks, void* stream) {
  return launch(qkv, rel_h, rel_w, out, static_cast<float*>(lse), batch, n,
                heads, d, h, w, hs, kv_stages, v_slots, u_stages, blocks,
                static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
