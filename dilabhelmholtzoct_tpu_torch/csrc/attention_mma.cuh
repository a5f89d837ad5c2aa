// Tensor-core building blocks of the bf16 encoder attention kernels on
// mma.sync: the windowed body of K7 (attention_winimg.cu,
// attn_winimg_mma_kernel), window_tile_mma, and the fragment loads the bf16
// K3 / K4 kernels share (decoder_mma.cuh). The wgmma kernels (the bf16 K1 /
// K2 / K6, attention_relpos_wgmma.cu; K5's bf16 kernels, attention_bwd.cu) take
// their softmax and packing helpers from here, the f32 kernels
// (attention_tf32.cuh) the copies.
//
// Every tile holds rows of one head in bf16 in shared memory. At head dim
// 64 (K7) rows are padded to LDS = 72 elements (144 bytes): the
// eight 16-byte rows that one ldmatrix phase reads then start on eight
// different bank groups, so the loads are free of bank conflicts. The
// fragment loads take the row length (LD) as a template argument whose
// default is that tiling (K4's kernels share them). A block is 4 warps; a
// warp owns 16-row tiles and computes with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (f32 accumulators).
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane =
// 4 g + t: an accumulator n-tile c[4] holds rows g (c0, c1) and g + 8
// (c2, c3), columns 2t and 2t + 1. The A operand of a 16 x 16 step is
// a0 (row g, cols 2t..), a1 (row g + 8), a2 (row g, cols 2t + 8..),
// a3 (row g + 8, cols 2t + 8..): two neighbouring accumulator n-tiles,
// packed to bf16 pairs, are an A fragment, so p goes from one product into
// the next without a trip through shared memory.

#pragma once

#include "attention_common.cuh"

namespace attn {
namespace mma {

constexpr int TILE = 64;      // rows of a query or key tile
constexpr int LDS = D + 8;    // padded shared row (bf16 elements; D = 64)
constexpr int WARPS = 4;      // a warp owns 16 rows of the tile
constexpr int NT = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; `valid` false zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores (16 x 8 += 16 x 16 . 16 x 8)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 2^x in one instruction (relative error 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16 x 16 A fragment at rows r0.., columns k0.. of a row-major tile
// (LD elements per row).
template <int LD = LDS>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0.., n0 + 8..) over k0..k0 + 15 from a tile
// stored [n][k] (keys by head dim for q.k^T): b[0], b[1] for n-tile n0,
// b[2], b[3] for n0 + 8.
template <int LD = LDS>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (values by head dim for p.v), through
// the transposing ldmatrix.
template <int LD = LDS>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows x 64 bf16 of a shared tile (leading dim LDS) times 1/8 in place, by
// a block of NTH threads: exact (a power of two), the TPU kernels' q * sc at
// head dim 64 (the windowed body scales k)
template <int NTH = NT>
__device__ __forceinline__ void scale_eighth(bf16* tile, int rows) {
  const __nv_bfloat162 eighth = __float2bfloat162_rn(0.125f);
  for (int i = threadIdx.x; i < rows * D / 2; i += NTH) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(
        tile + (i / (D / 2)) * LDS + 2 * (i % (D / 2)));
    *x = __hmul2(*x, eighth);
  }
}

// ------------------------------------------------ the windowed body ----
// The bf16 body of the windowed kernel K7: a block per (window,
// head) holds the window's keys and values (NK = N rounded up to 16 rows,
// zero past N; K pre-scaled by 1/8, exact) and its warps take the NK / 16
// m16 query tiles in turn. The bias s += rel_h[q, k / W] + rel_w[q, k % W]
// is a product on the tensor cores too: s += F . E^T, with
//   F  NK x FK  the query rows' factors [rel_h (H) | rel_w (W) | 0 .. |
//               WIN_MASK], FK = 16 ceil((H + W + 1) / 16) (A operand, rows
//               of FK + 8 elements: an odd count of 16-byte units)
//   E  FK x NK  one-hot: key k < N has ones at rows k / W and H + k % W;
//               a key at or past N one at the last row, so its score
//               becomes WIN_MASK (its exp is 0, as the TPU kernel's -inf
//               mask gives) -- stored as the B fragments themselves
// The factors and ones are bf16 and exact, so the bias enters the f32
// accumulator unrounded; no score is looked up or selected on the CUDA
// cores.
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr float WIN_MASK = -16384.f;  // a power of two: exact in bf16

// k16 steps of the bias product
__host__ __device__ __forceinline__ int win_fk16(int H, int W) {
  return (H + W + 16) / 16;
}

// The 16 x 16 A fragment at rows r0.., columns k0.. of a row-major tile of
// `ld` elements per row (a runtime row length)
__device__ __forceinline__ void load_a_ld(uint32_t* a, const bf16* tile,
                                          int ld, int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// E as B fragments, by a block of NTH threads: entry ((kk nj + np) 32 +
// lane) holds the lane's b0, b1 of n-tile 2 np and of 2 np + 1 at k-step kk
// (rows 16 kk + 2t (+1), + 8 (+1); column g: key 16 np + 8 h + g)
template <int NTH>
__device__ __forceinline__ void build_onehot(uint4* E, int n, int nj, int H,
                                             int W) {
  const int fk16 = win_fk16(H, W), last = 16 * fk16 - 1;
  for (int i = threadIdx.x; i < fk16 * nj * 32; i += NTH) {
    const int lane = i & 31, np = (i >> 5) % nj, kk = (i >> 5) / nj;
    const int g = lane >> 2, t = lane & 3;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = 16 * np + 8 * h + g;
      const int kr = key / W, kc = key - kr * W;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 16 * kk + 2 * t + 8 * half + e;
          const bool hot = key < n ? (f == kr || f == H + kc) : f == last;
          v |= (hot ? BF16_ONE : 0u) << (16 * e);
        }
        w[2 * h + half] = v;
      }
    }
    E[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// F's columns from c0 on (past the factors): zero, and WIN_MASK in the last
// of the fk, for all nk rows, by a block of NTH threads
template <int NTH>
__device__ __forceinline__ void fill_mask_columns(bf16* F, int fld, int nk,
                                                  int c0, int fk) {
  const int w = fk - c0;
  for (int i = threadIdx.x; i < nk * w; i += NTH) {
    const int r = i / w, f = c0 + i - r * w;
    F[r * fld + f] = __float2bfloat16(f == fk - 1 ? WIN_MASK : 0.f);
  }
}

// One m16 query tile (rows q0 .. q0 + 15 of the window, staged in Qt, 16 x
// LDS) against all keys of its window at once: the one-pass softmax of the
// TPU _windowed_group_kernel. All 2 nj n8 score tiles in registers (q.k^T
// from the pre-scaled K, then the bias product F . E^T onto the same
// accumulators), the row max and denominator over the lane quad, then
// p / l rounded to bf16 (that kernel's (p / l).astype(bf16)) packed into A
// fragments and the p.v product; nothing is left to divide. Leaves the
// tile's output o (rows g, g + 8 of the lane: o[n-tile][0, 1] and [2, 3]),
// row maximum m and denominator l (m + log l is the row's logsumexp). NJ >=
// nj is the compile-time bound of the register arrays; EXACT instances take
// nj == NJ, so no product is guarded (the guards cost a branch and the
// fragment addresses again per block of products).
template <int NJ, bool EXACT>
__device__ __forceinline__ void window_tile_mma(
    const bf16* Qt, const bf16* Ks, const bf16* Vs, const bf16* F, int fld,
    const uint4* E, int fk16, int nj, int q0, int lane, float (*o)[4],
    float* m, float* l) {
  if (EXACT) nj = NJ;
  float s[2 * NJ][4];
#pragma unroll
  for (int j = 0; j < 2 * NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, Qt, 0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < NJ; ++np)
      if (np < nj) {
        uint32_t b[4];
        load_b_nk(b, Ks, 16 * np, 16 * kk, lane);
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
  }
  for (int kk = 0; kk < fk16; ++kk) {
    uint32_t a[4];
    load_a_ld(a, F, fld, q0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < NJ; ++np)
      if (np < nj) {
        const uint4 b = E[(kk * nj + np) * 32 + lane];
        mma16816(s[2 * np], a, b.x, b.y);
        mma16816(s[2 * np + 1], a, b.z, b.w);
      }
  }

  uint32_t pk[2 * NJ][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
      if (j < 2 * nj) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    m[r] = quad_max(mx);  // key 0 is real: finite
    const float mb = m[r] * LOG2E;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * r + e];
        x = j < 2 * nj ? exp2_approx(fmaf(x, LOG2E, -mb)) : 0.f;
        rs += x;
      }
    l[r] = quad_sum(rs);
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
      pk[j][r] = pack_bf16(s[j][2 * r] * inv, s[j][2 * r + 1] * inv);
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NJ; ++kk)
    if (kk < nj) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                             pk[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        load_b_kn(b, Vs, 16 * kk, 16 * np, lane);
        mma16816(o[2 * np], a, b[0], b[1]);
        mma16816(o[2 * np + 1], a, b[2], b[3]);
      }
    }
}

// The block's part after its loads of K, V (nk rows each), F and E were
// issued and committed: the warps' query tiles. Each warp stages its tiles'
// q rows through two 16 x LDS buffers of Qw (its own, 2 x 16 x LDS), the
// next tile's copy in flight while the current one computes:
// stage_q(dst, row0) issues the warp's cp.async copies of rows row0 ..
// row0 + 15; store(row0, o, m, l) writes a finished tile. Every thread of
// the block must call it (it synchronises).
template <int NJ, bool EXACT, int NTH, class StageQ, class Store>
__device__ __forceinline__ void window_tiles_mma(
    bf16* Qw, bf16* Ks, const bf16* Vs, const bf16* F, int fld,
    const uint4* E, int fk16, int nj, StageQ stage_q, Store store) {
  constexpr int WARPS_ = NTH / 32, QT = 16 * LDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* buf = Qw + warp * 2 * QT;
  if (warp < nj) stage_q(buf, 16 * warp);
  cp_commit();
  cp_wait<1>();  // K, V, F and E (all but the first q tile) have landed
  __syncthreads();
  scale_eighth<NTH>(Ks, 16 * nj);  // k / 8: exact, as the TPU's q * sc
  __syncthreads();
  int i = 0;
  for (int mt = warp; mt < nj; mt += WARPS_, ++i) {
    if (mt + WARPS_ < nj) stage_q(buf + ((i + 1) & 1) * QT, 16 * (mt + WARPS_));
    cp_commit();
    cp_wait<1>();  // this tile's q rows have landed
    __syncwarp();
    float o[D / 8][4], m[2], l[2];
    window_tile_mma<NJ, EXACT>(buf + (i & 1) * QT, Ks, Vs, F, fld, E, fk16,
                               nj, 16 * mt, lane, o, m, l);
    store(16 * mt, o, m, l);
    __syncwarp();  // every lane is done with this buffer before its refill
  }
}

// Shared memory of the windowed bf16 kernels for n keys of an H x W window
// and 32 warps threads, Tok excluded: K, V (nk x LDS), F (nk x (FK + 8)),
// E (FK nk / 16 x 32 uint4), Qw (warps x 2 x 16 x LDS)
__host__ __device__ __forceinline__ size_t window_smem(int n, int H, int W,
                                                      int warps) {
  const int nj = (n + 15) / 16, fk16 = win_fk16(H, W);
  return sizeof(bf16) * (size_t)(16 * nj) * (2 * LDS + 16 * fk16 + 8) +
         sizeof(uint4) * (size_t)fk16 * nj * 32 +
         sizeof(bf16) * (size_t)warps * 2 * 16 * LDS;
}

}  // namespace mma
}  // namespace attn
