// Tensor-core building blocks of the bf16 encoder attention kernels: the
// forward K1 (attention.cu, attn_global_mma_kernel) and the backward K5
// (attention_bwd.cu, attn_bwd_dq_mma_kernel / attn_bwd_dkv_mma_kernel).
//
// Every tile is 64 rows of one head (head dim 64) in bf16 in shared memory,
// rows padded to LDS = 72 elements (144 bytes): the eight 16-byte rows that
// one ldmatrix phase reads then start on eight different bank groups, so
// the loads are free of bank conflicts. A block is 4 warps; a warp owns 16
// rows of the block's tile and computes with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (f32 accumulators).
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane =
// 4 g + t: an accumulator n-tile c[4] holds rows g (c0, c1) and g + 8
// (c2, c3), columns 2t and 2t + 1. The A operand of a 16 x 16 step is
// a0 (row g, cols 2t..), a1 (row g + 8), a2 (row g, cols 2t + 8..),
// a3 (row g + 8, cols 2t + 8..): two neighbouring accumulator n-tiles,
// packed to bf16 pairs, are an A fragment, so p (or ds) goes from one
// product into the next without a trip through shared memory.

#pragma once

#include "attention_common.cuh"

namespace attn {
namespace mma {

constexpr int TILE = 64;      // rows of a query or key tile
constexpr int LDS = D + 8;    // padded shared row (bf16 elements; D = 64)
constexpr int WARPS = 4;      // a warp owns 16 rows of the tile
constexpr int NT = 32 * WARPS;
constexpr int TILE_ELEMS = TILE * LDS;
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

// The 16 x 16 A fragment at rows r0.., columns k0.. of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0.., n0 + 8..) over k0..k0 + 15 from a tile
// stored [n][k] (keys by head dim for q.k^T): b[0], b[1] for n-tile n0,
// b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDS + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (values by head dim for p.v), through
// the transposing ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + n0 +
                   (lane >> 4) * 8);
}

// acc[m][16][64] += A_m . B^T for M m-tiles of 16 rows, A_m the rows
// r0 + 16 m.. of a row-major shared tile, B a [64][64] tile stored [n][k]:
// the score product q.k^T (or dO.v^T, k.q^T, v.dO^T). Every B fragment
// loaded serves all M m-tiles.
template <int M>
__device__ __forceinline__ void product_nk(float (*acc)[TILE / 8][4],
                                                const bf16* a_tile, int r0,
                                                const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) load_a(a[m], a_tile, r0 + 16 * m, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      uint32_t b[4];
      load_b_nk(b, b_tile, 16 * np, 16 * kk, lane);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        mma16816(acc[m][2 * np], a[m], b[0], b[1]);
        mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// acc[m][16][64] += P_m[16][64 keys] . B[64 keys][64] for M m-tiles, P_m
// given as its 8 accumulator n-tiles packed to bf16 (pk[m][n-tile][0] rows
// g, [1] rows g + 8), B a tile stored [k][n]: p.v, ds.k, p^T.dO, ds^T.q.
template <int M>
__device__ __forceinline__ void product_kn(float (*acc)[D / 8][4],
                                           const uint32_t (*pk)[TILE / 8][2],
                                           const bf16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_kn(b, b_tile, 16 * kk, 16 * np, lane);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint32_t a[4] = {pk[m][2 * kk][0], pk[m][2 * kk][1],
                               pk[m][2 * kk + 1][0], pk[m][2 * kk + 1][1]};
        mma16816(acc[m][2 * np], a, b[0], b[1]);
        mma16816(acc[m][2 * np + 1], a, b[2], b[3]);
      }
    }
}

// rows [row0, row0 + rows) x 64 columns (`stride` elements per row) ->
// shared tile, asynchronously, by a block of NTH threads; rows at or past n
// are zero-filled
template <int NTH = NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int stride, int row0, int n,
                                                int rows = TILE) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += NTH) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * LDS + c, src + (size_t)(ok ? row0 + r : 0) * stride + c,
               ok);
  }
}

// Shared row length of a tile's bias factors (`len` values per query): a
// multiple of 8 is padded by 8 bf16 (16 bytes), so the 8 rows a warp reads
// at once start on different banks (64 -> 72: rows 36 words apart); any
// other length is left as it is (14 -> 7 words apart, already apart)
__host__ __device__ __forceinline__ int factor_ld(int len) {
  return len % 8 ? len : len + 8;
}

// A tile's bias factors, `rows` rows (a multiple of 8) of `len` values,
// `nrows` of them real and the rest zero, from src (row-major, `len` per
// row) -> shared rows of factor_ld(len), by a block of NTH threads:
// asynchronously in 16-byte pieces where src is 16-byte aligned (every ViT
// shape), else by plain loads
template <int NTH = NT>
__device__ __forceinline__ void load_factors(bf16* dst, const bf16* src,
                                             int len, int nrows,
                                             int rows = TILE) {
  const int ld = factor_ld(len), valid = nrows * len;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (aligned && ld != len) {  // padded rows, len % 8 == 0
    const int chunks = len / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += NTH) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const bool ok = r < nrows;
      cp_async16(dst + r * ld + c, src + (ok ? r * len + c : 0), ok);
    }
  } else if (aligned && valid % 8 == 0) {  // one contiguous run
    for (int i = threadIdx.x * 8; i < rows * len; i += NTH * 8)
      cp_async16(dst + i, src + (i < valid ? i : 0), i < valid);
  } else {
    for (int i = threadIdx.x; i < rows * len; i += NTH) {
      const int r = i / len, c = i - r * len;
      dst[r * ld + c] = i < valid ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// The grid row r and column c of the keys k0 + 8 j + 2 t + e (j < 8,
// e < 2) whose scores a lane holds in its accumulator columns, walked in
// that order: one division, then steps with wrap-around (W may be < 8).
struct KeyWalk {
  int r, c, W;
  __device__ __forceinline__ KeyWalk(int key, int w) : W(w) {
    r = key / w;
    c = key - r * w;
  }
  // on to the lane's next key: + 1 after e = 0, + 7 after e = 1 (the next
  // j's e = 0)
  __device__ __forceinline__ void step(int e) {
    c += e ? 7 : 1;
    while (c >= W) {
      c -= W;
      ++r;
    }
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace attn
