// Tensor-core building blocks of the bf16 decoder kernels on mma.sync and
// the row helpers their wgmma kernels share: the image->token attention K4
// (decoder_attn.cu: i2t_fwd_wgmma_kernel keeps its per-head products on
// mma.sync; i2t_bwd_rows_wgmma_kernel and i2t_bwd_dw_wgmma_kernel take
// group_sum8 and the row helpers from here) and the upscaler K3
// (upscaler.cu: upscale_fwd_wgmma_kernel's hypernetwork sum on mma.sync,
// upscale_bwd_rows_wgmma_kernel's column sums and row stores, and the bf16
// weight pass upscale_bwd_dw_kernel).
//
// Each backward is two launches:
//   * a row pass (on wgmma, see the kernels): it recomputes the chain per
//     row and writes the operands of the weight gradients as bf16 rows; the
//     small per-column gradients (biases, LayerNorm) are summed over a
//     warp's 16 rows by group_sum8 and over its units in registers: one
//     partial per block and warp, summed by the wrapper.
//   * a weight pass (dw_* below, K3's): a split-K product over rows. A
//     block of 8 warps owns a chunk of rows and one 128 x 256 output tile
//     (64 x 64 per warp, 128 accumulator registers), streams the chunk
//     through a cp.async ring of DW_STAGES stages of DW_SR rows and writes
//     one f32 partial; the wrapper sums the partials in a fixed order. No
//     atomics: the gradients repeat bit for bit.
// Each scratch row is a bf16 rounding point of the JAX kernel, so the bf16
// scratch loses nothing and every tensor-core term is exact; only the order
// of the f32 sums differs from the plain versions.

#pragma once

#include "attention_mma.cuh"

namespace dec {

using attn::mma::bf16;
using attn::mma::cp_async16;
using attn::mma::cp_commit;
using attn::mma::cp_wait;
using attn::mma::ldsm_x4_t;
using attn::mma::load_a;
using attn::mma::load_b_kn;
using attn::mma::load_b_nk;
using attn::mma::mma16816;
using attn::mma::pack_bf16;
using attn::mma::quad_max;
using attn::mma::quad_sum;
using attn::mma::round_bf16;

constexpr int DW_WARPS = 8;               // warps per weight-pass block
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_SR = 32;                 // rows per stage of the weight pass
constexpr int DW_STAGES = 3;

// c += a . b on the tensor cores (16 x 8 += 16 x 8 . 8 x 8): a0 rows g,
// a1 rows g + 8 (columns 2t, 2t + 1); b0 rows 2t, 2t + 1, column g
__device__ __forceinline__ void mma1688(float* c, uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The 16 x 16 A fragment of X^T at rows (of X^T) m0.., columns k0.., from a
// tile X stored [k][m] (LD elements per row), through the transposing
// ldmatrix: the weight pass's A operand, rows of the row-major scratch.
template <int LD>
__device__ __forceinline__ void load_a_t(uint32_t* a, const bf16* tile,
                                         int m0, int k0, int lane) {
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + (lane >> 4) * 8) * LD + m0 +
                   ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two addresses -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Column sums over a tile's 16 rows of one group of four accumulator
// n-tiles. v[2 j + e] is the lane's value of n-tile j of the group, column
// 2t + e, already summed over its two rows (g, g + 8); the eight lanes that
// share t are summed by a reduce-scatter (4 + 2 + 1 shuffles), after which
// the lane with g holds the sum of v[g]: column 8 (4 grp + g / 2) + 2t +
// (g & 1) of the group grp (group_col).
__device__ __forceinline__ float group_sum8(const float (&v)[8], int lane) {
  const int g = lane >> 2;
  float w[4], u[2];
  bool hi = g & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = (hi ? v[j + 4] : v[j]) +
           __shfl_xor_sync(0xffffffffu, hi ? v[j] : v[j + 4], 16);
  hi = g & 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    u[j] = (hi ? w[j + 2] : w[j]) +
           __shfl_xor_sync(0xffffffffu, hi ? w[j] : w[j + 2], 8);
  hi = g & 1;
  return (hi ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, hi ? u[0] : u[1], 4);
}

__device__ __forceinline__ int group_col(int grp, int lane) {
  const int g = lane >> 2;
  return 8 * (4 * grp + (g >> 1)) + 2 * (lane & 3) + (g & 1);
}

// A 4 x 4 transpose of 32-bit words within each lane quad: on entry lane t
// holds x[j] = word (t, j), on exit x[s] = word (s, t). For packed
// accumulators of four neighbouring n-tiles (word j: n-tile j, columns
// 2t, 2t + 1 of one row), lane t ends with the eight columns of n-tile t:
// a 16-byte row segment. Two exchanges (lanes t ^ 2, then t ^ 1), each
// swapping the two words whose index differs from t in that bit.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
#pragma unroll
  for (int mask = 2; mask >= 1; mask >>= 1) {
    const bool hi = t & mask;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u & mask) continue;
      // the pair (u, u | mask): swap the word whose bit differs from t's
      const uint32_t send = hi ? x[u] : x[u | mask];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, mask);
      if (hi)
        x[u] = got;
      else
        x[u | mask] = got;
    }
  }
}

__device__ __forceinline__ float2 up2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Four packed words of a row, n-tiles j0..j0 + 3 (columns 8 j + 2t, + 1
// each), to the row's columns 8 j0.. as one 16-byte segment a lane (n-tile
// j0 + t), by a 4 x 4 transpose over the lane quad: a warp writes whole
// 64-byte runs of 8 rows instead of 4-byte pieces, which cost the memory
// system a partial sector each. Every lane of the quad takes part; `ok`
// guards the store alone.
__device__ __forceinline__ void store_quad(bf16* row, bool ok,
                                           uint32_t (&w)[4], int t) {
  quad_transpose(w, t);
  if (ok)
    *reinterpret_cast<uint4*>(row + 8 * t) = make_uint4(w[0], w[1], w[2],
                                                        w[3]);
}

// ------------------------------------------------------ weight pass ----
// acc[mi][nj] (64 x 64: m-tiles mi < 4, n8 tiles nj < 8) += X[:, a0 + m]^T
// . Y[:, b0 + n] over the DW_SR rows of one stage, X stored [rows][LDA],
// Y [rows][LDB]. Each B fragment serves the warp's four m-tiles.
template <int LDA, int LDB>
__device__ __forceinline__ void dw_stage_mma(float (*acc)[8][4],
                                             const bf16* xs, int a0,
                                             const bf16* ys, int b0,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < DW_SR / 16; ++kk) {
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      load_a_t<LDA>(a[mi], xs, a0 + 16 * mi, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_kn<LDB>(b, ys, 16 * kk, b0 + 16 * np, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        mma16816(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma16816(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The block's chunk of rows [lo, hi) through the ring: load(stage, r0)
// issues the cp.async copies of rows r0 .. r0 + DW_SR - 1 of stage
// `stage` (zero past hi); prep(stage) runs on each stage after it landed
// (every thread, then a barrier); mma(stage) is the warp's product. Every
// thread of the block calls it.
template <class Load, class Prep, class Mma>
__device__ __forceinline__ void dw_ring(int lo, int hi, Load load, Prep prep,
                                        Mma mma) {
  const int nst = (hi - lo + DW_SR - 1) / DW_SR;
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < nst) load(s, lo + s * DW_SR);
    cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_wait<DW_STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free again
    const int nxt = s + DW_STAGES - 1;
    if (nxt < nst) load(nxt % DW_STAGES, lo + nxt * DW_SR);
    cp_commit();
    if (prep(s % DW_STAGES)) __syncthreads();
    mma(s % DW_STAGES);
  }
}

// a warp's 64 x 64 accumulators -> out[(m) * ld + n] from out + base
__device__ __forceinline__ void dw_store(float* out, int ld,
                                         float (*acc)[8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (size_t)(16 * mi + g + 8 * h) * ld +
                                   8 * nj + 2 * t) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
}

}  // namespace dec
