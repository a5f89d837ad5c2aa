// Tensor-core building blocks of the bf16 decoder backward kernels: the
// image->token attention K4 (decoder_attn.cu, i2t_bwd_rows_kernel /
// i2t_bwd_dw_kernel) and the upscaler K3 (upscaler.cu,
// upscale_bwd_rows_kernel / upscale_bwd_dw_kernel).
//
// Each backward is two launches:
//   * a row pass: persistent blocks of 8 warps (one block per SM) hold the
//     layer's weights in shared memory (bf16, rows padded by 8 elements,
//     read in both orientations with ldmatrix / ldmatrix.trans); a pair of
//     warps walks 16-row tiles (RowTile), each warp owning the tile's rows
//     across its share of the columns, so the LayerNorms reduce over a lane
//     quad, the warp's own n-tiles and, where a row spans both warps, one
//     exchange through shared memory. Every product is mma.sync m16n8k16
//     (or m16n8k8 over <= 8 tokens) bf16 -> f32, chained from accumulator
//     to A fragment where the operand is a rounding point of the JAX
//     kernel. The small per-column gradients (biases, LayerNorm) are summed
//     over a tile's 16 rows by group_sum8 and over the pair's tiles in
//     registers or shared memory: one partial per pair, summed by the
//     wrapper.
//   * a weight pass (dw_* below): a split-K product over rows. A block of 8
//     warps owns a chunk of rows and one 128 x 256 output tile (64 x 64 per
//     warp, 128 accumulator registers), streams the chunk through a
//     cp.async ring of DW_STAGES stages of DW_SR rows and writes one f32
//     partial; the wrapper sums the partials in a fixed order. No atomics:
//     the gradients repeat bit for bit.
// The row pass writes the operands of the weight gradients as bf16 rows.
// Each is a bf16 rounding point of the JAX kernel, so the bf16 scratch
// loses nothing and every tensor-core term is exact; only the order of
// the f32 sums differs from the plain versions.

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

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// The tiles of the row pass: 16-row tiles of each pair's m rows, pair-major;
// slot s of the grid (a warp pair) takes tiles s, s + (slots of the grid), ...
struct RowTile {
  int pair, row0;
  size_t prow0;  // the tile's first row in the (pairs x m) row arrays
  __device__ __forceinline__ RowTile(int tile, int tpp, int m) {
    pair = tile / tpp;
    row0 = (tile - pair * tpp) * 16;
    prow0 = (size_t)pair * m + row0;
  }
};

// 16 rows x W columns (bf16, W elements per row) -> a slot's shared tile (LD
// elements per row), by the slot's 64 threads (pl = 32 sub + lane),
// asynchronously; rows at or past `valid` zero-filled
template <int W, int LD>
__device__ __forceinline__ void slot_rows_async(bf16* dst, const bf16* src,
                                                int valid, int pl) {
  for (int i = pl; i < 16 * (W / 8); i += 64) {
    const int r = i / (W / 8), c = (i - r * (W / 8)) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r * W + c : 0), ok);
  }
}

// R x W bf16 (row-major, W per row) -> shared rows of LD, by a whole block
// of NTH threads, asynchronously
template <int R, int W, int LD, int NTH>
__device__ __forceinline__ void block_weights_async(bf16* dst,
                                                    const bf16* src) {
  for (int i = threadIdx.x; i < R * (W / 8); i += NTH) {
    const int r = i / (W / 8), c = (i - r * (W / 8)) * 8;
    cp_async16(dst + r * LD + c, src + (size_t)r * W + c, true);
  }
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
