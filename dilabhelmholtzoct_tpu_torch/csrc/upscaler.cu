// SAM mask-decoder upscaler fused with the hypernetwork product (K3).
//
// Per embedding row (one (image, prompt) pair p, one grid cell):
//
//   u1pre[de, c1] = up . W1[:, de, c1] + b1[c1]                 (f32)
//   y             = LayerNorm over the 64 c1 lanes of each de   (f32)
//   u1g           = rnd(gelu(rnd(y * g + bt)))
//   u2pre[de, fg, c2] = u1g[de, :] . W2[:, fg, c2] + b2[c2]     (f32)
//   u2g           = rnd(gelu(rnd(u2pre)))
//   out[t, de, fg] = sum_c2 u2g[de, fg, c2] * hyper[p, t, c2]   (f32)
//
// with C = 256 input channels, C1 = 64, C2 = 32, de = (d, e) and fg = (f, g)
// the two 2x2 upscale offsets, rnd() the rounding to the input type
// (identity for float) and gelu the tanh form for bf16, the erf form for f32
// (the JAX package's rounding points, ops/upscaler.py:77-138).
//
// The forward replaces dilabhelmholtzoct_tpu/ops/upscaler.py _fused_fwd
//    (:295, body _fwd_kernel :119-138, math _chain_fwd :77-99): persistent
//    8-warp blocks, a warp pair per 16-row slot.
//    * bf16 (the training path): upscale_fwd_mma_kernel on the tensor
//      cores, W1 and W2 in shared memory, the next tile's rows copied in
//      while this one computes.
//    * f32 (reached with set_fused_upscaler('interpret')):
//      upscale_fwd_tf32_kernel in split TF32 (decoder_tf32.cuh), super-tiles
//      of 64 rows streaming W1 through a cp.async ring, W2 in the ring's
//      space once the first product is done.
// The backward replaces the same file's _fused_bwd (:329, body _bwd_kernel
//    :141-243) with two launches: a row pass recomputes the chain per row,
//    writes d_up per row and the scratch rows u1g, rnd(d_u2pre) and
//    rnd(d_u1pre), and sums the vector gradients over rows; a weight pass
//    forms dW1 = sum_r up^T rnd(d_u1pre) and dW2[de] = sum_r u1g[de]^T
//    rnd(d_u2pre)[de], split-K over row chunks. The JAX kernel carries the
//    sums in output blocks across its sequential grid; here blocks run in
//    parallel, so every sum over rows is one partial per slot, tile or
//    chunk, added up by the wrapper in a fixed order -- no atomics, so the
//    gradients repeat bit for bit from run to run.
//    * bf16: upscale_bwd_rows_kernel (W1 and W2 in shared memory, a warp
//      pair per 16-row tile) and upscale_bwd_dw_kernel (decoder_mma.cuh).
//    * f32: upscale_bwd_rows_tf32_kernel (super-tiles of 64 rows streaming
//      W1 and W1^T) and upscale_bwd_dw_tf32_kernel, in split TF32; rnd() is
//      the identity, so the scratch rows are f32.
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096 rows):
//    forward 198 kFLOP/row = 51.8 GFLOP, over 989 TFLOP/s (bf16) = 0.052 ms,
//    over split TF32's 165 TFLOP/s (f32, 495 / 3) 0.31 ms (bytes: up in,
//    masks out, 0.045 ms in bf16, 0.085 in f32); backward 592 kFLOP/row =
//    155 GFLOP = 0.157 ms in bf16, 0.94 ms in split TF32 (bytes ~0.09 /
//    0.17 ms). Operation-bound; on the CUDA cores (67 TFLOP/s f32) the
//    bound is 2.5x the split-TF32 one. The scratch rows between the two
//    launches (written and read once) add 536 MB in bf16, 1.07 GB in f32
//    (chip_smoke.py::k3_bound_ms bounds each launch with them).
// What this design does about it: the 268 MB second upscale stays in shared
//    memory and registers (as on the TPU). Every product runs on the tensor
//    cores: the first and second products per (d, e) block (the second by
//    halves of 64 lanes), the hypernetwork sum over c2 against hyper^T, and
//    in the backward d_u1g = rnd(d_u2pre) . W2^T and d_up = rnd(d_u1pre) .
//    W1^T; bf16 as mma.sync bf16 -> f32 (each operand a bf16 rounding point
//    of the JAX kernel, so each term is exact), f32 as hi.hi + hi.lo + lo.hi
//    on m16n8k8 TF32 with the GELU in its erf form and exact derivative.
//    The LayerNorms, GELUs and their backwards run in f32 registers over a
//    lane quad. The second product runs per (d, e) block of W2 (64 x 128),
//    not as the TPU's 256 x 512 Kronecker expansion; LayerNorm reduces its
//    64 lanes with shuffles, not selector matmuls. In f32, W1 (256 KB)
//    does not fit in shared memory; streaming it per 64-row super-tile
//    reads each byte from L2 once for 64 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decoder_tf32.cuh"

namespace {

constexpr int C = 256;          // input channels (every SAM decoder)
constexpr int C1 = C / 4;       // channels after the first upscale
constexpr int C2 = C / 8;       // channels after the second upscale
constexpr int L1 = 4 * C1;      // lanes (d, e, c1) of the first upscale
constexpr int LQ = 4 * C2;      // lanes (f, g, c2) of one (d, e) block
constexpr int MAXT = 4;         // mask tokens per pair

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kKappa = 0.044715f;

template <typename T>
__device__ __forceinline__ float gelu(float x) {
  if (std::is_same<T, __nv_bfloat16>::value)
    return 0.5f * x * (1.f + tanhf(kSqrt2OverPi * (x + kKappa * x * x * x)));
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

template <typename T>
__device__ __forceinline__ float gelu_grad(float x) {
  if (std::is_same<T, __nv_bfloat16>::value) {
    const float x2 = x * x;
    const float t = tanhf(kSqrt2OverPi * (x + kKappa * x * x2));
    const float di = kSqrt2OverPi * (1.f + 3.f * kKappa * x2);
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * di;
  }
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;
}

// ------------------------------------------ bf16 backward, two passes ----
using dec::bf16;
using dec::ld_bf2;
using dec::st_bf2;

constexpr int LD1 = L1 + 8;   // shared row of W1 [C][L1] and of a warp's tile
constexpr int LD2 = LQ + 8;   // shared row of W2 [C1][LQ]
constexpr int SLOTS = 4;          // tiles in flight per block: a warp pair each
constexpr int RT = 64 * SLOTS;     // threads per row-pass block
constexpr int CS = 4 * LQ + L1;    // a slot's per-column sums: db2, db1
constexpr size_t ROWS_SMEM =
    sizeof(bf16) * (size_t)(C * LD1 + C1 * LD2 + SLOTS * 2 * 16 * LD1) +
    sizeof(float) * (size_t)SLOTS * CS;
constexpr size_t FWD_MMA_SMEM =
    sizeof(bf16) * (size_t)(C * LD1 + C1 * LD2 + SLOTS * 2 * 16 * LD1);

// gelu (tanh form) of x and its derivative from one tanh
__device__ __forceinline__ float gelu_and_grad(float x, float* grad) {
  const float t = tanhf(kSqrt2OverPi * (x + kKappa * x * x * x));
  *grad = 0.5f * (1.f + t) +
          0.5f * x * (1.f - t * t) * (kSqrt2OverPi * (1.f + 3.f * kKappa * x * x));
  return 0.5f * x * (1.f + t);
}

// acc[(de) block] += v where de is known only at run time: a select per
// block, so the accumulators stay in registers
template <int N>
__device__ __forceinline__ void add_at(float (&acc)[4 * N], int de, int i,
                                       float v) {
#pragma unroll
  for (int d = 0; d < 4; ++d)
    if (d == de) acc[d * N + i] += v;
}

// The forward chain's pieces that the forward kernel and the backward's row
// pass share. Lane = 4 g + t holds rows g and g + 8 of every accumulator
// n-tile, columns 2t, 2t + 1.

// (d, e) block de of the first upscale for a 16-row tile: u1pre = up . W1
// + b1 over its 64 lanes (up u_s [16][LD1], W1 w1_s), the LayerNorm over
// them (mean, then the centred variance; f32): y in a1, 1/std of rows g,
// g + 8 in rs; and u1g = rnd(gelu(rnd(y g + bt))) as the A fragments of
// the second product (one k16 step per two n-tiles)
__device__ __forceinline__ void first_block(float (&a1)[8][4], float (&rs)[2],
                                            uint32_t (&ua)[4][4],
                                            const bf16* u_s, const bf16* w1_s,
                                            const float* b1, const float* g,
                                            const float* bt, int de,
                                            float eps, int lane) {
  using namespace dec;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) a1[j][0] = a1[j][1] = a1[j][2] = a1[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4];
    load_a<LD1>(a, u_s, 0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_kn<LD1>(b, w1_s, 16 * kk, C1 * de + 16 * np, lane);
      mma16816(a1[2 * np], a, b[0], b[1]);
      mma16816(a1[2 * np + 1], a, b[2], b[3]);
    }
  }
  float su0 = 0.f, su1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    a1[j][0] += b1[c];
    a1[j][1] += b1[c + 1];
    a1[j][2] += b1[c];
    a1[j][3] += b1[c + 1];
    su0 += a1[j][0] + a1[j][1];
    su1 += a1[j][2] + a1[j][3];
  }
  const float mu0 = quad_sum(su0) * (1.f / C1);
  const float mu1 = quad_sum(su1) * (1.f / C1);
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a1[j][0] -= mu0;
    a1[j][1] -= mu0;
    a1[j][2] -= mu1;
    a1[j][3] -= mu1;
    v0 = fmaf(a1[j][0], a1[j][0], fmaf(a1[j][1], a1[j][1], v0));
    v1 = fmaf(a1[j][2], a1[j][2], fmaf(a1[j][3], a1[j][3], v1));
  }
  rs[0] = rsqrtf(quad_sum(v0) * (1.f / C1) + eps);
  rs[1] = rsqrtf(quad_sum(v1) * (1.f / C1) + eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float g0 = g[c], g1 = g[c + 1], t0 = bt[c], t1 = bt[c + 1];
    a1[j][0] *= rs[0];
    a1[j][1] *= rs[0];
    a1[j][2] *= rs[1];
    a1[j][3] *= rs[1];
    ua[j / 2][(j & 1) * 2] =
        pack_bf16(gelu<bf16>(round_bf16(a1[j][0] * g0 + t0)),
                  gelu<bf16>(round_bf16(a1[j][1] * g1 + t1)));
    ua[j / 2][(j & 1) * 2 + 1] =
        pack_bf16(gelu<bf16>(round_bf16(a1[j][2] * g0 + t0)),
                  gelu<bf16>(round_bf16(a1[j][3] * g1 + t1)));
  }
}

// the second product of one (d, e) block by halves of 64 lanes (f, g, c2):
// a2 = u1g . W2[:, 64 half..] (f32)
__device__ __forceinline__ void second_half(float (&a2)[8][4],
                                            const uint32_t (&ua)[4][4],
                                            const bf16* w2_s, int half,
                                            int lane) {
  using namespace dec;
#pragma unroll
  for (int j = 0; j < 8; ++j) a2[j][0] = a2[j][1] = a2[j][2] = a2[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C1 / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_kn<LD2>(b, w2_s, 16 * kk, 64 * half + 16 * np, lane);
      mma16816(a2[2 * np], ua[kk], b[0], b[1]);
      mma16816(a2[2 * np + 1], ua[kk], b[2], b[3]);
    }
}

// The bf16 forward. Persistent blocks of SLOTS warp pairs (one block per
// SM) hold W1 [C][LD1] and W2 [C1][LD2] in shared memory; a pair walks
// 16-row tiles, warp `sub` taking the (d, e) blocks 2 sub, 2 sub + 1. Per
// slot two stages of up rows [16][LD1]: the next tile's rows are copied in
// while this tile computes. Per (d, e) block: the first product, its
// LayerNorm and GELU (u1g kept as A fragments); once both warps are done
// with the up rows their stage holds the tile's output rows [16][n_out *
// 16] (f32); then by halves of 64 lanes (two (f, g)): the second product,
// u2g = rnd(gelu(rnd(u2pre + b2))), and the hypernetwork sum over c2 as
// m16n8k16 products of u2g (16 rows x 32 c2 per (f, g)) against hyper^T
// (32 c2 x 8 mask tokens, zero past n_out). The tile's output rows are
// contiguous in device memory and leave in 16-byte stores.
__global__ void __launch_bounds__(RT, 1)
    upscale_fwd_mma_kernel(const bf16* up, const bf16* w1, const float* b1,
                           const float* g, const float* bt, const bf16* w2,
                           const float* b2, const bf16* hyper, float* out,
                           int bp, int m, int n_out, float eps) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* w2_s = w1_s + C * LD1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1, pl = 32 * sub + lane;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* stage0 = w2_s + C1 * LD2 + slot * 2 * 16 * LD1;
  auto pair_sync = [&] {  // the pair's own barrier (0 is __syncthreads)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };
  const int tpp = (m + 15) / 16, ntiles = bp * tpp, lanes = n_out * 16;
  const int stride = gridDim.x * SLOTS;
  auto load = [&](int tile, bf16* dst) {
    const RowTile tl(tile, tpp, m);
    slot_rows_async<C, LD1>(dst, up + tl.prow0 * C, min(16, m - tl.row0), pl);
  };

  int tile = blockIdx.x * SLOTS + slot;
  block_weights_async<C, L1, LD1, RT>(w1_s, w1);
  block_weights_async<C1, LQ, LD2, RT>(w2_s, w2);
  if (tile < ntiles) load(tile, stage0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (int it = 0; tile < ntiles; tile += stride, ++it) {
    bf16* u_s = stage0 + (it & 1) * 16 * LD1;
    cp_wait<0>();
    pair_sync();  // the tile's up rows landed; the other stage is free
    if (tile + stride < ntiles)
      load(tile + stride, stage0 + ((it + 1) & 1) * 16 * LD1);
    cp_commit();
    const RowTile tl(tile, tpp, m);
    const int valid = min(16, m - tl.row0);

    uint32_t ua[2][4][4];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      float a1[8][4], rs[2];
      first_block(a1, rs, ua[d], u_s, w1_s, b1, g, bt, 2 * sub + d, eps,
                  lane);
    }
    // hyper^T as B fragments, one per k16 step of c2: column = mask token
    const bf16* hy = hyper + ((size_t)tl.pair * n_out + gq) * C2;
    const bool tok = gq < n_out;
    uint32_t hb[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      hb[kk][0] = tok ? ld_u32(hy + 16 * kk + 2 * tq) : 0u;
      hb[kk][1] = tok ? ld_u32(hy + 16 * kk + 8 + 2 * tq) : 0u;
    }
    pair_sync();  // both warps are done with the up rows
    float* o_s = reinterpret_cast<float*>(u_s);  // [16][lanes]
    const bool t0 = 2 * tq < n_out, t1 = 2 * tq + 1 < n_out;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * sub + d;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a2[8][4];
        second_half(a2, ua[d], w2_s, half, lane);
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {  // a group of 4 n-tiles is one (f, g)
          const int fg = 2 * half + hg;
          uint32_t ha[2][4];  // u2g of (f, g): A fragments, k16 steps of c2
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * hg + jj, c2 = 8 * jj + 2 * tq;
            const float b0 = b2[c2], b1v = b2[c2 + 1];
            ha[jj / 2][(jj & 1) * 2] =
                pack_bf16(gelu<bf16>(round_bf16(a2[j][0] + b0)),
                          gelu<bf16>(round_bf16(a2[j][1] + b1v)));
            ha[jj / 2][(jj & 1) * 2 + 1] =
                pack_bf16(gelu<bf16>(round_bf16(a2[j][2] + b0)),
                          gelu<bf16>(round_bf16(a2[j][3] + b1v)));
          }
          float o[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(o, ha[0], hb[0][0], hb[0][1]);
          mma16816(o, ha[1], hb[1][0], hb[1][1]);
          // o: rows g (o[0..1]), g + 8 (o[2..3]); tokens 2t, 2t + 1
          const int l = 2 * tq * 16 + de * 4 + fg;
          if (t0) {
            o_s[gq * lanes + l] = o[0];
            o_s[(gq + 8) * lanes + l] = o[2];
          }
          if (t1) {
            o_s[gq * lanes + l + 16] = o[1];
            o_s[(gq + 8) * lanes + l + 16] = o[3];
          }
        }
      }
    }
    pair_sync();  // o_s holds the tile's output rows
    const float4* src = reinterpret_cast<const float4*>(o_s);
    float4* dst = reinterpret_cast<float4*>(out + tl.prow0 * lanes);
    for (int i = pl; i < valid * lanes / 4; i += 64) dst[i] = src[i];
  }
}

// The row pass. A pair of warps shares each 16-row tile (a slot): warp
// `sub` of the pair takes the (d, e) blocks 2 sub, 2 sub + 1 and the d_up
// channels 128 sub.., so a block holds 8 warps on 4 slots. Shared memory:
// W1 [C][LD1] and W2 [C1][LD2] (k by n for the forward products, n by k
// for the backward ones), per slot its tile's up rows and rnd(d_u1pre)
// rows [16][LD1] each, and its per-column sums of db2 and db1 (group_sum8
// layout, each entry owned by one lane; dg and dbt in registers). Per
// (d, e) block: the 64 lanes of the first product, their LayerNorm and
// GELU, the second product by halves of 64 lanes (two (f, g)), its GELU,
// the hypernetwork terms, d_u2pre and its share of d_u1g; then back to
// rnd(d_u1pre). No accumulator is wider than 64 registers. Lane = 4 g + t
// holds rows g and g + 8 of every accumulator n-tile, columns 2t, 2t + 1.
__global__ void __launch_bounds__(RT, 1)
    upscale_bwd_rows_kernel(const bf16* up, const float* dm, const bf16* w1,
                            const float* b1, const float* g, const float* bt,
                            const bf16* w2, const float* b2, const bf16* hyper,
                            bf16* d_up, bf16* u1g_rows, bf16* d2_rows,
                            bf16* du1_rows, float* db1_p, float* dg_p,
                            float* dbt_p, float* db2_p, float* dht_t, int bp,
                            int m, int n_out, float eps) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* w2_s = w1_s + C * LD1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1, pl = 32 * sub + lane;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* u_s = w2_s + C1 * LD2 + slot * 2 * 16 * LD1;
  bf16* d_s = u_s + 16 * LD1;
  float* cs0 = reinterpret_cast<float*>(w2_s + C1 * LD2 + SLOTS * 2 * 16 * LD1);
  float* cs = cs0 + slot * CS;  // db2 [4 LQ], db1 [L1]
  // the pair's own barrier (0 is __syncthreads)
  auto pair_sync = [&] {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };

  block_weights_async<C, L1, LD1, RT>(w1_s, w1);
  block_weights_async<C1, LQ, LD2, RT>(w2_s, w2);
  cp_commit();
  for (int i = threadIdx.x; i < SLOTS * CS; i += RT) cs0[i] = 0.f;
  cp_wait<0>();
  __syncthreads();

  const int tpp = (m + 15) / 16, ntiles = bp * tpp, lanes = n_out * 16;
  float a_dg[8], a_dbt[8];  // per (d, e) two groups (group_sum8 layout)
#pragma unroll
  for (int i = 0; i < 8; ++i) a_dg[i] = a_dbt[i] = 0.f;

  for (int tile = blockIdx.x * SLOTS + slot; tile < ntiles;
       tile += gridDim.x * SLOTS) {
    const RowTile tl(tile, tpp, m);
    const int valid = min(16, m - tl.row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    const size_t r0 = tl.prow0 + gq, r1 = r0 + 8;  // the lane's two rows
    slot_rows_async<C, LD1>(u_s, up + tl.prow0 * C, valid, pl);
    cp_commit();
    cp_wait<0>();
    pair_sync();
    const bf16* hy = hyper + (size_t)tl.pair * n_out * C2;
    const float* dm0 = dm + r0 * lanes;
    const float* dm1 = dm + r1 * lanes;

#pragma unroll 1
    for (int de = 2 * sub; de < 2 * sub + 2; ++de) {
      // first product, the 64 lanes (de, c1), its LayerNorm (y in a1) and
      // u1g as the second product's A fragments; u1g to the scratch rows
      float a1[8][4], rs[2];
      uint32_t ua[4][4];
      first_block(a1, rs, ua, u_s, w1_s, b1, g, bt, de, eps, lane);
      const float rs0 = rs[0], rs1 = rs[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (ok0) *reinterpret_cast<uint32_t*>(u1g_rows + r0 * L1 + C1 * de + c) = ua[j / 2][(j & 1) * 2];
        if (ok1) *reinterpret_cast<uint32_t*>(u1g_rows + r1 * L1 + C1 * de + c) = ua[j / 2][(j & 1) * 2 + 1];
      }
      // the second product by halves of 64 lanes (f, g, c2); per half: its
      // GELU, the hypernetwork terms, d_u2pre, and d_u1g += rnd(d_u2pre) .
      // W2^T over those lanes
      float a3[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) a3[j][0] = a3[j][1] = a3[j][2] = a3[j][3] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a2[8][4];
        second_half(a2, ua, w2_s, half, lane);
        uint32_t da[4][4];  // rnd(d_u2pre): A fragments, k16 steps of q
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {  // a group of 4 n-tiles is one (f, g)
          const int fg = 2 * half + hg;
          float dmv[2][MAXT];
#pragma unroll
          for (int t = 0; t < MAXT; ++t) {
            const int l = t * 16 + de * 4 + fg;
            dmv[0][t] = (t < n_out && ok0) ? dm0[l] : 0.f;
            dmv[1][t] = (t < n_out && ok1) ? dm1[l] : 0.f;
          }
          float ug[4][4], vb2[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * hg + jj, c2 = 8 * jj + 2 * tq;
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // rows g (e < 2), g + 8; column e & 1
              const float u2r = round_bf16(a2[j][e] + b2[c2 + (e & 1)]);
              float grad;
              ug[jj][e] = round_bf16(gelu_and_grad(u2r, &grad));
              float du = 0.f;
#pragma unroll
              for (int t = 0; t < MAXT; ++t)
                if (t < n_out)
                  du = fmaf(dmv[e >> 1][t],
                            __bfloat162float(hy[t * C2 + c2 + (e & 1)]), du);
              a2[j][e] = du * grad;  // d_u2pre, f32
            }
            vb2[2 * jj] = a2[j][0] + a2[j][2];
            vb2[2 * jj + 1] = a2[j][1] + a2[j][3];
            da[j / 2][(j & 1) * 2] = pack_bf16(a2[j][0], a2[j][1]);
            da[j / 2][(j & 1) * 2 + 1] = pack_bf16(a2[j][2], a2[j][3]);
            const int q = LQ * de + 64 * half + 8 * j + 2 * tq;
            if (ok0) *reinterpret_cast<uint32_t*>(d2_rows + r0 * 4 * LQ + q) = da[j / 2][(j & 1) * 2];
            if (ok1) *reinterpret_cast<uint32_t*>(d2_rows + r1 * 4 * LQ + q) = da[j / 2][(j & 1) * 2 + 1];
          }
          cs[LQ * de + 32 * fg + group_col(0, lane)] += group_sum8(vb2, lane);
          // d_hyper of this tile: sum over its rows of dm * u2g
          float* ht = dht_t + (size_t)tile * n_out * 4 * LQ + LQ * de +
                      32 * fg + group_col(0, lane);
#pragma unroll
          for (int t = 0; t < MAXT; ++t)
            if (t < n_out) {
              float vh[8];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                vh[2 * jj] = dmv[0][t] * ug[jj][0] + dmv[1][t] * ug[jj][2];
                vh[2 * jj + 1] = dmv[0][t] * ug[jj][1] + dmv[1][t] * ug[jj][3];
              }
              ht[(size_t)t * 4 * LQ] = group_sum8(vh, lane);
            }
        }
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int np = 0; np < C1 / 16; ++np) {
            uint32_t b[4];
            load_b_nk<LD2>(b, w2_s, 16 * np, 64 * half + 16 * kq, lane);
            mma16816(a3[2 * np], da[kq], b[0], b[1]);
            mma16816(a3[2 * np + 1], da[kq], b[2], b[3]);
          }
      }
      // GELU and LayerNorm-affine backward: d_out1 in place
      float sa0 = 0.f, sb0 = 0.f, sa1 = 0.f, sb1 = 0.f;
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vg[8], vt[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * tq;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gc = g[c + (e & 1)];
            const float y = a1[j][e];
            const float d1 = a3[j][e] * gelu_grad<bf16>(round_bf16(y * gc + bt[c + (e & 1)]));
            a3[j][e] = d1;
            const float dyv = d1 * gc;
            if (e < 2) {
              sa0 += dyv;
              sb0 = fmaf(dyv, y, sb0);
            } else {
              sa1 += dyv;
              sb1 = fmaf(dyv, y, sb1);
            }
          }
          vg[2 * jj] = a3[j][0] * a1[j][0] + a3[j][2] * a1[j][2];
          vg[2 * jj + 1] = a3[j][1] * a1[j][1] + a3[j][3] * a1[j][3];
          vt[2 * jj] = a3[j][0] + a3[j][2];
          vt[2 * jj + 1] = a3[j][1] + a3[j][3];
        }
        add_at<2>(a_dg, de, grp, group_sum8(vg, lane));
        add_at<2>(a_dbt, de, grp, group_sum8(vt, lane));
      }
      const float m10 = quad_sum(sa0) * (1.f / C1), m20 = quad_sum(sb0) * (1.f / C1);
      const float m11 = quad_sum(sa1) * (1.f / C1), m21 = quad_sum(sb1) * (1.f / C1);
      // d_u1pre = rstd (d_y - mean d_y - y mean(d_y y)) -> rnd: d_s and the
      // scratch rows
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vd[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * tq;
          const float g0 = g[c], g1 = g[c + 1];
          const float e0 = rs0 * (a3[j][0] * g0 - m10 - a1[j][0] * m20);
          const float e1 = rs0 * (a3[j][1] * g1 - m10 - a1[j][1] * m20);
          const float e2 = rs1 * (a3[j][2] * g0 - m11 - a1[j][2] * m21);
          const float e3 = rs1 * (a3[j][3] * g1 - m11 - a1[j][3] * m21);
          vd[2 * jj] = e0 + e2;
          vd[2 * jj + 1] = e1 + e3;
          st_bf2(d_s + gq * LD1 + C1 * de + c, e0, e1);
          st_bf2(d_s + (gq + 8) * LD1 + C1 * de + c, e2, e3);
          if (ok0) st_bf2(du1_rows + r0 * L1 + C1 * de + c, e0, e1);
          if (ok1) st_bf2(du1_rows + r1 * L1 + C1 * de + c, e2, e3);
        }
        cs[4 * LQ + C1 * de + 32 * grp + group_col(0, lane)] += group_sum8(vd, lane);
      }
    }
    pair_sync();  // d_s holds all four (d, e) blocks

    // d_up = rnd(d_u1pre) . W1^T, this warp's 128 channels
    {
      const int half = sub;
      float a4[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) a4[j][0] = a4[j][1] = a4[j][2] = a4[j][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < L1 / 16; ++kk) {
        uint32_t a[4];
        load_a<LD1>(a, d_s, 0, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];
          load_b_nk<LD1>(b, w1_s, 128 * half + 16 * np, 16 * kk, lane);
          mma16816(a4[2 * np], a, b[0], b[1]);
          mma16816(a4[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * half + 8 * j + 2 * tq;
        if (ok0) st_bf2(d_up + r0 * C + c, a4[j][0], a4[j][1]);
        if (ok1) st_bf2(d_up + r1 * C + c, a4[j][2], a4[j][3]);
      }
    }
    pair_sync();  // u_s and d_s are refilled by the next tile
  }

  pair_sync();
  const size_t wg = (size_t)blockIdx.x * SLOTS + slot;
#pragma unroll
  for (int de = 0; de < 4; ++de)
    if (de >> 1 == sub)
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int col = C1 * de + group_col(grp, lane);
        dg_p[wg * L1 + col] = a_dg[de * 2 + grp];
        dbt_p[wg * L1 + col] = a_dbt[de * 2 + grp];
      }
  for (int i = pl; i < 4 * LQ; i += 64) db2_p[wg * 4 * LQ + i] = cs[i];
  for (int i = pl; i < L1; i += 64) db1_p[wg * L1 + i] = cs[4 * LQ + i];
}

// The weight pass: block (chunk, kind) sums over the chunk's rows
//   kind 0, 1: dW1 rows 128 kind.. [C][L1] = up[:, 128 kind..]^T . rnd(d_u1pre)
//   kind 2:    dW2 [4][C1][LQ], dW2[de] = u1g[de]^T . rnd(d_u2pre)[de]
// into part[chunk] = [dW1 | dW2]; warp w owns a 64 x 64 tile of it
constexpr int DW_LDA = L1 + 8, DW_LDB = 4 * LQ + 8;
constexpr int DW_STAGE = dec::DW_SR * (DW_LDA + DW_LDB);
constexpr size_t DW_SMEM = sizeof(bf16) * (size_t)dec::DW_STAGES * DW_STAGE;
constexpr int DW_PART = C * L1 + 4 * C1 * LQ;  // floats per chunk

__global__ void __launch_bounds__(dec::DW_THREADS, 1)
    upscale_bwd_dw_kernel(const bf16* up, const bf16* u1g_rows,
                          const bf16* d2_rows, const bf16* du1_rows,
                          float* part, int rows, int chunk) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int kind = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk, hi = min(rows, lo + chunk);
  float acc[4][8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  // X: up columns 128 kind.. (128 wide) or u1g (256); Y: rnd(d_u1pre) (256)
  // or rnd(d_u2pre) (512)
  const bool w2k = kind == 2;
  const int xw = w2k ? L1 : C / 2, yw = w2k ? 4 * LQ : L1;
  const int xstride = w2k ? L1 : C;
  const bf16* xsrc = w2k ? u1g_rows : up + (C / 2) * kind;
  const bf16* ysrc = w2k ? d2_rows : du1_rows;
  auto load = [&](int st, int r0) {
    bf16* xs = ring + st * DW_STAGE;
    bf16* ys = xs + DW_SR * DW_LDA;
    for (int i = threadIdx.x; i < DW_SR * (xw / 8); i += DW_THREADS) {
      const int r = i / (xw / 8), c = (i - r * (xw / 8)) * 8;
      const bool ok = r0 + r < hi;
      cp_async16(xs + r * DW_LDA + c, xsrc + (ok ? (size_t)(r0 + r) * xstride + c : 0), ok);
    }
    for (int i = threadIdx.x; i < DW_SR * (yw / 8); i += DW_THREADS) {
      const int r = i / (yw / 8), c = (i - r * (yw / 8)) * 8;
      const bool ok = r0 + r < hi;
      cp_async16(ys + r * DW_LDB + c, ysrc + (ok ? (size_t)(r0 + r) * yw + c : 0), ok);
    }
  };
  auto prep = [](int) { return false; };
  const int a0 = w2k ? C1 * (warp / 2) : 64 * (warp / 4);
  const int b0 = w2k ? LQ * (warp / 2) + 64 * (warp % 2) : 64 * (warp % 4);
  auto mma = [&](int st) {
    const bf16* xs = ring + st * DW_STAGE;
    dw_stage_mma<DW_LDA, DW_LDB>(acc, xs, a0, xs + DW_SR * DW_LDA, b0, lane);
  };
  dw_ring(lo, hi, load, prep, mma);
  float* out = part + (size_t)blockIdx.x * DW_PART;
  if (w2k)
    dw_store(out + C * L1 + (warp / 2) * C1 * LQ + 64 * (warp % 2), LQ, acc,
             lane);
  else
    dw_store(out + ((C / 2) * kind + a0) * L1 + b0, L1, acc, lane);
}

int launch_bwd_rows(void* const* a, int bp, int m, int n_out, int blocks,
                    float eps, cudaStream_t stream) {
  if (n_out < 1 || n_out > MAXT || blocks < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ROWS_SMEM);
  if (e != cudaSuccess) return (int)e;
  auto in = [&](int i) { return static_cast<const bf16*>(a[i]); };
  auto out = [&](int i) { return static_cast<bf16*>(a[i]); };
  auto f = [&](int i) { return static_cast<float*>(a[i]); };
  upscale_bwd_rows_kernel<<<blocks, RT, ROWS_SMEM, stream>>>(
      in(0), f(1), in(2), f(3), f(4), f(5), in(6), f(7), in(8), out(9),
      out(10), out(11), out(12), f(13), f(14), f(15), f(16), f(17), bp, m,
      n_out, eps);
  return (int)cudaGetLastError();
}

int launch_bwd_dw(void* const* a, int rows, int chunk, int nchunks,
                  cudaStream_t stream) {
  if (chunk < 1 || chunk % dec::DW_SR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DW_SMEM);
  if (e != cudaSuccess) return (int)e;
  upscale_bwd_dw_kernel<<<dim3(nchunks, 3), dec::DW_THREADS, DW_SMEM,
                          stream>>>(
      static_cast<const bf16*>(a[0]), static_cast<const bf16*>(a[1]),
      static_cast<const bf16*>(a[2]), static_cast<const bf16*>(a[3]),
      static_cast<float*>(a[4]), rows, chunk);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const void* up, const void* w1, const void* b1,
                   const void* g, const void* bt, const void* w2,
                   const void* b2, const void* hyper, void* out, int bp, int m,
                   int n_out, int blocks, float eps, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_MMA_SMEM);
  if (e != cudaSuccess) return (int)e;
  upscale_fwd_mma_kernel<<<blocks, RT, FWD_MMA_SMEM, stream>>>(
      static_cast<const bf16*>(up), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(hyper),
      static_cast<float*>(out), bp, m, n_out, eps);
  return (int)cudaGetLastError();
}


// ---------------------------- f32 forward and backward, split TF32 ----
// The f32 kernels: super-tiles of 64 rows, a warp pair per 16-row slot,
// warp `sub` taking the (d, e) blocks 2 sub, 2 sub + 1 (decoder_tf32.cuh).
// W1 (256 KB) is streamed per super-tile (dec32::stream_product); W2 (32
// KB) is copied into the ring's space once the first product is done, and
// read from there by the second product (and, in the backward, by d_u1g).
// Shared memory per slot: its rows [16][LDT] (up, then u1g, then
// rnd(d_u1pre)); the row pass adds the LayerNorm outputs y [16][LDY] and
// its per-column sums.
using attn::mma::cp_commit;
using attn::mma::cp_wait;
using stf32::acc_a;
using stf32::Frag;
using stf32::load_a;
using stf32::mma3;
using stf32::mma3s;
using stf32::split;

constexpr int LDT = C + 4;     // up / u1g / d_u1pre rows (A fragments)
constexpr int LDY = L1 + 8;    // y rows (float2 at bank 8g + 2t)
constexpr int LDW2F = LQ + 8;  // W2 [C1][LQ] rows
constexpr int W1_KS = 16;      // W1 / W1^T stage rows
constexpr int RING32 = dec32::STAGES * W1_KS * (L1 + 8);
static_assert(RING32 >= C1 * LDW2F, "W2 fits in the ring's space");
constexpr size_t FWD_TF32_SMEM =
    sizeof(float) * ((size_t)dec32::ROWS * (LDT + MAXT * 16) + RING32);
constexpr int CS32 = CS + 2 * L1;  // a slot's sums: db2, db1, dg, dbt
constexpr size_t ROWS_TF32_SMEM =
    sizeof(float) * ((size_t)dec32::ROWS * (LDT + LDY) + RING32 +
                     dec32::SLOTS * CS32);

// W2 [C1][LQ] -> the ring's space, rows of LDW2F, asynchronously
__device__ __forceinline__ void w2_async(float* w2s, const float* w2) {
  for (int i = threadIdx.x; i < C1 * (LQ / 4); i += dec32::THREADS) {
    const int r = i / (LQ / 4), c = (i - r * (LQ / 4)) * 4;
    attn::mma::cp_async16(w2s + r * LDW2F + c, w2 + r * LQ + c, true);
  }
}

// The first upscale of the warp's 16 rows (up in ts), its (d, e) blocks
// 2 sub, 2 sub + 1 (columns 128 sub..: n-tiles 8 d..): u1pre = up . W1 +
// b1, then per block the LayerNorm over its 64 lanes (mean, then the
// centred variance; f32). On exit a holds y and rs[d] the 1/std of rows g,
// g + 8 of block d. Ends with a barrier (the ring and ts are free).
__device__ __forceinline__ void first_upscale32(float (&a)[16][4],
                                                float (&rs)[2][2],
                                                const float* ts,
                                                const float* w1,
                                                const float* b1, float* ring,
                                                int sub, float eps, int lane) {
  using attn::mma::quad_sum;
  const int tq = lane & 3;
  dec32::zero<16>(a);
  dec32::stream_product<C, L1, W1_KS, 16>(
      a, w1, ring, 128 * sub,
      [&](Frag& f, int k0) { load_a(f, ts, LDT, 0, k0, lane); }, lane);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    float su0 = 0.f, su1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float* x = a[8 * d + jj];
      const int c = 8 * jj + 2 * tq;
      x[0] += b1[c];
      x[1] += b1[c + 1];
      x[2] += b1[c];
      x[3] += b1[c + 1];
      su0 += x[0] + x[1];
      su1 += x[2] + x[3];
    }
    const float mu0 = quad_sum(su0) * (1.f / C1);
    const float mu1 = quad_sum(su1) * (1.f / C1);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float* x = a[8 * d + jj];
      x[0] -= mu0;
      x[1] -= mu0;
      x[2] -= mu1;
      x[3] -= mu1;
      v0 = fmaf(x[0], x[0], fmaf(x[1], x[1], v0));
      v1 = fmaf(x[2], x[2], fmaf(x[3], x[3], v1));
    }
    rs[d][0] = rsqrtf(quad_sum(v0) * (1.f / C1) + eps);
    rs[d][1] = rsqrtf(quad_sum(v1) * (1.f / C1) + eps);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float* x = a[8 * d + jj];
      x[0] *= rs[d][0];
      x[1] *= rs[d][0];
      x[2] *= rs[d][1];
      x[3] *= rs[d][1];
    }
  }
}

// the second upscale of block de by halves of 64 lanes (f, g, c2): a2 =
// u1g[de] . W2[:, 64 half..] (u1g in ts, W2 in w2s)
__device__ __forceinline__ void second_half32(float (&a2)[8][4],
                                              const float* ts,
                                              const float* w2s, int de,
                                              int half, int lane) {
  const int g = lane >> 2, t = lane & 3;
  dec32::zero<8>(a2);
#pragma unroll
  for (int kk = 0; kk < C1 / 8; ++kk) {
    Frag a;
    load_a(a, ts, LDT, 0, C1 * de + 8 * kk, lane);
    const float* b = w2s + (8 * kk + t) * LDW2F + 64 * half + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) mma3(a2[j], a, b[8 * j], b[4 * LDW2F + 8 * j]);
  }
}

// hyper^T of the pair as split B fragments of the hypernetwork product
// (k = c2 permuted: rows 8 kk + 2t, + 1; column = mask token g, zero past
// n_out): hb[kk] = {hi, lo of row 2t, hi, lo of row 2t + 1}
__device__ __forceinline__ void hyper_frags(uint32_t (&hb)[4][4],
                                            const float* hy, int n_out,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float2 v = g < n_out ? dec32::ld2(hy + g * C2 + 8 * kk + 2 * t)
                               : make_float2(0.f, 0.f);
    split(v.x, hb[kk][0], hb[kk][1]);
    split(v.y, hb[kk][2], hb[kk][3]);
  }
}

// out[t] = sum_c2 u2g[c2] hyper[t, c2] for one (f, g): u2g the four
// accumulator n-tiles u (32 c2, k permuted): o[0..1] row g, o[2..3] row
// g + 8, tokens 2t, 2t + 1
__device__ __forceinline__ void hyper_dot32(float (&o)[4],
                                            const float (*u)[4],
                                            const uint32_t (&hb)[4][4]) {
  o[0] = o[1] = o[2] = o[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Frag a;
    acc_a(a, u[kk]);
    mma3s(o, a, hb[kk][0], hb[kk][1], hb[kk][2], hb[kk][3]);
  }
}

// The f32 forward. Per super-tile: the first upscale (W1 streamed), its
// LayerNorm and GELU (erf) into the slot's rows over up; W2 into the
// ring's space; per (d, e) block and half of 64 lanes the second upscale,
// its GELU and the hypernetwork sums (split mma against hyper^T), staged as
// the super-tile's output rows and stored as 16-byte rows.
__global__ void __launch_bounds__(dec32::THREADS, 1)
    upscale_fwd_tf32_kernel(const float* up, const float* w1,
                            const float* b1, const float* g, const float* bt,
                            const float* w2, const float* b2,
                            const float* hyper, float* out, int bp, int m,
                            int n_out, float eps) {
  extern __shared__ __align__(16) float smem32[];
  float* t_s = smem32;
  float* o_s = t_s + dec32::ROWS * LDT;  // [ROWS][lanes]
  float* ring = o_s + dec32::ROWS * MAXT * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  float* ts = t_s + slot * 16 * LDT;
  const int lanes = n_out * 16;
  float* os = o_s + slot * 16 * lanes;
  const int tps = (m + dec32::ROWS - 1) / dec32::ROWS, ntiles = bp * tps;
  const bool t0 = 2 * tq < n_out, t1 = 2 * tq + 1 < n_out;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int pair = tile / tps, srow0 = (tile - pair * tps) * dec32::ROWS;
    const size_t prow0 = (size_t)pair * m + srow0;
    __syncthreads();  // the previous tile is done with the rows
    dec32::rows_async<C, LDT>(t_s, up + prow0 * C, m - srow0);
    cp_commit();
    float a[16][4], rs[2][2];
    first_upscale32(a, rs, ts, w1, b1, ring, sub, eps, lane);
    w2_async(ring, w2);
    cp_commit();
    // u1g = gelu(y g + bt) over up, this warp's two blocks
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * (j & 7) + 2 * tq, col = 128 * sub + 8 * j + 2 * tq;
      const float g0 = g[c], g1 = g[c + 1], e0 = bt[c], e1 = bt[c + 1];
      dec32::st2(ts + gq * LDT + col, gelu<float>(a[j][0] * g0 + e0),
                 gelu<float>(a[j][1] * g1 + e1));
      dec32::st2(ts + (gq + 8) * LDT + col, gelu<float>(a[j][2] * g0 + e0),
                 gelu<float>(a[j][3] * g1 + e1));
    }
    uint32_t hb[4][4];
    hyper_frags(hb, hyper + (size_t)pair * n_out * C2, n_out, lane);
    cp_wait<0>();
    __syncthreads();  // W2 landed

#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * sub + d;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a2[8][4];
        second_half32(a2, ts, ring, de, half, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c2 = 8 * (j & 3) + 2 * tq;
          const float b0 = b2[c2], b1v = b2[c2 + 1];
          a2[j][0] = gelu<float>(a2[j][0] + b0);
          a2[j][1] = gelu<float>(a2[j][1] + b1v);
          a2[j][2] = gelu<float>(a2[j][2] + b0);
          a2[j][3] = gelu<float>(a2[j][3] + b1v);
        }
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {  // a group of 4 n-tiles is one (f, g)
          const int fg = 2 * half + hg;
          float o[4];
          hyper_dot32(o, a2 + 4 * hg, hb);
          const int l = 2 * tq * 16 + de * 4 + fg;
          if (t0) {
            os[gq * lanes + l] = o[0];
            os[(gq + 8) * lanes + l] = o[2];
          }
          if (t1) {
            os[gq * lanes + l + 16] = o[1];
            os[(gq + 8) * lanes + l + 16] = o[3];
          }
        }
      }
    }
    __syncthreads();  // the output rows are staged
    const float4* src = reinterpret_cast<const float4*>(o_s);
    float4* dst = reinterpret_cast<float4*>(out + prow0 * lanes);
    const int n4 = min(dec32::ROWS, m - srow0) * lanes / 4;
    for (int i = threadIdx.x; i < n4; i += dec32::THREADS) dst[i] = src[i];
  }
}

// The f32 row pass. Per super-tile: the first upscale (W1 streamed), y to
// the slot's y rows, u1g over up and to the scratch rows; W2 into the
// ring's space. Per (d, e) block of the warp: by halves of 64 lanes the
// second upscale, its GELU, the hypernetwork terms and d_u2pre (to the
// scratch rows), and d_u1g += d_u2pre . W2^T (d_u2pre from the
// accumulators, k permuted: W2's rows read as float2 pairs); then the GELU
// and LayerNorm backward, rnd(d_u1pre) over the block's u1g and to the
// scratch rows. Then d_up = rnd(d_u1pre) . W1^T (W1^T streamed). Per-column
// sums as in bf16: group_sum8 per tile, one partial per slot, d_hyper one
// partial per 16-row tile.
__global__ void __launch_bounds__(dec32::THREADS, 1)
    upscale_bwd_rows_tf32_kernel(const float* up, const float* dm,
                                 const float* w1, const float* b1,
                                 const float* g, const float* bt,
                                 const float* w2, const float* b2,
                                 const float* hyper, float* d_up,
                                 float* u1g_rows, float* d2_rows,
                                 float* du1_rows, float* db1_p, float* dg_p,
                                 float* dbt_p, float* db2_p, float* dht_t,
                                 const float* w1t, int bp, int m, int n_out,
                                 float eps) {
  using attn::mma::quad_sum;
  using dec::group_col;
  using dec::group_sum8;
  extern __shared__ __align__(16) float smem32[];
  float* t_s = smem32;
  float* y_s = t_s + dec32::ROWS * LDT;
  float* ring = y_s + dec32::ROWS * LDY;
  float* cs0 = ring + RING32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1, pl = 32 * sub + lane;
  const int gq = lane >> 2, tq = lane & 3;
  float* ts = t_s + slot * 16 * LDT;
  float* ys = y_s + slot * 16 * LDY;
  // per-column sums over the slot's tiles, each entry one lane's: db2
  // [4 LQ], db1, dg, dbt [L1]
  float* cs = cs0 + slot * CS32;
  for (int i = threadIdx.x; i < dec32::SLOTS * CS32; i += dec32::THREADS)
    cs0[i] = 0.f;

  const int tps = (m + dec32::ROWS - 1) / dec32::ROWS, ntiles = bp * tps;
  const int tpp16 = (m + 15) / 16, lanes = n_out * 16;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int pair = tile / tps, srow0 = (tile - pair * tps) * dec32::ROWS;
    const int row0 = srow0 + 16 * slot, valid = min(16, m - row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    const size_t r0 = (size_t)pair * m + row0 + gq, r1 = r0 + 8;
    __syncthreads();  // the previous tile is done with the rows and sums
    dec32::rows_async<C, LDT>(t_s, up + ((size_t)pair * m + srow0) * C,
                              m - srow0);
    cp_commit();
    float rs[2][2];
    {
      float a[16][4];
      first_upscale32(a, rs, ts, w1, b1, ring, sub, eps, lane);
      w2_async(ring, w2);
      cp_commit();
      // y to the y rows; u1g = gelu(y g + bt) over up and to the scratch
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * (j & 7) + 2 * tq, col = 128 * sub + 8 * j + 2 * tq;
        const float g0 = g[c], g1 = g[c + 1], e0 = bt[c], e1 = bt[c + 1];
        dec32::st2(ys + gq * LDY + col, a[j][0], a[j][1]);
        dec32::st2(ys + (gq + 8) * LDY + col, a[j][2], a[j][3]);
        const float u0 = gelu<float>(a[j][0] * g0 + e0);
        const float u1 = gelu<float>(a[j][1] * g1 + e1);
        const float u2 = gelu<float>(a[j][2] * g0 + e0);
        const float u3 = gelu<float>(a[j][3] * g1 + e1);
        dec32::st2(ts + gq * LDT + col, u0, u1);
        dec32::st2(ts + (gq + 8) * LDT + col, u2, u3);
        if (ok0) dec32::st2(u1g_rows + r0 * L1 + col, u0, u1);
        if (ok1) dec32::st2(u1g_rows + r1 * L1 + col, u2, u3);
      }
    }
    cp_wait<0>();
    __syncthreads();  // W2 landed
    const float* w2s = ring;
    const float* hy = hyper + (size_t)pair * n_out * C2;
    const float* dm0 = dm + r0 * lanes;
    const float* dm1 = dm + r1 * lanes;

#pragma unroll 1
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * sub + d;
      // the block's 1/std of rows g, g + 8 (selects: d is not unrolled)
      const float rs0 = d ? rs[1][0] : rs[0][0], rs1 = d ? rs[1][1] : rs[0][1];
      float a3[8][4];  // d_u1g of the block's 64 lanes
      dec32::zero<8>(a3);
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float a2[8][4];
        second_half32(a2, ts, w2s, de, half, lane);
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {  // a group of 4 n-tiles is one (f, g)
          const int fg = 2 * half + hg;
          float dmv[2][MAXT];
#pragma unroll
          for (int t = 0; t < MAXT; ++t) {
            const int l = t * 16 + de * 4 + fg;
            dmv[0][t] = (t < n_out && ok0) ? dm0[l] : 0.f;
            dmv[1][t] = (t < n_out && ok1) ? dm1[l] : 0.f;
          }
          float ug[4][4], vb2[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * hg + jj, c2 = 8 * jj + 2 * tq;
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // rows g (e < 2), g + 8; column e & 1
              const float u2 = a2[j][e] + b2[c2 + (e & 1)];
              ug[jj][e] = gelu<float>(u2);
              float du = 0.f;
#pragma unroll
              for (int t = 0; t < MAXT; ++t)
                if (t < n_out)
                  du = fmaf(dmv[e >> 1][t], hy[t * C2 + c2 + (e & 1)], du);
              a2[j][e] = du * gelu_grad<float>(u2);  // d_u2pre
            }
            vb2[2 * jj] = a2[j][0] + a2[j][2];
            vb2[2 * jj + 1] = a2[j][1] + a2[j][3];
            const int q = LQ * de + 64 * half + 8 * j + 2 * tq;
            if (ok0) dec32::st2(d2_rows + r0 * 4 * LQ + q, a2[j][0], a2[j][1]);
            if (ok1) dec32::st2(d2_rows + r1 * 4 * LQ + q, a2[j][2], a2[j][3]);
          }
          cs[LQ * de + 32 * fg + group_col(0, lane)] += group_sum8(vb2, lane);
          // d_hyper of this 16-row tile: sum over its rows of dm * u2g
          if (valid > 0) {
            float* ht = dht_t + ((size_t)pair * tpp16 + row0 / 16) * n_out * 4 * LQ +
                        LQ * de + 32 * fg + group_col(0, lane);
#pragma unroll
            for (int t = 0; t < MAXT; ++t)
              if (t < n_out) {
                float vh[8];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  vh[2 * jj] = dmv[0][t] * ug[jj][0] + dmv[1][t] * ug[jj][2];
                  vh[2 * jj + 1] = dmv[0][t] * ug[jj][1] + dmv[1][t] * ug[jj][3];
                }
                ht[(size_t)t * 4 * LQ] = group_sum8(vh, lane);
              }
          }
        }
        // d_u1g += d_u2pre . W2^T over this half's 64 lanes: A from the
        // accumulators (k = q permuted), B = W2[c1][q] as float2 pairs
#pragma unroll
        for (int kq = 0; kq < 8; ++kq) {
          Frag a;
          acc_a(a, a2[kq]);
          const float* b = w2s + gq * LDW2F + 64 * half + 8 * kq + 2 * tq;
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            const float2 v = dec32::ld2(b + 8 * jn * LDW2F);
            mma3(a3[jn], a, v.x, v.y);
          }
        }
      }
      // GELU and LayerNorm-affine backward: d_out1 in place (y read from
      // its rows where it is needed: registers are the scarce resource)
      float sa0 = 0.f, sb0 = 0.f, sa1 = 0.f, sb1 = 0.f;
      const float* y0 = ys + gq * LDY + C1 * de;
      const float* y1 = y0 + 8 * LDY;
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vg[8], vt[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * tq;
          const float2 ya = dec32::ld2(y0 + c), yb = dec32::ld2(y1 + c);
          const float y[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gc = g[c + (e & 1)];
            const float d1 = a3[j][e] * gelu_grad<float>(y[e] * gc + bt[c + (e & 1)]);
            a3[j][e] = d1;
            const float dyv = d1 * gc;
            if (e < 2) {
              sa0 += dyv;
              sb0 = fmaf(dyv, y[e], sb0);
            } else {
              sa1 += dyv;
              sb1 = fmaf(dyv, y[e], sb1);
            }
          }
          vg[2 * jj] = a3[j][0] * y[0] + a3[j][2] * y[2];
          vg[2 * jj + 1] = a3[j][1] * y[1] + a3[j][3] * y[3];
          vt[2 * jj] = a3[j][0] + a3[j][2];
          vt[2 * jj + 1] = a3[j][1] + a3[j][3];
        }
        const int col = C1 * de + 32 * grp + group_col(0, lane);
        cs[4 * LQ + L1 + col] += group_sum8(vg, lane);
        cs[4 * LQ + 2 * L1 + col] += group_sum8(vt, lane);
      }
      const float m10 = quad_sum(sa0) * (1.f / C1), m20 = quad_sum(sb0) * (1.f / C1);
      const float m11 = quad_sum(sa1) * (1.f / C1), m21 = quad_sum(sb1) * (1.f / C1);
      // d_u1pre = rstd (d_y - mean d_y - y mean(d_y y)) over the block's
      // u1g and to the scratch rows
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vd[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * tq;
          const float2 ya = dec32::ld2(y0 + c), yb = dec32::ld2(y1 + c);
          const float g0 = g[c], g1 = g[c + 1];
          const float e0 = rs0 * (a3[j][0] * g0 - m10 - ya.x * m20);
          const float e1 = rs0 * (a3[j][1] * g1 - m10 - ya.y * m20);
          const float e2 = rs1 * (a3[j][2] * g0 - m11 - yb.x * m21);
          const float e3 = rs1 * (a3[j][3] * g1 - m11 - yb.y * m21);
          vd[2 * jj] = e0 + e2;
          vd[2 * jj + 1] = e1 + e3;
          dec32::st2(ts + gq * LDT + C1 * de + c, e0, e1);
          dec32::st2(ts + (gq + 8) * LDT + C1 * de + c, e2, e3);
          if (ok0) dec32::st2(du1_rows + r0 * L1 + C1 * de + c, e0, e1);
          if (ok1) dec32::st2(du1_rows + r1 * L1 + C1 * de + c, e2, e3);
        }
        cs[4 * LQ + C1 * de + 32 * grp + group_col(0, lane)] += group_sum8(vd, lane);
      }
    }
    __syncthreads();  // the rows hold rnd(d_u1pre); W2's space is free

    // d_up = rnd(d_u1pre) . W1^T, this warp's 128 channels
    float a4[16][4];
    dec32::zero<16>(a4);
    dec32::stream_product<L1, C, W1_KS, 16>(
        a4, w1t, ring, 128 * sub,
        [&](Frag& f, int k0) { load_a(f, ts, LDT, 0, k0, lane); }, lane);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * sub + 8 * j + 2 * tq;
      if (ok0) dec32::st2(d_up + r0 * C + c, a4[j][0], a4[j][1]);
      if (ok1) dec32::st2(d_up + r1 * C + c, a4[j][2], a4[j][3]);
    }
  }

  __syncthreads();
  const size_t wg = (size_t)blockIdx.x * dec32::SLOTS + slot;
  for (int i = pl; i < 4 * LQ; i += 64) db2_p[wg * 4 * LQ + i] = cs[i];
  for (int i = pl; i < L1; i += 64) {
    db1_p[wg * L1 + i] = cs[4 * LQ + i];
    dg_p[wg * L1 + i] = cs[4 * LQ + L1 + i];
    dbt_p[wg * L1 + i] = cs[4 * LQ + 2 * L1 + i];
  }
}

// The f32 weight pass: block (chunk, kind) sums over the chunk's rows
//   kind 0-3: dW1 [C][L1] rows 128 (kind / 2).., columns 128 (kind % 2).. =
//             up[:, rows]^T . rnd(d_u1pre)[:, columns]
//   kind 4, 5: dW2 [4][C1][LQ] of the (d, e) blocks 2 (kind - 4), + 1:
//             dW2[de] = u1g[de]^T . rnd(d_u2pre)[de]
// into part[chunk] = [dW1 | dW2]; warp w owns a 32 x 64 tile of the block
constexpr int DW32_LDX = 128 + 8, DW32_LDY = 256 + 8;
constexpr int DW32_STAGE = dec::DW_SR * (DW32_LDX + DW32_LDY);
constexpr size_t DW32_SMEM = sizeof(float) * (size_t)dec::DW_STAGES * DW32_STAGE;

__global__ void __launch_bounds__(dec::DW_THREADS, 1)
    upscale_bwd_dw_tf32_kernel(const float* up, const float* u1g_rows,
                               const float* d2_rows, const float* du1_rows,
                               float* part, int rows, int chunk) {
  using attn::mma::cp_async16;
  extern __shared__ __align__(16) float smem32[];
  const int kind = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk, hi = min(rows, lo + chunk);
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) dec32::zero<8>(acc[a]);

  // X: 128 columns of up or u1g; Y: 128 columns of rnd(d_u1pre) or 256 of
  // rnd(d_u2pre)
  const bool w2k = kind >= 4;
  const int yw = w2k ? 2 * LQ : L1 / 2;
  const float* xsrc = w2k ? u1g_rows + 2 * C1 * (kind - 4) : up + 128 * (kind >> 1);
  const int xstride = w2k ? L1 : C;
  const float* ysrc = w2k ? d2_rows + 2 * LQ * (kind - 4) : du1_rows + 128 * (kind & 1);
  const int ystride = w2k ? 4 * LQ : L1;
  auto load = [&](int st, int r0) {
    float* xs = smem32 + st * DW32_STAGE;
    float* ys = xs + dec::DW_SR * DW32_LDX;
    for (int i = threadIdx.x; i < dec::DW_SR * 32; i += dec::DW_THREADS) {
      const int r = i / 32, c = (i - r * 32) * 4;
      const bool ok = r0 + r < hi;
      cp_async16(xs + r * DW32_LDX + c,
                 xsrc + (ok ? (size_t)(r0 + r) * xstride + c : 0), ok);
    }
    for (int i = threadIdx.x; i < dec::DW_SR * (yw / 4); i += dec::DW_THREADS) {
      const int r = i / (yw / 4), c = (i - r * (yw / 4)) * 4;
      const bool ok = r0 + r < hi;
      cp_async16(ys + r * DW32_LDY + c,
                 ysrc + (ok ? (size_t)(r0 + r) * ystride + c : 0), ok);
    }
  };
  auto prep = [](int) { return false; };
  // dW1: rows 32 (w / 2).., columns 64 (w % 2)..; dW2: block de = w / 4,
  // rows 32 ((w / 2) % 2).. of its C1, columns 64 (w % 2).. of its LQ
  const int mrow = w2k ? 32 * ((warp >> 1) & 1) : 32 * (warp >> 1);
  const int a0 = w2k ? C1 * (warp >> 2) + mrow : mrow;
  const int b0 = w2k ? LQ * (warp >> 2) + 64 * (warp & 1) : 64 * (warp & 1);
  auto mma = [&](int st) {
    const float* xs = smem32 + st * DW32_STAGE;
    dec32::dw_stage_tf32<DW32_LDX, DW32_LDY>(acc, xs, a0,
                                             xs + dec::DW_SR * DW32_LDX, b0,
                                             lane);
  };
  dec::dw_ring(lo, hi, load, prep, mma);
  float* out = part + (size_t)blockIdx.x * DW_PART;
  if (w2k)
    dec32::dw_store32(out + C * L1 + (size_t)(2 * (kind - 4) + (warp >> 2)) * C1 * LQ +
                          mrow * LQ + 64 * (warp & 1),
                      LQ, acc, lane);
  else
    dec32::dw_store32(out + (size_t)(128 * (kind >> 1) + mrow) * L1 +
                          128 * (kind & 1) + b0,
                      L1, acc, lane);
}

int launch_fwd_tf32(const void* up, const void* w1, const void* b1,
                    const void* g, const void* bt, const void* w2,
                    const void* b2, const void* hyper, void* out, int bp,
                    int m, int n_out, int blocks, float eps,
                    cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_TF32_SMEM);
  if (e != cudaSuccess) return (int)e;
  upscale_fwd_tf32_kernel<<<blocks, dec32::THREADS, FWD_TF32_SMEM, stream>>>(
      static_cast<const float*>(up), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(hyper),
      static_cast<float*>(out), bp, m, n_out, eps);
  return (int)cudaGetLastError();
}

int launch_bwd_rows_tf32(void* const* a, int bp, int m, int n_out,
                         int blocks, float eps, cudaStream_t stream) {
  if (n_out < 1 || n_out > MAXT || blocks < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_rows_tf32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ROWS_TF32_SMEM);
  if (e != cudaSuccess) return (int)e;
  auto in = [&](int i) { return static_cast<const float*>(a[i]); };
  auto out = [&](int i) { return static_cast<float*>(a[i]); };
  upscale_bwd_rows_tf32_kernel<<<blocks, dec32::THREADS, ROWS_TF32_SMEM,
                                 stream>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7), in(8), out(9),
      out(10), out(11), out(12), out(13), out(14), out(15), out(16), out(17),
      in(18), bp, m, n_out, eps);
  return (int)cudaGetLastError();
}

int launch_bwd_dw_tf32(void* const* a, int rows, int chunk, int nchunks,
                       cudaStream_t stream) {
  if (chunk < 1 || chunk % dec::DW_SR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DW32_SMEM);
  if (e != cudaSuccess) return (int)e;
  upscale_bwd_dw_tf32_kernel<<<dim3(nchunks, 6), dec::DW_THREADS, DW32_SMEM,
                               stream>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const float*>(a[3]),
      static_cast<float*>(a[4]), rows, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward on `blocks` persistent blocks: bf16 upscale_fwd_mma_kernel,
// f32 upscale_fwd_tf32_kernel.
int dhoct_upscale_fwd(const void* up, const void* w1, const void* b1,
                      const void* g, const void* bt, const void* w2,
                      const void* b2, const void* hyper, void* out, int bp,
                      int m, int n_out, int blocks, int dtype, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out < 1 || n_out > MAXT || m < 1) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? launch_fwd_mma(up, w1, b1, g, bt, w2, b2, hyper, out,
                                     bp, m, n_out, blocks, eps, s)
                    : launch_fwd_tf32(up, w1, b1, g, bt, w2, b2, hyper, out,
                                      bp, m, n_out, blocks, eps, s);
}

// The row pass on `blocks` persistent blocks (bf16 upscale_bwd_rows_kernel,
// f32 upscale_bwd_rows_tf32_kernel). a: up, dm, w1, b1, g, bt, w2, b2,
// hyper; outputs d_up, the u1g, rnd(d_u2pre) and rnd(d_u1pre) scratch rows,
// per-slot partials of db1, dg, dbt, db2, and per-16-row-tile partials of
// d_hyper; f32 also takes W1^T [L1][C] (a[18]).
int dhoct_upscale_bwd_rows(void* const* a, int bp, int m, int n_out,
                           int blocks, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bwd_rows(a, bp, m, n_out, blocks, eps, s)
                    : launch_bwd_rows_tf32(a, bp, m, n_out, blocks, eps, s);
}

// The weight pass (bf16 upscale_bwd_dw_kernel, f32
// upscale_bwd_dw_tf32_kernel). a[5]: up, u1g, rnd(d_u2pre) and
// rnd(d_u1pre) rows, and the partials [nchunks][dW1 | dW2] of row chunks
// of `chunk` rows.
int dhoct_upscale_bwd_dw(void* const* a, int rows, int chunk, int nchunks,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bwd_dw(a, rows, chunk, nchunks, s)
                    : launch_bwd_dw_tf32(a, rows, chunk, nchunks, s);
}

const char* dhoct_upscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
