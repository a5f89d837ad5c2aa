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
//    (:295, body _fwd_kernel :119-138, math _chain_fwd :77-99), one
//    persistent block per SM.
//    * bf16 (the training path): upscale_fwd_wgmma_kernel on wgmma with
//      TMA loads (see the kernel): 64-row units shared by its two
//      warpgroups, W1 and W2 in shared memory.
//    * f32 (reached with set_fused_upscaler('interpret')):
//      upscale_fwd_tf32_kernel in split TF32 (decoder_tf32.cuh) on
//      mma.sync, 8 warps, super-tiles of 64 rows streaming W1 through a
//      cp.async ring, W2 in the ring's space once the first product is done.
// The backward replaces the same file's _fused_bwd (:329, body _bwd_kernel
//    :141-243) with two launches: a row pass recomputes the chain per row,
//    writes d_up per row and the scratch rows u1g, rnd(d_u2pre) and
//    rnd(d_u1pre), and sums the vector gradients over rows; a weight pass
//    forms dW1 = sum_r up^T rnd(d_u1pre) and dW2[de] = sum_r u1g[de]^T
//    rnd(d_u2pre)[de], split-K over row chunks. The JAX kernel carries the
//    sums in output blocks across its sequential grid; here blocks run in
//    parallel, so every sum over rows is one partial per block and warp,
//    unit or chunk, added up by the wrapper in a fixed order -- no atomics,
//    so the gradients repeat bit for bit from run to run.
//    * bf16: upscale_bwd_rows_wgmma_kernel (on bf16 wgmma, its up rows
//      landed by TMA beside W1 and W2, see the kernel) and
//      upscale_bwd_dw_kernel (decoder_mma.cuh).
//    * f32: upscale_bwd_rows_tf32_kernel (super-tiles of 64 rows streaming
//      W1 and W1^T) and upscale_bwd_dw_tf32_kernel (on TF32 wgmma, its rows
//      landed by TMA; see the kernel), in split TF32; rnd() is the
//      identity, so the scratch rows are f32.
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
//    cores: the first and second products per (d, e) block, the
//    hypernetwork sum over c2 against hyper^T, and in the backward d_u1g =
//    rnd(d_u2pre) . W2^T and d_up = rnd(d_u1pre) . W1^T; in bf16 on wgmma
//    (the forward's hypernetwork sum on mma.sync, straight from the
//    accumulators), each operand a bf16 rounding point of the JAX kernel,
//    so each term is exact; in f32 as lo.hi + hi.lo + hi.hi on TF32 (the
//    weight pass on wgmma, the forward and row pass on mma.sync m16n8k8)
//    with the GELU in its erf form and exact derivative. The LayerNorms, GELUs and their backwards run in
//    f32 registers over a lane quad. The second product runs per (d, e)
//    block of W2 (64 x 128), not as the TPU's 256 x 512 Kronecker
//    expansion; LayerNorm reduces its 64 lanes with shuffles, not selector
//    matmuls. In f32, W1 (256 KB) does not fit in shared memory; streaming
//    it per 64-row super-tile reads each byte from L2 once for 64 rows.
//    The f32 weight pass (dW1, dW2: 51.5 GFLOP at 64 pairs x 4096 rows, 155
//    with the split, 0.312 ms at split TF32's rate, against 1.34 GB of rows
//    read once: 0.401 ms; byte-bound) runs on TF32 wgmma m64n256k8 /
//    m64n128k8 with TMA loads into an mbarrier ring, each element split
//    once; its four units of a chunk read 6 KB a row, of which the second
//    read of rnd(d_u1pre), 1 KB, is meant to come from L2. The bf16 row
//    pass (155 GFLOP with the recompute, 0.10 ms of wgmma; 822 MB of rows
//    in and out at n_out 1: 0.245 ms; byte-bound) leaves every row as
//    16-byte segments or by TMA and keeps its CUDA-core work -- the GELUs
//    (1024 tanh a row), LayerNorms and their backwards, ~35 K instructions
//    a row -- beside its products on wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_tf32.cuh"
#include "hopper.cuh"

namespace {

constexpr int C = 256;          // input channels (every SAM decoder)
constexpr int C1 = C / 4;       // channels after the first upscale
constexpr int C2 = C / 8;       // channels after the second upscale
constexpr int L1 = 4 * C1;      // lanes (d, e, c1) of the first upscale
constexpr int LQ = 4 * C2;      // lanes (f, g, c2) of one (d, e) block
constexpr int MAXT = 4;         // mask tokens per pair

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kKappa = 0.044715f;

// the f32 GELU (erf form) and its exact derivative; the bf16 kernels take
// the tanh form on rwu::tanh_fast
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;
}

// ------------------------------------------ bf16 backward, two passes ----
using dec::bf16;

// The row pass on wgmma and TMA (upscale_bwd_rows_wgmma_kernel). A unit is
// 64 rows (one m64 tile) of one pair: u = pair * tpp + tile, tpp = ceil(m
// / 64); block b takes units b, b + G, b + 2 G, ... (G blocks). Both
// warpgroups work on the block's unit, warpgroup w on the (d, e)
// blocks 2 w and 2 w + 1 (their whole chain, so a (d, e) block's
// LayerNorms reduce over a lane quad alone) and on d_up's channels 128
// w..: so the unit's up rows and rnd(d_u1pre) rows are one slot each (in
// turns, each warpgroup would need both: 272 KB beside the weights).
//   loads (thread 0): W1 (four slabs of 64 lanes x C rows) and W2 (two
//     slabs of 64 lanes x C1 rows) once per block; a unit's up rows as
//     boxes of 64 columns x 64 rows in the 128-byte swizzle (rows past M
//     land as zero), the next unit's once both warpgroups are done with
//     this one's first products (they land while d_up is formed).
//   per (d, e) block:
//     u1pre = up . W1[:, de] (16 wgmma m64n64k16, up K-major, W1 MN-major),
//       its LayerNorm over the 64 lanes (f32, quad shuffles), u1g =
//       rnd(gelu(rnd(y g + bt))) into the next product's A fragments and
//       the block's box of the rnd(d_u1pre) slot, stored from there to its
//       rows by TMA while that product runs;
//     u2pre = u1g . W2 (4 wgmma m64n128k16, A in registers, W2 MN-major),
//       per (f, g) group of 32 lanes: u2g = rnd(gelu(rnd(u2pre + b2))) and
//       d_u2pre = (dm . hyper) gelu'(...) in f32 (dm from device memory, the
//       pair's hyper in registers), db2's column sums, d_hyper's (each
//       warp's into shared memory, then the warpgroup's added there in warp
//       order: one partial a unit); rnd(d_u2pre) to its rows and into the
//       next product's A fragments;
//     d_u1g = rnd(d_u2pre) . W2^T (8 wgmma m64n64k16, A in registers, W2
//       K-major: the same copy), the GELU and LayerNorm backward in f32,
//       dg, dbt and db1's column sums; rnd(d_u1pre) into the block's box
//       (K-major for the last product).
//   then, both warpgroups' blocks in the slot: rnd(d_u1pre) from there to
//     its rows by TMA; d_up = rnd(d_u1pre) . W1^T (16 wgmma m64n128k16,
//     both K-major: W1 through the same copy), the warpgroup's 128
//     channels staged over the slot and stored by TMA.
// rnd(d_u2pre) of the second (d, e) block is staged over the warpgroup's
// half of the up slot, free by then, and stored by TMA; that of the first
// (no room is left to stage it) leaves registers as 16-byte row segments
// (store_quad: a warp writes 64-byte runs of 8 rows): the
// mma.sync kernel's 4-byte row stores cost it 0.37 ms, and a first version
// of this one with all rows leaving as 16-byte segments lost 0.25 ms to
// them (NVIDIA H100 80GB HBM3 at 700 W, utils/kernel_variants.py --target
// k3_rows). The column sums reduce over a
// warp's 16 rows by group_sum8 and over its units in registers: one
// partial a block and warp index (the two warpgroups' warps w hold
// disjoint (d, e) blocks); d_hyper one partial a unit. The wrapper adds
// the partials in a fixed order: no atomics, the same bits every run.
// Shared memory: W1 (128 KB) and W2 (16 KB) as TMA lands them, the up and
// rnd(d_u1pre) slots (32 KB each), each warpgroup's d_hyper sums (4 warps
// x MAXT tokens x 128 lanes f32, 8 KB), barriers: 225.1 KB. No producer
// warp: the loads are few, and a block of two warpgroups lets a thread
// take 255 registers (the chain of a (d, e) block spilled at 168, and at
// 232 after setmaxnreg, with one).
namespace rwu {

constexpr int RR = 64;                      // rows of a unit
constexpr int BOX = RR * 128;               // 64 bf16 columns x RR rows
constexpr int SLOT = (C / 64) * BOX;        // a unit's C-wide rows: 32 KB
constexpr int W1_SLAB = C * 128;            // 64 lanes x C rows of W1
constexpr int W2_SLAB = C1 * 128;           // 64 lanes x C1 rows of W2
constexpr int WEIGHTS = 4 * W1_SLAB + 2 * W2_SLAB;
constexpr int DH = 4 * MAXT * LQ;           // a warpgroup's d_hyper sums
constexpr int NTH = 256;                    // two warpgroups
constexpr size_t SMEM = 1024 + WEIGHTS + 2 * (size_t)SLOT +
                        sizeof(float) * 2 * DH + 2 * MAXT * C2 * 2 + 64;
static_assert(SMEM <= 232448, "shared memory of the bf16 row pass");

// tanh as 1 - 2 / (e^{2x} + 1) from ex2.approx and rcp.approx: within
// ~1e-7 of tanhf (absolute; ample for values rounded to bf16 next or
// scaled by a bf16-rounded gradient) in 6 instructions against tanhf's
// ~20 (1024 of them a row); e^{2x} = inf past x ~ 44 gives 1, 0 below
// x ~ -44 gives -1
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, attn::mma::exp2_approx(2.8853900817779268f * x) +
                                   1.f);
}

// gelu (tanh form) of x, and with its derivative, on tanh_fast
__device__ __forceinline__ float gelu_fast(float x) {
  return 0.5f * x * (1.f + tanh_fast(kSqrt2OverPi * (x + kKappa * x * x * x)));
}
__device__ __forceinline__ float gelu_and_grad_fast(float x, float* grad) {
  const float t = tanh_fast(kSqrt2OverPi * (x + kKappa * x * x * x));
  *grad = 0.5f * (1.f + t) +
          0.5f * x * (1.f - t * t) * (kSqrt2OverPi * (1.f + 3.f * kKappa * x * x));
  return 0.5f * x * (1.f + t);
}
__device__ __forceinline__ float gelu_grad_fast(float x) {
  float grad;
  gelu_and_grad_fast(x, &grad);
  return grad;
}

// acc[b * N + i] += v for the block b (0 or 1) known only at run time: a
// select, so the accumulators stay in registers
template <int N>
__device__ __forceinline__ void add_at(float (&acc)[2 * N], int b, int i,
                                       float v) {
  if (b == 0)
    acc[i] += v;
  else
    acc[N + i] += v;
}

// u1pre of one (d, e) block (a wgmma m64n64 accumulator tile) -> y in
// place: + b1, the LayerNorm over the block's 64 lanes in f32 (the mean,
// then the centred variance, each over a lane quad); rs: 1/std of the
// lane's rows g, g + 8 (the bf16 forward)
__device__ __forceinline__ void layer_norm(float (&a)[32], float (&rs)[2],
                                           const float* b1, float eps,
                                           int t) {
  float su[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j + 2 * t));
    a[4 * j] += b.x, a[4 * j + 1] += b.y;
    a[4 * j + 2] += b.x, a[4 * j + 3] += b.y;
    su[0] += a[4 * j] + a[4 * j + 1];
    su[1] += a[4 * j + 2] + a[4 * j + 3];
  }
  const float mu[2] = {dec::quad_sum(su[0]) * (1.f / C1),
                       dec::quad_sum(su[1]) * (1.f / C1)};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    a[e] -= mu[(e >> 1) & 1];
    v[(e >> 1) & 1] = fmaf(a[e], a[e], v[(e >> 1) & 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rs[r] = rsqrtf(dec::quad_sum(v[r]) * (1.f / C1) + eps);
#pragma unroll
  for (int e = 0; e < 32; ++e) a[e] *= rs[(e >> 1) & 1];
}

}  // namespace rwu

__global__ void __launch_bounds__(rwu::NTH, 1)
    upscale_bwd_rows_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_up,
        const __grid_constant__ CUtensorMap tm_w1,
        const __grid_constant__ CUtensorMap tm_w2,
        const __grid_constant__ CUtensorMap tm_dup,
        const __grid_constant__ CUtensorMap tm_u1g,
        const __grid_constant__ CUtensorMap tm_du1,
        const __grid_constant__ CUtensorMap tm_d2, const float* dm,
        const float* b1, const float* g, const float* bt, const float* b2,
        const bf16* hyper, bf16* d2_rows, float* db1_p, float* dg_p,
        float* dbt_p, float* db2_p, float* dht_u, int bp, int m, int n_out,
        float eps) {
  using namespace hop;
  using namespace rwu;
  using dec::group_col;
  using dec::group_sum8;
  using dec::pack_bf16;
  using dec::quad_sum;
  using dec::round_bf16;
  using dec::store_quad;
  using dec::up2;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array (shared accesses)
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* w1_s = base;                // slab s: lanes 64 s.., C rows
  unsigned char* w2_s = w1_s + 4 * W1_SLAB;  // slab s: lanes 64 s.., C1 rows
  unsigned char* up_s = w2_s + 2 * W2_SLAB;  // the unit's up rows
  unsigned char* du_s = up_s + SLOT;         // the unit's rnd(d_u1pre) rows
  float* dh_s = reinterpret_cast<float*>(du_s + SLOT);  // [wg][warp][t][LQ]
  // the unit's pair's hyper, double-buffered by unit: [2][MAXT][C2] bf16
  uint32_t* hy_s = reinterpret_cast<uint32_t*>(dh_s + 2 * DH);
  uint64_t* up_full = reinterpret_cast<uint64_t*>(hy_s + MAXT * C2);
  uint64_t* wbar = up_full + 1;
  const int tpp = (m + RR - 1) / RR, units = bp * tpp, lanes = n_out * 16;
  // the up rows of unit u into the slot (thread 0)
  auto load_up = [&](int u) {
    const int pair = u / tpp, r0 = (u - pair * tpp) * RR;
    mbar_expect_tx(up_full, SLOT);
#pragma unroll
    for (int b = 0; b < C / 64; ++b)
      tma_load_3d(up_s + b * BOX, &tm_up, up_full, 64 * b, r0, pair);
  };
  if (threadIdx.x == 0) {
    mbar_init(up_full, 1);
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, WEIGHTS);
    for (int s = 0; s < 4; ++s)
      tma_load_2d(w1_s + s * W1_SLAB, &tm_w1, wbar, 64 * s, 0);
    for (int s = 0; s < 2; ++s)
      tma_load_2d(w2_s + s * W2_SLAB, &tm_w2, wbar, 64 * s, 0);
    if (blockIdx.x < units) load_up(blockIdx.x);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int wgi = warp >> 2, wq = warp & 3, t = lane & 3;
  const int tid = threadIdx.x & 127;
  const int R0 = 16 * wq + (lane >> 2);  // the lane's rows R0, R0 + 8
  float* dhw = dh_s + (wgi * 4 + wq) * MAXT * LQ;  // this warp's d_hyper sums
  const float* dhg = dh_s + wgi * DH;              // its warpgroup's
  // the operands' wgmma descriptors: a k step moves the address field
  // (bytes / 16) alone
  const uint64_t d_ups = desc(up_s, 16, 1024, LAYOUT_SW128);      // K-major
  const uint64_t d_dus = desc(du_s, 16, 1024, LAYOUT_SW128);      // K-major
  const uint64_t d_w1_mn = desc(w1_s, W1_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_w1_k = desc(w1_s, 16, 1024, LAYOUT_SW128);
  const uint64_t d_w2_mn = desc(w2_s, W2_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_w2_k = desc(w2_s, 16, 1024, LAYOUT_SW128);
  // the column sums of the warpgroup's (d, e) blocks 2 wgi + d, in
  // group_sum8's layout (lane -> column group_col)
  float a_db2[8], a_db1[4], a_dg[4], a_dbt[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) a_db2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) a_db1[i] = a_dg[i] = a_dbt[i] = 0.f;
  mbar_wait(wbar, 0);

  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int pair = u / tpp, r0 = (u - pair * tpp) * RR;
    const bool ok0 = r0 + R0 < m, ok1 = r0 + R0 + 8 < m;
    const size_t row0 = (size_t)pair * m + r0 + R0, row1 = row0 + 8;
    // the pair's hyper into this unit's buffer (zero past n_out), read
    // after the barrier below
    uint32_t* hyb = hy_s + (k & 1) * (MAXT * C2 / 2);
    if (threadIdx.x < MAXT * C2 / 2) {
      const int tt = threadIdx.x / (C2 / 2);
      hyb[threadIdx.x] = tt < n_out
                             ? __ldg(reinterpret_cast<const unsigned int*>(
                                         hyper + (size_t)pair * n_out * C2) +
                                     threadIdx.x)
                             : 0u;
    }
    if (tid == 0) bulk_wait_read();
    named_sync(1, NTH);  // the last unit's slot and sums are read
    mbar_wait(up_full, k & 1);

#pragma unroll 1
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * wgi + d;
      // the block's dm (lanes (t, de, fg)): a float4 of the four (f, g) a
      // row and token, loaded while the first product runs
      float4 dmq[2][MAXT];
#pragma unroll
      for (int tt = 0; tt < MAXT; ++tt) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const int l = tt * 16 + de * 4;
        dmq[0][tt] = (tt < n_out && ok0) ? __ldg(reinterpret_cast<const float4*>(
                                               dm + row0 * lanes + l))
                                         : z;
        dmq[1][tt] = (tt < n_out && ok1) ? __ldg(reinterpret_cast<const float4*>(
                                               dm + row1 * lanes + l))
                                         : z;
      }
      // u1pre = up . W1[:, de] + b1, its LayerNorm (f32: the mean, then the
      // centred variance), y in a1
      float a1[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        mma_bf16_ss_bmn<64>(a1, d_ups + 512 * (kk >> 2) + 2 * (kk & 3),
                            d_w1_mn + 2048 * de + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a1);
      float rs[2];
      {
        float su[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j +
                                                                 2 * t));
          a1[4 * j] += b.x, a1[4 * j + 1] += b.y;
          a1[4 * j + 2] += b.x, a1[4 * j + 3] += b.y;
          su[0] += a1[4 * j] + a1[4 * j + 1];
          su[1] += a1[4 * j + 2] + a1[4 * j + 3];
        }
        const float mu0 = quad_sum(su[0]) * (1.f / C1);
        const float mu1 = quad_sum(su[1]) * (1.f / C1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a1[4 * j] -= mu0, a1[4 * j + 1] -= mu0;
          a1[4 * j + 2] -= mu1, a1[4 * j + 3] -= mu1;
          v[0] = fmaf(a1[4 * j], a1[4 * j], fmaf(a1[4 * j + 1], a1[4 * j + 1], v[0]));
          v[1] = fmaf(a1[4 * j + 2], a1[4 * j + 2], fmaf(a1[4 * j + 3], a1[4 * j + 3], v[1]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rs[r] = rsqrtf(quad_sum(v[r]) * (1.f / C1) + eps);
#pragma unroll
        for (int e = 0; e < 32; ++e) a1[e] *= rs[(e >> 1) & 1];
      }
      // u1g = rnd(gelu(rnd(y g + bt))): the next product's A fragments
      // (one k16 step per two n-tiles) and the scratch rows (staged in the
      // block's box of the slot, stored from there by TMA while the next
      // product runs)
      uint32_t ua[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 gg = __ldg(reinterpret_cast<const float2*>(g + c));
        const float2 tb = __ldg(reinterpret_cast<const float2*>(bt + c));
        ua[j / 2][(j & 1) * 2] =
            pack_bf16(gelu_fast(round_bf16(a1[4 * j] * gg.x + tb.x)),
                      gelu_fast(round_bf16(a1[4 * j + 1] * gg.y + tb.y)));
        ua[j / 2][(j & 1) * 2 + 1] =
            pack_bf16(gelu_fast(round_bf16(a1[4 * j + 2] * gg.x + tb.x)),
                      gelu_fast(round_bf16(a1[4 * j + 3] * gg.y + tb.y)));
      }

      // u2pre = u1g . W2 over the 128 lanes (f, g, c2)
      float a2[64];
      fence_operands(ua);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C1 / 16; ++kk)
        mma_bf16_rs_mn<128>(a2, ua[kk], d_w2_mn + 128 * kk, kk > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = C1 * de + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0, c)) =
            ua[j / 2][(j & 1) * 2];
        *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0 + 8, c)) =
            ua[j / 2][(j & 1) * 2 + 1];
      }
      fence_proxy_async();
      named_sync(2 + wgi, 128);  // the box holds u1g of the unit's rows
      if (tid == 0) {
        tma_store_3d(&tm_u1g, du_s + de * BOX, C1 * de, r0, pair);
        bulk_commit();
      }
      wgmma_wait<0>();
      fence_operands(a2);
      if (d == 1) named_sync(2 + wgi, 128);  // d = 0's d_hyper sums are read
      // per (f, g) group of four n-tiles (32 lanes c2): u2g = rnd(gelu(
      // rnd(u2pre + b2))), d_u2pre = (sum_t dm hyper) gelu'(..) in f32 over
      // u2pre in a2; db2's and d_hyper's column sums
#pragma unroll
      for (int fg = 0; fg < 4; ++fg) {
        float dmv[2][MAXT];
#pragma unroll
        for (int tt = 0; tt < MAXT; ++tt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dmv[r][tt] = fg == 0   ? dmq[r][tt].x
                         : fg == 1 ? dmq[r][tt].y
                         : fg == 2 ? dmq[r][tt].z
                                   : dmq[r][tt].w;
        float ug[4][4], vb2[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * fg + jj, c2 = 8 * jj + 2 * t;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c2));
          float2 hy[MAXT];
#pragma unroll
          for (int tt = 0; tt < MAXT; ++tt)
            hy[tt] = up2(hyb[tt * (C2 / 2) + 4 * jj + t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // rows R0 (e < 2), R0 + 8; column e & 1
            const float u2r = round_bf16(a2[4 * j + e] + ((e & 1) ? bb.y : bb.x));
            float grad;
            ug[jj][e] = round_bf16(gelu_and_grad_fast(u2r, &grad));
            float du = 0.f;
#pragma unroll
            for (int tt = 0; tt < MAXT; ++tt)
              if (tt < n_out)
                du = fmaf(dmv[e >> 1][tt], (e & 1) ? hy[tt].y : hy[tt].x, du);
            a2[4 * j + e] = du * grad;  // d_u2pre, f32
          }
          vb2[2 * jj] = a2[4 * j] + a2[4 * j + 2];
          vb2[2 * jj + 1] = a2[4 * j + 1] + a2[4 * j + 3];
        }
        add_at<4>(a_db2, d, fg, group_sum8(vb2, lane));
        // d_hyper: the warp's sums over its rows of dm * u2g
#pragma unroll
        for (int tt = 0; tt < MAXT; ++tt)
          if (tt < n_out) {
            float vh[8];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              vh[2 * jj] = dmv[0][tt] * ug[jj][0] + dmv[1][tt] * ug[jj][2];
              vh[2 * jj + 1] = dmv[0][tt] * ug[jj][1] + dmv[1][tt] * ug[jj][3];
            }
            dhw[tt * LQ + 32 * fg + group_col(0, lane)] = group_sum8(vh, lane);
          }
      }
      named_sync(2 + wgi, 128);  // the warpgroup's d_hyper sums are in
      // d_hyper of the unit, this (d, e) block: the four warps' sums added
      // in warp order, a lane a column
      for (int tt = 0; tt < n_out; ++tt)
        dht_u[((size_t)u * n_out + tt) * 4 * LQ + LQ * de + tid] =
            dhg[tt * LQ + tid] + dhg[(MAXT + tt) * LQ + tid] +
            dhg[(2 * MAXT + tt) * LQ + tid] + dhg[(3 * MAXT + tt) * LQ + tid];

      // rnd(d_u2pre): the next product's A fragments and the scratch rows
      uint32_t da[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          da[kk][i] = pack_bf16(a2[8 * kk + 2 * i], a2[8 * kk + 2 * i + 1]);
      if (d == 0) {  // the up rows are still read: from registers
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          uint32_t w0[4], w1[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * a + jj;
            w0[jj] = da[j / 2][(j & 1) * 2];
            w1[jj] = da[j / 2][(j & 1) * 2 + 1];
          }
          store_quad(d2_rows + row0 * 4 * LQ + LQ * de + 32 * a, ok0, w0, t);
          store_quad(d2_rows + row1 * 4 * LQ + LQ * de + 32 * a, ok1, w1, t);
        }
      } else {  // staged over the warpgroup's half of the up slot, by TMA
        named_sync(1, NTH);  // both warpgroups' products have read up
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * wgi + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(up_s + sw128_off<RR>(R0, c)) =
              da[j / 2][(j & 1) * 2];
          *reinterpret_cast<uint32_t*>(up_s + sw128_off<RR>(R0 + 8, c)) =
              da[j / 2][(j & 1) * 2 + 1];
        }
        fence_proxy_async();
        named_sync(2 + wgi, 128);  // the boxes hold the block's d_u2pre
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_store_3d(&tm_d2, up_s + (2 * wgi + b) * BOX,
                         LQ * de + 64 * b, r0, pair);
          bulk_commit();
        }
      }

      // d_u1g = rnd(d_u2pre) . W2^T over the block's 64 lanes
      float a3[32];
      fence_operands(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LQ / 16; ++kk)
        mma_bf16_rs<64>(a3, da[kk], d_w2_k + 512 * (kk >> 2) + 2 * (kk & 3),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a3);
      // the GELU and LayerNorm-affine backward (d_out1 in a3), dg, dbt
      float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vg[8], vt[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * t;
          const float2 gg = __ldg(reinterpret_cast<const float2*>(g + c));
          const float2 tb = __ldg(reinterpret_cast<const float2*>(bt + c));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gc = (e & 1) ? gg.y : gg.x;
            const float y = a1[4 * j + e];
            const float d1 =
                a3[4 * j + e] *
                gelu_grad_fast(round_bf16(y * gc + ((e & 1) ? tb.y : tb.x)));
            a3[4 * j + e] = d1;
            const float dyv = d1 * gc;
            sa[e >> 1] += dyv;
            sb[e >> 1] = fmaf(dyv, y, sb[e >> 1]);
          }
          vg[2 * jj] = a3[4 * j] * a1[4 * j] + a3[4 * j + 2] * a1[4 * j + 2];
          vg[2 * jj + 1] =
              a3[4 * j + 1] * a1[4 * j + 1] + a3[4 * j + 3] * a1[4 * j + 3];
          vt[2 * jj] = a3[4 * j] + a3[4 * j + 2];
          vt[2 * jj + 1] = a3[4 * j + 1] + a3[4 * j + 3];
        }
        add_at<2>(a_dg, d, grp, group_sum8(vg, lane));
        add_at<2>(a_dbt, d, grp, group_sum8(vt, lane));
      }
      float m1[2], m2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m1[r] = quad_sum(sa[r]) * (1.f / C1);
        m2[r] = quad_sum(sb[r]) * (1.f / C1);
      }
      // d_u1pre = rstd (d_y - mean d_y - y mean(d_y y)), db1 (f32); rnd
      // into the slot, over u1g once its store has read it
      if (tid == 0) bulk_wait_read();
      named_sync(2 + wgi, 128);
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        float vd[8];
        uint32_t w0[4], w1[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * grp + jj, c = 8 * j + 2 * t;
          const float2 gg = __ldg(reinterpret_cast<const float2*>(g + c));
          const float e0 = rs[0] * (a3[4 * j] * gg.x - m1[0] - a1[4 * j] * m2[0]);
          const float e1 = rs[0] * (a3[4 * j + 1] * gg.y - m1[0] - a1[4 * j + 1] * m2[0]);
          const float e2 = rs[1] * (a3[4 * j + 2] * gg.x - m1[1] - a1[4 * j + 2] * m2[1]);
          const float e3 = rs[1] * (a3[4 * j + 3] * gg.y - m1[1] - a1[4 * j + 3] * m2[1]);
          vd[2 * jj] = e0 + e2;
          vd[2 * jj + 1] = e1 + e3;
          w0[jj] = pack_bf16(e0, e1);
          w1[jj] = pack_bf16(e2, e3);
          *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0, C1 * de + c)) = w0[jj];
          *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0 + 8, C1 * de + c)) = w1[jj];
        }
        add_at<2>(a_db1, d, grp, group_sum8(vd, lane));
      }
    }

    // d_up = rnd(d_u1pre) . W1^T, the warpgroup's 128 channels
    fence_proxy_async();       // the slot's writes -> TMA's and wgmma's
    if (tid == 0) bulk_wait_read();  // (the up slot's stores too)
    named_sync(1, NTH);  // the slot holds all four (d, e) blocks
    if (threadIdx.x == 0) {    // rnd(d_u1pre) to its rows (not past M)
#pragma unroll
      for (int b = 0; b < C / 64; ++b)
        tma_store_3d(&tm_du1, du_s + b * BOX, 64 * b, r0, pair);
      bulk_commit();
      if (u + (int)gridDim.x < units) load_up(u + gridDim.x);  // up is read
    }
    {
      float a4[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L1 / 16; ++kk)
        mma_bf16_ss<128>(a4, d_dus + 512 * (kk >> 2) + 2 * (kk & 3),
                         d_w1_k + 1024 * wgi + 2048 * (kk >> 2) + 2 * (kk & 3),
                         kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a4);
      // d_up staged over the slot once both products and the store of
      // rnd(d_u1pre) have read it, stored from there by TMA
      if (threadIdx.x == 0) bulk_wait_read();
      named_sync(1, NTH);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * wgi + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0, c)) =
            pack_bf16(a4[4 * j], a4[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(du_s + sw128_off<RR>(R0 + 8, c)) =
            pack_bf16(a4[4 * j + 2], a4[4 * j + 3]);
      }
      fence_proxy_async();
      named_sync(2 + wgi, 128);  // the boxes hold the warpgroup's d_up
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          tma_store_3d(&tm_dup, du_s + (2 * wgi + b) * BOX,
                       128 * wgi + 64 * b, r0, pair);
        bulk_commit();
      }
    }
  }

  if (tid == 0) bulk_wait();  // the last TMA stores are done
  // the column sums: one partial a block and warp index, the warpgroup's
  // (d, e) blocks
  const size_t pw = (size_t)blockIdx.x * 4 + wq;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int de = 2 * wgi + d;
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      const int col = C1 * de + group_col(grp, lane);
      db1_p[pw * L1 + col] = a_db1[2 * d + grp];
      dg_p[pw * L1 + col] = a_dg[2 * d + grp];
      dbt_p[pw * L1 + col] = a_dbt[2 * d + grp];
    }
#pragma unroll
    for (int fg = 0; fg < 4; ++fg)
      db2_p[pw * 4 * LQ + LQ * de + group_col(fg, lane)] = a_db2[4 * d + fg];
  }
}

// The bf16 forward on wgmma and TMA (upscale_fwd_wgmma_kernel). A unit is
// 64 rows (one m64 tile) of one pair, as in the row pass: u = pair * tpp +
// tile, tpp = ceil(m / 64); block b takes units b, b + G, ... (G blocks).
// Both warpgroups work on the block's unit, warpgroup w on the (d, e)
// blocks 2 w and 2 w + 1, so a (d, e) block's LayerNorm reduces over a
// lane quad alone and the unit's up rows are one slot for both.
//   loads (thread 0): W1 (four slabs of 64 lanes x C rows) and W2 (two
//     slabs of 64 lanes x C1 rows) once per block, as the row pass lands
//     them; a unit's up rows as boxes of 64 columns x 64 rows in the
//     128-byte swizzle (rows past M land as zero) into one of two slots,
//     the next unit's while this one computes.
//   per (d, e) block:
//     u1pre = up . W1[:, de] (16 wgmma m64n64k16, up K-major, W1 MN-major),
//       its LayerNorm over the 64 lanes (f32, quad shuffles), u1g =
//       rnd(gelu(rnd(y g + bt))) into the next product's A fragments;
//     u2pre = u1g . W2 (4 wgmma m64n128k16, A in registers, W2 MN-major);
//     per (f, g) group of 32 lanes c2: u2g = rnd(gelu(rnd(u2pre + b2))) as
//       the A fragments of the hypernetwork sum, two mma.sync m16n8k16 per
//       warp straight from the accumulators against hyper^T (the pair's
//       n_out <= 4 tokens padded to 8, B fragments from device memory);
//     the block's outputs leave registers as 16-byte segments: a lane holds
//       the four (f, g) of its rows and tokens, contiguous in the row.
// The GELUs run on rwu::gelu_fast, the row pass's recompute. No partial
// sums, no barrier but one a unit (both warpgroups are done with the slot
// the next unit's rows land in). Shared memory: W1 (128 KB), W2 (16 KB),
// two up slots (32 KB each), barriers.
namespace fwu {

constexpr int RR = rwu::RR;    // rows of a unit
constexpr int NTH = 256;       // two warpgroups
constexpr size_t SMEM = 1024 + rwu::WEIGHTS + 2 * (size_t)rwu::SLOT + 64;
static_assert(SMEM <= 232448, "shared memory of the bf16 forward");

}  // namespace fwu

__global__ void __launch_bounds__(fwu::NTH, 1)
    upscale_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_up,
                             const __grid_constant__ CUtensorMap tm_w1,
                             const __grid_constant__ CUtensorMap tm_w2,
                             const float* b1, const float* g, const float* bt,
                             const float* b2, const bf16* hyper, float* out,
                             int bp, int m, int n_out, float eps) {
  using namespace hop;
  using namespace rwu;
  using dec::ld_u32;
  using dec::mma16816;
  using dec::pack_bf16;
  using dec::round_bf16;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* w1_s = base;                // slab s: lanes 64 s.., C rows
  unsigned char* w2_s = w1_s + 4 * W1_SLAB;  // slab s: lanes 64 s.., C1 rows
  unsigned char* up_s = w2_s + 2 * W2_SLAB;  // two slots: unit k in k & 1
  uint64_t* full = reinterpret_cast<uint64_t*>(up_s + 2 * SLOT);  // [2]
  uint64_t* wbar = full + 2;
  const int tpp = (m + RR - 1) / RR, units = bp * tpp, lanes = n_out * 16;
  // the up rows of unit u into slot s (thread 0)
  auto load_up = [&](int u, int s) {
    const int pair = u / tpp, r0 = (u - pair * tpp) * RR;
    mbar_expect_tx(full + s, SLOT);
#pragma unroll
    for (int b = 0; b < C / 64; ++b)
      tma_load_3d(up_s + s * SLOT + b * BOX, &tm_up, full + s, 64 * b, r0,
                  pair);
  };
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, WEIGHTS);
    for (int s = 0; s < 4; ++s)
      tma_load_2d(w1_s + s * W1_SLAB, &tm_w1, wbar, 64 * s, 0);
    for (int s = 0; s < 2; ++s)
      tma_load_2d(w2_s + s * W2_SLAB, &tm_w2, wbar, 64 * s, 0);
    if (blockIdx.x < units) load_up(blockIdx.x, 0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp >> 2, wq = warp & 3, t = lane & 3, gq = lane >> 2;
  const int R0 = 16 * wq + gq;  // the lane's rows R0, R0 + 8
  const uint64_t d_w1_mn = desc(w1_s, W1_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_w2_mn = desc(w2_s, W2_SLAB, 1024, LAYOUT_SW128);
  mbar_wait(wbar, 0);

  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int pair = u / tpp, r0 = (u - pair * tpp) * RR, s = k & 1;
    const bool ok0 = r0 + R0 < m, ok1 = r0 + R0 + 8 < m;
    float* row0 = out + ((size_t)pair * m + r0 + R0) * lanes;
    float* row1 = row0 + 8 * lanes;
    named_sync(1, NTH);  // both warpgroups are done with the other slot
    if (threadIdx.x == 0 && u + (int)gridDim.x < units)
      load_up(u + gridDim.x, s ^ 1);
    // hyper^T as mma.sync B fragments, one per k16 step of c2: column =
    // mask token gq (zero past n_out)
    const bf16* hy = hyper + ((size_t)pair * n_out + gq) * C2;
    const bool tok = gq < n_out;
    uint32_t hb[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      hb[kk][0] = tok ? ld_u32(hy + 16 * kk + 2 * t) : 0u;
      hb[kk][1] = tok ? ld_u32(hy + 16 * kk + 8 + 2 * t) : 0u;
    }
    const uint64_t d_ups = desc(up_s + s * SLOT, 16, 1024, LAYOUT_SW128);
    mbar_wait(full + s, (k >> 1) & 1);

#pragma unroll 1
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * wgi + d;
      // u1pre = up . W1[:, de] + b1, its LayerNorm (f32: the mean, then the
      // centred variance), y in a1
      float a1[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        mma_bf16_ss_bmn<64>(a1, d_ups + 512 * (ks >> 2) + 2 * (ks & 3),
                            d_w1_mn + 2048 * de + 128 * ks, ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a1);
      float rs[2];
      layer_norm(a1, rs, b1, eps, t);
      // u1g = rnd(gelu(rnd(y g + bt))): the next product's A fragments
      // (one k16 step per two n-tiles)
      uint32_t ua[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 gg = __ldg(reinterpret_cast<const float2*>(g + c));
        const float2 tb = __ldg(reinterpret_cast<const float2*>(bt + c));
        ua[j / 2][(j & 1) * 2] =
            pack_bf16(gelu_fast(round_bf16(a1[4 * j] * gg.x + tb.x)),
                      gelu_fast(round_bf16(a1[4 * j + 1] * gg.y + tb.y)));
        ua[j / 2][(j & 1) * 2 + 1] =
            pack_bf16(gelu_fast(round_bf16(a1[4 * j + 2] * gg.x + tb.x)),
                      gelu_fast(round_bf16(a1[4 * j + 3] * gg.y + tb.y)));
      }

      // u2pre = u1g . W2 over the 128 lanes (f, g, c2)
      float a2[64];
      fence_operands(ua);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C1 / 16; ++ks)
        mma_bf16_rs_mn<128>(a2, ua[ks], d_w2_mn + 128 * ks, ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a2);
      // per (f, g): u2g = rnd(gelu(rnd(u2pre + b2))) as A fragments (k16
      // steps of c2), out[t] = sum_c2 u2g hyper[t] on mma.sync: o[fg] rows
      // R0 (o[fg][0..1]) and R0 + 8 (o[fg][2..3]), tokens 2t, 2t + 1
      float o[4][4];
#pragma unroll
      for (int fg = 0; fg < 4; ++fg) {
        uint32_t ha[2][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * fg + jj;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(
              b2 + 8 * jj + 2 * t));
          ha[jj / 2][(jj & 1) * 2] =
              pack_bf16(gelu_fast(round_bf16(a2[4 * j] + bb.x)),
                        gelu_fast(round_bf16(a2[4 * j + 1] + bb.y)));
          ha[jj / 2][(jj & 1) * 2 + 1] =
              pack_bf16(gelu_fast(round_bf16(a2[4 * j + 2] + bb.x)),
                        gelu_fast(round_bf16(a2[4 * j + 3] + bb.y)));
        }
        o[fg][0] = o[fg][1] = o[fg][2] = o[fg][3] = 0.f;
        mma16816(o[fg], ha[0], hb[0][0], hb[0][1]);
        mma16816(o[fg], ha[1], hb[1][0], hb[1][1]);
      }
      // the lane's outputs: lanes (t, de, fg) of a row, the four fg of a
      // token contiguous (16 bytes)
      const int l = 2 * t * 16 + de * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * t + h >= n_out) continue;
        if (ok0)
          *reinterpret_cast<float4*>(row0 + l + 16 * h) =
              make_float4(o[0][h], o[1][h], o[2][h], o[3][h]);
        if (ok1)
          *reinterpret_cast<float4*>(row1 + l + 16 * h) =
              make_float4(o[0][2 + h], o[1][2 + h], o[2][2 + h], o[3][2 + h]);
      }
    }
  }
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
  // up, d_up, u1g and rnd(d_u1pre) (C, m, bp) and rnd(d_u2pre) (4 LQ, m,
  // bp) in boxes of 64 columns x rwu::RR rows; W1 [C][L1] and W2 [C1][LQ]
  // in slabs of 64 lanes x all rows; all in the 128-byte swizzle
  CUtensorMap maps[7];
  const cuuint64_t up_dims[3] = {(cuuint64_t)C, (cuuint64_t)m,
                                 (cuuint64_t)bp};
  const cuuint64_t up_strides[2] = {2ull * C, 2ull * C * m};
  const cuuint32_t up_box[3] = {64, (cuuint32_t)rwu::RR, 1};
  const cuuint64_t d2_dims[3] = {(cuuint64_t)(4 * LQ), (cuuint64_t)m,
                                 (cuuint64_t)bp};
  const cuuint64_t d2_strides[2] = {8ull * LQ, 8ull * LQ * m};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)L1, (cuuint64_t)C};
  const cuuint64_t w1_strides[1] = {2ull * L1};
  const cuuint32_t w1_box[2] = {64, (cuuint32_t)C};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)LQ, (cuuint64_t)C1};
  const cuuint64_t w2_strides[1] = {2ull * LQ};
  const cuuint32_t w2_box[2] = {64, (cuuint32_t)C1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hop::tensor_map(maps, bf, 3, a[0], up_dims, up_strides, up_box, sw) ||
      !hop::tensor_map(maps + 1, bf, 2, a[2], w1_dims, w1_strides, w1_box,
                       sw) ||
      !hop::tensor_map(maps + 2, bf, 2, a[6], w2_dims, w2_strides, w2_box,
                       sw) ||
      !hop::tensor_map(maps + 3, bf, 3, a[9], up_dims, up_strides, up_box,
                       sw) ||
      !hop::tensor_map(maps + 4, bf, 3, a[10], up_dims, up_strides, up_box,
                       sw) ||
      !hop::tensor_map(maps + 5, bf, 3, a[12], up_dims, up_strides, up_box,
                       sw) ||
      !hop::tensor_map(maps + 6, bf, 3, a[11], d2_dims, d2_strides, up_box,
                       sw))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_rows_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rwu::SMEM);
  if (e != cudaSuccess) return (int)e;
  auto f = [&](int i) { return static_cast<float*>(a[i]); };
  upscale_bwd_rows_wgmma_kernel<<<blocks, rwu::NTH, rwu::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], f(1),
      f(3), f(4), f(5), f(7), static_cast<const bf16*>(a[8]),
      static_cast<bf16*>(a[11]), f(13), f(14), f(15), f(16), f(17), bp, m,
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
constexpr int CS32 = 4 * LQ + 3 * L1;  // a slot's sums: db2, db1, dg, dbt
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
      dec32::st2(ts + gq * LDT + col, gelu(a[j][0] * g0 + e0),
                 gelu(a[j][1] * g1 + e1));
      dec32::st2(ts + (gq + 8) * LDT + col, gelu(a[j][2] * g0 + e0),
                 gelu(a[j][3] * g1 + e1));
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
          a2[j][0] = gelu(a2[j][0] + b0);
          a2[j][1] = gelu(a2[j][1] + b1v);
          a2[j][2] = gelu(a2[j][2] + b0);
          a2[j][3] = gelu(a2[j][3] + b1v);
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
        const float u0 = gelu(a[j][0] * g0 + e0);
        const float u1 = gelu(a[j][1] * g1 + e1);
        const float u2 = gelu(a[j][2] * g0 + e0);
        const float u3 = gelu(a[j][3] * g1 + e1);
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
              ug[jj][e] = gelu(u2);
              float du = 0.f;
#pragma unroll
              for (int t = 0; t < MAXT; ++t)
                if (t < n_out)
                  du = fmaf(dmv[e >> 1][t], hy[t * C2 + c2 + (e & 1)], du);
              a2[j][e] = du * gelu_grad(u2);  // d_u2pre
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
            const float d1 = a3[j][e] * gelu_grad(y[e] * gc + bt[c + (e & 1)]);
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

// The f32 weight pass on TF32 wgmma and TMA: block units (chunk, kind)
// sum over the chunk's rows
//   kind 0, 1: dW1 [C][L1] rows 128 kind.. = up[:, 128 kind..]^T .
//              rnd(d_u1pre), all 256 columns
//   kind 2, 3: dW2 [4][C1][LQ] blocks de = 2 (kind - 2) + w, w < 2:
//              dW2[de] = u1g[de]^T . rnd(d_u2pre)[de]
// into part[chunk] = [dW1 | dW2]. Every unit reads X = 128 columns of up or
// u1g and Y = 256 columns of rnd(d_u1pre) or rnd(d_u2pre) a row: 1.5 KB, 6
// KB a row over the four units against the 5 KB of the rows themselves.
// The two dW1 units of a chunk run in the same wave (units u = 4 chunk +
// kind, one block each), so that the second read of a chunk's rnd(d_u1pre)
// comes from L2 (ops/upscaler.py: upscale_dw_plan_f32). Persistent blocks
// walk the units with a producer warp (of a warpgroup that gives its
// registers to the consumers) and two consumer warpgroups;
// warpgroup w owns X columns 64 w.. of the unit: in dW1 a 64 x 256 block
// (128 f32 accumulators a thread), in dW2 the 64 x 128 block of its de.
//   producer: per stage of dwu::KR = 16 rows, the X rows (16 x 128 f32) and
//     the Y rows (16 x 256) by TMA into a ring of `stages` stages (the
//     plan's; at most dwu::MAX_STAGES), against full / empty mbarriers.
//   consumers: TF32 wgmma reads shared operands K-major only, and K (the
//     row index) is the slow one in both operands. So Y is split once per
//     element into hi and lo and written transposed, K-major without
//     swizzle, into one of two B buffers by the 256 consumer threads (a
//     thread a column, 16-byte stores of 4 rows); X is the register A
//     operand, each element loaded and split by the one thread whose
//     fragment holds it. Per k-step of 8 rows, wgmma m64nNk8 (N = 256 in
//     dW1, 128 in dW2) three times (lo.hi, hi.lo, hi.hi) into the one f32
//     accumulator; the next stage's transpose runs while the products are
//     in flight. Rows past the chunk enter as zero A values (a chunk's end
//     is not the tensor's: the Y rows there are the next chunk's, finite).
// The partials are summed by the wrapper in a fixed order: no atomics, the
// same bits every run. This is K4's f32 weight pass (decoder_attn.cu,
// dw32) on K3's operands, with no keys + pe to add.
namespace dwu {

constexpr int KR = 16;                     // rows of a stage: two k-steps
constexpr int MAX_STAGES = 6;
constexpr int CONSUMERS = 256;
constexpr int NTH = CONSUMERS + 128;  // and the producer's warpgroup
// registers a thread: 168 at launch (64K over 384 threads); the producer's
// warpgroup gives back all but 24, the consumers take them (240 each:
// 128 x 24 + 256 x 240 = 384 x 168), for a dW1 unit's 128 accumulators
// beside its split A fragments (at 168 ptxas serialized the wgmma)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int XW = 128, YW = 256;          // a unit's X and Y columns
constexpr int X_BYTES = KR * XW * 4;       // 8 KB
constexpr int Y_BYTES = KR * YW * 4;       // 16 KB
constexpr int STAGE_BYTES = X_BYTES + Y_BYTES;
constexpr int KSTEP_BYTES = YW * 8 * 4;    // one k-step of Y^T, hi or lo
constexpr int B_BYTES = 2 * (KR / 8) * KSTEP_BYTES;  // a stage's hi and lo
// alignment slack and the mbarriers, the ring, the two B buffers
__host__ __device__ constexpr size_t smem(int stages) {
  return 2048 + (size_t)stages * STAGE_BYTES + 2 * B_BYTES;
}
static_assert(smem(MAX_STAGES) <= 232448, "shared memory of the pass");

// rows 0..15 of a stage's Y -> its B buffer: split into TF32 hi and lo,
// K-major without swizzle (core matrices of 8 columns x 4 rows, 128 bytes;
// LBO 128 between the two row halves of a k-step, SBO 256 between
// 8-column groups), hi then lo per k-step. Thread c of the 256 consumers
// takes column c.
__device__ __forceinline__ void transpose_split(const unsigned char* stage,
                                               unsigned char* bbuf, int c) {
  const float* y = reinterpret_cast<const float*>(stage + X_BYTES);
#pragma unroll
  for (int q = 0; q < KR / 4; ++q) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) stf32::split(y[(4 * q + k) * YW + c], h[k], l[k]);
    unsigned char* dst = bbuf + (q >> 1) * 2 * KSTEP_BYTES + (c >> 3) * 256 +
                         (q & 1) * 128 + (c & 7) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + KSTEP_BYTES) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One unit's sum by the consumers, N = 256 (dW1) or 128 (dW2): warpgroup
// wgi's B columns start at b_col; its 64 x N partial goes to `out` (row
// i0 of the block, `ld` floats a row). `it` counts the ring's stages.
template <int N>
__device__ __forceinline__ void consume_unit(
    unsigned char* stages, unsigned char* bbufs, uint64_t* full,
    uint64_t* empty, int nstages, int& it, int lo, int hi, int b_col,
    int xcol, float* out, int ld) {
  using namespace hop;
  const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nst = (hi - lo + KR - 1) / KR;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  mbar_wait(full + it % nstages, (it / nstages) & 1);
  transpose_split(stages + (it % nstages) * STAGE_BYTES, bbufs, ct);
  fence_proxy_async();
  named_sync(1, CONSUMERS);
  for (int s = 0; s < nst; ++s, ++it) {
    const int st = it % nstages;
    const float* x =
        reinterpret_cast<const float*>(stages + st * STAGE_BYTES);
    uint32_t ah[KR / 8][4], al[KR / 8][4];  // split A fragments of X^T
#pragma unroll
    for (int kk = 0; kk < KR / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 8 * kk + t + 4 * (q >> 1);
        const int col = xcol + 16 * (warp & 3) + g + 8 * (q & 1);
        const float v = lo + s * KR + r < hi ? x[r * XW + col] : 0.f;
        stf32::split(v, ah[kk][q], al[kk][q]);
      }
    mbar_arrive(empty + st);  // X in registers, Y already transposed
    const unsigned char* b = bbufs + (s & 1) * B_BYTES + (b_col >> 3) * 256;
    fence_operands(ah);
    fence_operands(al);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 8; ++kk) {
      const uint64_t bh = desc(b + 2 * kk * KSTEP_BYTES, 128, 256,
                               LAYOUT_NONE);
      const uint64_t bl = desc(b + (2 * kk + 1) * KSTEP_BYTES, 128, 256,
                               LAYOUT_NONE);
      mma_tf32_rs<N>(acc, al[kk], bh, 1);  // the small terms first
      mma_tf32_rs<N>(acc, ah[kk], bl, 1);
      mma_tf32_rs<N>(acc, ah[kk], bh, 1);
    }
    wgmma_commit();
    if (s + 1 < nst) {  // the next stage's B while these run
      const int nx = it + 1;
      mbar_wait(full + nx % nstages, (nx / nstages) & 1);
      transpose_split(stages + (nx % nstages) * STAGE_BYTES,
                      bbufs + ((s + 1) & 1) * B_BYTES, ct);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    named_sync(1, CONSUMERS);  // B written, both buffers' products done
  }
  const int i0 = 16 * (warp & 3) + g;  // the lane's rows i0, i0 + 8
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      dec32::st2(out + (size_t)(i0 + 8 * h) * ld + 8 * j + 2 * t,
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

}  // namespace dwu

__global__ void __launch_bounds__(dwu::NTH, 1)
    upscale_bwd_dw_tf32_kernel(const __grid_constant__ CUtensorMap tm_up,
                               const __grid_constant__ CUtensorMap tm_u1g,
                               const __grid_constant__ CUtensorMap tm_d2,
                               const __grid_constant__ CUtensorMap tm_du1,
                               float* part, int rows, int chunk, int nchunks,
                               int nstages) {
  using namespace hop;
  using namespace dwu;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* stages = base + 1024;
  unsigned char* bbufs = stages + nstages * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < nstages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int units = 4 * nchunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= CONSUMERS / 32) {  // -------------------------- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > CONSUMERS / 32) return;  // one warp loads
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int kind = u & 3, lo = (u >> 2) * chunk;
      const int hi = min(rows, lo + chunk);
      const bool w1 = kind < 2;
      const CUtensorMap* xm = w1 ? &tm_up : &tm_u1g;
      const CUtensorMap* ym = w1 ? &tm_du1 : &tm_d2;
      const int xc = XW * (kind & 1), yc = w1 ? 0 : YW * (kind & 1);
      for (int r0 = lo; r0 < hi; r0 += KR, ++it) {
        const int st = it % nstages;
        unsigned char* x = stages + st * STAGE_BYTES;
        mbar_wait(empty + st, ((it / nstages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + st, X_BYTES + Y_BYTES);
          tma_load_2d(x, xm, full + st, xc, r0);
          tma_load_2d(x + X_BYTES, ym, full + st, yc, r0);
        }
        __syncwarp();
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = threadIdx.x >> 7;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kind = u & 3, chunk_i = u >> 2, lo = chunk_i * chunk;
    const int hi = min(rows, lo + chunk);
    float* out = part + (size_t)chunk_i * DW_PART;
    if (kind < 2)  // dW1 rows 128 kind + 64 wgi.., all 256 columns
      consume_unit<256>(stages, bbufs, full, empty, nstages, it, lo, hi, 0,
                        64 * wgi, out + (size_t)(XW * kind + 64 * wgi) * L1,
                        L1);
    else  // dW2[de], de = 2 (kind - 2) + wgi: its 64 x 128 block
      consume_unit<LQ>(stages, bbufs, full, empty, nstages, it, lo, hi,
                       LQ * wgi, 64 * wgi,
                       out + C * L1 + (size_t)(2 * (kind - 2) + wgi) * C1 * LQ,
                       LQ);
  }
}

int launch_fwd_wgmma(const void* up, const void* w1, const void* b1,
                     const void* g, const void* bt, const void* w2,
                     const void* b2, const void* hyper, void* out, int bp,
                     int m, int n_out, int blocks, float eps,
                     cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  // up (C, m, bp) in boxes of 64 columns x fwu::RR rows; W1 [C][L1] and W2
  // [C1][LQ] in slabs of 64 lanes x all rows; all in the 128-byte swizzle
  CUtensorMap maps[3];
  const cuuint64_t up_dims[3] = {(cuuint64_t)C, (cuuint64_t)m,
                                 (cuuint64_t)bp};
  const cuuint64_t up_strides[2] = {2ull * C, 2ull * C * m};
  const cuuint32_t up_box[3] = {64, (cuuint32_t)fwu::RR, 1};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)L1, (cuuint64_t)C};
  const cuuint64_t w1_strides[1] = {2ull * L1};
  const cuuint32_t w1_box[2] = {64, (cuuint32_t)C};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)LQ, (cuuint64_t)C1};
  const cuuint64_t w2_strides[1] = {2ull * LQ};
  const cuuint32_t w2_box[2] = {64, (cuuint32_t)C1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hop::tensor_map(maps, bf, 3, up, up_dims, up_strides, up_box, sw) ||
      !hop::tensor_map(maps + 1, bf, 2, w1, w1_dims, w1_strides, w1_box,
                       sw) ||
      !hop::tensor_map(maps + 2, bf, 2, w2, w2_dims, w2_strides, w2_box, sw))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwu::SMEM);
  if (e != cudaSuccess) return (int)e;
  upscale_fwd_wgmma_kernel<<<blocks, fwu::NTH, fwu::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(b1),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<const float*>(b2), static_cast<const bf16*>(hyper),
      static_cast<float*>(out), bp, m, n_out, eps);
  return (int)cudaGetLastError();
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
                       int stages, int blocks, cudaStream_t stream) {
  if (chunk < 1 || chunk % dwu::KR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows ||
      stages < 2 || stages > dwu::MAX_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  // row-major (rows, width) f32, boxes of dwu::KR rows x a unit's X (128)
  // or Y (256) columns: up, u1g, rnd(d_u2pre), rnd(d_u1pre)
  CUtensorMap maps[4];
  const int widths[4] = {C, L1, 4 * LQ, L1};
  const int boxes[4] = {dwu::XW, dwu::XW, dwu::YW, dwu::YW};
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)widths[i], (cuuint64_t)rows};
    const cuuint64_t strides[1] = {4ull * widths[i]};
    const cuuint32_t box[2] = {(cuuint32_t)boxes[i], (cuuint32_t)dwu::KR};
    if (!hop::tensor_map(maps + i, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a[i],
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = dwu::smem(stages);
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  upscale_bwd_dw_tf32_kernel<<<blocks, dwu::NTH, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(a[4]), rows,
      chunk, nchunks, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward on `blocks` persistent blocks: bf16 upscale_fwd_wgmma_kernel
// (the plan of ops/upscaler.py::upscale_fwd_plan_bf16), f32
// upscale_fwd_tf32_kernel.
int dhoct_upscale_fwd(const void* up, const void* w1, const void* b1,
                      const void* g, const void* bt, const void* w2,
                      const void* b2, const void* hyper, void* out, int bp,
                      int m, int n_out, int blocks, int dtype, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out < 1 || n_out > MAXT || m < 1) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? launch_fwd_wgmma(up, w1, b1, g, bt, w2, b2, hyper,
                                       out, bp, m, n_out, blocks, eps, s)
                    : launch_fwd_tf32(up, w1, b1, g, bt, w2, b2, hyper, out,
                                      bp, m, n_out, blocks, eps, s);
}

// The row pass on `blocks` persistent blocks (bf16
// upscale_bwd_rows_wgmma_kernel, the plan of ops/upscaler.py::
// rows_plan_bf16; f32 upscale_bwd_rows_tf32_kernel). a: up, dm, w1, b1, g,
// bt, w2, b2, hyper; outputs d_up, the u1g, rnd(d_u2pre) and rnd(d_u1pre)
// scratch rows, partials of db1, dg, dbt, db2 (bf16: per block and warp
// index; f32: per slot) and of d_hyper (bf16: per 64-row unit; f32: per
// 16-row tile); f32 also takes W1^T [L1][C] (a[18]).
int dhoct_upscale_bwd_rows(void* const* a, int bp, int m, int n_out,
                           int blocks, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bwd_rows(a, bp, m, n_out, blocks, eps, s)
                    : launch_bwd_rows_tf32(a, bp, m, n_out, blocks, eps, s);
}

// The weight pass (bf16 upscale_bwd_dw_kernel, one block per (chunk,
// tile); f32 upscale_bwd_dw_tf32_kernel on `blocks` persistent blocks and a
// ring of `stages`, the plan of ops/upscaler.py::upscale_dw_plan_f32).
// a[5]: up, u1g, rnd(d_u2pre) and rnd(d_u1pre) rows, and the partials
// [nchunks][dW1 | dW2] of row chunks of `chunk` rows.
int dhoct_upscale_bwd_dw(void* const* a, int rows, int chunk, int nchunks,
                         int stages, int blocks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd_dw(a, rows, chunk, nchunks, s)
             : launch_bwd_dw_tf32(a, rows, chunk, nchunks, stages, blocks, s);
}

const char* dhoct_upscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
