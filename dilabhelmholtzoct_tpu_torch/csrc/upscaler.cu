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
//    (:295, body _fwd_kernel :119-138, math _chain_fwd :77-99).
//    * bf16 (the training path): upscale_fwd_mma_kernel on the tensor
//      cores, persistent 8-warp blocks with W1 and W2 in shared memory, a
//      warp pair per 16-row tile, the next tile's rows copied in while
//      this one computes.
//    * f32: upscale_fwd_kernel, one SIMT block per (pair, 32-row tile) (not
//      on a main path: the JAX package routes K3 only in bf16).
// The backward replaces the same file's _fused_bwd (:329, body _bwd_kernel
//    :141-243): it recomputes the chain per row, writes d_up per row, and
//    sums the weight and vector gradients over rows. The JAX kernel carries
//    them in output blocks across its sequential grid; here blocks run in
//    parallel, so every sum over rows is one partial per block, warp or
//    tile, added up by the wrapper in a fixed order -- no atomics, so the
//    gradients repeat bit for bit from run to run.
//    * bf16 (the training path): two launches on the tensor cores
//      (decoder_mma.cuh). upscale_bwd_rows_kernel is the row pass:
//      persistent 8-warp blocks with W1 and W2 in shared memory, a warp
//      pair per 16-row tile, the chain per (d, e) block of 64 lanes; it
//      writes u1g, rnd(d_u2pre) and rnd(d_u1pre) per row as bf16 scratch.
//      upscale_bwd_dw_kernel is the weight pass: dW1 = sum_r up^T
//      rnd(d_u1pre) (two 128-row output tiles) and dW2[de] = sum_r
//      u1g[de]^T rnd(d_u2pre)[de], split-K over row chunks.
//    * f32: upscale_bwd_kernel, one fused SIMT kernel, one block per (pair,
//      split) looping over 32-row tiles (not on a main path: the JAX
//      package routes K3 only in bf16).
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096 rows,
//    bf16): forward 198 kFLOP/row = 51.8 GFLOP over 989 TFLOP/s = 0.052 ms
//    (bytes: up 134 MB in, 16.8 MB out = 0.045 ms); backward 592 kFLOP/row =
//    155 GFLOP = 0.157 ms (bytes ~285 MB = 0.085 ms). Operation-bound on
//    the tensor-core rate; on the CUDA cores (67 TFLOP/s f32) the bound is
//    15x higher. The bf16 backward's scratch (536 MB written and read once)
//    adds 0.32 ms of bytes.
// What this design does about it: the 268 MB second upscale stays in shared
//    memory and registers (as on the TPU). The bf16 kernels run every
//    product on the tensor cores (mma.sync bf16 -> f32; each operand a bf16
//    rounding point of the JAX kernel, so each term is exact): the first
//    and second products per (d, e) block (the second by halves of 64
//    lanes), the hypernetwork sum over c2 as m16n8k16 against hyper^T, and
//    in the backward d_u1g = rnd(d_u2pre) . W2^T and d_up = rnd(d_u1pre) .
//    W1^T; the LayerNorms, GELUs and their backwards run in f32 registers
//    over a lane quad. The f32 kernels keep each row tile's inputs and
//    every intermediate in shared memory; their products are SIMT register
//    tiles (one output column per thread over the tile's 32 rows, 16-byte
//    broadcast loads of the row operand). The second product runs per
//    (d, e) block of W2 (64 x 128), not as the TPU's 256 x 512 Kronecker
//    expansion; LayerNorm reduces its 64 lanes with shuffles, not selector
//    matmuls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decoder_mma.cuh"

namespace {

constexpr int C = 256;          // input channels (every SAM decoder)
constexpr int C1 = C / 4;       // channels after the first upscale
constexpr int C2 = C / 8;       // channels after the second upscale
constexpr int L1 = 4 * C1;      // lanes (d, e, c1) of the first upscale
constexpr int LQ = 4 * C2;      // lanes (f, g, c2) of one (d, e) block
constexpr int LDW2 = LQ + 1;    // padded shared row of W2
constexpr int TM = 32;          // rows per tile
constexpr int THREADS = 256;
constexpr int MAXT = 4;         // mask tokens per pair
constexpr int RPW = TM / (THREADS / 32);  // rows per warp in the LayerNorms
static_assert(THREADS == C && THREADS == L1 && THREADS == 2 * LQ,
              "thread-to-column maps assume 256 threads");

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return __ldg(p); }

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + TM) of the pair's (m, width) matrix -> shared f32
// (zeros past m)
template <typename T>
__device__ void load_tile(float* dst, const T* src, int width, int row0,
                          int m) {
  for (int i = threadIdx.x; i < TM * width; i += THREADS) {
    const int r = i / width;
    dst[i] = (row0 + r < m) ? ld(src + (size_t)(row0 + r) * width + i % width)
                            : 0.f;
  }
}

template <typename T>
__device__ void load_common(float* w2_s, float* hy_s, const T* w2,
                            const T* hyper, int n_out) {
  for (int i = threadIdx.x; i < C1 * LQ; i += THREADS)
    w2_s[(i / LQ) * LDW2 + i % LQ] = ld(w2 + i);
  for (int i = threadIdx.x; i < n_out * C2; i += THREADS)
    hy_s[i] = ld(hyper + i);
}

// u1pre[r][j] = sum_k up[r][k] W1[k][j] + b1[j % C1]; thread j = column
template <typename T>
__device__ void first_product(float* u1_s, const float* up_s, const T* w1,
                              const float* b1) {
  const int j = threadIdx.x;
  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.f;
  for (int k = 0; k < C; k += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = ld(w1 + (size_t)(k + i) * L1 + j);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float4 a = lds4(up_s + r * C + k);
      acc[r] = fmaf(a.x, w[0], acc[r]);
      acc[r] = fmaf(a.y, w[1], acc[r]);
      acc[r] = fmaf(a.z, w[2], acc[r]);
      acc[r] = fmaf(a.w, w[3], acc[r]);
    }
  }
  const float bj = b1[j % C1];
#pragma unroll
  for (int r = 0; r < TM; ++r) u1_s[r * L1 + j] = acc[r] + bj;
}

// LayerNorm over each 64-lane (d, e) segment, then u1g = rnd(gelu(rnd(.))).
// u1_s holds u1pre on entry and u1g on exit; with y_s the normalised y and
// rstd_s the per-(row, segment) 1/std are kept for the backward.
template <typename T>
__device__ void layer_norm_gelu(float* u1_s, float* y_s, float* rstd_s,
                                const float* g, const float* bt, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float ga = g[lane], gb = g[lane + 32];
  const float ba = bt[lane], bb = bt[lane + 32];
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    for (int s = 0; s < 4; ++s) {
      float* x = u1_s + r * L1 + s * C1;
      const float a = x[lane], b = x[lane + 32];
      const float mu = warp_sum(a + b) * (1.f / C1);
      const float ca = a - mu, cb = b - mu;
      const float var = warp_sum(ca * ca + cb * cb) * (1.f / C1);
      const float rs = rsqrtf(var + eps);
      const float ya = ca * rs, yb = cb * rs;
      if (y_s) {
        y_s[r * L1 + s * C1 + lane] = ya;
        y_s[r * L1 + s * C1 + lane + 32] = yb;
        if (lane == 0) rstd_s[r * 4 + s] = rs;
      }
      x[lane] = rnd<T>(gelu<T>(rnd<T>(ya * ga + ba)));
      x[lane + 32] = rnd<T>(gelu<T>(rnd<T>(yb * gb + bb)));
    }
  }
}

// u2pre for the thread's column q of both (d, e) blocks it owns (de =
// 2 * half + d), all TM rows: acc[d][r] = u1g[r][de] . W2[:, q] (f32)
__device__ __forceinline__ void second_product(float (&acc)[2][TM],
                                               const float* u1_s,
                                               const float* w2_s, int half,
                                               int q) {
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[d][r] = 0.f;
  for (int c = 0; c < C1; c += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = w2_s[(c + i) * LDW2 + q];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * half + d;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 a = lds4(u1_s + r * L1 + de * C1 + c);
        acc[d][r] = fmaf(a.x, w[0], acc[d][r]);
        acc[d][r] = fmaf(a.y, w[1], acc[d][r]);
        acc[d][r] = fmaf(a.z, w[2], acc[d][r]);
        acc[d][r] = fmaf(a.w, w[3], acc[d][r]);
      }
    }
  }
}

constexpr size_t FWD_SMEM =
    sizeof(float) * (size_t)(TM * C + TM * L1 + C1 * LDW2 + MAXT * C2);

template <typename T>
__global__ void __launch_bounds__(THREADS)
    upscale_fwd_kernel(const T* up, const T* w1, const float* b1,
                       const float* g, const float* bt, const T* w2,
                       const float* b2, const T* hyper, float* out, int m,
                       int n_out, float eps) {
  extern __shared__ float smem[];
  float* up_s = smem;
  float* u1_s = up_s + TM * C;
  float* w2_s = u1_s + TM * L1;
  float* hy_s = w2_s + C1 * LDW2;
  const int pair = blockIdx.y, row0 = blockIdx.x * TM;
  const int tid = threadIdx.x, lane = tid % 32;

  load_tile(up_s, up + (size_t)pair * m * C, C, row0, m);
  load_common(w2_s, hy_s, w2, hyper + (size_t)pair * n_out * C2, n_out);
  __syncthreads();
  first_product(u1_s, up_s, w1, b1);
  __syncthreads();
  layer_norm_gelu<T>(u1_s, nullptr, nullptr, g, bt, eps);
  __syncthreads();

  const int half = tid / LQ, q = tid % LQ, fg = q / C2, c2 = q % C2;
  float acc[2][TM];
  second_product(acc, u1_s, w2_s, half, q);
  const float bq = b2[c2];
  const int lanes = n_out * 16;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int de = 2 * half + d;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float u = rnd<T>(gelu<T>(rnd<T>(acc[d][r] + bq)));
      for (int t = 0; t < n_out; ++t) {
        // a warp holds the 32 c2 lanes of one (de, fg): the sum over c2 is
        // a warp reduction
        const float v = warp_sum(u * hy_s[t * C2 + c2]);
        if (lane == 0 && row0 + r < m)
          out[((size_t)pair * m + row0 + r) * lanes + t * 16 + de * 4 + fg] =
              v;
      }
    }
  }
}

constexpr size_t BWD_SMEM =
    sizeof(float) * (size_t)(3 * TM * C + TM * 4 * LQ + TM * MAXT * 16 +
                             C1 * LDW2 + MAXT * C2 + 3 * TM * 4);

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    upscale_bwd_kernel(const T* up, const float* dm, const T* w1,
                       const T* w1t, const float* b1, const float* g,
                       const float* bt, const T* w2, const float* b2,
                       const T* hyper, T* d_up, float* dw1p, float* dw2p,
                       float* db1p, float* dgp, float* dbtp, float* db2p,
                       float* dhtp, int m, int n_out, int splits, float eps) {
  extern __shared__ float smem[];
  float* up_s = smem;                   // [TM][C]
  float* y_s = up_s + TM * C;           // [TM][L1] normalised y
  float* g1_s = y_s + TM * L1;          // [TM][L1] u1g, then d_y, d_u1pre
  float* d2_s = g1_s + TM * L1;         // [TM][4 * LQ] rnd(d_u2pre)
  float* dm_s = d2_s + TM * 4 * LQ;     // [TM][MAXT * 16]
  float* w2_s = dm_s + TM * MAXT * 16;  // [C1][LDW2]
  float* hy_s = w2_s + C1 * LDW2;       // [MAXT][C2]
  float* rstd_s = hy_s + MAXT * C2;     // [TM][4]
  float* mdy_s = rstd_s + TM * 4;       // [TM][4]
  float* mdyy_s = mdy_s + TM * 4;       // [TM][4]

  const int pair = blockIdx.y, split = blockIdx.x;
  const int blk = pair * splits + split;
  const int ntiles = (m + TM - 1) / TM;
  const int per = (ntiles + splits - 1) / splits;
  const int t0 = split * per;
  const int t1 = min(ntiles, t0 + per);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = tid / LQ, q = tid % LQ, fg = q / C2, c2 = q % C2;
  const int j = tid, jde = j / C1, jc = j % C1;
  const int lanes = n_out * 16;

  load_common(w2_s, hy_s, w2, hyper + (size_t)pair * n_out * C2, n_out);
  const T* up_p = up + (size_t)pair * m * C;

  float db1 = 0.f, dg = 0.f, dbt = 0.f;  // lane j
  float db2[2] = {0.f, 0.f};             // lanes (de, q)
  float dht[MAXT][2];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) dht[t][0] = dht[t][1] = 0.f;

  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * TM;
    const bool first = tile == t0;
    __syncthreads();  // the previous tile is done with shared memory
    load_tile(up_s, up_p, C, row0, m);
    for (int i = tid; i < TM * MAXT * 16; i += THREADS) {
      const int r = i / (MAXT * 16), l = i % (MAXT * 16);
      dm_s[i] = (l < lanes && row0 + r < m)
                    ? dm[((size_t)pair * m + row0 + r) * lanes + l]
                    : 0.f;
    }
    __syncthreads();
    first_product(g1_s, up_s, w1, b1);
    __syncthreads();
    layer_norm_gelu<T>(g1_s, y_s, rstd_s, g, bt, eps);
    __syncthreads();

    // second product, its GELU and the hypernetwork gradients
    {
      float acc[2][TM];
      second_product(acc, g1_s, w2_s, half, q);
      const float bq = b2[c2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int de = 2 * half + d;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float u2r = rnd<T>(acc[d][r] + bq);
          const float u2g = rnd<T>(gelu<T>(u2r));
          float du = 0.f;
#pragma unroll
          for (int t = 0; t < MAXT; ++t) {  // static indices into dht
            if (t < n_out) {
              const float dmv = dm_s[r * MAXT * 16 + t * 16 + de * 4 + fg];
              du = fmaf(dmv, hy_s[t * C2 + c2], du);
              dht[t][d] = fmaf(dmv, u2g, dht[t][d]);
            }
          }
          const float d2 = du * gelu_grad<T>(u2r);
          db2[d] += d2;
          d2_s[r * 4 * LQ + de * LQ + q] = rnd<T>(d2);
        }
      }
    }
    __syncthreads();

    // dW2[de][c][q] partial: sum_r u1g[r][de, c] * d2[r][de, q]
#pragma unroll 1
    for (int d = 0; d < 2; ++d) {
      const int de = 2 * half + d;
      float dcol[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) dcol[r] = d2_s[r * 4 * LQ + de * LQ + q];
      float* dst = dw2p + ((size_t)blk * 4 + de) * C1 * LQ + q;
#pragma unroll 1
      for (int c = 0; c < C1; c += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(g1_s + r * L1 + de * C1 + c);
          s[0] = fmaf(a.x, dcol[r], s[0]);
          s[1] = fmaf(a.y, dcol[r], s[1]);
          s[2] = fmaf(a.z, dcol[r], s[2]);
          s[3] = fmaf(a.w, dcol[r], s[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* p = dst + (size_t)(c + i) * LQ;
          *p = first ? s[i] : *p + s[i];
        }
      }
    }

    // d_u1g[r][j] = sum_q d2[r][jde, q] W2[jc][q]; then the GELU and the
    // LayerNorm affine backward, d_y kept in registers
    float dy[TM];
    {
#pragma unroll
      for (int r = 0; r < TM; ++r) dy[r] = 0.f;
      for (int qq = 0; qq < LQ; qq += 4) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = w2_s[jc * LDW2 + qq + i];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(d2_s + r * 4 * LQ + jde * LQ + qq);
          dy[r] = fmaf(a.x, w[0], dy[r]);
          dy[r] = fmaf(a.y, w[1], dy[r]);
          dy[r] = fmaf(a.z, w[2], dy[r]);
          dy[r] = fmaf(a.w, w[3], dy[r]);
        }
      }
      const float gj = g[jc], bj = bt[jc];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float y = y_s[r * L1 + j];
        const float d_out1 = dy[r] * gelu_grad<T>(rnd<T>(y * gj + bj));
        dg = fmaf(d_out1, y, dg);
        dbt += d_out1;
        dy[r] = d_out1 * gj;
      }
    }
    __syncthreads();  // the dW2 pass is done reading u1g
#pragma unroll
    for (int r = 0; r < TM; ++r) g1_s[r * L1 + j] = dy[r];
    __syncthreads();

    // LayerNorm backward: per-(row, segment) means of d_y and d_y * y
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      for (int s = 0; s < 4; ++s) {
        const int o = r * L1 + s * C1 + lane;
        const float a = g1_s[o], b = g1_s[o + 32];
        const float s1 = warp_sum(a + b);
        const float s2 = warp_sum(a * y_s[o] + b * y_s[o + 32]);
        if (lane == 0) {
          mdy_s[r * 4 + s] = s1 * (1.f / C1);
          mdyy_s[r * 4 + s] = s2 * (1.f / C1);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int sidx = r * 4 + jde;
      const float du = rstd_s[sidx] * (dy[r] - mdy_s[sidx] -
                                       y_s[r * L1 + j] * mdyy_s[sidx]);
      db1 += du;
      g1_s[r * L1 + j] = rnd<T>(du);
    }
    __syncthreads();

    // d_up[r][k] = sum_j d_u1pre[r][j] W1[k][j] (W1^T rows: coalesced in k)
    {
      const int k = tid;
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      for (int jj = 0; jj < L1; jj += 4) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = ld(w1t + (size_t)(jj + i) * C + k);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(g1_s + r * L1 + jj);
          acc[r] = fmaf(a.x, w[0], acc[r]);
          acc[r] = fmaf(a.y, w[1], acc[r]);
          acc[r] = fmaf(a.z, w[2], acc[r]);
          acc[r] = fmaf(a.w, w[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (row0 + r < m)
          st(d_up + ((size_t)pair * m + row0 + r) * C + k, acc[r]);
    }

    // dW1[k][j] partial: sum_r up[r][k] * d_u1pre[r][j]
    {
      float dcol[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) dcol[r] = g1_s[r * L1 + j];
      float* dst = dw1p + (size_t)blk * C * L1 + j;
#pragma unroll 1
      for (int k = 0; k < C; k += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(up_s + r * C + k);
          s[0] = fmaf(a.x, dcol[r], s[0]);
          s[1] = fmaf(a.y, dcol[r], s[1]);
          s[2] = fmaf(a.z, dcol[r], s[2]);
          s[3] = fmaf(a.w, dcol[r], s[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* p = dst + (size_t)(k + i) * L1;
          *p = first ? s[i] : *p + s[i];
        }
      }
    }
  }

  db1p[(size_t)blk * L1 + j] = db1;
  dgp[(size_t)blk * L1 + j] = dg;
  dbtp[(size_t)blk * L1 + j] = dbt;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int lane2 = (2 * half + d) * LQ + q;
    db2p[(size_t)blk * 4 * LQ + lane2] = db2[d];
#pragma unroll
    for (int t = 0; t < MAXT; ++t)
      if (t < n_out)
        dhtp[(((size_t)pair * splits + split) * n_out + t) * 4 * LQ + lane2] =
            dht[t][d];
  }
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

int launch_fwd_f32(const void* up, const void* w1, const void* b1,
                   const void* g, const void* bt, const void* w2,
                   const void* b2, const void* hyper, void* out, int bp, int m,
                   int n_out, float eps, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      upscale_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TM - 1) / TM, bp);
  upscale_fwd_kernel<float><<<grid, THREADS, FWD_SMEM, stream>>>(
      static_cast<const float*>(up), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(hyper),
      static_cast<float*>(out), m, n_out, eps);
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

template <typename T>
int launch_bwd(const void* up, const void* dm, const void* w1,
               const void* w1t, const void* b1, const void* g, const void* bt,
               const void* w2, const void* b2, const void* hyper, void* d_up,
               void* dw1p, void* dw2p, void* db1p, void* dgp, void* dbtp,
               void* db2p, void* dhtp, int bp, int m, int n_out, int splits,
               float eps, cudaStream_t stream) {
  const int ntiles = (m + TM - 1) / TM;
  // every block must own at least one tile: its partial sums are written,
  // never accumulated into a zeroed buffer
  if (n_out < 1 || n_out > MAXT || splits < 1 ||
      (splits - 1) * ((ntiles + splits - 1) / splits) >= ntiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(splits, bp);
  upscale_bwd_kernel<T><<<grid, THREADS, BWD_SMEM, stream>>>(
      static_cast<const T*>(up), static_cast<const float*>(dm),
      static_cast<const T*>(w1), static_cast<const T*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(hyper),
      static_cast<T*>(d_up), static_cast<float*>(dw1p),
      static_cast<float*>(dw2p), static_cast<float*>(db1p),
      static_cast<float*>(dgp), static_cast<float*>(dbtp),
      static_cast<float*>(db2p), static_cast<float*>(dhtp), m, n_out, splits,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward: bf16 on `blocks` persistent blocks (upscale_fwd_mma_kernel),
// f32 one block per (pair, 32-row tile) (upscale_fwd_kernel; `blocks`
// unused).
int dhoct_upscale_fwd(const void* up, const void* w1, const void* b1,
                      const void* g, const void* bt, const void* w2,
                      const void* b2, const void* hyper, void* out, int bp,
                      int m, int n_out, int blocks, int dtype, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out < 1 || n_out > MAXT || m < 1) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? launch_fwd_mma(up, w1, b1, g, bt, w2, b2, hyper, out,
                                     bp, m, n_out, blocks, eps, s)
                    : launch_fwd_f32(up, w1, b1, g, bt, w2, b2, hyper, out,
                                     bp, m, n_out, eps, s);
}

// The f32 backward (upscale_bwd_kernel); dtype must be 0: the bf16
// backward is the two launches below.
int dhoct_upscale_bwd(const void* up, const void* dm, const void* w1,
                      const void* w1t, const void* b1, const void* g,
                      const void* bt, const void* w2, const void* b2,
                      const void* hyper, void* d_up, void* dw1p, void* dw2p,
                      void* db1p, void* dgp, void* dbtp, void* db2p,
                      void* dhtp, int bp, int m, int n_out, int splits,
                      int dtype, float eps, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd<float>(up, dm, w1, w1t, b1, g, bt, w2, b2, hyper, d_up,
                           dw1p, dw2p, db1p, dgp, dbtp, db2p, dhtp, bp, m,
                           n_out, splits, eps,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 row pass (upscale_bwd_rows_kernel) on `blocks` persistent
// blocks. a[18]: up, dm, w1, b1, g, bt, w2, b2, hyper; outputs d_up, the
// u1g, rnd(d_u2pre) and rnd(d_u1pre) scratch rows, per-warp partials of
// db1, dg, dbt, db2, and per-tile partials of d_hyper.
int dhoct_upscale_bwd_rows(void* const* a, int bp, int m, int n_out,
                           int blocks, float eps, void* stream) {
  return launch_bwd_rows(a, bp, m, n_out, blocks, eps,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 weight pass (upscale_bwd_dw_kernel). a[5]: up, u1g, rnd(d_u2pre)
// and rnd(d_u1pre) rows, and the partials [nchunks][dW1 | dW2] of row
// chunks of `chunk` rows.
int dhoct_upscale_bwd_dw(void* const* a, int rows, int chunk, int nchunks,
                         void* stream) {
  return launch_bwd_dw(a, rows, chunk, nchunks,
                       static_cast<cudaStream_t>(stream));
}

const char* dhoct_upscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
