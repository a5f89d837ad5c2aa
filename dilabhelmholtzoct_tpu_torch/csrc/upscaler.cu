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
// upscale_fwd_kernel replaces dilabhelmholtzoct_tpu/ops/upscaler.py
//    _fused_fwd (:295, body _fwd_kernel :119-138). One block per (pair,
//    32-row tile).
// upscale_bwd_kernel replaces the same file's _fused_bwd (:329, body
//    _bwd_kernel :141-243). It recomputes the chain per row and writes d_up
//    per row; the weight gradients are summed over rows inside each block
//    (one block per (pair, split), looping over its row tiles) into one
//    partial sum per block, which the wrapper adds up over the blocks in a
//    fixed order — a second pass, no atomics, so the gradients repeat bit
//    for bit from run to run.
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096 rows,
//    bf16): forward 198 kFLOP/row = 51.8 GFLOP over 989 TFLOP/s = 0.052 ms
//    (bytes: up 134 MB in, 16.8 MB out = 0.045 ms); backward 592 kFLOP/row =
//    155 GFLOP = 0.157 ms (bytes ~285 MB = 0.085 ms). Operation-bound on
//    the tensor-core rate; on the CUDA cores (67 TFLOP/s f32) the bound is
//    15x higher.
// What this design does about it: the 268 MB second upscale stays in shared
//    memory and registers (as on the TPU); each row tile keeps its inputs
//    and every intermediate in shared memory, the products are f32 SIMT
//    register tiles (one output column per thread over the tile's 32 rows,
//    16-byte broadcast loads of the row operand). The second product runs
//    per (d, e) block of W2 (64 x 128), not as the TPU's 256 x 512 Kronecker
//    expansion; LayerNorm reduces its 64 lanes with warp shuffles, not
//    selector matmuls. Tensor cores (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
int launch_fwd(const void* up, const void* w1, const void* b1, const void* g,
               const void* bt, const void* w2, const void* b2,
               const void* hyper, void* out, int bp, int m, int n_out,
               float eps, cudaStream_t stream) {
  if (n_out < 1 || n_out > MAXT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      upscale_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TM - 1) / TM, bp);
  upscale_fwd_kernel<T><<<grid, THREADS, FWD_SMEM, stream>>>(
      static_cast<const T*>(up), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g),
      static_cast<const float*>(bt), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(hyper),
      static_cast<float*>(out), m, n_out, eps);
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

int dhoct_upscale_fwd(const void* up, const void* w1, const void* b1,
                      const void* g, const void* bt, const void* w2,
                      const void* b2, const void* hyper, void* out, int bp,
                      int m, int n_out, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_fwd<__nv_bfloat16>(up, w1, b1, g, bt, w2, b2,
                                                hyper, out, bp, m, n_out, eps,
                                                s)
                    : launch_fwd<float>(up, w1, b1, g, bt, w2, b2, hyper, out,
                                        bp, m, n_out, eps, s);
}

int dhoct_upscale_bwd(const void* up, const void* dm, const void* w1,
                      const void* w1t, const void* b1, const void* g,
                      const void* bt, const void* w2, const void* b2,
                      const void* hyper, void* d_up, void* dw1p, void* dw2p,
                      void* db1p, void* dgp, void* dbtp, void* db2p,
                      void* dhtp, int bp, int m, int n_out, int splits,
                      int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd<__nv_bfloat16>(up, dm, w1, w1t, b1, g, bt, w2, b2,
                                         hyper, d_up, dw1p, dw2p, db1p, dgp,
                                         dbtp, db2p, dhtp, bp, m, n_out,
                                         splits, eps, s)
             : launch_bwd<float>(up, dm, w1, w1t, b1, g, bt, w2, b2, hyper,
                                 d_up, dw1p, dw2p, db1p, dgp, dbtp, db2p,
                                 dhtp, bp, m, n_out, splits, eps, s);
}

const char* dhoct_upscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
