// Tile helpers shared by the encoder attention kernels: the forward K1 / K2
// (attention.cu), the backward K5 (attention_bwd.cu), the any-head-dim
// forward K6 (attention_relpos.cu) and the image-layout windowed forward K7
// (attention_winimg.cu).
//
// Every tile is 64 rows of one head (head dim 64) widened to f32 in shared
// memory; a block of 256 threads is a 16 x 16 grid of threads (ty, tx) and
// each thread owns a 4 x 4 register tile: rows ty + 16 i, columns
// tx + 16 j (scores) or 4 tx + c (head-dim outputs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int D = 64;          // head dim (every SAM variant)
constexpr int TQ = 64;         // query rows per tile
constexpr int TK = 64;         // key tokens per tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx)
constexpr int LD = D + 4;      // padded shared row of a 64-wide tile
constexpr int KMAX = 256;      // most keys a whole-window kernel holds (16 x 16)
constexpr int NJ = KMAX / 16;  // key columns per thread in those kernels

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = raw.x;
  *reinterpret_cast<uint32_t*>(&b) = raw.y;
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [row0, row0 + nrows) x 64 columns of a row-major matrix with
// `stride` elements per row -> shared dst (leading dim ld), times `scale`;
// rows at or past n are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int stride,
                          int row0, int nrows, int n, float scale) {
  for (int i = threadIdx.x; i < nrows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load4(src + (size_t)(row0 + r) * stride + c, v);
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    *d = make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale);
  }
}

// the TQ query rows' bias factors (nq valid rows of `len` values) -> shared
template <typename T>
__device__ void load_rel(float* dst, const T* src, int len, int nq) {
  for (int i = threadIdx.x; i < TQ * len; i += THREADS)
    dst[i] = (i / len < nq) ? to_f32(src[i]) : 0.f;
}

// s[i][j] += A[ty + 16i] . B[tx + 16(j0 + j)] for j < 4 (and j0 + j < nj);
// A and B are 64-wide shared tiles with leading dim LD
__device__ __forceinline__ void score_tile(float (*s)[4], const float* As,
                                           const float* Bs, int ty, int tx,
                                           int j0, int nj) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lds4(As + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + j < nj) b[j] = lds4(Bs + (tx + 16 * (j0 + j)) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j0 + j < nj)
          s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
  }
}

// acc[i][c] += sum_k P[ty + 16i][k] * V[k][4tx + c] over k < nk (nk % 4 == 0);
// P has leading dim ldp, V leading dim ldv
__device__ __forceinline__ void pv_tile(float (*acc)[4], const float* Ps,
                                        int ldp, const float* Vs, int ldv,
                                        int nk, int ty, int tx) {
  for (int k = 0; k < nk; k += 4) {
    float4 v[4], p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = lds4(Vs + (k + u) * ldv + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = lds4(Ps + (ty + 16 * i) * ldp + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pu[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][0] += pu[u] * v[u].x;
        acc[i][1] += pu[u] * v[u].y;
        acc[i][2] += pu[u] * v[u].z;
        acc[i][3] += pu[u] * v[u].w;
      }
    }
  }
}

// max / sum over the 16 threads (tx) that share a query row
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The last step of K1, K2 and K7: one query row's four output columns,
// acc / l in f32, rounded once to T. Shared so that the kernels that must
// agree bit for bit (K7 with K2) cannot normalise differently.
template <typename T>
__device__ __forceinline__ void store_normalised(T* dst, const float* acc,
                                                 float l) {
  const float inv = 1.f / l;
  const float o[4] = {acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv};
  store4(dst, o);
}

// One-pass softmax attention of a 64-query tile against all n <= KMAX keys
// of a window, every operand already in shared memory (the body of K2, and
// of K7, which differs only in where its rows come from and go to):
//   Qs TQ x LD (scaled queries) | Ks nk x LD | Vs nk x D, nk = n rounded up
//   to 16 with zero rows past n | Rh TQ x H | Rw TQ x W bias factors.
// Ps (TQ x (nk + 4)) may alias Qs / Ks: they are consumed before it is
// written. Leaves the row maximum m, the denominator l and the
// un-normalised output tile acc in registers. Every thread of the block
// must call it (it synchronises).
__device__ __forceinline__ void window_attend(
    const float* Qs, const float* Ks, float* Ps, const float* Vs,
    const float* Rh, const float* Rw, int n, int H, int W, int ty, int tx,
    float* m, float* l, float (*acc)[4]) {
  const int nk = (n + 15) / 16 * 16, nj = nk / 16, ldp = nk + 4;
  float s[4][NJ];
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += 4) {
    float t[4][4] = {};
    if (j0 < nj) score_tile(t, Qs, Ks, ty, tx, j0, nj);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j0 + j] = t[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = ty + 16 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = tx + 16 * j;
      if (k < n) {
        const int kr = k / W;
        s[i][j] += Rh[q * H + kr] + Rw[q * W + (k - kr * W)];
      } else {
        s[i][j] = -INFINITY;
      }
      mx = fmaxf(mx, s[i][j]);
    }
    mx = row_max(mx);
    m[i] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = expf(s[i][j] - mx);  // 0 past n
      rs += s[i][j];
    }
    l[i] = row_sum(rs);
  }
  __syncthreads();  // every thread is done reading Qs / Ks: reuse as Ps
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) Ps[(ty + 16 * i) * ldp + tx + 16 * j] = s[i][j];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  pv_tile(acc, Ps, ldp, Vs, D, nk, ty, tx);
}

}  // namespace attn
