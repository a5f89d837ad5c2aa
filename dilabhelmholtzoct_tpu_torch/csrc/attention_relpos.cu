// K6: SAM encoder self-attention with decomposed relative-position bias for
// any head dim, read straight from the fused qkv projection. It is the
// attention of every model whose head dim is not 64 (ViT-H: 16 heads of 80;
// the test-size models: 16 and 32), for the global and the windowed layers
// alike.
//
//   qkv   (B, N, 3C)  feature order (3, heads, d): q of head h at columns
//                     h*d, k at C + h*d, v at 2C + h*d
//   rel_h (B, heads, N, H)   bias factor over key rows
//   rel_w (B, heads, N, W)   bias factor over key columns
//   out   (B, N, C)   token order, ready for the output projection
//
//   s[q, k] = f32(q . k) * d^-1/2 + rel_h[q, k / W] + rel_w[q, k % W]
//   out[q]  = (sum_k rnd(exp(s[q, k] - m)) v[k]) / sum_k exp(s[q, k] - m)
//
// attn_relpos_kernel replaces dilabhelmholtzoct_tpu/ops/attention.py
// flash_attention_relpos (_flash_kernel). Its rounding points are that
// kernel's, and differ from K1 / K2: the scale multiplies the f32 score
// after the dot (d^-1/2 is no power of two at d = 80, so a scaled bf16 q
// would round), the un-normalised p is rounded to the input type (rnd)
// before the p.v product while the denominator sums the unrounded p, and
// the division by the denominator comes last, in f32, with one rounding of
// the output. Inputs are widened to f32 in shared memory and every sum is
// f32.
//
// One block of 256 threads (16 x 16: ty, tx) per (batch, head, 64-query
// tile) streams 64-key tiles with an online softmax; keys past N in the
// last tile (N = 196 in the windowed layers) are masked to -inf. A thread
// owns a 4 x 4 tile of the scores and, of the output, rows ty + 16 i and
// head-dim columns tx + 16 j for j < ND = ceil(d / 16): the kernel is
// instantiated for ND = 1..8, so it takes every d that is a multiple of 4
// up to 128 (16-byte shared rows, 8-byte bf16 loads).
//
// Bound on an H100 SXM (700 W), ViT-H (16 heads of 80), B = 1, f32:
//    global layer, N = 4096: 4 * 4096^2 * 80 * 16 = 85.9 GFLOP over the
//        67 TFLOP/s f32 peak = 1.28 ms; bytes (qkv 62.9 MB + rel 33.6 MB +
//        out 21.0 MB) over 3.35 TB/s = 0.035 ms. Compute-bound.
//    windowed layer, 25 windows of 196: 4.9 GFLOP -> 0.073 ms; 93 MB ->
//        0.028 ms. Compute-bound.
// What this design does about it: as K1, every operand of the two inner
// products sits in shared memory (padded rows, 16-byte loads for q, k and
// p) and each qkv byte is read from device memory once per query tile. The
// p.v product reads v by single floats (the strided column ownership that
// lets one code path serve every d), so it needs more shared loads per
// multiply-add than K1's; the products run on the CUDA cores in f32.
// Tensor-core products (mma.sync / wgmma) with TMA loads are later work.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the head-major
// (B*heads, N, d) copies of q, k and v and of the output, the one-hot
// selector matmuls that expand the bias, whole-N k / v blocks in VMEM.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int MAX_ND = 8;      // head dim <= 128
constexpr int LDP = TK + 4;    // padded shared row of the p tile

// rows [row0, row0 + nrows) x d columns of a row-major matrix with `stride`
// elements per row -> shared dst (leading dim ld >= d, a multiple of 4);
// rows at or past n and columns at or past d are zero.
template <typename T>
__device__ void load_rows_d(float* dst, int ld, int width, const T* src,
                            int stride, int row0, int nrows, int n, int d) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < nrows * w4; i += THREADS) {
    const int r = i / w4, c = (i % w4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n && c < d) load4(src + (size_t)(row0 + r) * stride + c, v);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// s[i][j] = A[ty + 16i] . B[tx + 16j] over d columns; leading dim ld
__device__ __forceinline__ void score_tile_d(float (*s)[4], const float* As,
                                             const float* Bs, int ld, int d,
                                             int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lds4(As + (ty + 16 * i) * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = lds4(Bs + (tx + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                   a[i].w * b[j].w;
  }
}

// grid (ceil(N / 64), heads, B), 256 threads. With ld = d + 4 and
// ldv = 16 * ND, shared (floats):
//   Qs TQ*ld | Ks TK*ld | Vs TK*ldv | Ps TQ*LDP | Rh TQ*H | Rw TQ*W
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS)
attn_relpos_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                   const T* __restrict__ rel_w, T* __restrict__ out, int n,
                   int heads, int d, int H, int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4, ldv = 16 * ND;
  float* Qs = smem;
  float* Ks = Qs + TQ * ld;
  float* Vs = Ks + TK * ld;
  float* Ps = Vs + TK * ldv;
  float* Rh = Ps + TQ * LDP;
  float* Rw = Rh + TQ * H;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TQ;
  const int C = heads * d, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* base = qkv + (size_t)b * n * stride;
  const size_t rel_row = ((size_t)b * heads + head) * n + q0;

  load_rows_d(Qs, ld, d, base + head * d, stride, q0, TQ, n, d);
  load_rel(Rh, rel_h + rel_row * H, H, n - q0);
  load_rel(Rw, rel_w + rel_row * W, W, n - q0);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_rows_d(Ks, ld, d, base + C + head * d, stride, k0, TK, n, d);
    load_rows_d(Vs, ldv, ldv, base + 2 * C + head * d, stride, k0, TK, n, d);
    __syncthreads();

    float s[4][4] = {};
    score_tile_d(s, Qs, Ks, ld, d, ty, tx);

    int kr[4], kc[4];
    bool kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kg = k0 + tx + 16 * j;
      kv[j] = kg < n;
      kr[j] = kg / W;
      kc[j] = kg - kr[j] * W;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kv[j] ? s[i][j] * scale + Rh[q * H + kr[j]] + Rw[q * W + kc[j]]
                        : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;                                    // the denominator: f32 p
        Ps[q * LDP + tx + 16 * j] = round_to<T>(p); // the product: rounded p
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][j] += sum_k P[ty + 16i][k] * V[k][tx + 16j]
    for (int k = 0; k < TK; k += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = lds4(Ps + (ty + 16 * i) * LDP + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) v[j] = Vs[(k + u) * ldv + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[i][j] += pu * v[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= n) continue;
    T* o = out + ((size_t)b * n + q) * C + head * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = from_f32<T>(acc[i][j] / l[i]);
    }
  }
}

template <typename T, int ND>
int launch_nd(const void* qkv, const void* rel_h, const void* rel_w, void* out,
              int batch, int n, int heads, int d, int h, int w,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * TQ * (d + 4) + TK * 16 * ND +
                                               TQ * LDP + TQ * (h + w));
  cudaError_t e = cudaFuncSetAttribute(
      attn_relpos_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attn_relpos_kernel<T, ND><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out), n, heads, d, h, w,
      1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out,
           int batch, int n, int heads, int d, int h, int w,
           cudaStream_t stream) {
  if (d < 4 || d % 4 || d > 16 * MAX_ND) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
#define DHOCT_ND(ND)                                                          \
  case ND:                                                                    \
    return launch_nd<T, ND>(qkv, rel_h, rel_w, out, batch, n, heads, d, h, w, \
                            stream);
    DHOCT_ND(1) DHOCT_ND(2) DHOCT_ND(3) DHOCT_ND(4)
    DHOCT_ND(5) DHOCT_ND(6) DHOCT_ND(7) DHOCT_ND(8)
#undef DHOCT_ND
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16; d: the head dim, a
// multiple of 4 up to 128. Returns the cudaError_t of the launch
// (0 = success); the caller raises on non-zero.
extern "C" {

int dhoct_attn_relpos(const void* qkv, const void* rel_h, const void* rel_w,
                      void* out, int batch, int n, int heads, int d, int h,
                      int w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(qkv, rel_h, rel_w, out, batch, n,
                                            heads, d, h, w, s)
                    : launch<float>(qkv, rel_h, rel_w, out, batch, n, heads, d,
                                    h, w, s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
