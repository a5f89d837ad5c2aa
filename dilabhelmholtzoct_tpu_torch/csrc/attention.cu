// SAM encoder self-attention with decomposed relative-position bias, read
// straight from the fused qkv projection.
//
//   qkv   (B, N, 3C)  feature order (3, heads, 64): q of head h at columns
//                     h*64, k at C + h*64, v at 2C + h*64
//   rel_h (B, heads, N, H)   bias factor over key rows
//   rel_w (B, heads, N, W)   bias factor over key columns
//   out   (B, N, C)   token order, ready for the output projection
//
//   s[q, k] = (q . k) / 8 + rel_h[q, k / W] + rel_w[q, k % W]
//   out[q]  = softmax_k(s[q, :]) . v
//
// Two kernels, both templated on the element type (float: the serving
// path; __nv_bfloat16: the training path). Inputs are widened to f32 in
// shared memory; every sum is f32; the output is stored in the input type.
// Given a non-null `lse` (B, heads, N) f32, each also writes the row's
// logsumexp m + log(l) in the scaled-score domain (the TPU kernel's
// return_lse), which the backward K5 (attention_bwd.cu) reads; with a null
// pointer nothing more is written.
//
// K1 attn_global_kernel replaces dilabhelmholtzoct_tpu/ops/attention.py
//    flash_attention_packed, _packed_kernel branch (the 4 global layers,
//    N = 4096 at ViT-B). One block per (batch, head, 64-query tile) loops
//    over 64-key tiles with an online softmax (running max, denominator and
//    output accumulator in registers).
// K2 attn_windowed_kernel replaces the same function's
//    _windowed_group_kernel branch (the 8 windowed layers, 25 windows of
//    14x14 = 196 tokens per image). One block per (window, head, 64-query
//    tile) holds all keys and values of the window in shared memory and
//    takes a one-pass softmax.
//
// Bound on an H100 SXM (700 W), one layer at B = 1, f32:
//    K1: 4 * 4096^2 * 64 * 12 = 51.5 GFLOP over the 67 TFLOP/s f32 peak
//        = 0.77 ms; bytes (qkv 37.7 MB + rel 25.2 MB + out 12.6 MB) over
//        3.35 TB/s = 0.022 ms. Compute-bound.
//    K2: 2.95 GFLOP -> 0.044 ms; 67 MB -> 0.020 ms. Compute-bound.
//    In bf16 the bound is the 989 TFLOP/s tensor-core rate (K1 ~52 us).
// What this design does about it: both kernels are compute-bound, so they
// keep every operand of the inner loops in shared memory and registers
// (a 4x4 register tile of scores and of the output per thread, 16-byte
// shared loads, padded rows against bank conflicts) and read each qkv byte
// from device memory once per query tile. They run on the CUDA cores in
// f32; moving the two products onto the tensor cores (mma.sync / wgmma
// with TMA loads) is later work.
//
// Not carried over from the TPU kernel (Mosaic-only workarounds): head-pair
// packing into 128 lanes, one-hot selector matmuls that expand the bias,
// grouping 5 windows per program, pre-transposed k.

#include "attention_common.cuh"

namespace {

using namespace attn;

// out rows and, with lse != null, lse[lse_row + q] = m + log(l)
template <typename T>
__device__ __forceinline__ void store_out(T* out, float* lse, size_t lse_row,
                                          float (*acc)[4], const float* m,
                                          const float* l, int b, int n, int C,
                                          int head, int q0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= n) continue;
    if (lse != nullptr && tx == 0) lse[lse_row + q] = m[i] + logf(l[i]);
    store_normalised(out + ((size_t)b * n + q) * C + head * D + 4 * tx,
                     acc[i], l[i]);
  }
}

// ---------------------------------------------------------------- K1 ----
// grid (ceil(N / 64), heads, B), 256 threads. Shared (floats):
//   Qs TQ*LD | Ks TK*LD | Vs TK*D | Ps TQ*LD | Rh TQ*H | Rw TQ*W
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_global_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                   const T* __restrict__ rel_w, T* __restrict__ out,
                   float* __restrict__ lse, int n, int heads, int H, int W,
                   float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Vs = Ks + TK * LD;
  float* Ps = Vs + TK * D;
  float* Rh = Ps + TQ * LD;
  float* Rw = Rh + TQ * H;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TQ;
  const int C = heads * D, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* base = qkv + (size_t)b * n * stride;
  const size_t rel_row = ((size_t)b * heads + head) * n + q0;

  load_rows(Qs, LD, base + head * D, stride, q0, TQ, n, scale);
  load_rel(Rh, rel_h + rel_row * H, H, n - q0);
  load_rel(Rw, rel_w + rel_row * W, W, n - q0);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_rows(Ks, LD, base + C + head * D, stride, k0, TK, n, 1.f);
    load_rows(Vs, D, base + 2 * C + head * D, stride, k0, TK, n, 1.f);
    __syncthreads();

    float s[4][4] = {};
    score_tile(s, Qs, Ks, ty, tx, 0, 4);

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
        s[i][j] = kv[j] ? s[i][j] + Rh[q * H + kr[j]] + Rw[q * W + kc[j]]
                        : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[q * LD + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile(acc, Ps, LD, Vs, D, TK, ty, tx);
  }
  store_out(out, lse, rel_row - q0, acc, m, l, b, n, C, head, q0, ty, tx);
}

// ---------------------------------------------------------------- K2 ----
// grid (ceil(N / 64), heads, windows), 256 threads, N <= KMAX. With
// NK = N rounded up to 16, shared (floats):
//   [Qs TQ*LD | Ks NK*LD], reused as Ps TQ*(NK+4) once the scores are in
//   registers | Vs NK*D | Rh TQ*H | Rw TQ*W
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_windowed_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                     const T* __restrict__ rel_w, T* __restrict__ out,
                     float* __restrict__ lse, int n, int heads, int H, int W,
                     float scale, int qk_floats) {
  extern __shared__ __align__(16) float smem[];
  const int nk = (n + 15) / 16 * 16;
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Ps = smem;
  float* Vs = smem + qk_floats;
  float* Rh = Vs + nk * D;
  float* Rw = Rh + TQ * H;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TQ;
  const int C = heads * D, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* base = qkv + (size_t)b * n * stride;
  const size_t rel_row = ((size_t)b * heads + head) * n + q0;

  load_rows(Qs, LD, base + head * D, stride, q0, TQ, n, scale);
  load_rows(Ks, LD, base + C + head * D, stride, 0, nk, n, 1.f);
  load_rows(Vs, D, base + 2 * C + head * D, stride, 0, nk, n, 1.f);
  load_rel(Rh, rel_h + rel_row * H, H, n - q0);
  load_rel(Rw, rel_w + rel_row * W, W, n - q0);
  __syncthreads();

  float m[4], l[4], acc[4][4];
  window_attend(Qs, Ks, Ps, Vs, Rh, Rw, n, H, W, ty, tx, m, l, acc);
  store_out(out, lse, rel_row - q0, acc, m, l, b, n, C, head, q0, ty, tx);
}

template <typename T>
int launch_global(const void* qkv, const void* rel_h, const void* rel_w,
                  void* out, float* lse, int batch, int n, int heads, int h,
                  int w, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(3 * TQ * LD + TK * D + TQ * (h + w));
  cudaError_t e = cudaFuncSetAttribute(
      attn_global_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attn_global_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out), lse, n, heads, h,
      w, 0.125f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_windowed(const void* qkv, const void* rel_h, const void* rel_w,
                    void* out, float* lse, int batch, int n, int heads, int h,
                    int w, cudaStream_t stream) {
  if (n > KMAX) return (int)cudaErrorInvalidValue;
  const int nk = (n + 15) / 16 * 16;
  int qk_floats = TQ * LD + nk * LD;
  if (TQ * (nk + 4) > qk_floats) qk_floats = TQ * (nk + 4);
  const size_t smem = sizeof(float) * (size_t)(qk_floats + nk * D + TQ * (h + w));
  cudaError_t e = cudaFuncSetAttribute(
      attn_windowed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attn_windowed_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<T*>(out), lse, n, heads, h,
      w, 0.125f, qk_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16; lse: null, or
// (B, heads, N) f32 to receive the row logsumexps. Returns the cudaError_t
// of the launch (0 = success); the caller raises on non-zero.
extern "C" {

int dhoct_attn_global(const void* qkv, const void* rel_h, const void* rel_w,
                      void* out, void* lse, int batch, int n, int heads,
                      int h, int w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return dtype == 1
             ? launch_global<__nv_bfloat16>(qkv, rel_h, rel_w, out, l, batch,
                                            n, heads, h, w, s)
             : launch_global<float>(qkv, rel_h, rel_w, out, l, batch, n,
                                    heads, h, w, s);
}

int dhoct_attn_windowed(const void* qkv, const void* rel_h, const void* rel_w,
                        void* out, void* lse, int batch, int n, int heads,
                        int h, int w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return dtype == 1
             ? launch_windowed<__nv_bfloat16>(qkv, rel_h, rel_w, out, l,
                                              batch, n, heads, h, w, s)
             : launch_windowed<float>(qkv, rel_h, rel_w, out, l, batch, n,
                                      heads, h, w, s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
