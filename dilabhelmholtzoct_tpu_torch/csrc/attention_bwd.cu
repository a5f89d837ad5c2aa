// K5: the flash backward of the encoder attention K1 / K2 (attention.cu),
// from the logsumexp rows the forward saved.
//
//   qkv   (B, N, 3C)      feature order (3, heads, 64), as the forward
//   rel_h (B, heads, N, H), rel_w (B, heads, N, W)   bias factors
//   g     (B, N, C)       dO, the output's cotangent in qkv's type
//   lse   (B, heads, N)   f32, L = m + log(l) of the forward
//   dvec  (B, heads, N)   f32, D = rowsum(dO * O) per head
//   dqkv  (B, N, 3C)      dq, dk, dv written straight into their q / k / v
//                         column blocks (no concat afterwards)
//   drel_h, drel_w        like rel_h, rel_w
//
//   s  = q.k / 8 + rel_h[q, k / W] + rel_w[q, k % W]
//   p  = exp(s - L),  dp = dO.v,  ds = p * (dp - D)
//   dq = ds.k / 8,  dk = ds^T.(q / 8),  dv = p^T.dO
//   drel_h[q, r] = sum over keys k of row r of ds[q, k]; drel_w likewise
//   over the keys of column c
//
// Replaces dilabhelmholtzoct_tpu/ops/attention.py::_flash_packed_bwd, as two
// kernels like the TPU's:
//   attn_bwd_dq_kernel  (_packed_bwd_dq_kernel): one block per (batch,
//     head, 64-query tile) loops over 64-key tiles and accumulates dq in
//     registers and drel_h / drel_w in shared memory. The block owns its
//     query rows: no atomics, a fixed summation order, a deterministic
//     result.
//   attn_bwd_dkv_kernel (_packed_bwd_dkv_kernel): one block per (batch,
//     head, 64-key tile) loops over 64-query tiles and accumulates dk and
//     dv in registers.
// Both serve every N (global 64x64 = 4096, 14x14 = 196 windows, ragged
// grids): the last tile of either kind is masked, so K5 needs no windowed
// variant. Windows that the partition zero-padded are ordinary inputs here:
// their pad tokens are live keys, as in the forward.
//
// Rounding where the TPU kernels round (bf16; float rounds nowhere): q/8 is
// exact; the dq kernel takes ds = bf16(p * (dp - D)) with p in f32; the
// dk/dv kernel rounds p first, p_b = bf16(p), and takes
// ds = bf16(p_b * (dp - D)), so the two kernels' ds differ on purpose;
// dq = bf16(sum * 1/8); drel sums the bf16 ds in f32 and rounds once.
//
// Bound on an H100 SXM (700 W), one global layer at B = 4, 12 heads:
//    dq kernel: 3 products (s, dp, dq) = 6 * 4096^2 * 64 * 48 = 309 GFLOP;
//    dk/dv kernel: 4 products (s, dp, dv, dk) = 412 GFLOP. In bf16 over
//    the 989 TFLOP/s tensor-core rate: 0.31 + 0.42 ms; the bytes (qkv, dO,
//    rel, L, D in, dqkv and drel out: ~0.3 GB) take 0.09 ms. Compute-bound.
// What this design does about it: as K1, every operand of the inner
// products sits in shared memory (64-wide tiles padded to 68 floats) and
// each thread keeps a 4x4 register tile of every product; each qkv and dO
// byte is read from device memory once per tile of the other side. The
// products run on the CUDA cores in f32, so the kernels sit far above the
// bf16 bound; tensor cores (mma.sync / wgmma with TMA) and one fused kernel
// are later work.
//
// Not carried over from the TPU kernels (Mosaic-only workarounds): head-pair
// packing into 128 lanes, one-hot selector matmuls for drel and the bias,
// the concatenated q / rel "q_cat" operand.

#include "attention_common.cuh"

namespace {

using namespace attn;

// dq kernel shared floats: Qs, Gs, Ks, Vs, Ss (64 x LD each), Rh, dRh
// (TQ x H), Rw, dRw (TQ x W), Ls, Ds (TQ)
size_t dq_smem_bytes(int h, int w) {
  return sizeof(float) * (size_t)(5 * TQ * LD + 2 * TQ * (h + w) + 2 * TQ);
}

// dk/dv kernel shared floats: Ks, Vs, Qs, Gs, Pt, St (64 x LD each), Rh
// (TQ x H), Rw (TQ x W), Ls, Ds (TQ)
size_t dkv_smem_bytes(int h, int w) {
  return sizeof(float) * (size_t)(6 * TQ * LD + TQ * (h + w) + 2 * TQ);
}

// L and D of the TQ query rows from q0: L = +inf past n, so p = exp(s - L)
// is exactly 0 on those rows
__device__ void load_rows_ld(float* Ls, float* Ds, const float* lse,
                             const float* dvec, size_t row, int nq) {
  for (int i = threadIdx.x; i < TQ; i += THREADS) {
    Ls[i] = i < nq ? lse[row + i] : INFINITY;
    Ds[i] = i < nq ? dvec[row + i] : 0.f;
  }
}

// ------------------------------------------------------- dq / drel ----
// grid (ceil(N / 64), heads, B), 256 threads
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                   const T* __restrict__ rel_w, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, T* __restrict__ dqkv,
                   T* __restrict__ drel_h, T* __restrict__ drel_w, int n,
                   int heads, int H, int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TQ * LD;
  float* Ks = Gs + TQ * LD;
  float* Vs = Ks + TK * LD;
  float* Ss = Vs + TK * LD;  // ds of the current tile, [query][key]
  float* Rh = Ss + TQ * LD;
  float* dRh = Rh + TQ * H;
  float* Rw = dRh + TQ * H;
  float* dRw = Rw + TQ * W;
  float* Ls = dRw + TQ * W;
  float* Ds = Ls + TQ;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TQ;
  const int C = heads * D, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* base = qkv + (size_t)b * n * stride;
  const size_t row = ((size_t)b * heads + head) * n + q0;

  load_rows(Qs, LD, base + head * D, stride, q0, TQ, n, scale);
  load_rows(Gs, LD, g + (size_t)b * n * C + head * D, C, q0, TQ, n, 1.f);
  load_rel(Rh, rel_h + row * H, H, n - q0);
  load_rel(Rw, rel_w + row * W, W, n - q0);
  load_rows_ld(Ls, Ds, lse, dvec, row, n - q0);
  for (int i = threadIdx.x; i < TQ * H; i += THREADS) dRh[i] = 0.f;
  for (int i = threadIdx.x; i < TQ * W; i += THREADS) dRw[i] = 0.f;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += TK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ss are consumed
    load_rows(Ks, LD, base + C + head * D, stride, k0, TK, n, 1.f);
    load_rows(Vs, LD, base + 2 * C + head * D, stride, k0, TK, n, 1.f);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    score_tile(s, Qs, Ks, ty, tx, 0, 4);
    score_tile(dp, Gs, Vs, ty, tx, 0, 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      const float L = Ls[q], Dq = Ds[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j, kg = k0 + kl;
        float ds = 0.f;
        if (kg < n) {
          const int kr = kg / W;
          const float p = expf(s[i][j] + Rh[q * H + kr] +
                               Rw[q * W + (kg - kr * W)] - L);
          ds = round_to<T>(p * (dp[i][j] - Dq));
        }
        Ss[q * LD + kl] = ds;
      }
    }
    __syncthreads();

    pv_tile(acc, Ss, LD, Ks, LD, TK, ty, tx);  // dq += ds . k
    // drel: each (query, grid row) and (query, grid column) slot of this
    // tile is summed by one thread, in key order
    const int kend = min(k0 + TK, n);
    const int r0 = k0 / W, nr = (kend - 1) / W - r0 + 1;
    for (int t = threadIdx.x; t < TQ * nr; t += THREADS) {
      const int q = t / nr, r = r0 + t % nr;
      const int lo = max(r * W, k0) - k0, hi = min((r + 1) * W, kend) - k0;
      float sum = 0.f;
      for (int kl = lo; kl < hi; ++kl) sum += Ss[q * LD + kl];
      dRh[q * H + r] += sum;
    }
    for (int t = threadIdx.x; t < TQ * W; t += THREADS) {
      const int q = t / W, c = t % W;
      float sum = 0.f;
      for (int kl = (c - k0 % W + W) % W; kl < kend - k0; kl += W)
        sum += Ss[q * LD + kl];
      dRw[t] += sum;
    }
  }
  __syncthreads();  // dRh / dRw complete

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= n) continue;
    const float o[4] = {acc[i][0] * scale, acc[i][1] * scale,
                        acc[i][2] * scale, acc[i][3] * scale};
    store4(dqkv + ((size_t)b * n + q) * stride + head * D + 4 * tx, o);
  }
  const int nq = min(TQ, n - q0);
  for (int t = threadIdx.x; t < nq * H; t += THREADS)
    drel_h[row * H + t] = from_f32<T>(dRh[t]);
  for (int t = threadIdx.x; t < nq * W; t += THREADS)
    drel_w[row * W + t] = from_f32<T>(dRw[t]);
}

// ------------------------------------------------------------ dk / dv ----
// grid (ceil(N / 64), heads, B), 256 threads; thread (ty, tx) owns key rows
// ty + 16 i of the block's tile
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ rel_h,
                    const T* __restrict__ rel_w, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dqkv,
                    int n, int heads, int H, int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TK * LD;
  float* Qs = Vs + TK * LD;
  float* Gs = Qs + TQ * LD;
  float* Pt = Gs + TQ * LD;  // p of the current tile, [key][query]
  float* St = Pt + TK * LD;  // ds of the current tile, [key][query]
  float* Rh = St + TK * LD;
  float* Rw = Rh + TQ * H;
  float* Ls = Rw + TQ * W;
  float* Ds = Ls + TQ;

  const int head = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * TK;
  const int C = heads * D, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* base = qkv + (size_t)b * n * stride;
  const T* gbase = g + (size_t)b * n * C + head * D;
  const size_t head_row = ((size_t)b * heads + head) * n;

  load_rows(Ks, LD, base + C + head * D, stride, k0, TK, n, 1.f);
  load_rows(Vs, LD, base + 2 * C + head * D, stride, k0, TK, n, 1.f);

  int kr[4], kc[4];
  bool kv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty + 16 * i;
    kv[i] = kg < n;
    kr[i] = kg / W;
    kc[i] = kg - kr[i] * W;
  }

  float dk[4][4] = {}, dv[4][4] = {};
  for (int q0 = 0; q0 < n; q0 += TQ) {
    __syncthreads();  // the previous tile's Qs / Gs / Pt / St are consumed
    load_rows(Qs, LD, base + head * D, stride, q0, TQ, n, scale);
    load_rows(Gs, LD, gbase, C, q0, TQ, n, 1.f);
    load_rel(Rh, rel_h + (head_row + q0) * H, H, n - q0);
    load_rel(Rw, rel_w + (head_row + q0) * W, W, n - q0);
    load_rows_ld(Ls, Ds, lse, dvec, head_row + q0, n - q0);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};  // [key i][query j]
    score_tile(s, Ks, Qs, ty, tx, 0, 4);
    score_tile(dp, Vs, Gs, ty, tx, 0, 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (kv[i]) {
          p = round_to<T>(expf(s[i][j] + Rh[ql * H + kr[i]] +
                               Rw[ql * W + kc[i]] - Ls[ql]));
          ds = round_to<T>(p * (dp[i][j] - Ds[ql]));
        }
        Pt[kl * LD + ql] = p;
        St[kl * LD + ql] = ds;
      }
    }
    __syncthreads();
    pv_tile(dv, Pt, LD, Gs, LD, TQ, ty, tx);  // dv += p^T . dO
    pv_tile(dk, St, LD, Qs, LD, TQ, ty, tx);  // dk += ds^T . (q / 8)
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kv[i]) continue;
    T* dst = dqkv + ((size_t)b * n + k0 + ty + 16 * i) * stride + head * D +
             4 * tx;
    store4(dst + C, dk[i]);
    store4(dst + 2 * C, dv[i]);
  }
}

template <typename T>
int launch_dq(const void* qkv, const void* rel_h, const void* rel_w,
              const void* g, const float* lse, const float* dvec, void* dqkv,
              void* drel_h, void* drel_w, int batch, int n, int heads, int h,
              int w, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(h, w);
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attn_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(g), lse, dvec,
      static_cast<T*>(dqkv), static_cast<T*>(drel_h), static_cast<T*>(drel_w),
      n, heads, h, w, 0.125f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* qkv, const void* rel_h, const void* rel_w,
               const void* g, const float* lse, const float* dvec, void* dqkv,
               int batch, int n, int heads, int h, int w,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(h, w);
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TK - 1) / TK, heads, batch);
  attn_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel_h),
      static_cast<const T*>(rel_w), static_cast<const T*>(g), lse, dvec,
      static_cast<T*>(dqkv), n, heads, h, w, 0.125f);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (qkv, rel, g,
// dqkv and drel share it; lse and dvec are f32). The dq kernel writes the q
// columns of dqkv and drel; the dk/dv kernel the k and v columns. Each
// launches on `stream` and returns the cudaError_t of its launch
// (0 = success); the caller raises on non-zero.
extern "C" {

int dhoct_attn_bwd_dq(const void* qkv, const void* rel_h, const void* rel_w,
                      const void* g, const void* lse, const void* dvec,
                      void* dqkv, void* drel_h, void* drel_w, int batch,
                      int n, int heads, int h, int w, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dv = static_cast<const float*>(dvec);
  if (dq_smem_bytes(h, w) > 232448) return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_dq<__nv_bfloat16>(qkv, rel_h, rel_w, g, l, dv, dqkv,
                                        drel_h, drel_w, batch, n, heads, h, w,
                                        s)
             : launch_dq<float>(qkv, rel_h, rel_w, g, l, dv, dqkv, drel_h,
                                drel_w, batch, n, heads, h, w, s);
}

int dhoct_attn_bwd_dkv(const void* qkv, const void* rel_h, const void* rel_w,
                       const void* g, const void* lse, const void* dvec,
                       void* dqkv, int batch, int n, int heads, int h, int w,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dv = static_cast<const float*>(dvec);
  if (dkv_smem_bytes(h, w) > 232448) return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_dkv<__nv_bfloat16>(qkv, rel_h, rel_w, g, l, dv, dqkv,
                                         batch, n, heads, h, w, s)
             : launch_dkv<float>(qkv, rel_h, rel_w, g, l, dv, dqkv, batch, n,
                                 heads, h, w, s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
