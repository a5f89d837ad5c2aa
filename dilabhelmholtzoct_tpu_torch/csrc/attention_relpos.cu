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
// K6 replaces dilabhelmholtzoct_tpu/ops/attention.py flash_attention_relpos
// (_flash_kernel). Its rounding points are that kernel's, and differ from
// K1 / K2: the scale multiplies the f32 score after the dot (d^-1/2 is no
// power of two at d = 80, so a scaled bf16 q would round), the
// un-normalised p is rounded to the input type (rnd) before the p.v product
// while the denominator sums the unrounded p, and the division by the
// denominator comes last, in f32, with one rounding of the output. Every
// sum is f32. One block per (batch, head, query tile) streams 64-key tiles
// with an online softmax; keys past N in the last tile (N = 196 in the
// windowed layers) are masked to -inf, and rows past N are neither stored
// nor counted. Two kernels, both on the tensor cores, for every d that is a
// multiple of 4 up to 128:
//
//    f32, attn_relpos_tf32_kernel<DP, ROW_TILE>: the flash body K1 shares
//    (attention_tf32.cuh flash_tf32; in f32 the rounding of p is the
//    identity, and d^-1/2 multiplies the f32 accumulator): q.k^T and p.v in
//    split TF32 (hi.hi + hi.lo + lo.hi on mma.sync m16n8k8, f32
//    accumulators, each fragment split as it is loaded) from shared rows of
//    DP = ceil(d / 8) * 8 columns, zero past d, padded to DP + 4 floats;
//    one m16 query tile per warp, 8 warps where ROW_TILE and DP <= 80 (the
//    ViT-H global layers: 128 rows share each K / V tile), else 4; K / V
//    tiles through a 2-stage cp.async ring in 16-byte pieces; p in f32 fed
//    to p.v from registers; o / l last.
//    bf16, attn_relpos_mma_kernel<DP, ROW_TILE>: K1's tensor-core design
//    (attention.cu attn_global_mma_kernel) for any head dim: 4 warps of
//    M m16 query tiles (M = 2 up to DP = 80, the ViT-H head: 128 query
//    rows; 1 above, where the output accumulators would not fit beside the
//    scores), q.k^T and p.v on mma.sync m16n8k16 from shared rows of
//    DP = ceil(d / 16) * 16 columns, zero past d, padded to DP + 8 elements
//    (attention_mma.cuh); K / V tiles through a 2-stage cp.async ring, in
//    16-byte pieces (8-byte where d is no multiple of 8); s = scale * acc +
//    bias on the accumulators; the online softmax on the fragments; the
//    un-normalised p rounded to bf16 and fed to p.v from registers, the
//    denominator summing the f32 p; one division and one rounding at the
//    end. ROW_TILE (W = 64: every ViT global layer): a 64-key tile is one
//    grid row, so a row's bias over the tile is one Rh value plus Rw over
//    the tile's columns; otherwise (the windowed layers) each slot looks its
//    bias up with KeyWalk and keys past N are selected away.
//
// Bound on an H100 SXM (700 W), ViT-H (16 heads of 80), B = 1:
//    global layer, N = 4096: 4 * 4096^2 * 80 * 16 = 85.9 GFLOP over the
//        split-TF32 rate (495 / 3 = 165 TFLOP/s) = 0.52 ms (over the CUDA
//        cores' 67 TFLOP/s f32 peak: 1.28 ms), over the 989 TFLOP/s bf16
//        rate = 0.087 ms; bytes (qkv 62.9 MB + rel 33.6 MB + out 21.0 MB in
//        f32, half in bf16) over 3.35 TB/s = 0.035 / 0.018 ms.
//        Compute-bound.
//    windowed layer, 25 windows of 196: 4.9 GFLOP -> 0.030 ms in f32 over
//        the split-TF32 rate (0.073 over the CUDA cores; compute-bound; the
//        64-key tiles over 196 keys compute 256 / 196 = 1.3x of it twice:
//        1.7x); in bf16 0.005 ms of products against 55 MB -> 0.016 ms
//        (bound by bytes).
// What this design does about it: as K1, every operand of the two inner
// products sits in shared memory, each qkv byte is read from device memory
// once per query tile, and both products run on the tensor cores; what
// stays on the CUDA cores per score is the scale and the bias, the
// exponential and the max / sum (and in f32 the split of each operand as
// its fragment is loaded), and the next K / V tile's copy overlaps the
// current tile's work. wgmma with TMA is later work.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the head-major
// (B*heads, N, d) copies of q, k and v and of the output, the one-hot
// selector matmuls that expand the bias, whole-N k / v blocks in VMEM.

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

using namespace attn;

constexpr int MAX_D = 128;  // head dim: a multiple of 4 up to this

// ------------------------------------------------------------------ f32 ----
// The flash body's block (attention_tf32.cuh flash_tf32) for DP = d
// rounded up to 8 columns: 8 warps (128 query rows share each K / V tile)
// where a key tile is one grid row (the global layers) and the shared
// memory holds them (DP <= 80: ViT-H), else 4 (the windowed layers: twice
// the blocks for their 196 rows)
template <int DP, bool ROW_TILE>
using K6F = tf32::Flash<DP, ROW_TILE && DP <= 80 ? 8 : 4>;

// grid (ceil(N / ROWS), heads, B), 32 WARPS threads: the flash body with
// scale d^-1/2 on the accumulator, no LSE rows
template <int DP, bool ROW_TILE>
__global__ void __launch_bounds__(K6F<DP, ROW_TILE>::NTH, 1)
attn_relpos_tf32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ rel_h,
                        const float* __restrict__ rel_w,
                        float* __restrict__ out, int n, int heads, int d,
                        int H, int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int head = blockIdx.y, b = blockIdx.z, C = heads * d;
  const size_t row = (size_t)b * heads + head;  // (batch, head)
  tf32::flash_tf32<K6F<DP, ROW_TILE>, ROW_TILE>(
      smem, qkv + (size_t)b * n * 3 * C + head * d, C, rel_h + row * n * H,
      rel_w + row * n * W, out + (size_t)b * n * C + head * d, nullptr, n, d,
      H, W, scale);
}

// ----------------------------------------------------------------- bf16 ----
// M m16 query tiles per warp: 2 (sharing every K / V fragment between two
// tiles, as K1) while the output accumulators (DP / 2 floats a tile) fit
// beside the scores, else 1
__host__ __device__ constexpr int k6_tiles(int dp) { return dp <= 80 ? 2 : 1; }

// grid (ceil(N / R), heads, B) with R = 64 M query rows per block, 4 warps:
// warp w owns query rows 16 (M w + m) + g and 16 (M w + m) + g + 8 (m < M,
// lane = 4 g + t). With LD = DP + 8, shared (bf16):
// Qs R x LD | Ks, Vs stage 0, 1 (64 x LD) | Rh R x factor_ld(H) | Rw
// R x factor_ld(W).
template <int DP, bool ROW_TILE>
__global__ void __launch_bounds__(mma::NT, 2)
attn_relpos_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ rel_h,
                       const __nv_bfloat16* __restrict__ rel_w,
                       __nv_bfloat16* __restrict__ out, int n, int heads,
                       int d, int H, int W, float scale) {
  using namespace mma;
  constexpr int M = k6_tiles(DP), ROWS = 16 * M * WARPS, LD = DP + 8,
                KV = TILE * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + ROWS * LD;
  bf16* Vs = Ks + 2 * KV;
  bf16* Rh = Vs + 2 * KV;
  bf16* Rw = Rh + ROWS * ldh;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS;
  const int C = heads * d, stride = 3 * C;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16 * M;
  const int t = lane & 3, g = lane >> 2;
  const bf16* base = qkv + (size_t)b * n * stride + head * d;
  const size_t rel_row = ((size_t)b * heads + head) * n + q0;
  const int nq = min(ROWS, n - q0);

  load_rows_async<LD, DP>(Qs, base, stride, q0, n, ROWS, d);
  load_factors(Rh, rel_h + rel_row * H, H, nq, ROWS);
  load_factors(Rw, rel_w + rel_row * W, W, nq, ROWS);
  load_rows_async<LD, DP>(Ks, base + C, stride, 0, n, TILE, d);
  load_rows_async<LD, DP>(Vs, base + 2 * C, stride, 0, n, TILE, d);
  cp_commit();

  float m[M][2], l[M][2], o[M][DP / 8][4] = {};
#pragma unroll
  for (int mm = 0; mm < M; ++mm)
    m[mm][0] = m[mm][1] = -INFINITY, l[mm][0] = l[mm][1] = 0.f;

  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    const bf16* Kc = Ks + (it & 1) * KV;
    const bf16* Vc = Vs + (it & 1) * KV;
    if (it + 1 < ntiles) {  // the stage consumed in the previous iteration
      load_rows_async<LD, DP>(Ks + ((it + 1) & 1) * KV, base + C, stride,
                              k0 + TILE, n, TILE, d);
      load_rows_async<LD, DP>(Vs + ((it + 1) & 1) * KV, base + 2 * C, stride,
                              k0 + TILE, n, TILE, d);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and Q, the bias factors) have landed
    __syncthreads();

    float s[M][TILE / 8][4] = {};
    product_nk<M, DP, LD>(s, Qs, r0, Kc, lane);
    if (ROW_TILE) {  // no key past n: n = 64 H
#pragma unroll
      for (int mm = 0; mm < M; ++mm)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = r0 + 16 * mm + g + 8 * r;
          const float rh = __bfloat162float(Rh[q * ldh + it]);
#pragma unroll
          for (int j = 0; j < TILE / 8; ++j) {
            const float2 rw = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    Rw + q * ldw + 8 * j + 2 * t));
            s[mm][j][2 * r] = fmaf(s[mm][j][2 * r], scale, rh + rw.x);
            s[mm][j][2 * r + 1] = fmaf(s[mm][j][2 * r + 1], scale, rh + rw.y);
          }
        }
    } else {
      KeyWalk key(k0 + 2 * t, W);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool kv = k0 + 8 * j + 2 * t + e < n;
          const int kr = min(key.r, H - 1);  // in bounds past n, discarded
#pragma unroll
          for (int mm = 0; mm < M; ++mm)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int q = r0 + 16 * mm + g + 8 * r;
              const float bias = __bfloat162float(Rh[q * ldh + kr]) +
                                 __bfloat162float(Rw[q * ldw + key.c]);
              float& x = s[mm][j][2 * r + e];
              x = kv ? fmaf(x, scale, bias) : -INFINITY;
            }
          key.step(e);
        }
    }

    uint32_t pk[M][TILE / 8][2];
#pragma unroll
    for (int mm = 0; mm < M; ++mm)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[mm][j][2 * r], s[mm][j][2 * r + 1]));
        // key 0 of the first tile is real: m_new is finite from there on
        const float m_new = fmaxf(m[mm][r], quad_max(mx));
        const float alpha = exp2_approx((m[mm][r] - m_new) * LOG2E);
        const float mb = m_new * LOG2E;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float p0 = exp2_approx(fmaf(s[mm][j][2 * r], LOG2E, -mb));
          const float p1 = exp2_approx(fmaf(s[mm][j][2 * r + 1], LOG2E, -mb));
          rs += p0 + p1;                    // the denominator sums f32 p
          pk[mm][j][r] = pack_bf16(p0, p1);  // p.v takes it rounded
        }
        l[mm][r] = l[mm][r] * alpha + rs;  // the lane's share; quad sum last
        m[mm][r] = m_new;
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          o[mm][dn][2 * r] *= alpha;
          o[mm][dn][2 * r + 1] *= alpha;
        }
      }
    product_kn<M, DP, LD>(o, pk, Vc, lane);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int mm = 0; mm < M; ++mm)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[mm][r]);
      const int q = q0 + r0 + 16 * mm + g + 8 * r;
      if (q >= n) continue;
      bf16* dst = out + ((size_t)b * n + q) * C + head * d + 2 * t;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn)
        if (8 * dn + 2 * t < d)  // d is even: both columns or neither
          *reinterpret_cast<uint32_t*>(dst + 8 * dn) =
              pack_bf16(o[mm][dn][2 * r] / lr, o[mm][dn][2 * r + 1] / lr);
    }
}

template <int DP, bool ROW_TILE>
int launch_tf32_dp(const void* qkv, const void* rel_h, const void* rel_w,
                   void* out, int batch, int n, int heads, int d, int h, int w,
                   cudaStream_t stream) {
  using F = K6F<DP, ROW_TILE>;
  const size_t smem = F::smem(h, w);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = attn_relpos_tf32_kernel<DP, ROW_TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + F::ROWS - 1) / F::ROWS, heads, batch);
  kernel<<<grid, F::NTH, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out), n, heads, d,
      h, w, 1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tf32(const void* qkv, const void* rel_h, const void* rel_w,
                void* out, int batch, int n, int heads, int d, int h, int w,
                cudaStream_t stream) {
  return w == mma::TILE
             ? launch_tf32_dp<DP, true>(qkv, rel_h, rel_w, out, batch, n,
                                        heads, d, h, w, stream)
             : launch_tf32_dp<DP, false>(qkv, rel_h, rel_w, out, batch, n,
                                         heads, d, h, w, stream);
}

template <int DP, bool ROW_TILE>
int launch_mma_dp(const void* qkv, const void* rel_h, const void* rel_w,
                  void* out, int batch, int n, int heads, int d, int h, int w,
                  cudaStream_t stream) {
  using namespace mma;
  constexpr int rows = 16 * k6_tiles(DP) * WARPS, ld = DP + 8;
  const size_t smem = sizeof(bf16) * (size_t)(rows * ld + 4 * TILE * ld +
                                              rows * (factor_ld(h) +
                                                      factor_ld(w)));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = attn_relpos_mma_kernel<DP, ROW_TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(out), n, heads, d, h,
      w, 1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mma(const void* qkv, const void* rel_h, const void* rel_w,
               void* out, int batch, int n, int heads, int d, int h, int w,
               cudaStream_t stream) {
  return w == mma::TILE
             ? launch_mma_dp<DP, true>(qkv, rel_h, rel_w, out, batch, n, heads,
                                       d, h, w, stream)
             : launch_mma_dp<DP, false>(qkv, rel_h, rel_w, out, batch, n,
                                        heads, d, h, w, stream);
}

int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out,
           int batch, int n, int heads, int d, int h, int w, bool bf16,
           cudaStream_t stream) {
  if (d < 4 || d % 4 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (bf16) {
    switch ((d + 15) / 16) {
#define DHOCT_ND(ND)                                                        \
  case ND:                                                                  \
    return launch_mma<16 * ND>(qkv, rel_h, rel_w, out, batch, n, heads, d,  \
                               h, w, stream);
      DHOCT_ND(1) DHOCT_ND(2) DHOCT_ND(3) DHOCT_ND(4)
      DHOCT_ND(5) DHOCT_ND(6) DHOCT_ND(7) DHOCT_ND(8)
#undef DHOCT_ND
    }
  } else {
    switch ((d + 7) / 8) {
#define DHOCT_N8(N8)                                                        \
  case N8:                                                                  \
    return launch_tf32<8 * N8>(qkv, rel_h, rel_w, out, batch, n, heads, d,  \
                               h, w, stream);
      DHOCT_N8(1) DHOCT_N8(2) DHOCT_N8(3) DHOCT_N8(4)
      DHOCT_N8(5) DHOCT_N8(6) DHOCT_N8(7) DHOCT_N8(8)
      DHOCT_N8(9) DHOCT_N8(10) DHOCT_N8(11) DHOCT_N8(12)
      DHOCT_N8(13) DHOCT_N8(14) DHOCT_N8(15) DHOCT_N8(16)
#undef DHOCT_N8
    }
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
  return launch(qkv, rel_h, rel_w, out, batch, n, heads, d, h, w, dtype == 1,
                static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
