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
// windowed layers) are masked to -inf. Two kernels:
//
//    f32, attn_relpos_kernel<ND>: 256 threads (16 x 16: ty, tx) per 64-query
//    tile, inputs widened to f32 in shared memory; a thread owns a 4 x 4
//    tile of the scores and, of the output, rows ty + 16 i and head-dim
//    columns tx + 16 j for j < ND = ceil(d / 16): instantiated for
//    ND = 1..8, so it takes every d that is a multiple of 4 up to 128
//    (16-byte shared rows, 8-byte loads).
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
//        67 TFLOP/s f32 peak = 1.28 ms, over the 989 TFLOP/s bf16 rate
//        = 0.087 ms; bytes (qkv 62.9 MB + rel 33.6 MB + out 21.0 MB in f32,
//        half in bf16) over 3.35 TB/s = 0.035 / 0.018 ms. Compute-bound.
//    windowed layer, 25 windows of 196: 4.9 GFLOP -> 0.073 ms in f32
//        (compute-bound); in bf16 0.005 ms of products against 55 MB ->
//        0.016 ms (bound by bytes).
// What this design does about it: as K1, every operand of the two inner
// products sits in shared memory and each qkv byte is read from device
// memory once per query tile. The f32 kernel's p.v product reads v by single
// floats (the strided column ownership that lets one code path serve every
// d), so it needs more shared loads per multiply-add than K1's; its products
// run on the CUDA cores in f32. The bf16 kernel runs both products on the
// tensor cores; what stays on the CUDA cores per score is the scale and the
// bias, the exponential and the max / sum, and the next K / V tile's copy
// overlaps the current tile's work. wgmma with TMA is later work.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the head-major
// (B*heads, N, d) copies of q, k and v and of the output, the one-hot
// selector matmuls that expand the bias, whole-N k / v blocks in VMEM.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int MAX_ND = 8;      // head dim <= 128
constexpr int LDP = TK + 4;    // padded shared row of the p tile

// rows [row0, row0 + nrows) x d columns of a row-major matrix with `stride`
// elements per row -> shared dst (leading dim ld >= d, a multiple of 4);
// rows at or past n and columns at or past d are zero.
__device__ void load_rows_d(float* dst, int ld, int width, const float* src,
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

// ------------------------------------------------------------------ f32 ----
// grid (ceil(N / 64), heads, B), 256 threads. With ld = d + 4 and
// ldv = 16 * ND, shared (floats):
//   Qs TQ*ld | Ks TK*ld | Vs TK*ldv | Ps TQ*LDP | Rh TQ*H | Rw TQ*W
template <int ND>
__global__ void __launch_bounds__(THREADS)
attn_relpos_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, float* __restrict__ out, int n,
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
  const float* base = qkv + (size_t)b * n * stride;
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
        rs += p;
        Ps[q * LDP + tx + 16 * j] = p;
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
    float* o = out + ((size_t)b * n + q) * C + head * d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[c] = acc[i][j] / l[i];
    }
  }
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

template <int ND>
int launch_f32_nd(const void* qkv, const void* rel_h, const void* rel_w,
                  void* out, int batch, int n, int heads, int d, int h, int w,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * TQ * (d + 4) + TK * 16 * ND +
                                               TQ * LDP + TQ * (h + w));
  cudaError_t e = cudaFuncSetAttribute(
      attn_relpos_kernel<ND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch);
  attn_relpos_kernel<ND><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out), n, heads, d,
      h, w, 1.f / sqrtf((float)d));
  return (int)cudaGetLastError();
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
  if (d < 4 || d % 4 || d > 16 * MAX_ND) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
#define DHOCT_ND(ND)                                                        \
  case ND:                                                                  \
    return bf16 ? launch_mma<16 * ND>(qkv, rel_h, rel_w, out, batch, n,     \
                                      heads, d, h, w, stream)               \
                : launch_f32_nd<ND>(qkv, rel_h, rel_w, out, batch, n,       \
                                    heads, d, h, w, stream);
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
  return launch(qkv, rel_h, rel_w, out, batch, n, heads, d, h, w, dtype == 1,
                static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
