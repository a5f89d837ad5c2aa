// K7: windowed SAM encoder self-attention read straight from the
// image-layout qkv projection — the window partition before the attention
// and the un-partition after it never exist in device memory.
//
//   qkv  (B, H, W, 3C)  the qkv projection of the H x W real tokens, feature
//                       order (3, heads, 64)
//   rel  (B, heads, H, W, 2 ws)  per-token bias factors: [..., :ws] over the
//                       key rows of the token's window, [..., ws:] over its
//                       key columns
//   bias (3C)           the qkv projection's bias
//   out  (B, H, W, C)   image layout, ready for the output projection
//
// The image is tiled by ws x ws windows from the top left; window (wy, wx)
// holds the tokens (wy ws + r, wx ws + c). Where H or W is no multiple of
// ws, the last windows reach past the image (64 = 4 * 14 + 8: the fifth
// window row and column hold 8 real and 6 pad tokens). A pad token is what
// the partitioned route makes of a zero-padded LayerNorm output: its q, k
// and v are the projection's bias row. Pad tokens attend and are attended,
// unmasked; their outputs are dropped, so their bias factors are never
// needed and `rel` holds none. Within a window:
//
//   s[q, k] = (q . k) / 8 + rel[q, k / ws] + rel[q, ws + k % ws]
//   out[q]  = softmax_k(s[q, :]) . v
//
// K7 replaces dilabhelmholtzoct_tpu/ops/attention.py
// flash_attention_windowed_image (_windowed_image_kernel). One block per
// (window, head [, 64-query tile]) first writes the window's token table
// (each token's image position, or that it is a pad token), then gathers
// the window's queries and all its keys and values by it from the image (or
// from the bias row) into shared memory, and from there on runs K2's body,
// so a real token's output is bit-equal to K2's on the partitioned windows:
//    f32, attn_winimg_kernel: 256 threads per 64-query tile, K2's
//    attention_common.cuh window_attend;
//    bf16, attn_winimg_mma_kernel: 4 warps per (window, head), K2's
//    attention_mma.cuh window_tile_mma on the tensor cores.
// Only real positions are written.
//
// Bound on an H100 SXM (700 W): K2's -- the same products on the same bytes
// (ViT-B, B = 1: f32 2.95 GFLOP over 67 TFLOP/s = 0.044 ms, compute-bound;
// bf16 33.5 MB over 3.35 TB/s = 0.010 ms, bound by bytes). What the kernel
// saves lies outside it: the pad, the two 6-D transposes and the slice of
// the partitioned route.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the 16-column
// slots of the spread layout with their gathers in and out, the phantom
// column mask, head-pair packing, the one-hot selector matmuls.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int PAD = -1;   // a pad token: its q, k and v are the bias row
constexpr int NONE = -2;  // past the window's ws^2 tokens: a zero row

// window tokens [row0, row0 + nrows) x 64 columns -> shared dst (leading dim
// ld), times `scale`: from the image row `img + tok[t] * stride` for a real
// token, from `pad` for a pad token, zero past the window's tokens.
// window tokens [row0, row0 + nrows) x 64 columns -> shared dst (leading dim
// ld), times `scale`: from the image row `img + tok[t] * stride` for a real
// token, from `pad` for a pad token, zero past the window's tokens.
__device__ void load_rows_img(float* dst, int ld, const float* img,
                              const float* pad, int stride, const int* tok,
                              int row0, int nrows, float scale) {
  for (int i = threadIdx.x; i < nrows * (D / 4); i += THREADS) {
    const int t = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const int o = tok[row0 + t];
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (o != NONE) load4(o == PAD ? pad + c4 : img + (size_t)o * stride + c4, v);
    *reinterpret_cast<float4*>(dst + t * ld + c4) =
        make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale);
  }
}

// The token table of window wi (of nwx per window row) for its first `count`
// slots, by a block of nth threads: each slot's image position r W + c, PAD
// or NONE (one division per token, not per load).
__device__ void token_table(int* tok, int count, int wi, int nwx, int ws,
                            int H, int W, int nth) {
  const int n = ws * ws;
  for (int t = threadIdx.x; t < count; t += nth) {
    const int wr = t / ws;
    const int r = (wi / nwx) * ws + wr, c = (wi % nwx) * ws + (t - wr * ws);
    tok[t] = t >= n ? NONE : (r < H && c < W) ? r * W + c : PAD;
  }
}

// ------------------------------------------------------------------ f32 ----
// grid (ceil(ws^2 / 64), heads, B * windows), 256 threads, ws^2 <= KMAX.
// Shared memory as K2's with H = W = ws, then Tok: for each of the KMAX
// token slots of the window its image position, PAD or NONE.
__global__ void __launch_bounds__(THREADS, 1)
attn_winimg_kernel(const float* __restrict__ qkv, const float* __restrict__ rel,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int heads, int H, int W, int ws, int nwx, int nwin,
                   float scale, int qk_floats) {
  extern __shared__ __align__(16) float smem[];
  const int n = ws * ws, nk = (n + 15) / 16 * 16;
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Ps = smem;
  float* Vs = smem + qk_floats;
  float* Rh = Vs + nk * D;
  float* Rw = Rh + TQ * ws;
  int* Tok = reinterpret_cast<int*>(Rw + TQ * ws);

  const int head = blockIdx.y, q0 = blockIdx.x * TQ;
  const int b = blockIdx.z / nwin, wi = blockIdx.z - b * nwin;
  const int C = heads * D, stride = 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* img = qkv + (size_t)b * H * W * stride + head * D;
  const float* pad = bias + head * D;

  token_table(Tok, KMAX, wi, nwx, ws, H, W, THREADS);
  __syncthreads();

  load_rows_img(Qs, LD, img, pad, stride, Tok, q0, TQ, scale);
  load_rows_img(Ks, LD, img + C, pad + C, stride, Tok, 0, nk, 1.f);
  load_rows_img(Vs, D, img + 2 * C, pad + 2 * C, stride, Tok, 0, nk, 1.f);
  // the query rows' bias factors; zero for pad queries (never written out)
  const float* rel_img = rel + ((size_t)b * heads + head) * H * W * 2 * ws;
  for (int i = threadIdx.x; i < TQ * 2 * ws; i += THREADS) {
    const int t = i / (2 * ws), k = i - t * 2 * ws;
    const int o = Tok[q0 + t];
    const float x = o >= 0 ? rel_img[(size_t)o * 2 * ws + k] : 0.f;
    (k < ws ? Rh + t * ws + k : Rw + t * ws + (k - ws))[0] = x;
  }
  __syncthreads();

  float m[4], l[4], acc[4][4];
  window_attend(Qs, Ks, Ps, Vs, Rh, Rw, n, ws, ws, ty, tx, m, l, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = Tok[q0 + ty + 16 * i];
    if (o < 0) continue;  // only real positions are written
    store_normalised(out + ((size_t)b * H * W + o) * C + head * D + 4 * tx,
                     acc[i], l[i]);
  }
}

// ----------------------------------------------------------------- bf16 ----
// grid (1, heads, B * windows), 32 WIN_WARPS threads: K2's bf16 block
// (attention.cu attn_windowed_mma_kernel) with the rows gathered by the
// token table: shared memory as K2's with H = W = ws, then Tok (NK ints).
constexpr int WIN_WARPS = 4;

template <int NJ, bool EXACT>
__global__ void __launch_bounds__(32 * WIN_WARPS, 2)
attn_winimg_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ rel,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int heads, int H,
                       int W, int ws, int nwx, int nwin) {
  using namespace mma;
  constexpr int NTH = 32 * WIN_WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = ws * ws, nj = (n + 15) / 16, nk = 16 * nj;
  const int fk16 = win_fk16(ws, ws), fk = 16 * fk16, fld = fk + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + nk * LDS;
  bf16* F = Vs + nk * LDS;
  uint4* E = reinterpret_cast<uint4*>(F + nk * fld);
  bf16* Qw = reinterpret_cast<bf16*>(E + fk16 * nj * 32);
  int* Tok = reinterpret_cast<int*>(Qw + WIN_WARPS * 2 * 16 * LDS);

  const int head = blockIdx.y;
  const int b = blockIdx.z / nwin, wi = blockIdx.z - b * nwin;
  const int C = heads * D, stride = 3 * C;
  const int t = (threadIdx.x & 31) & 3, g = (threadIdx.x & 31) >> 2;
  const bf16* img = qkv + (size_t)b * H * W * stride + head * D;
  const bf16* pad = bias + head * D;

  token_table(Tok, nk, wi, nwx, ws, H, W, NTH);
  __syncthreads();

  // window token r's row of part p (0 q, 1 k, 2 v) from the image or the
  // bias row; `ok` false past the window's tokens (a zero row)
  auto row = [&](int r, int part, bool& ok) {
    const int o = Tok[r];
    ok = o != NONE;
    return (o == PAD ? pad : img + (size_t)max(o, 0) * stride) + part * C;
  };
  for (int i = threadIdx.x; i < nk * (D / 8); i += NTH) {
    const int r = i >> 3, c = (i & 7) * 8;
    bool ok;
    cp_async16(Ks + r * LDS + c, row(r, 1, ok) + c, ok);
    cp_async16(Vs + r * LDS + c, row(r, 2, ok) + c, ok);
  }
  // F's factor columns: the query token's 2 ws factors (ws 4-byte words),
  // zero for pad queries (never written out) and past the window's tokens
  const bf16* rel_img = rel + ((size_t)b * heads + head) * H * W * 2 * ws;
  for (int i = threadIdx.x; i < nk * ws; i += NTH) {
    const int r = i / ws, f = 2 * (i - r * ws);
    const int o = Tok[r];
    cp_async4(F + r * fld + f, rel_img + (size_t)max(o, 0) * 2 * ws + f,
              o >= 0);
  }
  cp_commit();
  fill_mask_columns<NTH>(F, fld, nk, 2 * ws, fk);
  build_onehot<NTH>(E, n, nj, ws, ws);

  auto stage_q = [&](bf16* dst, int row0) {
    for (int i = threadIdx.x & 31; i < 16 * (D / 8); i += 32) {
      const int r = i >> 3, c = (i & 7) * 8;
      bool ok;
      const bf16* src = row(row0 + r, 0, ok) + c;
      cp_async16(dst + r * LDS + c, src, ok);
    }
  };
  auto store = [&](int row0, float (*o)[4], const float*, const float*) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = Tok[row0 + g + 8 * r];
      if (pos < 0) continue;  // only real positions are written
      bf16* dst = out + ((size_t)b * H * W + pos) * C + head * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<uint32_t*>(dst + 8 * dn) =
            pack_bf16(o[dn][2 * r], o[dn][2 * r + 1]);
    }
  };
  window_tiles_mma<NJ, EXACT, NTH>(Qw, Ks, Vs, F, fld, E, fk16, nj, stage_q,
                                   store);
}

int launch_f32(const void* qkv, const void* rel, const void* bias, void* out,
               int batch, int h, int w, int heads, int ws,
               cudaStream_t stream) {
  const int n = ws * ws;
  const int nk = (n + 15) / 16 * 16;
  int qk_floats = TQ * LD + nk * LD;
  if (TQ * (nk + 4) > qk_floats) qk_floats = TQ * (nk + 4);
  const size_t smem = sizeof(float) * (size_t)(qk_floats + nk * D + TQ * 2 * ws) +
                      sizeof(int) * KMAX;
  cudaError_t e = cudaFuncSetAttribute(
      attn_winimg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nwy = (h + ws - 1) / ws, nwx = (w + ws - 1) / ws;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch * nwy * nwx);
  attn_winimg_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel),
      static_cast<const float*>(bias), static_cast<float*>(out), heads, h, w,
      ws, nwx, nwy * nwx, 0.125f, qk_floats);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, const void* rel, const void* bias, void* out,
                int batch, int h, int w, int heads, int ws,
                cudaStream_t stream) {
  using namespace mma;
  const int nk = (ws * ws + 15) / 16 * 16;
  const size_t smem = window_smem(ws * ws, ws, ws, WIN_WARPS) + sizeof(int) * nk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // the instance K2 takes for the same window (attention.cu launch_windowed_bf16)
  auto kernel = nk == 208 ? attn_winimg_mma_kernel<13, true>
                          : attn_winimg_mma_kernel<KMAX / 16, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nwy = (h + ws - 1) / ws, nwx = (w + ws - 1) / ws;
  kernel<<<dim3(1, heads, batch * nwy * nwx), 32 * WIN_WARPS, smem,
           stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), heads, h, w,
      ws, nwx, nwy * nwx);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (qkv, rel, bias and
// out all of it). Returns the cudaError_t of the launch (0 = success); the
// caller raises on non-zero.
extern "C" {

int dhoct_attn_windowed_image(const void* qkv, const void* rel,
                              const void* bias, void* out, int batch, int h,
                              int w, int heads, int ws, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws < 1 || ws * ws > KMAX) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? launch_bf16(qkv, rel, bias, out, batch, h, w, heads, ws,
                                  s)
                    : launch_f32(qkv, rel, bias, out, batch, h, w, heads, ws,
                                 s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
