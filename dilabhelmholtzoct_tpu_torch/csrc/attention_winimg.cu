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
// (window, head) first writes the window's token table (each token's image
// position, or that it is a pad token), then gathers the window's queries
// and all its keys and values by it from the image (or from the bias row)
// into shared memory, and from there on runs a windowed body:
//    f32, attn_winimg_tf32_kernel: 8 warps per (window, head),
//    attention_tf32.cuh window_tiles_tf32 in split TF32 on the tensor
//    cores (a real token's output within the f32 limit of the f32 K2's on
//    the partitioned windows, which runs on wgmma);
//    bf16, attn_winimg_mma_kernel: 4 warps per (window, head),
//    attention_mma.cuh window_tile_mma on mma.sync (the bf16 K2 runs on
//    attention_relpos_wgmma.cu; both round the normalised p on SAM's
//    windows, and agree within two bf16 ulps).
// Only real positions are written.
//
// Bound on an H100 SXM (700 W): K2's -- the same products on the same bytes
// (ViT-B, B = 1: f32 67 MB over 3.35 TB/s = 0.020 ms, bound by bytes, its
// 2.95 GFLOP taking 0.018 ms over the split-TF32 rate and 0.044 ms over
// the CUDA cores; bf16 33.5 MB over 3.35 TB/s = 0.010 ms, bound by bytes).
// What the kernel saves lies outside it: the pad, the two 6-D transposes
// and the slice of the partitioned route.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the 16-column
// slots of the spread layout with their gathers in and out, the phantom
// column mask, head-pair packing, the one-hot selector matmuls.

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

using namespace attn;

constexpr int PAD = -1;   // a pad token: its q, k and v are the bias row
constexpr int NONE = -2;  // past the window's ws^2 tokens: a zero row

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

// ----------------------------------------------------------------- bf16 ----
// grid (1, heads, B * windows), 32 WIN_WARPS threads: a block of
// attention_mma.cuh's windowed body with the rows gathered by the token
// table: shared memory window_smem with H = W = ws, then Tok (NK ints).
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

// ------------------------------------------------------------------ f32 ----
// grid (1, heads, B * windows), 32 win_warps(EXACT) threads: a block per
// (window, head) on window_tiles_tf32 (the f32 K2's body until it moved to
// wgmma) with the rows gathered by the token table: shared memory as
// window_smem's with H = W = ws, then Tok (NK ints).
template <int NJ, bool EXACT>
__global__ void __launch_bounds__(32 * tf32::win_warps(EXACT), 1)
attn_winimg_tf32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ rel,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int heads, int H, int W,
                        int ws, int nwx, int nwin) {
  using namespace tf32;
  constexpr int WARPS_ = win_warps(EXACT), NTH = 32 * WARPS_;
  extern __shared__ __align__(16) float smem[];
  const int n = ws * ws, nj = (n + 15) / 16, nk = 16 * nj;
  const int fld = 8 * win_fk8(ws, ws) + 4;
  float* Ks = smem;
  float* Vs = Ks + nk * LDF;
  uint2* E = reinterpret_cast<uint2*>(Vs + nk * LDF);
  float* Qw = reinterpret_cast<float*>(E + win_fk8(ws, ws) * 2 * nj * 32);
  float* Fw = Qw + WARPS_ * 16 * LDF;
  int* Tok = reinterpret_cast<int*>(Fw + WARPS_ * 16 * fld);

  const int head = blockIdx.y;
  const int b = blockIdx.z / nwin, wi = blockIdx.z - b * nwin;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const float* img = qkv + (size_t)b * H * W * stride + head * D;
  const float* pad = bias + head * D;
  const float* rel_img = rel + ((size_t)b * heads + head) * H * W * 2 * ws;

  token_table(Tok, nk, wi, nwx, ws, H, W, NTH);
  __syncthreads();

  // window token r's row of part p (0 q, 1 k, 2 v) from the image or the
  // bias row; `ok` false past the window's tokens (a zero row)
  auto row = [&](int r, int part, bool& ok) {
    const int o = Tok[r];
    ok = o != NONE;
    return (o == PAD ? pad : img + (size_t)max(o, 0) * stride) + part * C;
  };
  for (int i = threadIdx.x; i < nk * (D / 4); i += NTH) {
    const int r = i >> 4, c = (i & 15) * 4;
    bool ok;
    mma::cp_async16(Ks + r * LDF + c, row(r, 1, ok) + c, ok);
    mma::cp_async16(Vs + r * LDF + c, row(r, 2, ok) + c, ok);
  }
  mma::cp_commit();

  // the warp's 16 q rows, and the query tokens' 2 ws factors (zero for pad
  // queries, never written out, and past the window's tokens) by 4-byte
  // copies, as window_tiles_tf32 stages them
  auto stage = [&](float* qt, float* ft, int row0) {
    for (int i = lane; i < 16 * (D / 4); i += 32) {
      const int r = i >> 4, c = (i & 15) * 4;
      bool ok;
      const float* src = row(row0 + r, 0, ok) + c;
      mma::cp_async16(qt + r * LDF + c, src, ok);
    }
    for (int i = lane; i < 16 * 2 * ws; i += 32) {
      const int r = i / (2 * ws), f = i - r * 2 * ws;
      const int o = Tok[row0 + r];
      mma::cp_async4(ft + r * fld + f,
                     rel_img + (size_t)max(o, 0) * 2 * ws + f, o >= 0);
    }
  };
  auto store = [&](int row0, float (*o)[4], const float*, const float*) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = Tok[row0 + g + 8 * r];
      if (pos < 0) continue;  // only real positions are written
      float* dst = out + ((size_t)b * H * W + pos) * C + head * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + 8 * dn) =
            make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    }
  };
  window_tiles_tf32<NJ, EXACT, NTH>(Qw, Fw, Ks, Vs, E, n, nj, ws, ws, stage,
                                    store);
}

int launch_f32(const void* qkv, const void* rel, const void* bias, void* out,
               int batch, int h, int w, int heads, int ws,
               cudaStream_t stream) {
  const int nk = (ws * ws + 15) / 16 * 16;
  // the 13-tile instance for SAM's 14 x 14 windows, any window up to KMAX
  // the other
  const bool exact = nk == 208;
  const size_t smem =
      tf32::window_smem(ws * ws, ws, ws, tf32::win_warps(exact)) +
      sizeof(int) * nk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = exact ? attn_winimg_tf32_kernel<13, true>
                      : attn_winimg_tf32_kernel<KMAX / 16, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nwy = (h + ws - 1) / ws, nwx = (w + ws - 1) / ws;
  kernel<<<dim3(1, heads, batch * nwy * nwx), 32 * tf32::win_warps(exact),
           smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel),
      static_cast<const float*>(bias), static_cast<float*>(out), heads, h, w,
      ws, nwx, nwy * nwx);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, const void* rel, const void* bias, void* out,
                int batch, int h, int w, int heads, int ws,
                cudaStream_t stream) {
  using namespace mma;
  const int nk = (ws * ws + 15) / 16 * 16;
  const size_t smem = window_smem(ws * ws, ws, ws, WIN_WARPS) + sizeof(int) * nk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // SAM's 14 x 14 window (13 m16 tiles, no guarded product), or any other
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
