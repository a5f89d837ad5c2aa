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
// attn_winimg_kernel replaces dilabhelmholtzoct_tpu/ops/attention.py
// flash_attention_windowed_image (_windowed_image_kernel). One block of 256
// threads per (window, head, 64-query tile) first writes the window's token
// table (each token's image position, or that it is a pad token), then
// gathers the window's q tile and all its keys and values by it from the
// image (or from the bias row) into shared memory, and from there on runs
// K2's code (attention_common.cuh window_attend), so a real token's output
// is bit-equal to K2's on the partitioned windows. Only real positions are
// written.
//
// Bound on an H100 SXM (700 W): K2's — the same products on the same bytes
// (ViT-B, B = 1, f32: 2.95 GFLOP over 67 TFLOP/s = 0.044 ms; compute-bound).
// What the kernel saves lies outside it: the pad, the two 6-D transposes and
// the slice of the partitioned route.
//
// Not carried over from the TPU kernel (Mosaic-only needs): the 16-column
// slots of the spread layout with their gathers in and out, the phantom
// column mask, head-pair packing, the one-hot selector matmuls.

#include "attention_common.cuh"

namespace {

using namespace attn;

static_assert(THREADS == KMAX, "one thread writes one token-table entry");
constexpr int PAD = -1;   // a pad token: its q, k and v are the bias row
constexpr int NONE = -2;  // past the window's ws^2 tokens: a zero row

// window tokens [row0, row0 + nrows) x 64 columns -> shared dst (leading dim
// ld), times `scale`: from the image row `img + tok[t] * stride` for a real
// token, from `pad` for a pad token, zero past the window's tokens.
template <typename T>
__device__ void load_rows_img(float* dst, int ld, const T* img, const T* pad,
                              int stride, const int* tok, int row0, int nrows,
                              float scale) {
  for (int i = threadIdx.x; i < nrows * (D / 4); i += THREADS) {
    const int t = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const int o = tok[row0 + t];
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (o != NONE) load4(o == PAD ? pad + c4 : img + (size_t)o * stride + c4, v);
    *reinterpret_cast<float4*>(dst + t * ld + c4) =
        make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale);
  }
}

// grid (ceil(ws^2 / 64), heads, B * windows), 256 threads, ws^2 <= KMAX.
// Shared memory as K2's with H = W = ws, then Tok: for each of the KMAX
// token slots of the window its image position r W + c, PAD or NONE (one
// division per token, not per load).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
attn_winimg_kernel(const T* __restrict__ qkv, const T* __restrict__ rel,
                   const T* __restrict__ bias, T* __restrict__ out, int heads,
                   int H, int W, int ws, int nwx, int nwin, float scale,
                   int qk_floats) {
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
  const T* img = qkv + (size_t)b * H * W * stride + head * D;
  const T* pad = bias + head * D;

  {
    const int t = threadIdx.x, wr = t / ws;  // THREADS == KMAX: one each
    const int r = (wi / nwx) * ws + wr, c = (wi % nwx) * ws + (t - wr * ws);
    Tok[t] = t >= n ? NONE : (r < H && c < W) ? r * W + c : PAD;
  }
  __syncthreads();

  load_rows_img(Qs, LD, img, pad, stride, Tok, q0, TQ, scale);
  load_rows_img(Ks, LD, img + C, pad + C, stride, Tok, 0, nk, 1.f);
  load_rows_img(Vs, D, img + 2 * C, pad + 2 * C, stride, Tok, 0, nk, 1.f);
  // the query rows' bias factors; zero for pad queries (never written out)
  const T* rel_img = rel + ((size_t)b * heads + head) * H * W * 2 * ws;
  for (int i = threadIdx.x; i < TQ * 2 * ws; i += THREADS) {
    const int t = i / (2 * ws), k = i - t * 2 * ws;
    const int o = Tok[q0 + t];
    const float x = o >= 0 ? to_f32(rel_img[(size_t)o * 2 * ws + k]) : 0.f;
    (k < ws ? Rh + t * ws + k : Rw + t * ws + (k - ws))[0] = x;
  }
  __syncthreads();

  float m[4], l[4], acc[4][4];
  window_attend<T>(Qs, Ks, Ps, Vs, Rh, Rw, n, ws, ws, ty, tx, m, l, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = Tok[q0 + ty + 16 * i];
    if (o < 0) continue;  // only real positions are written
    store_normalised(out + ((size_t)b * H * W + o) * C + head * D + 4 * tx,
                     acc[i], window_den<T>(l[i]));
  }
}

template <typename T>
int launch(const void* qkv, const void* rel, const void* bias, void* out,
           int batch, int h, int w, int heads, int ws, cudaStream_t stream) {
  const int n = ws * ws;
  if (ws < 1 || n > KMAX) return (int)cudaErrorInvalidValue;
  const int nk = (n + 15) / 16 * 16;
  int qk_floats = TQ * LD + nk * LD;
  if (TQ * (nk + 4) > qk_floats) qk_floats = TQ * (nk + 4);
  const size_t smem = sizeof(float) * (size_t)(qk_floats + nk * D + TQ * 2 * ws) +
                      sizeof(int) * KMAX;
  cudaError_t e = cudaFuncSetAttribute(
      attn_winimg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nwy = (h + ws - 1) / ws, nwx = (w + ws - 1) / ws;
  const dim3 grid((n + TQ - 1) / TQ, heads, batch * nwy * nwx);
  attn_winimg_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(rel),
      static_cast<const T*>(bias), static_cast<T*>(out), heads, h, w, ws, nwx,
      nwy * nwx, 0.125f, qk_floats);
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
  return dtype == 1 ? launch<__nv_bfloat16>(qkv, rel, bias, out, batch, h, w,
                                            heads, ws, s)
                    : launch<float>(qkv, rel, bias, out, batch, h, w, heads,
                                    ws, s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
