// K2 in f32: SAM encoder self-attention over the windowed layers, with
// decomposed relative-position bias, read straight from the fused qkv
// projection.
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
// One kernel, f32 (the serving and f32 fine-tune paths), on the tensor
// cores in split TF32 (attention_tf32.cuh), every sum in f32. The other
// instances of this function are the wgmma kernels: the f32 K1 (the
// global layers) is attention_relpos_wgmma_tf32.cu's kernel, the bf16 K1
// and K2 attention_relpos_wgmma.cu's (K2 at the JAX route's rounding point:
// ops/attention.py attention_fwd_cuda, normalised_rounding); each computes
// the same function at head dim 64. Given a non-null `lse` (B, heads, N)
// f32, K2 also writes the row's logsumexp m + log(l) in the scaled-score
// domain (the TPU kernel's return_lse), which the backward K5
// (attention_bwd.cu) reads; with a null pointer nothing more is written.
//
// K2 replaces dilabhelmholtzoct_tpu/ops/attention.py flash_attention_packed,
//    _windowed_group_kernel branch (the 8 windowed layers, 25 windows of
//    14x14 = 196 tokens per image), with a one-pass softmax over all keys
//    of a window. One block per (window, head) loads the window's k and v
//    once, and its warps take the 13 m16 query tiles in turn, each staging
//    its tile's q rows: q.k^T, then the bias as a second product (the
//    query rows' factors times a one-hot over the keys, which also masks
//    the keys past N) onto the same 26 n8 score tiles in registers; the
//    row max and sum over the lane quad; every product on mma.sync.
//    attn_windowed_tf32_kernel: 8 warps (attention_tf32.cuh
//    window_tiles_tf32), k and v in f32 in shared memory, each tile's
//    factors staged beside its q rows; split TF32 (hi.hi + hi.lo + lo.hi,
//    two products for the bias, whose one-hot is exact); p in f32, o / l
//    last.
//
// Bound on an H100 SXM (700 W), one layer at B = 1 (ViT-B): 2.95 GFLOP ->
// 0.018 ms in f32 over the split-TF32 rate (495 / 3 = 165 TFLOP/s; 0.044
// ms over the CUDA cores' 67), against 67 MB -> 0.020 ms (bound by bytes).
// What this design does about it: the kernel keeps the operands of its
// inner loops in shared memory and registers, reads each qkv byte from
// device memory once per window, and runs its products on the tensor
// cores. What stays on the CUDA cores per score is the bias, the
// exponential and the max / sum, and the split of each operand as its
// fragment is loaded (each value once per warp). The 8 warps, one block
// per SM, stage their tiles in turn.
//
// Not carried over from the TPU kernel (Mosaic-only workarounds): head-pair
// packing into 128 lanes, one-hot selector matmuls that expand the bias,
// grouping 5 windows per program, pre-transposed k.

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

using namespace attn;

// ------------------------------------------------------------ K2 f32 ----
// grid (1, heads, windows), 32 win_warps(EXACT) threads: one block per
// (window, head) loads the window's k and v in f32 (NK = N rounded up to 16
// rows, zero past N) and builds the one-hot E of the bias product, and its
// warps take the NK / 16 m16 query tiles in turn, each staging its tile's
// q rows and bias factors (attention_tf32.cuh window_tiles_tf32 /
// window_tile_tf32), every product in split TF32. Shared (f32):
//   Ks | Vs NK x LDF | E (uint2) | Qw warps x 16 x LDF | Fw warps x 16 x
//   (FK + 4)
// NJ bounds NK / 16 at compile time: the EXACT instance takes NK = 208 (the
// SAM windows of 14 x 14: 13 tiles, no guarded product), the other any NK
// up to KMAX.
template <int NJ, bool EXACT>
__global__ void __launch_bounds__(32 * tf32::win_warps(EXACT), 1)
attn_windowed_tf32_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ rel_h,
                          const float* __restrict__ rel_w,
                          float* __restrict__ out, float* __restrict__ lse,
                          int n, int heads, int H, int W) {
  using namespace tf32;
  constexpr int WARPS_ = win_warps(EXACT), NTH = 32 * WARPS_;
  extern __shared__ __align__(16) float smem[];
  const int nj = (n + 15) / 16, nk = 16 * nj, fld = 8 * win_fk8(H, W) + 4;
  float* Ks = smem;
  float* Vs = Ks + nk * LDF;
  uint2* E = reinterpret_cast<uint2*>(Vs + nk * LDF);
  float* Qw = reinterpret_cast<float*>(E + win_fk8(H, W) * 2 * nj * 32);
  float* Fw = Qw + WARPS_ * 16 * LDF;

  const int head = blockIdx.y, b = blockIdx.z;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
  const float* base = qkv + (size_t)b * n * stride + head * D;
  const size_t rel_row = ((size_t)b * heads + head) * n;
  const float* fh = rel_h + rel_row * H;
  const float* fw = rel_w + rel_row * W;

  load_tile<NTH>(Ks, base + C, stride, 0, n, nk);
  load_tile<NTH>(Vs, base + 2 * C, stride, 0, n, nk);
  mma::cp_commit();

  // the warp's 16 q rows, and their factor columns [rel_h | rel_w] (zero
  // past n) by 4-byte copies
  auto stage = [&](float* qt, float* ft, int row0) {
    for (int i = lane; i < 16 * (D / 4); i += 32) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = row0 + r < n;
      mma::cp_async16(qt + r * LDF + c,
                      base + (ok ? (size_t)(row0 + r) * stride + c : 0), ok);
    }
    for (int i = lane; i < 16 * (H + W); i += 32) {
      const int r = i / (H + W), f = i - r * (H + W), q = row0 + r;
      const bool ok = q < n;
      mma::cp_async4(ft + r * fld + f,
                     ok ? (f < H ? fh + q * H + f : fw + q * W + f - H) : fh,
                     ok);
    }
  };
  auto store = [&](int row0, float (*o)[4], const float* m, const float* l) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + g + 8 * r;
      if (q >= n) continue;
      if (lse != nullptr && t == 0) lse[rel_row + q] = m[r] + logf(l[r]);
      float* dst = out + ((size_t)b * n + q) * C + head * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(dst + 8 * dn) =
            make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    }
  };
  window_tiles_tf32<NJ, EXACT, NTH>(Qw, Fw, Ks, Vs, E, n, nj, H, W, stage,
                                    store);
}

int launch_windowed_f32(const void* qkv, const void* rel_h,
                        const void* rel_w, void* out, float* lse, int batch,
                        int n, int heads, int h, int w, cudaStream_t stream) {
  if (n > KMAX) return (int)cudaErrorInvalidValue;
  const bool exact = (n + 15) / 16 == 13;
  const size_t smem = tf32::window_smem(n, h, w, tf32::win_warps(exact));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = exact ? attn_windowed_tf32_kernel<13, true>
                      : attn_windowed_tf32_kernel<KMAX / 16, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(1, heads, batch), 32 * tf32::win_warps(exact), smem,
           stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out), lse, n,
      heads, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16; lse: null, or
// (B, heads, N) f32 to receive the row logsumexps. Returns the cudaError_t
// of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// f32 only: the bf16 K2 is attention_relpos_wgmma.cu's kernel too, at the
// JAX route's rounding point
int dhoct_attn_windowed(const void* qkv, const void* rel_h, const void* rel_w,
                        void* out, void* lse, int batch, int n, int heads,
                        int h, int w, int dtype, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_windowed_f32(qkv, rel_h, rel_w, out, static_cast<float*>(lse),
                             batch, n, heads, h, w,
                             static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
