// K6 in f32: SAM encoder self-attention with decomposed relative-position
// bias for any head dim, read straight from the fused qkv projection. It is
// the attention of every model whose head dim is not 64 (ViT-H: 16 heads of
// 80; the test-size models: 16 and 32), for the global and the windowed
// layers alike, in f32 (serving, evaluation); the bf16 K6 is
// attention_relpos_wgmma.cu.
//
//   qkv   (B, N, 3C)  feature order (3, heads, d): q of head h at columns
//                     h*d, k at C + h*d, v at 2C + h*d
//   rel_h (B, heads, N, H)   bias factor over key rows
//   rel_w (B, heads, N, W)   bias factor over key columns
//   out   (B, N, C)   token order, ready for the output projection
//
//   s[q, k] = f32(q . k) * d^-1/2 + rel_h[q, k / W] + rel_w[q, k % W]
//   out[q]  = (sum_k exp(s[q, k] - m) v[k]) / sum_k exp(s[q, k] - m)
//
// K6 replaces dilabhelmholtzoct_tpu/ops/attention.py flash_attention_relpos
// (_flash_kernel). Its rounding points are that kernel's, and differ from
// K1 / K2: the scale multiplies the f32 score after the dot (d^-1/2 is no
// power of two at d = 80), and the division by the denominator comes last.
// Every sum is f32. One block per (batch, head, query tile) streams 64-key
// tiles with an online softmax; keys past N in the last tile (N = 196 in
// the windowed layers) are masked to -inf, and rows past N are neither
// stored nor counted. attn_relpos_tf32_kernel<DP, ROW_TILE>, for every d
// that is a multiple of 4 up to 128, is the flash body K1 shares
// (attention_tf32.cuh flash_tf32; d^-1/2 multiplies the f32 accumulator):
// q.k^T and p.v in split TF32 (hi.hi + hi.lo + lo.hi on mma.sync m16n8k8,
// f32 accumulators, each fragment split as it is loaded) from shared rows
// of DP = ceil(d / 8) * 8 columns, zero past d, padded to DP + 4 floats;
// one m16 query tile per warp, 8 warps where ROW_TILE and DP <= 80 (the
// ViT-H global layers: 128 rows share each K / V tile), else 4; K / V tiles
// through a 2-stage cp.async ring in 16-byte pieces; p in f32 fed to p.v
// from registers; o / l last. ROW_TILE (W = 64: every ViT global layer): a
// 64-key tile is one grid row, so a row's bias over the tile is one Rh
// value plus Rw over the tile's columns; otherwise (the windowed layers)
// each slot looks its bias up with KeyWalk and keys past N are selected
// away.
//
// Bound on an H100 SXM (700 W), ViT-H (16 heads of 80), B = 1:
//    global layer, N = 4096: 4 * 4096^2 * 80 * 16 = 85.9 GFLOP over the
//        split-TF32 rate (495 / 3 = 165 TFLOP/s) = 0.52 ms (over the CUDA
//        cores' 67 TFLOP/s f32 peak: 1.28 ms); bytes (qkv 62.9 MB + rel
//        33.6 MB + out 21.0 MB) over 3.35 TB/s = 0.035 ms. Compute-bound.
//    windowed layer, 25 windows of 196: 4.9 GFLOP -> 0.030 ms over the
//        split-TF32 rate (0.073 over the CUDA cores; compute-bound; the
//        64-key tiles over 196 keys compute 256 / 196 = 1.3x of it twice:
//        1.7x).
// What this design does about it: as K1, every operand of the two inner
// products sits in shared memory, each qkv byte is read from device memory
// once per query tile, and both products run on the tensor cores; what
// stays on the CUDA cores per score is the scale and the bias, the
// exponential and the max / sum and the split of each operand as its
// fragment is loaded, and the next K / V tile's copy overlaps the current
// tile's work. TF32 wgmma (the bf16 K6's design) is later work.
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

int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out,
           int batch, int n, int heads, int d, int h, int w,
           cudaStream_t stream) {
  if (d < 4 || d % 4 || d > MAX_D) return (int)cudaErrorInvalidValue;
  switch ((d + 7) / 8) {
#define DHOCT_N8(N8)                                                      \
  case N8:                                                                \
    return launch_tf32<8 * N8>(qkv, rel_h, rel_w, out, batch, n, heads, d, \
                               h, w, stream);
    DHOCT_N8(1) DHOCT_N8(2) DHOCT_N8(3) DHOCT_N8(4)
    DHOCT_N8(5) DHOCT_N8(6) DHOCT_N8(7) DHOCT_N8(8)
    DHOCT_N8(9) DHOCT_N8(10) DHOCT_N8(11) DHOCT_N8(12)
    DHOCT_N8(13) DHOCT_N8(14) DHOCT_N8(15) DHOCT_N8(16)
#undef DHOCT_N8
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (ctypes), float32; d: the head dim, a multiple of 4 up to
// 128. Returns the cudaError_t of the launch (0 = success); the caller
// raises on non-zero.
extern "C" {

int dhoct_attn_relpos(const void* qkv, const void* rel_h, const void* rel_w,
                      void* out, int batch, int n, int heads, int d, int h,
                      int w, void* stream) {
  return launch(qkv, rel_h, rel_w, out, batch, n, heads, d, h, w,
                static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
