// Split-TF32 building blocks of the f32 decoder kernels on the tensor cores:
// the image->token attention K4 (decoder_attn.cu, i2t_fwd_tf32_kernel,
// i2t_bwd_rows_tf32_kernel) and the upscaler K3
// (upscaler.cu, upscale_fwd_tf32_kernel, upscale_bwd_rows_tf32_kernel).
//
// Every product is hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 TF32 with f32
// accumulators (split_tf32.cuh). In f32 a layer's weights take 256 KB (K4's
// Wq and Wo, K3's W1 alone), over the 227 KB a block may hold, so the row
// kernels stream them: a block of 8 warps walks super-tiles of 64 rows (four
// 16-row slots, a warp pair each, as the bf16 kernels pair their warps), and
// every product of a super-tile reads its weight [K][N] once from L2 through
// a cp.async ring of STAGES stages of KS rows (stream_product), the 8 warps
// in lockstep. Each weight byte fetched then serves 64 rows (K4's forward
// reads 4 KB of weights from L2 per 1 KB row of keys), and the row tiles
// stay in shared memory as f32 rows of width + 4 floats (4 mod 32 words: an
// A fragment, row g col t, hits bank 4g + t). Stages hold rows of N + 8
// floats (8 mod 32: a B fragment, row t col g, hits bank 8t + g).
//
// The f32 weight passes of both run on TF32 wgmma with TMA loads
// (decoder_attn.cu, i2t_bwd_dw_tf32_kernel; upscaler.cu,
// upscale_bwd_dw_tf32_kernel).

#pragma once

#include "decoder_mma.cuh"
#include "split_tf32.cuh"

namespace dec32 {

using attn::mma::cp_async16;
using attn::mma::cp_commit;
using attn::mma::cp_wait;
using stf32::Frag;
using stf32::mma3;
using stf32::mma3s;
using stf32::split;
using stf32::split_frag;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SLOTS = WARPS / 2;  // 16-row tiles of a super-tile
constexpr int ROWS = 16 * SLOTS;  // rows of a super-tile
constexpr int STAGES = 3;         // weight stages in flight

// the super-tile's first `valid` rows of a row-major [.][W] f32 matrix ->
// shared rows of LD floats, by the whole block, asynchronously; the other
// rows zero-filled (src is the super-tile's first row, always a real one)
template <int W, int LD>
__device__ __forceinline__ void rows_async(float* dst, const float* src,
                                           int valid) {
  constexpr int CH = W / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? (size_t)r * W + c : 0), ok);
  }
}

// acc[j] (n-tile j: columns n0 + 8 j, j < NT) += A . W for the warp's 16
// rows, W [K][N] row-major in device memory streamed through `ring`
// (STAGES stages of KS rows of N + 8 floats), afrag(Frag&, k0) the split A
// fragment of columns k0.. of the warp's rows. Every thread of the block
// calls it; it ends with a barrier, after which the ring and the A tiles
// are free. Groups of cp.async copies committed before it have landed by
// its first product.
template <int K, int N, int KS, int NT, class AFrag>
__device__ __forceinline__ void stream_product(float (*acc)[4],
                                               const float* w, float* ring,
                                               int n0, AFrag afrag,
                                               int lane) {
  constexpr int LDW = N + 8, STAGE = KS * LDW, NST = K / KS, CH = N / 4;
  static_assert(K % KS == 0 && KS % 8 == 0 && NST >= STAGES - 1,
                "stream_product stages");
  const int g = lane >> 2, t = lane & 3;
  auto load = [&](int s) {
    float* dst = ring + (s % STAGES) * STAGE;
    const float* src = w + (size_t)s * KS * N;
    for (int i = threadIdx.x; i < KS * CH; i += THREADS) {
      const int r = i / CH, c = (i - r * CH) * 4;
      cp_async16(dst + r * LDW + c, src + r * N + c, true);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_commit();
  }
#pragma unroll 1
  for (int s = 0; s < NST; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free again
    if (s + STAGES - 1 < NST) load(s + STAGES - 1);
    cp_commit();
    const float* ws = ring + (s % STAGES) * STAGE + t * LDW + n0 + g;
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      Frag a;
      afrag(a, s * KS + 8 * kk);
      const float* b = ws + 8 * kk * LDW;
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc[j], a, b[8 * j], b[4 * LDW + 8 * j]);
    }
  }
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

}  // namespace dec32
