// Split-TF32 primitives of the f32 kernels on the tensor cores, independent
// of any tile shape: the encoder attention (attention_tf32.cuh) and the
// decoder kernels K3 / K4 (decoder_tf32.cuh).
//
// f32 has no tensor-core type of its own, and TF32 keeps 10 mantissa bits
// (about three digits). Each f32 operand x is split as hi = tf32(x) and
// lo = x - hi (exact in f32; the tensor cores read the top 19 bits of a
// .tf32 register), and a product a.b is taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with f32
// accumulators. What that drops (lo_a.lo_b, and the low bits of lo) is about
// 2^-21 of each product; tests/test_torch_split_tf32.py emulates it on the
// CPU.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32), lane
// = 4 g + t:
//   A 16 x 8: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
//             a3 (g + 8, t + 4)
//   B  8 x 8: b0 (row t, col g), b1 (t + 4, g)
//   C 16 x 8: c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, same)
// An accumulator tile is an A fragment once the 8 k indices of the next
// product are permuted (logical t <-> 2t, t + 4 <-> 2t + 1): a = {c0, c2,
// c1, c3} (acc_a); its B fragment then takes rows 2t and 2t + 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stf32 {

// x = hi + lo: hi rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x
// (half a TF32 ulp added to the sign-magnitude bits, the 13 low bits
// cleared: to nearest, ties away from zero), lo the exact f32 remainder.
// cvt.rna itself compiles to four instructions on sm_90 (an add, a test
// for inf / nan, a select and the mask); this is two.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b on the tensor cores (16 x 8 += 16 x 8 . 8 x 8, TF32 in)
__device__ __forceinline__ void mma1688(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a split A fragment
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_frag(Frag& f, float x0, float x1,
                                           float x2, float x3) {
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
}

// c += a . b in split TF32, b given as the lane's two f32 values (split
// here): the small terms first
__device__ __forceinline__ void mma3(float* c, const Frag& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma1688(c, a.lo, h0, h1);
  mma1688(c, a.hi, l0, l1);
  mma1688(c, a.hi, h0, h1);
}

// The A fragment at rows r0.., columns k0.. of a row-major tile (ld floats
// per row), times `scale` (a power of two: exact), split
__device__ __forceinline__ void load_a(Frag& f, const float* tile, int ld,
                                       int r0, int k0, int lane,
                                       float scale = 1.f) {
  const float* p = tile + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_frag(f, p[0] * scale, p[8 * ld] * scale, p[4] * scale,
             p[8 * ld + 4] * scale);
}

// An accumulator tile as the A fragment of the next product (k permuted)
__device__ __forceinline__ void acc_a(Frag& f, const float* c) {
  split_frag(f, c[0], c[2], c[1], c[3]);
}

// c += a . b in split TF32 with b already split (hi, lo of b0 and of b1):
// one split of a B fragment serves several A fragments
__device__ __forceinline__ void mma3s(float* c, const Frag& a, uint32_t h0,
                                      uint32_t l0, uint32_t h1, uint32_t l1) {
  mma1688(c, a.lo, h0, h1);
  mma1688(c, a.hi, l0, l1);
  mma1688(c, a.hi, h0, h1);
}

}  // namespace stf32
