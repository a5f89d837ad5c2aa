// Split-TF32 building blocks of the f32 encoder attention kernels on
// mma.sync: K7's windowed body (attention_winimg.cu,
// attn_winimg_tf32_kernel), window_tiles_tf32, and its tile copy. The
// shape-independent primitives (split, mma1688, Frag, mma3, load_a, acc_a)
// are split_tf32.cuh's. (The f32 K1, K2 and K6 are on wgmma:
// attention_relpos_wgmma_tf32.cu; the f32 K5 too:
// attention_bwd_wgmma_tf32.cu.)
//
// f32 has no tensor-core type of its own, and TF32 keeps 10 mantissa bits
// (about three digits). Each f32 operand x is split as hi = tf32(x)
// (rounded as cvt.rna rounds: to nearest, ties away from zero) and lo = x -
// hi (exact in f32; the tensor cores read the top 19 bits of a .tf32
// register), and a
// product a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with f32
// accumulators. What that drops (lo_a.lo_b, and the low bits of lo) is
// about 2^-21 of each product, so the sums keep f32's accuracy to a few
// ulps; tests/test_torch_split_tf32.py emulates this arithmetic on the CPU.
//
// Tiles hold f32 rows of 64 values (one head) in shared memory, LDF = 68
// floats per row. Fragment
// layout (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32), lane =
// 4 g + t:
//   A 16 x 8: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
//             a3 (g + 8, t + 4)
//   B  8 x 8: b0 (row t, col g), b1 (t + 4, g)
//   C 16 x 8: c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8, same)
// A row-major tile read as A (row g, col t) or as B stored [n][k] (row g,
// col t) at LDF = 68 (4 mod 32 words) puts the 32 lanes on 32 banks.
// An accumulator tile is an A fragment once the 8 k indices of the next
// product are permuted (logical t <-> 2t, t + 4 <-> 2t + 1): a = {c0, c2,
// c1, c3}; its B fragment then takes rows 2t and 2t + 1 of a tile stored
// [k][n] (b0 row 2t, col g: bank 8t + g, again 32 banks). So p goes from
// one product into the next without a trip through shared memory.

#pragma once

#include "attention_mma.cuh"
#include "split_tf32.cuh"

namespace attn {
namespace tf32 {

using mma::TILE;
constexpr int LDF = D + 4;  // padded shared row (floats)
constexpr uint32_t TF32_ONE = 0x3F800000u;  // 1.0f, exact in TF32

// the shape-independent primitives (split_tf32.cuh)
using stf32::acc_a;
using stf32::Frag;
using stf32::load_a;
using stf32::mma1688;
using stf32::mma3;
using stf32::split;
using stf32::split_frag;

// rows [row0, row0 + rows) x 64 columns of a row-major f32 matrix
// (`stride` floats per row) -> shared rows of LDF floats, asynchronously,
// by a block of NTH threads; rows at or past n are zero-filled
template <int NTH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int stride, int row0, int n,
                                          int rows = TILE) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const bool ok = row0 + r < n;
    mma::cp_async16(dst + r * LDF + c,
                    src + (size_t)(ok ? row0 + r : 0) * stride + c, ok);
  }
}

// ------------------------------------------------ the windowed body ----
// The f32 body of the windowed kernel K7: a block per (window,
// head) holds the window's keys and values in f32 (NK = N rounded up to 16
// rows, zero past N), and its warps take the NK / 16 m16 query tiles in
// turn, each staging its tile's q rows and their bias factors. As in the
// bf16 body (attention_mma.cuh), the bias s += rel_h[q, k / W] + rel_w[q,
// k % W] is a second product on the tensor cores, s += F . E^T:
//   F  16 x FK per tile: the rows' [rel_h (H) | rel_w (W) | 0 .. |
//      WIN_MASK], FK = 8 ceil((H + W + 1) / 8), rows of FK + 4 floats
//   E  FK x NK one-hot: key k < N has ones at rows k / W and H + k % W; a
//      key at or past N one at the last row (its score becomes WIN_MASK,
//      its exp 0) -- stored as the B fragments themselves
// The ones and WIN_MASK are exact in TF32, so only F is split: two
// products, F_lo . E + F_hi . E.
using mma::WIN_MASK;

// k8 steps of the bias product
__host__ __device__ __forceinline__ int win_fk8(int H, int W) {
  return (H + W + 8) / 8;
}

// warps per block: the EXACT instance (the SAM 14 x 14 window) 8, the
// guarded one 4 (its tiles, up to 256 keys, fill the shared memory)
__host__ __device__ constexpr int win_warps(bool exact) {
  return exact ? 8 : 4;
}

// E as B fragments, by a block of NTH threads: entry ((kk nt + j) 32 +
// lane) holds the lane's b0, b1 of n8 tile j (keys 8 j..) at k8 step kk
// (rows 8 kk + t, 8 kk + t + 4; column g: key 8 j + g)
template <int NTH>
__device__ __forceinline__ void build_onehot(uint2* E, int n, int nt, int H,
                                             int W) {
  const int fk8 = win_fk8(H, W), last = 8 * fk8 - 1;
  for (int i = threadIdx.x; i < fk8 * nt * 32; i += NTH) {
    const int lane = i & 31, j = (i >> 5) % nt, kk = (i >> 5) / nt;
    const int key = 8 * j + (lane >> 2);
    const int kr = key / W, kc = key - kr * W;
    uint32_t v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = 8 * kk + (lane & 3) + 4 * h;
      const bool hot = key < n ? (f == kr || f == H + kc) : f == last;
      v[h] = hot ? TF32_ONE : 0u;
    }
    E[i] = make_uint2(v[0], v[1]);
  }
}

// One m16 query tile (q rows in Qt, 16 x LDF; their factors in Ft, 16 x
// fld) against all keys of its window: the softmax of the TPU
// _windowed_group_kernel. The n8 score tiles of a pass in registers (q.k^T
// / 8, the scale on q, exact; then F . E^T onto the same accumulators), the
// row max and denominator over the lane quad, p in f32 (never rounded),
// p.v, and o / l last. The EXACT instance (nj == NJ = 13, no product
// guarded) takes all 26 score tiles in one pass, the one-pass softmax of
// the TPU kernel; the guarded one (up to NJ = 16) passes of 16 tiles with a
// running maximum (registers for 32 tiles would spill). Leaves the tile's
// normalised output o (rows g, g + 8 of the lane: o[n-tile][0, 1] and [2,
// 3]), row maximum m and denominator l (m + log l is the row's
// logsumexp).
template <int NJ, bool EXACT>
__device__ __forceinline__ void window_tile_tf32(
    const float* Qt, const float* Ft, int fld, const float* Ks,
    const float* Vs, const uint2* E, int fk8, int nj, int lane, float (*o)[4],
    float* m, float* l) {
  constexpr int PT = EXACT || NJ < 8 ? 2 * NJ : 16;  // n8 tiles per pass
  if (EXACT) nj = NJ;
  const int g = lane >> 2, t = lane & 3, nt = 2 * nj;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int j0 = 0; j0 < nt; j0 += PT) {
    float s[PT][4];
#pragma unroll
    for (int jj = 0; jj < PT; ++jj)
      s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      Frag a;
      load_a(a, Qt, LDF, 0, 8 * kk, lane, 0.125f);
#pragma unroll
      for (int jj = 0; jj < PT; ++jj)
        if (EXACT || j0 + jj < nt) {
          const float* b = Ks + (8 * (j0 + jj) + g) * LDF + 8 * kk + t;
          mma3(s[jj], a, b[0], b[4]);
        }
    }
    for (int kk = 0; kk < fk8; ++kk) {
      Frag a;
      load_a(a, Ft, fld, 0, 8 * kk, lane);
#pragma unroll
      for (int jj = 0; jj < PT; ++jj)
        if (EXACT || j0 + jj < nt) {
          const uint2 e = E[(kk * nt + j0 + jj) * 32 + lane];
          mma1688(s[jj], a.lo, e.x, e.y);
          mma1688(s[jj], a.hi, e.x, e.y);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < PT; ++jj)
        if (EXACT || j0 + jj < nt)
          mx = fmaxf(mx, fmaxf(s[jj][2 * r], s[jj][2 * r + 1]));
      // key 0 is real: finite from the first pass on; alpha is 0 there
      const float m_new = fmaxf(m[r], mma::quad_max(mx));
      const float alpha = mma::exp2_approx((m[r] - m_new) * mma::LOG2E);
      const float mb = m_new * mma::LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < PT; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[jj][2 * r + e];
          x = EXACT || j0 + jj < nt
                  ? mma::exp2_approx(fmaf(x, mma::LOG2E, -mb))
                  : 0.f;
          rs += x;
        }
      l[r] = l[r] * alpha + mma::quad_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int jj = 0; jj < PT; ++jj)
      if (EXACT || j0 + jj < nt) {
        Frag a;
        acc_a(a, s[jj]);
        const float* b = Vs + (8 * (j0 + jj) + 2 * t) * LDF + g;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          mma3(o[dn], a, b[8 * dn], b[LDF + 8 * dn]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / l[r];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][2 * r] *= inv;
      o[dn][2 * r + 1] *= inv;
    }
  }
}

// The block's part after its loads of K and V (nk rows each) were issued
// and committed: E, then the warps' query tiles. Warp w stages the q rows
// of its tiles in Qw + w 16 LDF and their factor columns [0, H + W) in Fw +
// w 16 fld, whose other columns (zero, and WIN_MASK in the last) it fills
// once: stage(qt, ft, row0) issues the warp's cp.async copies of rows
// row0 .. row0 + 15; store(row0, o, m, l) writes a finished tile. Every
// thread of the block must call it (it synchronises).
template <int NJ, bool EXACT, int NTH, class Stage, class Store>
__device__ __forceinline__ void window_tiles_tf32(
    float* Qw, float* Fw, const float* Ks, const float* Vs, uint2* E, int n,
    int nj, int H, int W, Stage stage, Store store) {
  constexpr int WARPS_ = NTH / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fk8 = win_fk8(H, W), fk = 8 * fk8, fld = fk + 4;
  float* qt = Qw + warp * 16 * LDF;
  float* ft = Fw + warp * 16 * fld;
  build_onehot<NTH>(E, n, 2 * nj, H, W);
  const int w = fk - H - W;
  for (int i = lane; i < 16 * w; i += 32) {
    const int r = i / w, f = H + W + i - r * w;
    ft[r * fld + f] = f == fk - 1 ? WIN_MASK : 0.f;
  }
  mma::cp_wait<0>();  // K and V have landed
  __syncthreads();
  for (int mt = warp; mt < nj; mt += WARPS_) {
    stage(qt, ft, 16 * mt);
    mma::cp_commit();
    mma::cp_wait<0>();
    __syncwarp();
    float o[D / 8][4], m[2], l[2];
    window_tile_tf32<NJ, EXACT>(qt, ft, fld, Ks, Vs, E, fk8, nj, lane, o, m,
                                l);
    store(16 * mt, o, m, l);
    __syncwarp();  // every lane is done with qt / ft before their refill
  }
}

// Shared memory of the windowed f32 kernels for n keys of an H x W window
// and `warps` warps, Tok excluded: K, V (nk x LDF), E (fk8 x nk / 8 x 32
// uint2), Qw (warps x 16 x LDF), Fw (warps x 16 x (8 fk8 + 4))
__host__ __device__ __forceinline__ size_t window_smem(int n, int H, int W,
                                                      int warps) {
  const int nk = (n + 15) / 16 * 16, fk8 = win_fk8(H, W);
  return sizeof(float) * ((size_t)2 * nk * LDF +
                          (size_t)warps * 16 * (LDF + 8 * fk8 + 4)) +
         sizeof(uint2) * (size_t)fk8 * (nk / 8) * 32;
}

}  // namespace tf32
}  // namespace attn
