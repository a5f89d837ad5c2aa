// Split-TF32 building blocks of the f32 encoder attention kernels on the
// tensor cores: the backward K5 (attention_bwd.cu, attn_bwd_dq_tf32_kernel /
// attn_bwd_dkv_tf32_kernel), the flash body shared by K1 (attention.cu,
// attn_global_tf32_kernel) and K6 (attention_relpos.cu,
// attn_relpos_tf32_kernel): flash_tf32, and the windowed body shared by K2
// (attention.cu, attn_windowed_tf32_kernel) and K7 (attention_winimg.cu,
// attn_winimg_tf32_kernel): window_tiles_tf32. The shape-independent
// primitives (split, mma1688, Frag, mma3, load_a, acc_a) are split_tf32.cuh's.
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
// floats per row (the flash body: any head dim, rows of DP + 4). Fragment
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
// [k][n] (b0 row 2t, col g: bank 8t + g, again 32 banks). So p (or ds)
// goes from one product into the next without a trip through shared memory.

#pragma once

#include "attention_mma.cuh"
#include "split_tf32.cuh"

namespace attn {
namespace tf32 {

using mma::TILE;
constexpr int LDF = D + 4;  // padded shared row (floats)
constexpr int TILE_FLOATS = TILE * LDF;
constexpr uint32_t TF32_ONE = 0x3F800000u;  // 1.0f, exact in TF32

// the shape-independent primitives (split_tf32.cuh)
using stf32::acc_a;
using stf32::Frag;
using stf32::load_a;
using stf32::mma1688;
using stf32::mma3;
using stf32::split;
using stf32::split_frag;

// acc[dn][16][64] += P . B: P the NT accumulator tiles p[j] (16 x 8 NT, k
// permuted), B a [8 NT][64] tile stored [k][n] -- p.v, ds.k, p^T.dO, ds^T.q
template <int NT>
__device__ __forceinline__ void product_kn(float (*acc)[4],
                                           const float (*p)[4],
                                           const float* b_tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    Frag a;
    acc_a(a, p[j]);
    const float* b = b_tile + (8 * j + 2 * t) * LDF + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      mma3(acc[dn], a, b[8 * dn], b[LDF + 8 * dn]);
  }
}

// acc0[j] += A0 . B0^T and acc1[j] += A1 . B1^T for the NT n8 tiles j of
// B0 and B1, in one k loop (twice the accumulator chains in flight): A0 and
// A1 the 16 rows r0.. of row-major [row][64] tiles, B0 and B1 [8 NT][64]
// tiles stored [n][k] -- the score products q.k^T with dO.v^T, k.q^T with
// v.dO^T. KU of the 8 k steps are unrolled (it bounds the loads in flight).
template <int NT, int KU = D / 8>
__device__ __forceinline__ void product_nk2(float (*acc0)[4],
                                            const float* a0_tile,
                                            const float* b0_tile,
                                            float (*acc1)[4],
                                            const float* a1_tile,
                                            const float* b1_tile, int r0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll (KU)
  for (int kk = 0; kk < D / 8; ++kk) {
    Frag a0, a1;
    load_a(a0, a0_tile, LDF, r0, 8 * kk, lane);
    load_a(a1, a1_tile, LDF, r0, 8 * kk, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = (8 * j + g) * LDF + 8 * kk + t;
      mma3(acc0[j], a0, b0_tile[o], b0_tile[o + 4]);
      mma3(acc1[j], a1, b1_tile[o], b1_tile[o + 4]);
    }
  }
}

// Two independent products of product_kn's kind in one loop (acc0 += P0 .
// B0, acc1 += P1 . B1)
template <int NT>
__device__ __forceinline__ void product_kn2(float (*acc0)[4],
                                            const float (*p0)[4],
                                            const float* b0_tile,
                                            float (*acc1)[4],
                                            const float (*p1)[4],
                                            const float* b1_tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    Frag a0, a1;
    acc_a(a0, p0[j]);
    acc_a(a1, p1[j]);
    const int o = (8 * j + 2 * t) * LDF + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      mma3(acc0[dn], a0, b0_tile[o + 8 * dn], b0_tile[o + LDF + 8 * dn]);
      mma3(acc1[dn], a1, b1_tile[o + 8 * dn], b1_tile[o + LDF + 8 * dn]);
    }
  }
}

// rows [row0, row0 + rows) x DP columns of a row-major f32 matrix (`stride`
// floats per row; d <= DP of them real, d a multiple of 4) -> shared rows of
// DP + 4 floats, asynchronously, by a block of NTH threads; rows at or past
// n and columns at or past d are zero-filled
template <int NTH, int DP = D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int stride, int row0, int n,
                                          int rows = TILE, int d = DP) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < rows * CH; i += NTH) {
    const int r = i / CH, c = (i - r * CH) * 4;
    const bool ok = row0 + r < n && c < d;
    mma::cp_async16(dst + r * (DP + 4) + c,
                    src + (size_t)(ok ? row0 + r : 0) * stride + c, ok);
  }
}

// Shared row length of bias factors (`len` floats per query): a multiple of
// 8 is padded by 4 floats (64 -> 68: eight rows on eight bank groups), any
// other length left as it is
__host__ __device__ __forceinline__ int factor_ld(int len) {
  return len % 8 ? len : len + 4;
}

// `rows` rows of `len` factors, the first `nrows` from src (row-major) and
// the rest zero -> shared rows of factor_ld(len), asynchronously, by a
// block of NTH threads: in 16-byte pieces where the rows allow it (every
// ViT global layer), else in 4-byte ones
template <int NTH>
__device__ __forceinline__ void load_factors(float* dst, const float* src,
                                             int len, int nrows, int rows) {
  const int ld = factor_ld(len);
  if (len % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = len / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += NTH) {
      const int r = i / chunks, c = (i - r * chunks) * 4;
      const bool ok = r < nrows;
      mma::cp_async16(dst + r * ld + c, src + (ok ? r * len + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * len; i += NTH) {
      const int r = i / len, c = i - r * len;
      const bool ok = r < nrows;
      mma::cp_async4(dst + r * ld + c, src + (ok ? i : 0), ok);
    }
  }
}

// --------------------------------------------------- the flash body ----
// The f32 body of the streaming forwards K1 (attention.cu,
// attn_global_tf32_kernel) and K6 (attention_relpos.cu,
// attn_relpos_tf32_kernel). In f32 the two compute one function: K6's
// rounding of the un-normalised p to the input type is the identity, and
// its d^-1/2 on the f32 score equals K1's 1/8 on q at d = 64 (a power of
// two scales every term exactly: 1/8 on q or on the accumulator gives the
// same bits), so both take s = scale * (q . k) + bias with the scale on the
// accumulator.
//
// A block of WARPS warps owns ROWS = 16 WARPS query rows of one (batch,
// head), warp w the m16 tile from row 16 w, and streams 64-key tiles
// through a 2-stage cp.async ring with an online softmax, every product in
// split TF32:
//   s = q . k^T   A = q (split per k step, for all 8 n tiles), B = the key
//                 rows stored [n][k]
//   s = fma(s, scale, rel_h[q, k / W] + rel_w[q, k % W]), -inf past N
//   row max and sum over the lane quad; p = exp(s - m) in f32, never rounded
//   o = o * alpha + p . v   A = the score accumulators (acc_a, k permuted),
//                           B = the value rows stored [k][n]
//   o / l once at the end, and with `lse` the row's m + log l.
// Head dims: DP = d rounded up to 8 columns, the ones past d zero (nothing
// added to q . k; never stored), rows of LD = DP + 4 floats. DP + 4 = 8a + 4
// puts the rows g of a fragment load on banks 4 g (2a + 1) + t: 32 banks for
// every DP, as for 68 (the note at the top), and the p.v B rows 2t, 2t + 1
// on banks 8t + g (a even) or 24t + g (a odd): 32 banks again.
// The bias: ROW_TILE (W = 64, every ViT global layer: a 64-key tile is one
// grid row, no key past N) one Rh value per row and tile plus Rw over the
// tile's columns; otherwise a KeyWalk lookup per slot, keys past N masked.
// Both factor tiles sit in shared memory in f32 (factor_ld rows).
// Every warp splits the B fragments it loads, each value once per warp: a
// K / V tile split once per block into hi / lo planes (4 planes x 2 stages
// fit at DP = 64; at DP = 80 with the factors only with a single lo stage)
// doubles the shared-memory bytes per product and adds a pass and a
// barrier per tile, and was slower on the H100 at every shape tried (K1 at
// B = 1 and 4, K6's ViT-H global and windowed layers). Two m16 tiles per
// warp (each B fragment serving both) were no faster at B = 1 and fill the
// register file (spills at DP = 80).
template <int DP_, int WARPS_>
struct Flash {
  static constexpr int DP = DP_, WARPS = WARPS_;
  static constexpr int LD = DP + 4, NTH = 32 * WARPS, ROWS = 16 * WARPS;
  static constexpr int KV = TILE * LD;  // one K or V tile (floats)
  // Q | K stage 0, 1 | V stage 0, 1
  static constexpr int FLOATS = ROWS * LD + 4 * KV;
  // bytes of shared memory with the bias factor tiles of an H x W grid
  static size_t smem(int H, int W) {
    return sizeof(float) *
           ((size_t)FLOATS + (size_t)ROWS * (factor_ld(H) + factor_ld(W)));
  }
};

// The block's work (see above). q: the (batch, head)'s q columns (row 0;
// k at q + C, v at q + 2C, 3C floats per row); fh, fw: its bias factor rows
// (query 0); out: its output columns (row 0, C floats per row); lse: its N
// logsumexp rows, or null. Every thread of the block must call it.
template <class F, bool ROW_TILE>
__device__ __forceinline__ void flash_tf32(float* smem, const float* q, int C,
                                           const float* fh, const float* fw,
                                           float* out, float* lse, int n,
                                           int d, int H, int W, float scale) {
  constexpr int DP = F::DP, NTH = F::NTH, ROWS = F::ROWS, LD = F::LD,
                KV = F::KV;
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  float* Qs = smem;
  float* Ks = Qs + ROWS * LD;  // stages 0, 1
  float* Vs = Ks + 2 * KV;
  float* Rh = smem + F::FLOATS;
  float* Rw = Rh + ROWS * ldh;

  const int stride = 3 * C, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int nq = min(ROWS, n - q0);

  load_tile<NTH, DP>(Qs, q, stride, q0, n, ROWS, d);
  load_factors<NTH>(Rh, fh + (size_t)q0 * H, H, nq, ROWS);
  load_factors<NTH>(Rw, fw + (size_t)q0 * W, W, nq, ROWS);
  load_tile<NTH, DP>(Ks, q + C, stride, 0, n, TILE, d);
  load_tile<NTH, DP>(Vs, q + 2 * C, stride, 0, n, TILE, d);
  mma::cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    const float* Kc = Ks + (it & 1) * KV;
    const float* Vc = Vs + (it & 1) * KV;
    if (it + 1 < ntiles) {  // the stage consumed in the previous iteration
      load_tile<NTH, DP>(Ks + ((it + 1) & 1) * KV, q + C, stride, k0 + TILE,
                         n, TILE, d);
      load_tile<NTH, DP>(Vs + ((it + 1) & 1) * KV, q + 2 * C, stride,
                         k0 + TILE, n, TILE, d);
    }
    mma::cp_commit();
    mma::cp_wait<1>();  // this tile (and q, the factors) have landed
    __syncthreads();

    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      Frag a;
      load_a(a, Qs, LD, r0, 8 * kk, lane);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float* b = Kc + (8 * j + g) * LD + 8 * kk + t;
        mma3(s[j], a, b[0], b[4]);
      }
    }

    if (ROW_TILE) {  // no key past n: n = 64 H
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = r0 + g + 8 * r;
        const float rh = Rh[qr * ldh + it];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const float2 rw =
              *reinterpret_cast<const float2*>(Rw + qr * ldw + 8 * j + 2 * t);
          s[j][2 * r] = fmaf(s[j][2 * r], scale, rh + rw.x);
          s[j][2 * r + 1] = fmaf(s[j][2 * r + 1], scale, rh + rw.y);
        }
      }
    } else {
      mma::KeyWalk key(k0 + 2 * t, W);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool kv = k0 + 8 * j + 2 * t + e < n;
          const int kr = min(key.r, H - 1);  // in bounds past n, discarded
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qr = r0 + g + 8 * r;
            const float bias = Rh[qr * ldh + kr] + Rw[qr * ldw + key.c];
            float& x = s[j][2 * r + e];
            x = kv ? fmaf(x, scale, bias) : -INFINITY;
          }
          key.step(e);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      // key 0 of the first tile is real: m_new is finite from there on
      const float m_new = fmaxf(m[r], mma::quad_max(mx));
      const float alpha = mma::exp2_approx((m[r] - m_new) * mma::LOG2E);
      const float mb = m_new * mma::LOG2E;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = mma::exp2_approx(fmaf(x, mma::LOG2E, -mb));
          rs += x;
        }
      l[r] = l[r] * alpha + rs;  // the lane's share; quad sum last
      m[r] = m_new;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        o[dn][2 * r] *= alpha;
        o[dn][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      Frag a;
      acc_a(a, s[j]);
      const float* b = Vc + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn)
        mma3(o[dn], a, b[8 * dn], b[LD + 8 * dn]);
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = mma::quad_sum(l[r]);
    const int qg = q0 + r0 + g + 8 * r;
    if (qg >= n) continue;
    if (lse != nullptr && t == 0) lse[qg] = m[r] + logf(lr);
    float* dst = out + (size_t)qg * C + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
      if (8 * dn + 2 * t < d)  // d % 4 == 0: both columns or neither
        *reinterpret_cast<float2*>(dst + 8 * dn) =
            make_float2(o[dn][2 * r] / lr, o[dn][2 * r + 1] / lr);
  }
}

// ------------------------------------------------ the windowed body ----
// The f32 body of the windowed kernels K2 and K7: a block per (window,
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
