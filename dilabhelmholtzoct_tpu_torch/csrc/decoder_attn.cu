// SAM decoder image->token cross-attention + residual + LayerNorm (K4).
//
// Per image row (one (image, prompt) pair p, one grid cell), with C = 256
// channels, I = 128 internal lanes, 8 heads of 16, T <= 8 prompt tokens:
//
//   qin   = rnd(keys[p / pb] + pe)                 (input dtype)
//   qs    = rnd(rnd(qin . Wq + bq) * rnd(1/4))     (product in f32)
//   s[h,t] = qs[h] . k[p, t, h]                    (f32)
//   p     = softmax_t(s)                           (f32, per head)
//   out   = rnd(rnd(p) . v[p, :, h])               (f32 sum)
//   res   = rnd(keys + rnd(out . Wo + bo))
//   y     = rnd(LayerNorm(res) * g + bt)           (f32)
//
// rnd() is the rounding to the input type (identity for float): the JAX
// package's rounding points (ops/decoder_attn.py:86-117).
//
// The forward replaces dilabhelmholtzoct_tpu/ops/decoder_attn.py
//    _fused_fwd (:264, body _fwd_kernel :120-130, math _chain :86-117):
//    persistent 8-warp blocks; a warp pair walks units of image rows and
//    the pb pairs of each image (the q projection once per image tile).
//    * bf16 (the training path): i2t_fwd_mma_kernel on the tensor cores,
//      Wq and Wo in shared memory, units of 16 rows.
//    * f32 (reached with set_fused_i2t('on')): i2t_fwd_tf32_kernel in split
//      TF32 (decoder_tf32.cuh), units of 64 rows whose 4 slots stream Wq and
//      Wo through a shared cp.async ring.
// The backward replaces the same file's _fused_bwd (:287, body _bwd_kernel
//    :133-218) with two launches: a row pass recomputes the chain, runs the
//    LayerNorm and softmax backward per row, writes d_keys and the per-row
//    d_qpre, p, d_score and d_out (the token and positional gradients are
//    einsums over these rows outside the kernel, as in the JAX package),
//    the scratch rows rnd(out) and rnd(d_res), and sums dbq, dbo and the
//    LayerNorm gradients; a weight pass forms dWo = sum_r rnd(out)^T
//    rnd(d_res) and dWq^T = sum_r rnd(d_qpre)^T rnd(keys + pe), split-K over
//    row chunks. The JAX kernel carries dW in one output block across its
//    sequential grid; here blocks run in parallel, so every sum over rows is
//    one partial per slot (or chunk), added up by the wrapper in a fixed
//    order -- no atomics, so the gradients repeat bit for bit.
//    * bf16: i2t_bwd_rows_kernel (Wq and Wo in shared memory, a warp pair
//      per 16-row tile) and i2t_bwd_dw_kernel (decoder_mma.cuh).
//    * f32: i2t_bwd_rows_tf32_kernel (super-tiles of 64 rows streaming Wq,
//      Wo, Wo^T and Wq^T) and i2t_bwd_dw_tf32_kernel, in split TF32; rnd()
//      is the identity, so the scratch rows are f32.
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096
//    rows): forward 135 kFLOP/row = 35.3 GFLOP, over 989 TFLOP/s (bf16) =
//    0.036 ms against ~0.08 ms of bytes (keys in, y out): byte-bound; in
//    f32 over split TF32's 165 TFLOP/s (495 / 3) 0.214 ms against 0.16 ms
//    of bytes: operation-bound. Backward ~400 kFLOP/row = 105 GFLOP (bf16
//    0.106 ms, f32 split 0.64 ms) against bytes (keys, dy in; d_keys, d_qpre,
//    p, d_score, d_out out) ~0.18 ms in bf16, 0.36 in f32; the scratch rows
//    between the two launches add 201 MB written and read in bf16, 403 MB
//    in f32 (chip_smoke.py::k4_bound_ms bounds each launch with them).
// What the kernels do about it: every intermediate of the chain stays in
//    shared memory or registers, so device memory sees only the rows in and
//    out. Every product runs on the tensor cores, chained from accumulator
//    to A fragment where the operand needs no trip through shared memory:
//    q and out projections over the warp's 16 x 64 (or 16 x 128)
//    accumulators; per head the scores (head dim 16 x 8 tokens) and p . v
//    over the 8 tokens; the backward adds d_out = d_res . Wo^T, d_keys =
//    d_qpre . Wq^T + d_res, d_p = d_out . v^T and d_score . k. bf16 runs
//    them as mma.sync bf16 -> f32 (each operand a rounding point of the
//    JAX kernel, so each term is exact); f32 as hi.hi + hi.lo + lo.hi on
//    m16n8k8 TF32, the per-head products too (4 of every 270 kFLOP of a
//    row: splitting them costs less than a second path through FMAs). The
//    softmax over <= 8 tokens, the LayerNorm and their backwards run in f32
//    registers over a lane quad and the warp pair. In f32 the weights
//    (256 KB) do not fit in shared memory beside the rows; streaming them
//    per 64-row super-tile reads each weight byte from L2 once for 64 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_tf32.cuh"

namespace {

constexpr int C = 256;            // channels
constexpr int I = 128;            // internal lanes
constexpr int NH = 8;             // heads
constexpr int HD = I / NH;        // 16
constexpr int TP = 8;             // token capacity

// ------------------------------- bf16 forward and backward, tensor cores ----
using dec::bf16;
using dec::ld_bf2;
using dec::st_bf2;

constexpr int LDQ = I + 8;   // shared row of Wq [C][I]
constexpr int LDO = C + 8;   // shared row of Wo [I][C] and of a warp's tile
constexpr int SLOTS = 4;          // tiles in flight per block: a warp pair each
constexpr int RT = 64 * SLOTS;     // threads per row-pass block
constexpr int LDI = I + 8;         // shared row of a slot's [16][I] tile
constexpr int SLOT_BF16 = 2 * 16 * LDO + 16 * LDI;
constexpr size_t WEIGHTS_BF16 = (size_t)C * LDQ + (size_t)I * LDO;
constexpr size_t ROWS_SMEM =
    sizeof(bf16) * (WEIGHTS_BF16 + SLOTS * SLOT_BF16) +
    sizeof(float) * (size_t)SLOTS * 6 * 2 * 16;
constexpr size_t FWD_MMA_SMEM =
    sizeof(bf16) * (WEIGHTS_BF16 + SLOTS * SLOT_BF16) +
    sizeof(float) * (size_t)SLOTS * 2 * 2 * 16;

// The forward chain's pieces that the forward kernel and the backward's row
// pass share. A warp pair owns a 16-row tile; warp `sub` takes the heads
// 4 sub.. (I lanes i0 = 64 sub..) and the C columns c0 = 128 sub... Lane =
// 4 g + t holds rows g and g + 8 of every accumulator n-tile, columns 2t,
// 2t + 1.

// q projection of the warp's 64 lanes, qin = rnd(keys + pe) formed in the A
// fragments (keys x_s, pe e_s, [16][LDO]); qs = rnd(rnd(qpre + bq) *
// rnd(1/4)) returned as A fragments, one k16 step per head
__device__ __forceinline__ void q_heads(uint32_t (&qf)[4][4], const bf16* x_s,
                                        const bf16* e_s, const bf16* wq_s,
                                        const float* bq, int i0, int lane) {
  using namespace dec;
  const int tq = lane & 3;
  const float scale_in = round_bf16(1.f / sqrtf((float)HD));
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4], e[4];
    load_a<LDO>(a, x_s, 0, 16 * kk, lane);
    load_a<LDO>(e, e_s, 0, 16 * kk, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 kf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&a[j]));
      const float2 pf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&e[j]));
      a[j] = pack_bf16(kf.x + pf.x, kf.y + pf.y);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_kn<LDQ>(b, wq_s, 16 * kk, i0 + 16 * np, lane);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = i0 + 8 * j + 2 * tq;
    const float b0 = bq[col], b1 = bq[col + 1];
    qf[j / 2][(j & 1) * 2] =
        pack_bf16(round_bf16(acc[j][0] + b0) * scale_in,
                  round_bf16(acc[j][1] + b1) * scale_in);
    qf[j / 2][(j & 1) * 2 + 1] =
        pack_bf16(round_bf16(acc[j][2] + b0) * scale_in,
                  round_bf16(acc[j][3] + b1) * scale_in);
  }
}

// head h: scores of qs (its A fragment qh) against the pair's tokens tk
// (one m16n8k16: head dim 16 x 8 tokens) and their softmax in f32 over a
// lane quad, -inf past n_tok: p[0..1] row g, p[2..3] row g + 8, tokens 2t,
// 2t + 1
__device__ __forceinline__ void head_softmax(float (&p)[4], const uint32_t* qh,
                                             const bf16* tk, int h, int n_tok,
                                             int lane) {
  using namespace dec;
  const int gq = lane >> 2, tq = lane & 3;
  const bool tg = gq < n_tok, t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(sc, qh, tg ? ld_u32(tk + gq * I + 16 * h + 2 * tq) : 0u,
           tg ? ld_u32(tk + gq * I + 16 * h + 8 + 2 * tq) : 0u);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x0 = t0 ? sc[2 * r] : -INFINITY, x1 = t1 ? sc[2 * r + 1] : -INFINITY;
    const float mx = quad_max(fmaxf(x0, x1));
    x0 = t0 ? expf(x0 - mx) : 0.f;
    x1 = t1 ? expf(x1 - mx) : 0.f;
    const float inv = 1.f / quad_sum(x0 + x1);
    p[2 * r] = x0 * inv;
    p[2 * r + 1] = x1 * inv;
  }
}

// head h: rnd(out) = rnd(rnd(p) . v) over the pair's tokens tv (m16n8k8),
// the head's 16 lanes as packed bf16 pairs: w[n][r] rows g (r = 0), g + 8,
// lanes 16 h + 8 n + 2t, + 1
__device__ __forceinline__ void head_out(uint32_t (&w)[2][2],
                                         const float (&p)[4], const bf16* tv,
                                         int h, int n_tok, int lane) {
  using namespace dec;
  const int gq = lane >> 2, tq = lane & 3;
  const bool t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
  const bf16 zero = __float2bfloat16(0.f);
  const uint32_t pa0 = pack_bf16(p[0], p[1]), pa1 = pack_bf16(p[2], p[3]);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int d = 16 * h + 8 * n + gq;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma1688(o, pa0, pa1,
            pack_raw(t0 ? tv[2 * tq * I + d] : zero,
                     t1 ? tv[(2 * tq + 1) * I + d] : zero));
    w[n][0] = pack_bf16(o[0], o[1]);
    w[n][1] = pack_bf16(o[2], o[3]);
  }
}

// acc (16 rows x the warp's 128 columns c0..) = rnd(out) . Wo, rnd(out) of
// all heads in o_s [16][LDI]
__device__ __forceinline__ void out_product(float (&acc)[16][4],
                                            const bf16* o_s, const bf16* wo_s,
                                            int c0, int lane) {
  using namespace dec;
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < I / 16; ++kk) {
    uint32_t a[4];
    load_a<LDI>(a, o_s, 0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t b[4];
      load_b_kn<LDO>(b, wo_s, 16 * kk, c0 + 16 * np, lane);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The bf16 forward. Persistent blocks of SLOTS warp pairs (one block per
// SM) hold Wq [C][LDQ] and Wo [I][LDO] in shared memory. A pair walks units
// of 16 image rows: unit u is row tile u % tpp of image u / tpp, and the pb
// pairs of that image share its keys, pe, qin and qs, so the unit loads its
// keys and pe rows once and computes the q projection once (qs stays in
// registers), then runs the attention, out projection, residual and
// LayerNorm for each of the pb pairs. Per slot: the unit's keys [16][LDO]
// (the residual reads them for every pair), its pe [16][LDO] (free after
// the q projection: the next unit's pe is copied in while this unit's
// pairs run; the next keys follow once the last pair has read them), the
// rnd(out) rows [16][LDI] that cross the pair's halves, and the two warps'
// LayerNorm sums. y leaves registers as 16-byte row segments: a quad
// transpose gives each lane 8 neighbouring columns of a row.
__global__ void __launch_bounds__(RT, 1)
    i2t_fwd_mma_kernel(const bf16* keys, const bf16* pe, const bf16* tok_k,
                       const bf16* tok_v, const bf16* wq, const float* bq,
                       const bf16* wo, const float* bo, const float* g,
                       const float* bt, bf16* out, int bp, int m, int pb,
                       int n_tok, float eps) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wq_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* wo_s = wq_s + C * LDQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1, pl = 32 * sub + lane;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* x_s = wo_s + I * LDO + slot * SLOT_BF16;
  bf16* e_s = x_s + 16 * LDO;
  bf16* o_s = e_s + 16 * LDO;
  float* st_s = reinterpret_cast<float*>(wo_s + I * LDO + SLOTS * SLOT_BF16) +
                slot * 2 * 2 * 16;  // [quantity][sub][row]
  auto pair_sync = [&] {  // the pair's own barrier (0 is __syncthreads)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };
  // the sum of quantity q of rows g, g + 8 over the pair's two warps (each
  // already quad-reduced over its columns), added in a fixed order
  auto pair_sum = [&](int q, float (&v)[2]) {
    if (tq == 0) {
      st_s[(q * 2 + sub) * 16 + gq] = v[0];
      st_s[(q * 2 + sub) * 16 + gq + 8] = v[1];
    }
    pair_sync();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      v[r] = st_s[(q * 2) * 16 + gq + 8 * r] + st_s[(q * 2 + 1) * 16 + gq + 8 * r];
  };

  const int tpp = (m + 15) / 16, units = (bp / pb) * tpp;
  const int stride = gridDim.x * SLOTS;
  const int i0 = 64 * sub, c0 = 128 * sub;
  auto load_keys = [&](int u) {
    const int img = u / tpp, row0 = (u - img * tpp) * 16;
    slot_rows_async<C, LDO>(x_s, keys + ((size_t)img * m + row0) * C,
                            min(16, m - row0), pl);
  };
  auto load_pe = [&](int u) {
    const int row0 = (u % tpp) * 16;
    slot_rows_async<C, LDO>(e_s, pe + (size_t)row0 * C, min(16, m - row0), pl);
  };

  int unit = blockIdx.x * SLOTS + slot;
  block_weights_async<C, I, LDQ, RT>(wq_s, wq);
  block_weights_async<I, C, LDO, RT>(wo_s, wo);
  if (unit < units) {
    load_keys(unit);
    load_pe(unit);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (; unit < units; unit += stride) {
    cp_wait<0>();
    pair_sync();  // the unit's keys and pe rows landed
    const int img = unit / tpp, row0 = (unit - img * tpp) * 16;
    const int valid = min(16, m - row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    const int next = unit + stride;
    uint32_t qf[4][4];
    q_heads(qf, x_s, e_s, wq_s, bq, i0, lane);
    pair_sync();  // both warps are done with pe
    if (next < units) load_pe(next);
    cp_commit();

    for (int j = 0; j < pb; ++j) {
      const int pair = img * pb + j;
      const bf16* tk = tok_k + (size_t)pair * n_tok * I;
      const bf16* tv = tok_v + (size_t)pair * n_tok * I;
      // per head: softmax, rnd(out) -> o_s
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const int h = 4 * sub + hh;
        float p[4];
        head_softmax(p, qf[hh], tk, h, n_tok, lane);
        uint32_t w[2][2];
        head_out(w, p, tv, h, n_tok, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * h + 8 * n + 2 * tq;
          *reinterpret_cast<uint32_t*>(o_s + gq * LDI + col) = w[n][0];
          *reinterpret_cast<uint32_t*>(o_s + (gq + 8) * LDI + col) = w[n][1];
        }
      }
      pair_sync();  // o_s holds rnd(out) of all heads

      // res = rnd(keys + rnd(rnd(out) . Wo + bo)), this warp's columns
      float acc[16][4];
      out_product(acc, o_s, wo_s, c0, lane);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = c0 + 8 * jn + 2 * tq;
        const float2 k0 = ld_bf2(x_s + gq * LDO + col);
        const float2 k1 = ld_bf2(x_s + (gq + 8) * LDO + col);
        const float b0 = bo[col], b1 = bo[col + 1];
        acc[jn][0] = round_bf16(k0.x + round_bf16(acc[jn][0] + b0));
        acc[jn][1] = round_bf16(k0.y + round_bf16(acc[jn][1] + b1));
        acc[jn][2] = round_bf16(k1.x + round_bf16(acc[jn][2] + b0));
        acc[jn][3] = round_bf16(k1.y + round_bf16(acc[jn][3] + b1));
        s[0] += acc[jn][0] + acc[jn][1];
        s[1] += acc[jn][2] + acc[jn][3];
      }
      // LayerNorm over the 256 columns of rows g, g + 8 (f32): mean, then
      // the centred variance
      s[0] = quad_sum(s[0]);
      s[1] = quad_sum(s[1]);
      pair_sum(0, s);  // also: both warps have read the keys
      if (j == pb - 1) {
        if (next < units) load_keys(next);
        cp_commit();
      }
      const float mu0 = s[0] * (1.f / C), mu1 = s[1] * (1.f / C);
      s[0] = s[1] = 0.f;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        acc[jn][0] -= mu0;
        acc[jn][1] -= mu0;
        acc[jn][2] -= mu1;
        acc[jn][3] -= mu1;
        s[0] = fmaf(acc[jn][0], acc[jn][0], fmaf(acc[jn][1], acc[jn][1], s[0]));
        s[1] = fmaf(acc[jn][2], acc[jn][2], fmaf(acc[jn][3], acc[jn][3], s[1]));
      }
      s[0] = quad_sum(s[0]);
      s[1] = quad_sum(s[1]);
      pair_sum(1, s);
      const float rs0 = rsqrtf(s[0] * (1.f / C) + eps);
      const float rs1 = rsqrtf(s[1] * (1.f / C) + eps);
      // y = rnd(yn g + bt) (a product and a sum, each rounded, as the plain
      // version); four n-tiles per 16-byte segment of each row
      bf16* y0 = out + ((size_t)pair * m + row0 + gq) * C;
      bf16* y1 = y0 + 8 * C;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        uint32_t w0[4], w1[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int jn = 4 * a + jj, col = c0 + 8 * jn + 2 * tq;
          const float g0 = g[col], g1 = g[col + 1];
          const float t0 = bt[col], t1 = bt[col + 1];
          w0[jj] = pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(acc[jn][0], rs0), g0), t0),
                             __fadd_rn(__fmul_rn(__fmul_rn(acc[jn][1], rs0), g1), t1));
          w1[jj] = pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(acc[jn][2], rs1), g0), t0),
                             __fadd_rn(__fmul_rn(__fmul_rn(acc[jn][3], rs1), g1), t1));
        }
        quad_transpose(w0, tq);
        quad_transpose(w1, tq);
        const int col = c0 + 32 * a + 8 * tq;
        if (ok0) *reinterpret_cast<uint4*>(y0 + col) = make_uint4(w0[0], w0[1], w0[2], w0[3]);
        if (ok1) *reinterpret_cast<uint4*>(y1 + col) = make_uint4(w1[0], w1[1], w1[2], w1[3]);
      }
    }
  }
}

// The row pass. A pair of warps shares each 16-row tile (a slot): warp
// `sub` of the pair takes the heads 4 sub.. (the I lanes 64 sub..) and the
// C columns 128 sub.., so a block holds 8 warps on 4 slots. Shared memory:
// Wq [C][LDQ] and Wo [I][LDO] (k by n for the forward products, n by k for
// the backward ones); per slot its tile's keys, then res (bf16: a rounding
// point), then rnd(d_res) [16][LDO]; pe, then p (f32 [16][NH * TP]) in a
// second [16][LDO]; rnd(out), then rnd(d_qpre) [16][LDI], the operands
// that cross the pair's halves; and the row statistics the two warps add
// up (the LayerNorm sums). Lane = 4 g + t holds rows g and g + 8 of every
// accumulator n-tile, columns 2t, 2t + 1. No accumulator is wider than 64
// registers.
__global__ void __launch_bounds__(RT, 1)
    i2t_bwd_rows_kernel(const bf16* keys, const bf16* pe, const bf16* tok_k,
                        const bf16* tok_v, const bf16* wq, const float* bq,
                        const bf16* wo, const float* bo, const float* g,
                        const float* bt, const bf16* dy, bf16* dkeys,
                        bf16* dqpre, bf16* p_out, bf16* ds_out, bf16* dout,
                        bf16* out_rows, bf16* dres_rows, float* dbq_p,
                        float* dbo_p, float* dg_p, float* dbt_p, int bp,
                        int m, int pb, int n_tok, float eps) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wq_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* wo_s = wq_s + C * LDQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1, pl = 32 * sub + lane;
  const int gq = lane >> 2, tq = lane & 3;
  bf16* x_s = wo_s + I * LDO + slot * SLOT_BF16;
  bf16* e_s = x_s + 16 * LDO;
  bf16* o_s = e_s + 16 * LDO;
  float* p_s = reinterpret_cast<float*>(e_s);
  float* st_s = reinterpret_cast<float*>(wo_s + I * LDO + SLOTS * SLOT_BF16) +
                slot * 6 * 2 * 16;  // [quantity][sub][row]
  auto pair_sync = [&] {  // the pair's own barrier (0 is __syncthreads)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };
  // the two warps' sums (each quad-reduced over its columns) of two
  // quantities q, q + 1 of rows g, g + 8, added in a fixed order
  auto pair_sums = [&](int q, float (&v)[2][2]) {
    if (tq == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st_s[((q + i) * 2 + sub) * 16 + gq] = v[i][0];
        st_s[((q + i) * 2 + sub) * 16 + gq + 8] = v[i][1];
      }
    pair_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[i][r] = st_s[((q + i) * 2) * 16 + gq + 8 * r] +
                  st_s[((q + i) * 2 + 1) * 16 + gq + 8 * r];
  };

  block_weights_async<C, I, LDQ, RT>(wq_s, wq);
  block_weights_async<I, C, LDO, RT>(wo_s, wo);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const float scale_f32 = 1.f / sqrtf((float)HD);
  const int tpp = (m + 15) / 16, ntiles = bp * tpp;
  const int c0 = 128 * sub, i0 = 64 * sub;  // this warp's columns of C, I
  const bf16 zero = __float2bfloat16(0.f);
  // per-column sums over the slot's tiles (group_sum8 layout), this warp's
  // columns: groups 4 sub.. of C, 2 sub.. of I
  float a_dg[4], a_dbt[4], a_dbo[4], a_dbq[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a_dg[i] = a_dbt[i] = a_dbo[i] = 0.f;
  a_dbq[0] = a_dbq[1] = 0.f;

  for (int tile = blockIdx.x * SLOTS + slot; tile < ntiles;
       tile += gridDim.x * SLOTS) {
    const RowTile tl(tile, tpp, m);
    const int valid = min(16, m - tl.row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    const size_t r0 = tl.prow0 + gq, r1 = r0 + 8;  // the lane's two rows
    const bf16* keys_t = keys + ((size_t)(tl.pair / pb) * m + tl.row0) * C;
    const bf16* pe_t = pe + (size_t)tl.row0 * C;
    slot_rows_async<C, LDO>(x_s, keys_t, valid, pl);
    slot_rows_async<C, LDO>(e_s, pe_t, valid, pl);
    cp_commit();
    cp_wait<0>();
    pair_sync();

    // q projection, this warp's 64 lanes -> qs as per-head A fragments
    uint32_t qf[4][4];
    q_heads(qf, x_s, e_s, wq_s, bq, i0, lane);
    pair_sync();  // pe is read by both warps: e_s holds p from here on

    // per head: scores, softmax (p kept in f32), out = rnd(rnd(p) . v) ->
    // o_s and the scratch rows
    const bf16* tk = tok_k + (size_t)tl.pair * n_tok * I;
    const bf16* tv = tok_v + (size_t)tl.pair * n_tok * I;
    const bool tg = gq < n_tok, t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * sub + hh;
      float p[4];
      head_softmax(p, qf[hh], tk, h, n_tok, lane);
      *reinterpret_cast<float2*>(p_s + gq * NH * TP + h * TP + 2 * tq) =
          make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(p_s + (gq + 8) * NH * TP + h * TP + 2 * tq) =
          make_float2(p[2], p[3]);
      if (ok0) st_bf2(p_out + r0 * (NH * TP) + h * TP + 2 * tq, p[0], p[1]);
      if (ok1) st_bf2(p_out + r1 * (NH * TP) + h * TP + 2 * tq, p[2], p[3]);
      uint32_t w[2][2];
      head_out(w, p, tv, h, n_tok, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * h + 8 * n + 2 * tq;
        *reinterpret_cast<uint32_t*>(o_s + gq * LDI + col) = w[n][0];
        *reinterpret_cast<uint32_t*>(o_s + (gq + 8) * LDI + col) = w[n][1];
        if (ok0) *reinterpret_cast<uint32_t*>(out_rows + r0 * I + col) = w[n][0];
        if (ok1) *reinterpret_cast<uint32_t*>(out_rows + r1 * I + col) = w[n][1];
      }
    }
    pair_sync();  // o_s holds rnd(out) of all heads

    // out projection, this warp's 128 columns; res = rnd(keys + rnd(proj +
    // bo)) over its keys in x_s, and its part of the row sums
    float acc[16][4];
    out_product(acc, o_s, wo_s, c0, lane);
    float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      bf16* x0 = x_s + gq * LDO + col;
      bf16* x1 = x_s + (gq + 8) * LDO + col;
      const float2 k0 = ld_bf2(x0), k1 = ld_bf2(x1);
      const float b0 = bo[col], b1 = bo[col + 1];
      const __nv_bfloat162 v0 = __floats2bfloat162_rn(
          k0.x + round_bf16(acc[j][0] + b0), k0.y + round_bf16(acc[j][1] + b1));
      const __nv_bfloat162 v1 = __floats2bfloat162_rn(
          k1.x + round_bf16(acc[j][2] + b0), k1.y + round_bf16(acc[j][3] + b1));
      *reinterpret_cast<__nv_bfloat162*>(x0) = v0;
      *reinterpret_cast<__nv_bfloat162*>(x1) = v1;
      const float2 f0 = __bfloat1622float2(v0), f1 = __bfloat1622float2(v1);
      acc[j][0] = f0.x;
      acc[j][1] = f0.y;
      acc[j][2] = f1.x;
      acc[j][3] = f1.y;
      st[0][0] += f0.x + f0.y;
      st[0][1] += f1.x + f1.y;
    }
    // LayerNorm of rows g, g + 8: a quad holds the warp's half of a row
    st[0][0] = quad_sum(st[0][0]);
    st[0][1] = quad_sum(st[0][1]);
    pair_sums(0, st);
    const float mu0 = st[0][0] * (1.f / C), mu1 = st[0][1] * (1.f / C);
    st[0][0] = st[0][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // res -> centred res in acc
      acc[j][0] -= mu0;
      acc[j][1] -= mu0;
      acc[j][2] -= mu1;
      acc[j][3] -= mu1;
      st[0][0] = fmaf(acc[j][0], acc[j][0], fmaf(acc[j][1], acc[j][1], st[0][0]));
      st[0][1] = fmaf(acc[j][2], acc[j][2], fmaf(acc[j][3], acc[j][3], st[0][1]));
    }
    st[0][0] = quad_sum(st[0][0]);
    st[0][1] = quad_sum(st[0][1]);
    pair_sums(2, st);
    const float rs0 = rsqrtf(st[0][0] * (1.f / C) + eps);
    const float rs1 = rsqrtf(st[0][1] * (1.f / C) + eps);
    const bf16* dy0 = dy + r0 * C;
    const bf16* dy1 = dy + r1 * C;
    float sm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // sum dyn, sum dyn yn
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      float vg[8], vb[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * gg + jj, col = c0 + 8 * j + 2 * tq;
        acc[j][0] *= rs0;  // yn
        acc[j][1] *= rs0;
        acc[j][2] *= rs1;
        acc[j][3] *= rs1;
        const float2 d0 = ok0 ? ld_bf2(dy0 + col) : make_float2(0.f, 0.f);
        const float2 d1 = ok1 ? ld_bf2(dy1 + col) : make_float2(0.f, 0.f);
        const float g0 = g[col], g1 = g[col + 1];
        vg[2 * jj] = d0.x * acc[j][0] + d1.x * acc[j][2];
        vg[2 * jj + 1] = d0.y * acc[j][1] + d1.y * acc[j][3];
        vb[2 * jj] = d0.x + d1.x;
        vb[2 * jj + 1] = d0.y + d1.y;
        sm[0][0] += d0.x * g0 + d0.y * g1;
        sm[1][0] = fmaf(d0.x * g0, acc[j][0], fmaf(d0.y * g1, acc[j][1], sm[1][0]));
        sm[0][1] += d1.x * g0 + d1.y * g1;
        sm[1][1] = fmaf(d1.x * g0, acc[j][2], fmaf(d1.y * g1, acc[j][3], sm[1][1]));
      }
      a_dg[gg] += group_sum8(vg, lane);
      a_dbt[gg] += group_sum8(vb, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm[i][0] = quad_sum(sm[i][0]);
      sm[i][1] = quad_sum(sm[i][1]);
    }
    pair_sums(4, sm);
    const float mdy0 = sm[0][0] * (1.f / C), mdyy0 = sm[1][0] * (1.f / C);
    const float mdy1 = sm[0][1] * (1.f / C), mdyy1 = sm[1][1] * (1.f / C);
    // d_res = rstd (dyn - mean dyn - yn mean(dyn yn)); rnd(d_res) over res
    // in x_s and to the scratch rows
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      float vo[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * gg + jj, col = c0 + 8 * j + 2 * tq;
        const float2 d0 = ok0 ? ld_bf2(dy0 + col) : make_float2(0.f, 0.f);
        const float2 d1 = ok1 ? ld_bf2(dy1 + col) : make_float2(0.f, 0.f);
        const float g0 = g[col], g1 = g[col + 1];
        const float e0 = rs0 * (d0.x * g0 - mdy0 - acc[j][0] * mdyy0);
        const float e1 = rs0 * (d0.y * g1 - mdy0 - acc[j][1] * mdyy0);
        const float e2 = rs1 * (d1.x * g0 - mdy1 - acc[j][2] * mdyy1);
        const float e3 = rs1 * (d1.y * g1 - mdy1 - acc[j][3] * mdyy1);
        vo[2 * jj] = e0 + e2;
        vo[2 * jj + 1] = e1 + e3;
        st_bf2(x_s + gq * LDO + col, e0, e1);
        st_bf2(x_s + (gq + 8) * LDO + col, e2, e3);
        if (ok0) st_bf2(dres_rows + r0 * C + col, e0, e1);
        if (ok1) st_bf2(dres_rows + r1 * C + col, e2, e3);
      }
      a_dbo[gg] += group_sum8(vo, lane);
    }
    pair_sync();  // x_s holds rnd(d_res) of all columns

    // d_out = rnd(d_res) . Wo^T, this warp's 64 lanes -> rnd, the per-head
    // A fragments of d_p
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4];
      load_a<LDO>(a, x_s, 0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        load_b_nk<LDO>(b, wo_s, i0 + 16 * np, 16 * kk, lane);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    uint32_t df[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = i0 + 8 * j + 2 * tq;
      df[j / 2][(j & 1) * 2] = pack_bf16(acc[j][0], acc[j][1]);
      df[j / 2][(j & 1) * 2 + 1] = pack_bf16(acc[j][2], acc[j][3]);
      if (ok0) *reinterpret_cast<uint32_t*>(dout + r0 * I + col) = df[j / 2][(j & 1) * 2];
      if (ok1) *reinterpret_cast<uint32_t*>(dout + r1 * I + col) = df[j / 2][(j & 1) * 2 + 1];
    }

    // per head: d_p = d_out . v^T, the softmax backward, d_qpre = rnd(
    // (d_score . k) / 4) -> o_s and the rows
    float vq[8];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * sub + hh;
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(dp, df[hh], tg ? ld_u32(tv + gq * I + 16 * h + 2 * tq) : 0u,
               tg ? ld_u32(tv + gq * I + 16 * h + 8 + 2 * tq) : 0u);
      const float2 pa = *reinterpret_cast<const float2*>(
          p_s + gq * NH * TP + h * TP + 2 * tq);
      const float2 pc = *reinterpret_cast<const float2*>(
          p_s + (gq + 8) * NH * TP + h * TP + 2 * tq);
      const float p[4] = {pa.x, pa.y, pc.x, pc.y};
      float ds[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = p[2 * r] * dp[2 * r], x1 = p[2 * r + 1] * dp[2 * r + 1];
        const float sum = quad_sum(x0 + x1);
        ds[2 * r] = round_bf16(x0 - p[2 * r] * sum);  // p == 0 past n_tok
        ds[2 * r + 1] = round_bf16(x1 - p[2 * r + 1] * sum);
      }
      if (ok0) st_bf2(ds_out + r0 * (NH * TP) + h * TP + 2 * tq, ds[0], ds[1]);
      if (ok1) st_bf2(ds_out + r1 * (NH * TP) + h * TP + 2 * tq, ds[2], ds[3]);
      const uint32_t da0 = pack_bf16(ds[0], ds[1]), da1 = pack_bf16(ds[2], ds[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int d = 16 * h + 8 * n + gq;
        float q[4] = {0.f, 0.f, 0.f, 0.f};
        mma1688(q, da0, da1,
                pack_raw(t0 ? tk[2 * tq * I + d] : zero,
                         t1 ? tk[(2 * tq + 1) * I + d] : zero));
#pragma unroll
        for (int e = 0; e < 4; ++e) q[e] *= scale_f32;
        vq[(hh & 1) * 4 + 2 * n] = q[0] + q[2];
        vq[(hh & 1) * 4 + 2 * n + 1] = q[1] + q[3];
        const uint32_t w0 = pack_bf16(q[0], q[1]), w1 = pack_bf16(q[2], q[3]);
        const int col = 16 * h + 8 * n + 2 * tq;
        *reinterpret_cast<uint32_t*>(o_s + gq * LDI + col) = w0;
        *reinterpret_cast<uint32_t*>(o_s + (gq + 8) * LDI + col) = w1;
        if (ok0) *reinterpret_cast<uint32_t*>(dqpre + r0 * I + col) = w0;
        if (ok1) *reinterpret_cast<uint32_t*>(dqpre + r1 * I + col) = w1;
      }
      if (hh & 1) a_dbq[hh / 2] += group_sum8(vq, lane);
    }
    pair_sync();  // o_s holds rnd(d_qpre) of all heads

    // d_keys = rnd(d_res) + rnd(d_qpre) . Wq^T, this warp's 128 columns
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      const float2 e0 = ld_bf2(x_s + gq * LDO + col);
      const float2 e1 = ld_bf2(x_s + (gq + 8) * LDO + col);
      acc[j][0] = e0.x;
      acc[j][1] = e0.y;
      acc[j][2] = e1.x;
      acc[j][3] = e1.y;
    }
#pragma unroll 2
    for (int kk = 0; kk < I / 16; ++kk) {
      uint32_t a[4];
      load_a<LDI>(a, o_s, 0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t b[4];
        load_b_nk<LDQ>(b, wq_s, c0 + 16 * np, 16 * kk, lane);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      if (ok0) st_bf2(dkeys + r0 * C + col, acc[j][0], acc[j][1]);
      if (ok1) st_bf2(dkeys + r1 * C + col, acc[j][2], acc[j][3]);
    }
    pair_sync();  // the slot's tiles are refilled by the next tile
  }

  const size_t wg = (size_t)blockIdx.x * SLOTS + slot;
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) {
    const int col = group_col(4 * sub + gg, lane);
    dg_p[wg * C + col] = a_dg[gg];
    dbt_p[wg * C + col] = a_dbt[gg];
    dbo_p[wg * C + col] = a_dbo[gg];
  }
#pragma unroll
  for (int gg = 0; gg < 2; ++gg)
    dbq_p[wg * I + group_col(2 * sub + gg, lane)] = a_dbq[gg];
}

// The weight pass: block (chunk, kind) sums over the chunk's rows
//   kind 0: dWo   [I][C] = rnd(out)^T . rnd(d_res)
//   kind 1: dWq^T [I][C] = rnd(d_qpre)^T . rnd(keys[pair / pb] + pe)
// into part[kind][chunk]; warp w owns rows 64 (w / 4).., columns 64 (w % 4)..
constexpr int DW_LDA = I + 8, DW_LDB = C + 8;
constexpr int DW_STAGE = dec::DW_SR * (DW_LDA + 2 * DW_LDB);  // A, B, pe
constexpr size_t DW_SMEM = sizeof(bf16) * (size_t)dec::DW_STAGES * DW_STAGE;

__global__ void __launch_bounds__(dec::DW_THREADS, 1)
    i2t_bwd_dw_kernel(const bf16* keys, const bf16* pe, const bf16* dqpre,
                      const bf16* out_rows, const bf16* dres_rows,
                      float* part, int m, int pb, int rows, int chunk) {
  using namespace dec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int kind = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk, hi = min(rows, lo + chunk);
  const bf16* xsrc = kind ? dqpre : out_rows;
  float acc[4][8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  auto load = [&](int st, int r0) {
    bf16* xs = ring + st * DW_STAGE;
    bf16* ys = xs + DW_SR * DW_LDA;
    bf16* es = ys + DW_SR * DW_LDB;
    for (int i = threadIdx.x; i < DW_SR * (I / 8); i += DW_THREADS) {
      const int r = i / (I / 8), c = (i % (I / 8)) * 8;
      const bool ok = r0 + r < hi;
      cp_async16(xs + r * DW_LDA + c, xsrc + (ok ? (size_t)(r0 + r) * I + c : 0), ok);
    }
    for (int i = threadIdx.x; i < DW_SR * (C / 8); i += DW_THREADS) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      const int row = r0 + r;
      const bool ok = row < hi;
      if (kind == 0) {
        cp_async16(ys + r * DW_LDB + c, dres_rows + (ok ? (size_t)row * C + c : 0), ok);
      } else {
        const int pair = ok ? row / m : 0, rr = ok ? row - pair * m : 0;
        cp_async16(ys + r * DW_LDB + c,
                   keys + ((size_t)(pair / pb) * m + rr) * C + c, ok);
        cp_async16(es + r * DW_LDB + c, pe + (size_t)rr * C + c, ok);
      }
    }
  };
  auto prep = [&](int st) {  // kind 1: keys -> rnd(keys + pe) in place
    if (kind == 0) return false;
    bf16* ys = ring + st * DW_STAGE + DW_SR * DW_LDA;
    const bf16* es = ys + DW_SR * DW_LDB;
    for (int i = threadIdx.x; i < DW_SR * C / 2; i += DW_THREADS) {
      const int r = i / (C / 2), c = (i % (C / 2)) * 2;
      const float2 k = ld_bf2(ys + r * DW_LDB + c), p = ld_bf2(es + r * DW_LDB + c);
      st_bf2(ys + r * DW_LDB + c, k.x + p.x, k.y + p.y);
    }
    return true;
  };
  const int a0 = 64 * (warp / 4), b0 = 64 * (warp % 4);
  auto mma = [&](int st) {
    const bf16* xs = ring + st * DW_STAGE;
    dw_stage_mma<DW_LDA, DW_LDB>(acc, xs, a0, xs + DW_SR * DW_LDA, b0, lane);
  };
  dw_ring(lo, hi, load, prep, mma);
  dw_store(part + ((size_t)kind * gridDim.x + blockIdx.x) * I * C + a0 * C + b0,
           C, acc, lane);
}

int launch_bwd_rows(void* const* a, int bp, int m, int pb, int n_tok,
                    int blocks, float eps, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || blocks < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ROWS_SMEM);
  if (e != cudaSuccess) return (int)e;
  auto in = [&](int i) { return static_cast<const bf16*>(a[i]); };
  auto out = [&](int i) { return static_cast<bf16*>(a[i]); };
  auto f = [&](int i) { return static_cast<float*>(a[i]); };
  i2t_bwd_rows_kernel<<<blocks, RT, ROWS_SMEM, stream>>>(
      in(0), in(1), in(2), in(3), in(4), f(5), in(6), f(7), f(8), f(9),
      in(10), out(11), out(12), out(13), out(14), out(15), out(16), out(17),
      f(18), f(19), f(20), f(21), bp, m, pb, n_tok, eps);
  return (int)cudaGetLastError();
}

int launch_bwd_dw(void* const* a, int bp, int m, int pb, int chunk,
                  int nchunks, cudaStream_t stream) {
  const int rows = bp * m;
  if (pb < 1 || bp % pb || chunk < 1 || chunk % dec::DW_SR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DW_SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_bwd_dw_kernel<<<dim3(nchunks, 2), dec::DW_THREADS, DW_SMEM, stream>>>(
      static_cast<const bf16*>(a[0]), static_cast<const bf16*>(a[1]),
      static_cast<const bf16*>(a[2]), static_cast<const bf16*>(a[3]),
      static_cast<const bf16*>(a[4]), static_cast<float*>(a[5]), m, pb, rows,
      chunk);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const void* keys, const void* pe, const void* tok_k,
                   const void* tok_v, const void* wq, const void* bq,
                   const void* wo, const void* bo, const void* g,
                   const void* bt, void* out, int bp, int m, int pb,
                   int n_tok, int blocks, float eps, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_MMA_SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_fwd_mma_kernel<<<blocks, RT, FWD_MMA_SMEM, stream>>>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(pe),
      static_cast<const bf16*>(tok_k), static_cast<const bf16*>(tok_v),
      static_cast<const bf16*>(wq), static_cast<const float*>(bq),
      static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<bf16*>(out), bp, m, pb, n_tok, eps);
  return (int)cudaGetLastError();
}


// ---------------------------- f32 forward and backward, split TF32 ----
// The f32 kernels: the bf16 ones' warp pairs and chain, on super-tiles of
// 64 rows (decoder_tf32.cuh: dec32::stream_product streams each weight
// through a cp.async ring, every byte serving the super-tile's 64 rows).
// Shared memory: the super-tile's keys rows (then res, then d_res) and pe
// rows (then p: [16][LDP] per slot) [64][LDX], its rnd(out) (then d_qpre)
// rows [64][LDO32], the weight ring and the LayerNorm row sums. Warp `sub`
// of a slot's pair takes the heads 4 sub.. (I lanes 64 sub..) and the C
// columns 128 sub.., as in bf16.
using attn::mma::cp_commit;
using attn::mma::cp_wait;
using stf32::acc_a;
using stf32::Frag;
using stf32::load_a;
using stf32::mma3;
using stf32::split_frag;

constexpr int LDX = C + 4;        // keys / pe / res / d_res rows (floats)
constexpr int LDO32 = I + 4;      // rnd(out) / d_qpre rows
constexpr int LDP = NH * TP + 8;  // p rows (float2 at bank 8g + 2t)
constexpr int WQ_KS = 32;         // Wq-shaped ([C][I]) stage rows
constexpr int WO_KS = 16;         // Wo-shaped ([I][C]) stage rows
constexpr int RING32 = dec32::STAGES * WQ_KS * (I + 8);
static_assert(WQ_KS * (I + 8) >= WO_KS * (C + 8), "ring stage size");
constexpr size_t TF32_SMEM =
    sizeof(float) * ((size_t)dec32::ROWS * (2 * LDX + LDO32) + RING32 +
                     dec32::SLOTS * 6 * 2 * 16);
// the row pass adds its per-column sums of dg and dbt per slot
constexpr size_t ROWS_TF32_SMEM =
    TF32_SMEM + sizeof(float) * dec32::SLOTS * 2 * C;

// (qin . Wq + bq) / 4 of the warp's 16 rows, lanes i0.. (8 n-tiles), qin =
// keys + pe formed in the A fragments (keys xs, pe es: the slot's rows)
__device__ __forceinline__ void q_proj32(float (&q)[8][4], const float* xs,
                                         const float* es, const float* wq,
                                         const float* bq, float* ring, int i0,
                                         int lane) {
  const int tq = lane & 3;
  dec32::zero<8>(q);
  dec32::stream_product<C, I, WQ_KS, 8>(
      q, wq, ring, i0,
      [&](Frag& a, int k0) {
        const int o = (lane >> 2) * LDX + k0 + tq;
        split_frag(a, xs[o] + es[o], xs[o + 8 * LDX] + es[o + 8 * LDX],
                   xs[o + 4] + es[o + 4], xs[o + 8 * LDX + 4] + es[o + 8 * LDX + 4]);
      },
      lane);
  const float scale = 1.f / sqrtf((float)HD);  // 1/4: exact
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = i0 + 8 * j + 2 * tq;
    const float b0 = bq[col], b1 = bq[col + 1];
    q[j][0] = (q[j][0] + b0) * scale;
    q[j][1] = (q[j][1] + b1) * scale;
    q[j][2] = (q[j][2] + b0) * scale;
    q[j][3] = (q[j][3] + b1) * scale;
  }
}

// head h: sc = x . tok^T over the head's 16 lanes (x the two accumulator
// n-tiles xh, k permuted; tok the pair's [n_tok][I] rows, zero past n_tok):
// sc[0..1] row g, sc[2..3] row g + 8, tokens 2t, 2t + 1 -- the scores
// qs . k^T and, in the backward, d_p = d_out . v^T
__device__ __forceinline__ void head_dots32(float (&sc)[4],
                                            const float (*xh)[4],
                                            const float* tok, int h,
                                            int n_tok, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const bool tg = gq < n_tok;
  sc[0] = sc[1] = sc[2] = sc[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    Frag a;
    acc_a(a, xh[kk]);
    const float2 b = tg ? dec32::ld2(tok + gq * I + 16 * h + 8 * kk + 2 * tq)
                        : make_float2(0.f, 0.f);
    mma3(sc, a, b.x, b.y);
  }
}

// softmax over the tokens of sc (f32, per row over a lane quad, -inf past
// n_tok), in place
__device__ __forceinline__ void softmax32(float (&sc)[4], int n_tok,
                                          int lane) {
  using attn::mma::quad_max;
  using attn::mma::quad_sum;
  const int tq = lane & 3;
  const bool t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x0 = t0 ? sc[2 * r] : -INFINITY, x1 = t1 ? sc[2 * r + 1] : -INFINITY;
    const float mx = quad_max(fmaxf(x0, x1));
    x0 = t0 ? expf(x0 - mx) : 0.f;
    x1 = t1 ? expf(x1 - mx) : 0.f;
    const float inv = 1.f / quad_sum(x0 + x1);
    sc[2 * r] = x0 * inv;
    sc[2 * r + 1] = x1 * inv;
  }
}

// head h: o[n] = w . tok over the tokens (w rows x tokens in accumulator
// layout, k permuted), n-tile n: lanes 16 h + 8 n.. -- p . v and, in the
// backward, d_score . k
__device__ __forceinline__ void head_mix32(float (&o)[2][4],
                                           const float (&w)[4],
                                           const float* tok, int h,
                                           int n_tok, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const bool t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
  Frag a;
  acc_a(a, w);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int d = 16 * h + 8 * n + gq;
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    mma3(o[n], a, t0 ? tok[2 * tq * I + d] : 0.f,
         t1 ? tok[(2 * tq + 1) * I + d] : 0.f);
  }
}

// The f32 forward. Persistent blocks of 8 warps walk units of 64 image
// rows (the rows of one image; its pb pairs share keys, pe and the q
// projection, which stays in registers); per pair: the head scores,
// softmax and p . v (rnd(out) -> the slot's rows), the out projection,
// residual and LayerNorm, y stored from registers as 8-byte pairs.
__global__ void __launch_bounds__(dec32::THREADS, 1)
    i2t_fwd_tf32_kernel(const float* keys, const float* pe,
                        const float* tok_k, const float* tok_v,
                        const float* wq, const float* bq, const float* wo,
                        const float* bo, const float* g, const float* bt,
                        float* out, int bp, int m, int pb, int n_tok,
                        float eps) {
  using attn::mma::quad_sum;
  extern __shared__ __align__(16) float smem32[];
  float* x_s = smem32;
  float* e_s = x_s + dec32::ROWS * LDX;
  float* o_s = e_s + dec32::ROWS * LDX;
  float* ring = o_s + dec32::ROWS * LDO32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  const float* xs = x_s + slot * 16 * LDX;
  const float* es = e_s + slot * 16 * LDX;
  float* os = o_s + slot * 16 * LDO32;
  float* st_s = ring + RING32 + slot * 2 * 2 * 16;  // [quantity][sub][row]
  auto pair_sync = [&] {  // the pair's own barrier (0 is __syncthreads)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };
  auto pair_sum = [&](int q, float (&v)[2]) {
    if (tq == 0) {
      st_s[(q * 2 + sub) * 16 + gq] = v[0];
      st_s[(q * 2 + sub) * 16 + gq + 8] = v[1];
    }
    pair_sync();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      v[r] = st_s[(q * 2) * 16 + gq + 8 * r] + st_s[(q * 2 + 1) * 16 + gq + 8 * r];
  };

  const int tps = (m + dec32::ROWS - 1) / dec32::ROWS;
  const int units = (bp / pb) * tps;
  const int i0 = 64 * sub, c0 = 128 * sub;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int img = unit / tps, srow0 = (unit - img * tps) * dec32::ROWS;
    const int row0 = srow0 + 16 * slot, valid = min(16, m - row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    __syncthreads();  // the previous unit is done with the rows
    dec32::rows_async<C, LDX>(x_s, keys + ((size_t)img * m + srow0) * C,
                              m - srow0);
    dec32::rows_async<C, LDX>(e_s, pe + (size_t)srow0 * C, m - srow0);
    cp_commit();
    float q[8][4];
    q_proj32(q, xs, es, wq, bq, ring, i0, lane);

    for (int j = 0; j < pb; ++j) {
      const int pair = img * pb + j;
      const float* tk = tok_k + (size_t)pair * n_tok * I;
      const float* tv = tok_v + (size_t)pair * n_tok * I;
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const int h = 4 * sub + hh;
        float p[4], o[2][4];
        head_dots32(p, q + 2 * hh, tk, h, n_tok, lane);
        softmax32(p, n_tok, lane);
        head_mix32(o, p, tv, h, n_tok, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * h + 8 * n + 2 * tq;
          dec32::st2(os + gq * LDO32 + col, o[n][0], o[n][1]);
          dec32::st2(os + (gq + 8) * LDO32 + col, o[n][2], o[n][3]);
        }
      }
      // res = keys + (rnd(out) . Wo + bo), this warp's 128 columns
      float acc[16][4];
      dec32::zero<16>(acc);
      dec32::stream_product<I, C, WO_KS, 16>(
          acc, wo, ring, c0,
          [&](Frag& a, int k0) { load_a(a, os, LDO32, 0, k0, lane); }, lane);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = c0 + 8 * jn + 2 * tq;
        const float2 k0 = dec32::ld2(xs + gq * LDX + col);
        const float2 k1 = dec32::ld2(xs + (gq + 8) * LDX + col);
        const float b0 = bo[col], b1 = bo[col + 1];
        acc[jn][0] = k0.x + (acc[jn][0] + b0);
        acc[jn][1] = k0.y + (acc[jn][1] + b1);
        acc[jn][2] = k1.x + (acc[jn][2] + b0);
        acc[jn][3] = k1.y + (acc[jn][3] + b1);
        s[0] += acc[jn][0] + acc[jn][1];
        s[1] += acc[jn][2] + acc[jn][3];
      }
      s[0] = quad_sum(s[0]);
      s[1] = quad_sum(s[1]);
      pair_sum(0, s);
      const float mu0 = s[0] * (1.f / C), mu1 = s[1] * (1.f / C);
      s[0] = s[1] = 0.f;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        acc[jn][0] -= mu0;
        acc[jn][1] -= mu0;
        acc[jn][2] -= mu1;
        acc[jn][3] -= mu1;
        s[0] = fmaf(acc[jn][0], acc[jn][0], fmaf(acc[jn][1], acc[jn][1], s[0]));
        s[1] = fmaf(acc[jn][2], acc[jn][2], fmaf(acc[jn][3], acc[jn][3], s[1]));
      }
      s[0] = quad_sum(s[0]);
      s[1] = quad_sum(s[1]);
      pair_sum(1, s);
      const float rs0 = rsqrtf(s[0] * (1.f / C) + eps);
      const float rs1 = rsqrtf(s[1] * (1.f / C) + eps);
      float* y0 = out + ((size_t)pair * m + row0 + gq) * C;
      float* y1 = y0 + 8 * C;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = c0 + 8 * jn + 2 * tq;
        const float g0 = g[col], g1 = g[col + 1];
        const float t0 = bt[col], t1 = bt[col + 1];
        if (ok0)
          dec32::st2(y0 + col, acc[jn][0] * rs0 * g0 + t0,
                     acc[jn][1] * rs0 * g1 + t1);
        if (ok1)
          dec32::st2(y1 + col, acc[jn][2] * rs1 * g0 + t0,
                     acc[jn][3] * rs1 * g1 + t1);
      }
    }
  }
}

// The f32 row pass: super-tiles of 64 rows of one pair. Per slot: the q
// projection (qs in registers), per head the scores, softmax (p to the
// slot's p rows and p_out) and p . v (rnd(out) to its rows and the
// scratch), the out projection, residual, LayerNorm and its backward
// (d_res over the keys rows and to the scratch), d_out = d_res . Wo^T, per
// head d_p, the softmax backward and d_qpre = d_score . k / 4 (over the
// rnd(out) rows and to the rows), d_keys = d_res + d_qpre . Wq^T. The
// backward's products stream Wo^T and Wq^T, which the caller passes
// row-major, so every stage is read as [k][n]. Per-column sums as in bf16:
// group_sum8 per tile, one partial per slot.
__global__ void __launch_bounds__(dec32::THREADS, 1)
    i2t_bwd_rows_tf32_kernel(const float* keys, const float* pe,
                             const float* tok_k, const float* tok_v,
                             const float* wq, const float* bq,
                             const float* wo, const float* bo,
                             const float* g, const float* bt,
                             const float* dy, float* dkeys, float* dqpre,
                             float* p_out, float* ds_out, float* dout,
                             float* out_rows, float* dres_rows, float* dbq_p,
                             float* dbo_p, float* dg_p, float* dbt_p,
                             const float* wqt, const float* wot, int bp,
                             int m, int pb, int n_tok, float eps) {
  using attn::mma::quad_sum;
  using dec::group_col;
  using dec::group_sum8;
  extern __shared__ __align__(16) float smem32[];
  float* x_s = smem32;
  float* e_s = x_s + dec32::ROWS * LDX;
  float* o_s = e_s + dec32::ROWS * LDX;
  float* ring = o_s + dec32::ROWS * LDO32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 1, sub = warp & 1;
  const int gq = lane >> 2, tq = lane & 3;
  float* xs = x_s + slot * 16 * LDX;
  float* es = e_s + slot * 16 * LDX;
  float* ps = es;  // p rows [16][LDP] once the q projection has read pe
  float* os = o_s + slot * 16 * LDO32;
  float* st_s = ring + RING32 + slot * 6 * 2 * 16;  // [quantity][sub][row]
  // per-column sums of dg and dbt over the slot's tiles, each entry one
  // lane's (dbo and dbq stay in registers)
  float* cs0 = ring + RING32 + dec32::SLOTS * 6 * 2 * 16;
  float* cs = cs0 + slot * 2 * C;
  for (int i = threadIdx.x; i < dec32::SLOTS * 2 * C; i += dec32::THREADS)
    cs0[i] = 0.f;
  auto pair_sync = [&] {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slot) : "memory");
  };
  // the two warps' sums of quantities q, q + 1 of rows g, g + 8, added in a
  // fixed order
  auto pair_sums = [&](int q, float (&v)[2][2]) {
    if (tq == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st_s[((q + i) * 2 + sub) * 16 + gq] = v[i][0];
        st_s[((q + i) * 2 + sub) * 16 + gq + 8] = v[i][1];
      }
    pair_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[i][r] = st_s[((q + i) * 2) * 16 + gq + 8 * r] +
                  st_s[((q + i) * 2 + 1) * 16 + gq + 8 * r];
  };

  const float scale = 1.f / sqrtf((float)HD);
  const int tps = (m + dec32::ROWS - 1) / dec32::ROWS, ntiles = bp * tps;
  const int c0 = 128 * sub, i0 = 64 * sub;
  float a_dbo[4], a_dbq[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a_dbo[i] = 0.f;
  a_dbq[0] = a_dbq[1] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int pair = tile / tps, srow0 = (tile - pair * tps) * dec32::ROWS;
    const int row0 = srow0 + 16 * slot, valid = min(16, m - row0);
    const bool ok0 = gq < valid, ok1 = gq + 8 < valid;
    const size_t r0 = (size_t)pair * m + row0 + gq, r1 = r0 + 8;
    __syncthreads();  // the previous tile is done with the rows
    dec32::rows_async<C, LDX>(
        x_s, keys + ((size_t)(pair / pb) * m + srow0) * C, m - srow0);
    dec32::rows_async<C, LDX>(e_s, pe + (size_t)srow0 * C, m - srow0);
    cp_commit();
    float q[8][4];
    q_proj32(q, xs, es, wq, bq, ring, i0, lane);

    // per head: scores, softmax (p kept in f32), rnd(out) = rnd(p) . v
    const float* tk = tok_k + (size_t)pair * n_tok * I;
    const float* tv = tok_v + (size_t)pair * n_tok * I;
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * sub + hh;
      float p[4], o[2][4];
      head_dots32(p, q + 2 * hh, tk, h, n_tok, lane);
      softmax32(p, n_tok, lane);
      dec32::st2(ps + gq * LDP + h * TP + 2 * tq, p[0], p[1]);
      dec32::st2(ps + (gq + 8) * LDP + h * TP + 2 * tq, p[2], p[3]);
      if (ok0) dec32::st2(p_out + r0 * (NH * TP) + h * TP + 2 * tq, p[0], p[1]);
      if (ok1) dec32::st2(p_out + r1 * (NH * TP) + h * TP + 2 * tq, p[2], p[3]);
      head_mix32(o, p, tv, h, n_tok, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * h + 8 * n + 2 * tq;
        dec32::st2(os + gq * LDO32 + col, o[n][0], o[n][1]);
        dec32::st2(os + (gq + 8) * LDO32 + col, o[n][2], o[n][3]);
        if (ok0) dec32::st2(out_rows + r0 * I + col, o[n][0], o[n][1]);
        if (ok1) dec32::st2(out_rows + r1 * I + col, o[n][2], o[n][3]);
      }
    }

    // res = keys + (rnd(out) . Wo + bo), this warp's 128 columns
    float acc[16][4];
    dec32::zero<16>(acc);
    dec32::stream_product<I, C, WO_KS, 16>(
        acc, wo, ring, c0,
        [&](Frag& a, int k0) { load_a(a, os, LDO32, 0, k0, lane); }, lane);
    float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      const float2 k0 = dec32::ld2(xs + gq * LDX + col);
      const float2 k1 = dec32::ld2(xs + (gq + 8) * LDX + col);
      const float b0 = bo[col], b1 = bo[col + 1];
      acc[j][0] = k0.x + (acc[j][0] + b0);
      acc[j][1] = k0.y + (acc[j][1] + b1);
      acc[j][2] = k1.x + (acc[j][2] + b0);
      acc[j][3] = k1.y + (acc[j][3] + b1);
      st[0][0] += acc[j][0] + acc[j][1];
      st[0][1] += acc[j][2] + acc[j][3];
    }
    st[0][0] = quad_sum(st[0][0]);
    st[0][1] = quad_sum(st[0][1]);
    pair_sums(0, st);
    const float mu0 = st[0][0] * (1.f / C), mu1 = st[0][1] * (1.f / C);
    st[0][0] = st[0][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] -= mu0;
      acc[j][1] -= mu0;
      acc[j][2] -= mu1;
      acc[j][3] -= mu1;
      st[0][0] = fmaf(acc[j][0], acc[j][0], fmaf(acc[j][1], acc[j][1], st[0][0]));
      st[0][1] = fmaf(acc[j][2], acc[j][2], fmaf(acc[j][3], acc[j][3], st[0][1]));
    }
    st[0][0] = quad_sum(st[0][0]);
    st[0][1] = quad_sum(st[0][1]);
    pair_sums(2, st);
    const float rs0 = rsqrtf(st[0][0] * (1.f / C) + eps);
    const float rs1 = rsqrtf(st[0][1] * (1.f / C) + eps);
    const float* dy0 = dy + r0 * C;
    const float* dy1 = dy + r1 * C;
    float sm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // sum dyn, sum dyn yn
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      float vg[8], vb[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * gg + jj, col = c0 + 8 * j + 2 * tq;
        acc[j][0] *= rs0;  // yn
        acc[j][1] *= rs0;
        acc[j][2] *= rs1;
        acc[j][3] *= rs1;
        const float2 d0 = ok0 ? dec32::ld2(dy0 + col) : make_float2(0.f, 0.f);
        const float2 d1 = ok1 ? dec32::ld2(dy1 + col) : make_float2(0.f, 0.f);
        const float g0 = g[col], g1 = g[col + 1];
        vg[2 * jj] = d0.x * acc[j][0] + d1.x * acc[j][2];
        vg[2 * jj + 1] = d0.y * acc[j][1] + d1.y * acc[j][3];
        vb[2 * jj] = d0.x + d1.x;
        vb[2 * jj + 1] = d0.y + d1.y;
        sm[0][0] += d0.x * g0 + d0.y * g1;
        sm[1][0] = fmaf(d0.x * g0, acc[j][0], fmaf(d0.y * g1, acc[j][1], sm[1][0]));
        sm[0][1] += d1.x * g0 + d1.y * g1;
        sm[1][1] = fmaf(d1.x * g0, acc[j][2], fmaf(d1.y * g1, acc[j][3], sm[1][1]));
      }
      const int col = group_col(4 * sub + gg, lane);
      cs[col] += group_sum8(vg, lane);
      cs[C + col] += group_sum8(vb, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm[i][0] = quad_sum(sm[i][0]);
      sm[i][1] = quad_sum(sm[i][1]);
    }
    pair_sums(4, sm);
    const float mdy0 = sm[0][0] * (1.f / C), mdyy0 = sm[1][0] * (1.f / C);
    const float mdy1 = sm[0][1] * (1.f / C), mdyy1 = sm[1][1] * (1.f / C);
    // d_res = rstd (dyn - mean dyn - yn mean(dyn yn)) over the keys rows and
    // to the scratch rows
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      float vo[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * gg + jj, col = c0 + 8 * j + 2 * tq;
        const float2 d0 = ok0 ? dec32::ld2(dy0 + col) : make_float2(0.f, 0.f);
        const float2 d1 = ok1 ? dec32::ld2(dy1 + col) : make_float2(0.f, 0.f);
        const float g0 = g[col], g1 = g[col + 1];
        const float e0 = rs0 * (d0.x * g0 - mdy0 - acc[j][0] * mdyy0);
        const float e1 = rs0 * (d0.y * g1 - mdy0 - acc[j][1] * mdyy0);
        const float e2 = rs1 * (d1.x * g0 - mdy1 - acc[j][2] * mdyy1);
        const float e3 = rs1 * (d1.y * g1 - mdy1 - acc[j][3] * mdyy1);
        vo[2 * jj] = e0 + e2;
        vo[2 * jj + 1] = e1 + e3;
        dec32::st2(xs + gq * LDX + col, e0, e1);
        dec32::st2(xs + (gq + 8) * LDX + col, e2, e3);
        if (ok0) dec32::st2(dres_rows + r0 * C + col, e0, e1);
        if (ok1) dec32::st2(dres_rows + r1 * C + col, e2, e3);
      }
      a_dbo[gg] += group_sum8(vo, lane);
    }

    // d_out = d_res . Wo^T, this warp's 64 lanes
    float d[8][4];
    dec32::zero<8>(d);
    dec32::stream_product<C, I, WQ_KS, 8>(
        d, wot, ring, i0,
        [&](Frag& a, int k0) { load_a(a, xs, LDX, 0, k0, lane); }, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = i0 + 8 * j + 2 * tq;
      if (ok0) dec32::st2(dout + r0 * I + col, d[j][0], d[j][1]);
      if (ok1) dec32::st2(dout + r1 * I + col, d[j][2], d[j][3]);
    }

    // per head: d_p = d_out . v^T, the softmax backward, d_qpre = (d_score
    // . k) / 4 over the rnd(out) rows and to the rows
    float vq[8];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = 4 * sub + hh;
      float dp[4];
      head_dots32(dp, d + 2 * hh, tv, h, n_tok, lane);
      const float2 pa = dec32::ld2(ps + gq * LDP + h * TP + 2 * tq);
      const float2 pc = dec32::ld2(ps + (gq + 8) * LDP + h * TP + 2 * tq);
      const float p[4] = {pa.x, pa.y, pc.x, pc.y};
      float ds[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = p[2 * r] * dp[2 * r], x1 = p[2 * r + 1] * dp[2 * r + 1];
        const float sum = quad_sum(x0 + x1);
        ds[2 * r] = x0 - p[2 * r] * sum;  // p == 0 past n_tok
        ds[2 * r + 1] = x1 - p[2 * r + 1] * sum;
      }
      if (ok0) dec32::st2(ds_out + r0 * (NH * TP) + h * TP + 2 * tq, ds[0], ds[1]);
      if (ok1) dec32::st2(ds_out + r1 * (NH * TP) + h * TP + 2 * tq, ds[2], ds[3]);
      float dq[2][4];
      head_mix32(dq, ds, tk, h, n_tok, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] *= scale;
        vq[(hh & 1) * 4 + 2 * n] = dq[n][0] + dq[n][2];
        vq[(hh & 1) * 4 + 2 * n + 1] = dq[n][1] + dq[n][3];
        const int col = 16 * h + 8 * n + 2 * tq;
        dec32::st2(os + gq * LDO32 + col, dq[n][0], dq[n][1]);
        dec32::st2(os + (gq + 8) * LDO32 + col, dq[n][2], dq[n][3]);
        if (ok0) dec32::st2(dqpre + r0 * I + col, dq[n][0], dq[n][1]);
        if (ok1) dec32::st2(dqpre + r1 * I + col, dq[n][2], dq[n][3]);
      }
      if (hh & 1) a_dbq[hh / 2] += group_sum8(vq, lane);
    }

    // d_keys = d_res + d_qpre . Wq^T, this warp's 128 columns
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      const float2 e0 = dec32::ld2(xs + gq * LDX + col);
      const float2 e1 = dec32::ld2(xs + (gq + 8) * LDX + col);
      acc[j][0] = e0.x;
      acc[j][1] = e0.y;
      acc[j][2] = e1.x;
      acc[j][3] = e1.y;
    }
    dec32::stream_product<I, C, WO_KS, 16>(
        acc, wqt, ring, c0,
        [&](Frag& a, int k0) { load_a(a, os, LDO32, 0, k0, lane); }, lane);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      if (ok0) dec32::st2(dkeys + r0 * C + col, acc[j][0], acc[j][1]);
      if (ok1) dec32::st2(dkeys + r1 * C + col, acc[j][2], acc[j][3]);
    }
  }

  __syncthreads();  // cs holds the slot's sums
  const size_t wg = (size_t)blockIdx.x * dec32::SLOTS + slot;
#pragma unroll
  for (int gg = 0; gg < 4; ++gg)
    dbo_p[wg * C + group_col(4 * sub + gg, lane)] = a_dbo[gg];
#pragma unroll
  for (int gg = 0; gg < 2; ++gg)
    dbq_p[wg * I + group_col(2 * sub + gg, lane)] = a_dbq[gg];
  for (int i = 32 * sub + lane; i < C; i += 64) {
    dg_p[wg * C + i] = cs[i];
    dbt_p[wg * C + i] = cs[C + i];
  }
}

// The f32 weight pass: block (chunk, kind, half) sums over the chunk's rows
//   kind 0: dWo   [I][C] = rnd(out)^T . rnd(d_res)
//   kind 1: dWq^T [I][C] = d_qpre^T . (keys[pair / pb] + pe)
// the C columns 128 half.. of it into part[kind][chunk]; warp w owns rows
// 32 (w / 2).., columns 64 (w % 2).. of the half
constexpr int DW32_LD = I + 8;  // rows of 128 floats: X, and half of Y
static_assert(I == C / 2, "X rows and half a Y row have one width");
constexpr int DW32_STAGE = dec::DW_SR * 3 * DW32_LD;  // X, Y, pe
constexpr size_t DW32_SMEM = sizeof(float) * (size_t)dec::DW_STAGES * DW32_STAGE;

__global__ void __launch_bounds__(dec::DW_THREADS, 1)
    i2t_bwd_dw_tf32_kernel(const float* keys, const float* pe,
                           const float* dqpre, const float* out_rows,
                           const float* dres_rows, float* part, int m, int pb,
                           int rows, int chunk) {
  using attn::mma::cp_async16;
  extern __shared__ __align__(16) float smem32[];
  const int kind = blockIdx.y >> 1, half = blockIdx.y & 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = blockIdx.x * chunk, hi = min(rows, lo + chunk);
  const float* xsrc = kind ? dqpre : out_rows;
  const int cy = (C / 2) * half;  // the half's first column of C
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) dec32::zero<8>(acc[a]);

  auto load = [&](int st, int r0) {
    float* xs = smem32 + st * DW32_STAGE;
    float* ys = xs + dec::DW_SR * DW32_LD;
    float* es = ys + dec::DW_SR * DW32_LD;
    for (int i = threadIdx.x; i < dec::DW_SR * (I / 4); i += dec::DW_THREADS) {
      const int r = i / (I / 4), c = (i % (I / 4)) * 4;
      const int row = r0 + r;
      const bool ok = row < hi;
      cp_async16(xs + r * DW32_LD + c, xsrc + (ok ? (size_t)row * I + c : 0), ok);
      if (kind == 0) {
        cp_async16(ys + r * DW32_LD + c,
                   dres_rows + (ok ? (size_t)row * C + cy + c : 0), ok);
      } else {
        const int pair = ok ? row / m : 0, rr = ok ? row - pair * m : 0;
        cp_async16(ys + r * DW32_LD + c,
                   keys + ((size_t)(pair / pb) * m + rr) * C + cy + c, ok);
        cp_async16(es + r * DW32_LD + c, pe + (size_t)rr * C + cy + c, ok);
      }
    }
  };
  auto prep = [&](int st) {  // kind 1: keys -> keys + pe in place
    if (kind == 0) return false;
    float* ys = smem32 + st * DW32_STAGE + dec::DW_SR * DW32_LD;
    const float* es = ys + dec::DW_SR * DW32_LD;
    for (int i = threadIdx.x; i < dec::DW_SR * I; i += dec::DW_THREADS) {
      const int r = i / I, c = i % I;
      ys[r * DW32_LD + c] += es[r * DW32_LD + c];
    }
    return true;
  };
  const int a0 = 32 * (warp / 2), b0 = 64 * (warp % 2);
  auto mma = [&](int st) {
    const float* xs = smem32 + st * DW32_STAGE;
    dec32::dw_stage_tf32<DW32_LD, DW32_LD>(acc, xs, a0, xs + dec::DW_SR * DW32_LD,
                                           b0, lane);
  };
  dec::dw_ring(lo, hi, load, prep, mma);
  dec32::dw_store32(part + ((size_t)kind * gridDim.x + blockIdx.x) * I * C +
                        (size_t)a0 * C + cy + b0,
                    C, acc, lane);
}

int launch_fwd_tf32(const void* keys, const void* pe, const void* tok_k,
                    const void* tok_v, const void* wq, const void* bq,
                    const void* wo, const void* bo, const void* g,
                    const void* bt, void* out, int bp, int m, int pb,
                    int n_tok, int blocks, float eps, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TF32_SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_fwd_tf32_kernel<<<blocks, dec32::THREADS, TF32_SMEM, stream>>>(
      static_cast<const float*>(keys), static_cast<const float*>(pe),
      static_cast<const float*>(tok_k), static_cast<const float*>(tok_v),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<float*>(out), bp, m, pb, n_tok, eps);
  return (int)cudaGetLastError();
}

int launch_bwd_rows_tf32(void* const* a, int bp, int m, int pb, int n_tok,
                         int blocks, float eps, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || blocks < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_rows_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ROWS_TF32_SMEM);
  if (e != cudaSuccess) return (int)e;
  auto in = [&](int i) { return static_cast<const float*>(a[i]); };
  auto out = [&](int i) { return static_cast<float*>(a[i]); };
  i2t_bwd_rows_tf32_kernel<<<blocks, dec32::THREADS, ROWS_TF32_SMEM,
                             stream>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7), in(8), in(9),
      in(10), out(11), out(12), out(13), out(14), out(15), out(16), out(17),
      out(18), out(19), out(20), out(21), in(22), in(23), bp, m, pb, n_tok,
      eps);
  return (int)cudaGetLastError();
}

int launch_bwd_dw_tf32(void* const* a, int bp, int m, int pb, int chunk,
                       int nchunks, cudaStream_t stream) {
  const int rows = bp * m;
  if (pb < 1 || bp % pb || chunk < 1 || chunk % dec::DW_SR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DW32_SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_bwd_dw_tf32_kernel<<<dim3(nchunks, 4), dec::DW_THREADS, DW32_SMEM,
                           stream>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const float*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<float*>(a[5]), m, pb,
      rows, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward on `blocks` persistent blocks: bf16 i2t_fwd_mma_kernel, f32
// i2t_fwd_tf32_kernel.
int dhoct_i2t_fwd(const void* keys, const void* pe, const void* tok_k,
                  const void* tok_v, const void* wq, const void* bq,
                  const void* wo, const void* bo, const void* g,
                  const void* bt, void* out, int bp, int m, int pb, int n_tok,
                  int blocks, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || m < 1)
    return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_fwd_mma(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                              out, bp, m, pb, n_tok, blocks, eps, s)
             : launch_fwd_tf32(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                               out, bp, m, pb, n_tok, blocks, eps, s);
}

// The row pass on `blocks` persistent blocks (bf16 i2t_bwd_rows_kernel, f32
// i2t_bwd_rows_tf32_kernel). a: keys, pe, tok_k, tok_v, wq, bq, wo, bo, g,
// bt, dy; outputs d_keys, d_qpre, p, d_score, d_out, the rnd(out) and
// rnd(d_res) scratch rows, and per-slot partials of dbq, dbo, dg, dbt; f32
// also takes wq^T and wo^T (a[22], a[23]).
int dhoct_i2t_bwd_rows(void* const* a, int bp, int m, int pb, int n_tok,
                       int blocks, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd_rows(a, bp, m, pb, n_tok, blocks, eps, s)
             : launch_bwd_rows_tf32(a, bp, m, pb, n_tok, blocks, eps, s);
}

// The weight pass (bf16 i2t_bwd_dw_kernel, f32 i2t_bwd_dw_tf32_kernel).
// a[6]: keys, pe, d_qpre, rnd(out), rnd(d_res), and the partials
// [2][nchunks][I][C] (dWo, dWq^T) of row chunks of `chunk` rows.
int dhoct_i2t_bwd_dw(void* const* a, int bp, int m, int pb, int chunk,
                     int nchunks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_bwd_dw(a, bp, m, pb, chunk, nchunks, s)
                    : launch_bwd_dw_tf32(a, bp, m, pb, chunk, nchunks, s);
}

const char* dhoct_i2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
