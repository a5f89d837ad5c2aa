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
//    persistent blocks walk units of image rows and the pb pairs of each
//    image (the q projection once per image tile).
//    * bf16 (the training path): i2t_fwd_wgmma_kernel, its products on
//      wgmma (the per-head ones on mma.sync), its keys landed by TMA into
//      a ring beside Wq and Wo, units of 64 rows (see the kernel).
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
//    one partial per warp, slot or chunk, added up in a fixed order (by the
//    wrapper, or for the bf16 weight pass by i2t_dw_sum_kernel in the same
//    call) -- no atomics, so the gradients repeat bit for bit.
//    * bf16: i2t_bwd_rows_wgmma_kernel (on bf16 wgmma, its rows landed by
//      TMA into a ring beside Wq and Wo, see the kernel) and
//      i2t_bwd_dw_wgmma_kernel (on bf16 wgmma, both operands landed by
//      TMA, see the kernel).
//    * f32: i2t_bwd_rows_tf32_kernel (super-tiles of 64 rows streaming Wq,
//      Wo, Wo^T and Wq^T) and i2t_bwd_dw_tf32_kernel (on TF32 wgmma, its
//      rows landed by TMA), in split TF32; rnd() is the identity, so the
//      scratch rows are f32.
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
//    JAX kernel, so each term is exact), its row pass the four projections
//    on wgmma and the per-head products on the CUDA cores; f32 as hi.hi +
//    hi.lo + lo.hi on
//    m16n8k8 TF32, the per-head products too (4 of every 270 kFLOP of a
//    row: splitting them costs less than a second path through FMAs). The
//    softmax over <= 8 tokens, the LayerNorm and their backwards run in f32
//    registers over a lane quad and the warp pair. In f32 the weights
//    (256 KB) do not fit in shared memory beside the rows; streaming them
//    per 64-row super-tile reads each weight byte from L2 once for 64 rows.
//    The f32 weight pass (dWo, dWq: 34 GFLOP at 64 pairs x 4096 rows, 103
//    with the split, 0.208 ms at split TF32's rate, against 808 MB of
//    rows read once: 0.241 ms; byte-bound) runs on TF32 wgmma m64n256k8
//    with TMA loads into a 4-stage mbarrier ring: each row is read from
//    device memory once, each element split once (see the kernel). The
//    bf16 one (34 GFLOP, 0.035 ms, against 403 MB at pb 1: 0.121 ms, and
//    287 MB at pb 8, where an image's keys serve 8 pairs: 0.086 ms;
//    byte-bound) has to stream at the memory's rate: its rows come by TMA
//    in 24-40 KB stages, straight into the layout bf16 wgmma reads (no
//    thread touches an operand but for kind 1's keys + pe), and its blocks
//    are split between the two weights by the bytes each reads, so that
//    one wave of blocks ends together. The bf16 row pass (69 GFLOP: 0.069
//    ms; 805 MB at pb 1: 0.241 ms, 688 MB at pb 8: 0.206 ms; byte-bound)
//    lands a unit's rows by TMA while the consumer warpgroups take turns,
//    and chains its four projections on wgmma with the weights read once
//    a block (see the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_tf32.cuh"
#include "hopper.cuh"

namespace {

constexpr int C = 256;            // channels
constexpr int I = 128;            // internal lanes
constexpr int NH = 8;             // heads
constexpr int HD = I / NH;        // 16
constexpr int TP = 8;             // token capacity

// ------------------------------- bf16 forward and backward, tensor cores ----
using dec::bf16;

// The per-head pieces of the bf16 forward (i2t_fwd_wgmma_kernel), on a
// warp's 16 rows: lane = 4 g + t holds rows g and g + 8 of every
// accumulator n-tile, columns 2t, 2t + 1 (mma.sync's layout and that of a
// wgmma accumulator's warp).

// A pair's token rows as the per-head products' B fragments, zero past
// n_tok: k[h] (token g; head dims 16 h + 2t, + 1 and + 8..) for the scores,
// v[h][n] (tokens 2t, 2t + 1 of head dim 16 h + 8 n + g) for p . v. Loaded
// a pair ahead, so that their latency hides behind a pair's products.
struct TokenFrags {
  uint32_t k[NH][2], v[NH][2];
};

__device__ __forceinline__ void token_frags(TokenFrags& f, const bf16* tk,
                                            const bf16* tv, int n_tok,
                                            int lane) {
  using namespace dec;
  const int gq = lane >> 2, tq = lane & 3;
  const bool tg = gq < n_tok, t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    f.k[h][0] = tg ? ld_u32(tk + gq * I + 16 * h + 2 * tq) : 0u;
    f.k[h][1] = tg ? ld_u32(tk + gq * I + 16 * h + 8 + 2 * tq) : 0u;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = 16 * h + 8 * n + gq;
      f.v[h][n] = pack_raw(t0 ? tv[2 * tq * I + d] : zero,
                           t1 ? tv[(2 * tq + 1) * I + d] : zero);
    }
  }
}

// head h: scores of qs (its A fragment qh) against the pair's tokens (one
// m16n8k16: head dim 16 x 8 tokens) and their softmax in f32 over a lane
// quad, -inf past n_tok: p[0..1] row g, p[2..3] row g + 8, tokens 2t,
// 2t + 1
__device__ __forceinline__ void head_softmax(float (&p)[4], const uint32_t* qh,
                                             const uint32_t (&kb)[2],
                                             int n_tok, int lane) {
  using namespace dec;
  const int tq = lane & 3;
  const bool t0 = 2 * tq < n_tok, t1 = 2 * tq + 1 < n_tok;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(sc, qh, kb[0], kb[1]);
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

// head h: rnd(out) = rnd(rnd(p) . v) over the pair's tokens (m16n8k8) as
// the out projection's A fragment of k-step h: rows g, g + 8 of head dims
// 16 h + 2t.. (a[0], a[1]) and 16 h + 8 + 2t.. (a[2], a[3])
__device__ __forceinline__ void head_out(uint32_t (&a)[4], const float (&p)[4],
                                         const uint32_t (&vb)[2]) {
  using namespace dec;
  const uint32_t pa0 = pack_bf16(p[0], p[1]), pa1 = pack_bf16(p[2], p[3]);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    mma1688(o, pa0, pa1, vb[n]);
    a[2 * n] = pack_bf16(o[0], o[1]);
    a[2 * n + 1] = pack_bf16(o[2], o[3]);
  }
}

// The row pass on wgmma and TMA (i2t_bwd_rows_wgmma_kernel). A unit is 64
// rows (one m64 tile) of one pair: u = pair * tpp + tile, tpp = ceil(m /
// 64); block b takes units b, b + G, b + 2 G, ... (G blocks), and its two
// consumer warpgroups take them in turns, each a whole unit, so that one
// warpgroup's products run beside the other's CUDA-core work. A warpgroup
// owns whole rows: every product's N is all of C or I, so the row
// statistics reduce over a lane quad alone and each product's output is
// the next one's A fragments where its K is this one's N.
//   producer warpgroup (one lane of it): Wq and Wo once per block; per
//     unit two fills of a ring of three 32 KB slots, the keys (of the
//     pair's image) and the dy rows, as boxes of 64 columns x 64 rows in
//     the 128-byte swizzle (rows past M land as zero); fill f goes to slot
//     f % 3 once fill f - 3 is read.
//   consumers, per unit:
//     qin = rnd(keys + pe) into the q projection's A fragments, pe read
//       from device memory (2 MB, in L2), qpre = qin . Wq (16 wgmma
//       m64n128k16, Wq MN-major), q_s to the scratch;
//     per head (a rolled loop, two heads a step) on the CUDA cores (16 x
//       <= 8, the tokens through L1): the scores, a quad's partial sums
//       reduce-scattered so that lane t holds tokens 2t, 2t + 1 of its
//       rows; the softmax in f32; rnd(p) . v; p and rnd(out) to the
//       scratch;
//     proj = rnd(out) . Wo in two halves of 128 columns (wgmma m64n128k16,
//       A in registers, Wo MN-major), res = rnd(keys + rnd(proj + bo))
//       written over the keys in their slot;
//     the LayerNorm and its backward in f32: one pass over a row's res
//       and dy (a lane quad) for its variance and the backward's row sums,
//       to the scratch; then one over the unit's rows (lane tid: columns 2
//       tid, 2 tid + 1) for d_res, rnd(d_res) over dy in its slot (stored
//       from there to its rows by TMA) and the column sums dg, dbt, dbo;
//       the keys slot given back;
//     d_out = rnd(d_res) . Wo^T (16 wgmma m64n128k16 from shared memory, Wo
//       read K-major through the same copy), to the scratch;
//     per head (rolled), the softmax backward and d_qpre on the CUDA
//       cores, rnd(d_qpre) to the scratch; d_keys = rnd(d_res) +
//       rnd(d_qpre) . Wq^T (two halves of 128 columns, 8 wgmma m64n128k16
//       each, Wq read K-major, the accumulators first set to rnd(d_res)
//       from the slot), written over it and stored by TMA; the dy slot
//       given back once the store has read it.
//   The other rows leave registers as 16-byte row segments (store_quad) or,
//   p and d_score, as 4-byte words. dbq's column sums reduce over a warp's
//   16 rows by group_sum8 and over its units in registers (one partial per
//   consumer warp), dg, dbt and dbo's over a unit's rows in the pass above
//   (one partial per consumer warpgroup); the wrapper sums the partials in
//   a fixed order. (Each part costs about as much as each other:
//   utils/kernel_variants.py --target k4_rows times the kernel without
//   each.)
// Registers are the scarce resource, and the instruction cache: a version
// that held res in registers and unrolled every loop over heads and
// columns was 23 K instructions, spilled and ran at 2.7 ms (64 pairs x
// 4096 rows, NVIDIA H100 80GB HBM3 at 700 W, utils/kernel_variants.py);
// so no row of values stays in registers across a phase: they go through
// the slots and a per-warpgroup scratch in device memory (p_scratch, SCR
// f32, reused every unit, so it stays in L2), and the per-head and
// per-column loops are rolled. The scratch costs 18-20% of the kernel
// (0.90 -> 0.72 ms without its traffic at pb 1, NVIDIA H100 80GB HBM3
// at 700 W, kernel_variants.py no_scratch): shared memory and registers
// have no room for it.
// Shared memory: Wq (2 slabs of C rows x 64 columns) and Wo (4 slabs of I
// rows x 64 columns) in bf16, 128 KB, each slab as TMA lands it in the
// 128-byte swizzle: read MN-major (the forward products) and K-major (the
// backward ones) through the descriptors' transpose bits. A unit's keys, pe
// and dy would take 96 KB, so two units' stages do not fit beside the
// weights (227 KB a block): pe comes from L2 into registers, and the ring
// holds three slots for the two warpgroups' units' keys and dy. 128 KB + 3
// x 32 KB + 1 KB of alignment and barriers = 225.1 KB.
namespace rwb {

using attn::mma::pack_bf16;

constexpr int RR = 64;                      // rows of a unit
constexpr int BOX = RR * 128;               // 64 bf16 columns x RR rows
constexpr int SLOT = (C / 64) * BOX;        // one tensor's unit rows: 32 KB
constexpr int RING = 3;                     // slots: keys and dy fills
constexpr int WQ_SLAB = C * 128;            // C rows x 64 columns of Wq
constexpr int WO_SLAB = I * 128;            // I rows x 64 columns of Wo
constexpr int WEIGHTS = 2 * WQ_SLAB + 4 * WO_SLAB;
constexpr int CONSUMERS = 256, NTH = CONSUMERS + 128;
constexpr int WARPS = CONSUMERS / 32;       // partials a block
// registers a thread: 168 at launch (64K over 384 threads, in steps of 8);
// the producer's warpgroup gives back all but 40, the consumers take 232
// (128 x 40 + 256 x 232 <= 64K)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr size_t SMEM = 1024 + (size_t)RING * SLOT + WEIGHTS + 128;
static_assert(SMEM <= 232448, "shared memory of the bf16 row pass");
constexpr float SCALE = 0.25f;              // rnd(1 / sqrt(16)), exact
// a consumer warpgroup's scratch in device memory (f32 words): three areas
// of a 16-byte value per head and lane, then the row statistics
constexpr int AREA = NH * 128 * 4;
constexpr int SCR = 3 * AREA + RR * 4;

// byte offset of element (row, col) of a unit's C-wide rows in a slot
__device__ __forceinline__ int tile_off(int row, int col) {
  return hop::sw128_off<RR>(row, col);
}

using dec::store_quad;
using dec::up2;
using hop::lds_u32;

// Loads kept where they stand (volatile): the compiler would otherwise
// keep a value loaded once for a second use far away (a head's token rows
// from the forward heads for the backward ones, g and dy from the
// LayerNorm backward's first pass for its second) and run short of the
// registers the rest needs. Read-only data through the non-coherent path.
__device__ __forceinline__ float2 ldg_bf2(const bf16* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return up2(v);
}
__device__ __forceinline__ float2 ldg_f2(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

// a packed word to a row output where ok
__device__ __forceinline__ void store_word(bf16* at, bool ok, uint32_t w) {
  if (ok) *reinterpret_cast<uint32_t*>(at) = w;
}

// The scores (or d_p) of one head: part[r][tt] is the lane's share (its
// four head dims) of row r, token tt; reduce-scattered over the lane quad
// so that lane t ends with the sums of tokens 2t, 2t + 1 (t's bit 1 picks
// a half of the tokens, then bit 0 a quarter).
__device__ __forceinline__ void quad_tokens(const float (&part)[2][TP],
                                            float (&s)[2][2], int t) {
  const bool b1 = t & 2, b0 = t & 1;
  float w[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[r][i] = (b1 ? part[r][4 + i] : part[r][i]) +
                __shfl_xor_sync(0xffffffffu, b1 ? part[r][i] : part[r][4 + i],
                                2);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      s[r][e] = (b0 ? w[r][2 + e] : w[r][e]) +
                __shfl_xor_sync(0xffffffffu, b0 ? w[r][e] : w[r][2 + e], 1);
}

// The lane's four values (rows g, g + 8; head dims 2t, 2t + 1, 8 + 2t,
// 9 + 2t) of a head from its packed A fragment a0..a3
__device__ __forceinline__ void unpack_head(const uint32_t (&a)[4],
                                            float (&x)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 lo = up2(a[r]), hi = up2(a[2 + r]);
    x[r][0] = lo.x, x[r][1] = lo.y, x[r][2] = hi.x, x[r][3] = hi.y;
  }
}

// sum over the lane's four head dims of x[r] . row[tt] for every token
// (zero past n_tok): row = tok + 16 h + 2t, the token rows I apart
__device__ __forceinline__ void head_dots(float (&part)[2][TP],
                                          const float (&x)[2][4],
                                          const bf16* row, int n_tok) {
#pragma unroll
  for (int tt = 0; tt < TP; ++tt) {
    float2 a = make_float2(0.f, 0.f), b = a;
    if (tt < n_tok) {
      a = ldg_bf2(row + tt * I);
      b = ldg_bf2(row + tt * I + 8);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      part[r][tt] = fmaf(x[r][3], b.y,
                         fmaf(x[r][2], b.x, fmaf(x[r][1], a.y, x[r][0] * a.x)));
  }
}

// y[r][k] = sum over tokens of w(r, token) row[token][k], the lane's four
// head dims; w packed as two bf16 (tokens 2t, 2t + 1) per row in each lane
// of the quad, gathered lane by lane
__device__ __forceinline__ void head_mix(float (&y)[2][4],
                                         const uint32_t (&w)[2],
                                         const bf16* row, int n_tok,
                                         int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) y[r][0] = y[r][1] = y[r][2] = y[r][3] = 0.f;
#pragma unroll
  for (int tq = 0; tq < 4; ++tq) {
    const int src = (lane & ~3) | tq;
    const float2 w0 = up2(__shfl_sync(0xffffffffu, w[0], src));
    const float2 w1 = up2(__shfl_sync(0xffffffffu, w[1], src));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tt = 2 * tq + e;
      if (tt >= n_tok) continue;
      const float2 a = ldg_bf2(row + tt * I), b = ldg_bf2(row + tt * I + 8);
      const float v[4] = {a.x, a.y, b.x, b.y};
      const float c0 = e ? w0.y : w0.x, c1 = e ? w1.y : w1.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        y[0][k] = fmaf(c0, v[k], y[0][k]);
        y[1][k] = fmaf(c1, v[k], y[1][k]);
      }
    }
  }
}

// the packed A fragment of a head (rows g, g + 8; dims 2t.., 8 + 2t..)
// from the lane's four f32 values a row, each rounded to bf16
__device__ __forceinline__ void pack_head(uint32_t (&a)[4],
                                          const float (&y)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a[r] = pack_bf16(y[r][0], y[r][1]);
    a[2 + r] = pack_bf16(y[r][2], y[r][3]);
  }
}

// two heads' packed values (h - 1 and h: A fragments a, b) to rows r0 and
// r1 (each where ok) of a row array of I columns, at columns 16 (h - 1)..
__device__ __forceinline__ void store_heads(bf16* rows, size_t r0, size_t r1,
                                            bool ok0, bool ok1, int h,
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[4], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t w[4] = {a[r], a[2 + r], b[r], b[2 + r]};
    store_quad(rows + (r ? r1 : r0) * I + 16 * (h - 1), r ? ok1 : ok0, w, t);
  }
}

}  // namespace rwb

__global__ void __launch_bounds__(rwb::NTH, 1)
    i2t_bwd_rows_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_keys,
        const __grid_constant__ CUtensorMap tm_dy,
        const __grid_constant__ CUtensorMap tm_wq,
        const __grid_constant__ CUtensorMap tm_wo,
        const __grid_constant__ CUtensorMap tm_dres,
        const __grid_constant__ CUtensorMap tm_dkeys, const bf16* pe,
        const bf16* tok_k,
        const bf16* tok_v, const float* bq, const float* bo, const float* g,
        bf16* dqpre, bf16* p_out, bf16* ds_out, bf16* dout, bf16* out_rows,
        float* dbq_p, float* dbo_p,
        float* dg_p, float* dbt_p, float* p_scratch, int bp, int m, int pb,
        int n_tok, float eps) {
  using namespace hop;
  using namespace rwb;
  using attn::mma::pack_bf16;
  using attn::mma::quad_max;
  using attn::mma::quad_sum;
  using attn::mma::round_bf16;
  using dec::group_col;
  using dec::group_sum8;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array (shared accesses)
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* ring = base;  // RING slots of a unit's C-wide rows
  unsigned char* wq_s = ring + RING * SLOT;
  unsigned char* wo_s = wq_s + 2 * WQ_SLAB;
  // full[s]: slot s landed; empty[s]: slot s read
  uint64_t* full = reinterpret_cast<uint64_t*>(wo_s + 4 * WO_SLAB);
  uint64_t* empty = full + RING;
  uint64_t* wbar = empty + RING;
  const int tpp = (m + RR - 1) / RR, units = bp * tpp;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < RING; ++i) mbar_init(empty + i, 4);  // a lane a warp
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= WARPS) {  // ---------------------------- producer warpgroup ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > WARPS || lane != 0) return;
    mbar_expect_tx(wbar, WEIGHTS);
    for (int s = 0; s < 2; ++s)
      tma_load_2d(wq_s + s * WQ_SLAB, &tm_wq, wbar, 64 * s, 0);
    for (int s = 0; s < 4; ++s)
      tma_load_2d(wo_s + s * WO_SLAB, &tm_wo, wbar, 64 * s, 0);
    // fills 2 k and 2 k + 1 of the ring, the k-th unit's keys and dy, into
    // slot f % RING once its fill f - RING is read
    int f = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int pair = u / tpp, r0 = (u - pair * tpp) * RR;
#pragma unroll
      for (int j = 0; j < 2; ++j, ++f) {
        const int sl = f % RING;
        mbar_wait(empty + sl, ((f / RING) & 1) ^ 1);
        mbar_expect_tx(full + sl, SLOT);
#pragma unroll
        for (int b = 0; b < C / 64; ++b)
          tma_load_3d(ring + sl * SLOT + b * BOX, j ? &tm_dy : &tm_keys,
                      full + sl, 64 * b, r0, j ? pair : pair / pb);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = warp >> 2, g8 = lane >> 2, t = lane & 3;
  const int R0 = 16 * (warp & 3) + g8;  // the lane's rows R0, R0 + 8
  const int tid = threadIdx.x & 127, bar = 1 + wgi;
  auto release = [&](int j) {  // this warp has read slot j
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j);
  };
  // the warpgroup's scratch (SCR f32 in device memory, reused each unit, so
  // it stays in L2): per head and lane a 16-byte value of each area, q_s
  // (then d_out), rnd(out) (then rnd(d_qpre)), f32 p; and the unit's row
  // statistics (mu, rstd, mean dyn, mean dyn yn) by row
  float* scr = p_scratch + (size_t)(blockIdx.x * 2 + wgi) * SCR;
  uint4* qsv = reinterpret_cast<uint4*>(scr) + tid;
  uint4* ofv = reinterpret_cast<uint4*>(scr + AREA) + tid;
  float4* pv = reinterpret_cast<float4*>(scr + 2 * AREA) + tid;
  float4* rowst = reinterpret_cast<float4*>(scr + 3 * AREA);
  // the column sums: dbq per warp (group_sum8 over its 16 rows, then its
  // units), dg, dbt and dbo of columns 2 tid, 2 tid + 1 per warpgroup
  float a_dbq[4] = {0.f, 0.f, 0.f, 0.f};
  // (the column pass: lane 16 h + i of warp w takes columns 4 c.., c = 16
  // w + i, of rows 32 h..; the halves are added at the end)
  float4 a_dg = make_float4(0.f, 0.f, 0.f, 0.f), a_dbt = a_dg, a_dbo = a_dg;
  const int c4 = 4 * (16 * (warp & 3) + (lane & 15)), rh = 32 * (lane >> 4);
  const float2 g2[2] = {ldg_f2(g + c4), ldg_f2(g + c4 + 2)};
  // the weights' wgmma descriptors: MN-major (q and out projections) and
  // K-major (d_out, d_keys); a k or column step moves the address field
  // (bytes / 16) alone
  const uint64_t d_wq_mn = desc(wq_s, WQ_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_wo_mn = desc(wo_s, WO_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_wq_k = desc(wq_s, 16, 1024, LAYOUT_SW128);
  const uint64_t d_wo_k = desc(wo_s, 16, 1024, LAYOUT_SW128);
  mbar_wait(wbar, 0);

  int n = 0;  // this warpgroup's units so far
  for (int u = blockIdx.x + wgi * gridDim.x; u < units;
       u += 2 * gridDim.x, ++n) {
    // the unit is the block's k-th: its keys are fill 2 k of the ring, its
    // dy fill 2 k + 1
    const int fk = 2 * (2 * n + wgi), fd = fk + 1;
    unsigned char* ks = ring + (fk % RING) * SLOT;  // keys, then res
    unsigned char* ys = ring + (fd % RING) * SLOT;  // dy, then rnd(d_res)
    const uint64_t d_ys = desc(ys, 16, 1024, LAYOUT_SW128);
    const int pair = u / tpp, r0 = (u - pair * tpp) * RR;
    const bool ok0 = r0 + R0 < m, ok1 = r0 + R0 + 8 < m;
    const size_t row0 = (size_t)pair * m + r0 + R0, row1 = row0 + 8;
    const bf16* tk = tok_k + (size_t)pair * n_tok * I + 2 * t;
    const bf16* tv = tok_v + (size_t)pair * n_tok * I + 2 * t;

    // qin = rnd(keys + pe) as the q projection's A fragments: the keys
    // from their slot, pe from device memory (2 MB: it stays in L2; a row
    // past M reads row M - 1, its keys are zero and its dy too, so it adds
    // nothing to any sum), then qpre = qin . Wq -> qs = rnd(rnd(qpre + bq)
    // * rnd(1/4)), a head's A fragment to the scratch
    mbar_wait(full + fk % RING, (fk / RING) & 1);
    {
      const bf16* per[2] = {pe + (size_t)min(r0 + R0, m - 1) * C,
                            pe + (size_t)min(r0 + R0 + 8, m - 1) * C};
      uint32_t qa[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i & 1, col = 16 * kk + 8 * (i >> 1) + 2 * t;
          const float2 x = up2(lds_u32(ks + tile_off(R0 + 8 * r, col)));
          const float2 z = up2(__ldg(reinterpret_cast<const unsigned int*>(
              per[r] + col)));
          qa[kk][i] = pack_bf16(x.x + z.x, x.y + z.y);
        }
      float acc[64];
      fence_operands(qa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        mma_bf16_rs_mn<128>(
            acc, qa[kk], d_wq_mn + 128 * kk,
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        uint32_t q[4];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = 2 * h + e2;
          const float2 b = ldg_f2(bq + 8 * j + 2 * t);
          q[2 * e2] = pack_bf16(round_bf16(acc[4 * j] + b.x) * SCALE,
                                round_bf16(acc[4 * j + 1] + b.y) * SCALE);
          q[2 * e2 + 1] = pack_bf16(round_bf16(acc[4 * j + 2] + b.x) * SCALE,
                                    round_bf16(acc[4 * j + 3] + b.y) * SCALE);
        }
        qsv[h * 128] = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }

    // per head (two a step): scores, softmax (f32 p to the scratch),
    // rnd(out) = rnd(rnd(p) . v), the out projection's A fragment, to the
    // scratch and to the rows
#pragma unroll 1
    for (int h2 = 0; h2 < NH; h2 += 2) {
      uint32_t of[2][4];
      const uint4 qv2[2] = {qsv[h2 * 128], qsv[(h2 + 1) * 128]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = h2 + i;
        const uint4 qv = qv2[i];
        const uint32_t q[4] = {qv.x, qv.y, qv.z, qv.w};
        float x[2][4], part[2][TP], s[2][2], p[4];
        unpack_head(q, x);
        head_dots(part, x, tk + 16 * h, n_tok);
        quad_tokens(part, s, t);
        const bool v0 = 2 * t < n_tok, v1 = 2 * t + 1 < n_tok;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x0 = v0 ? s[r][0] : -INFINITY, x1 = v1 ? s[r][1] : -INFINITY;
          const float mx = quad_max(fmaxf(x0, x1));  // token 0 is real
          x0 = v0 ? expf(x0 - mx) : 0.f;
          x1 = v1 ? expf(x1 - mx) : 0.f;
          const float inv = 1.f / quad_sum(x0 + x1);
          p[2 * r] = x0 * inv;
          p[2 * r + 1] = x1 * inv;
        }
        pv[h * 128] = make_float4(p[0], p[1], p[2], p[3]);
        const uint32_t pr[2] = {pack_bf16(p[0], p[1]),
                                pack_bf16(p[2], p[3])};
        store_word(p_out + row0 * (NH * TP) + TP * h + 2 * t, ok0, pr[0]);
        store_word(p_out + row1 * (NH * TP) + TP * h + 2 * t, ok1, pr[1]);
        float y[2][4];
        head_mix(y, pr, tv + 16 * h, n_tok, lane);
        pack_head(of[i], y);
        ofv[h * 128] = make_uint4(of[i][0], of[i][1], of[i][2], of[i][3]);
      }
      store_heads(out_rows, row0, row1, ok0, ok1, h2 + 1, of[0], of[1], t);
    }

    // res = rnd(keys + rnd(rnd(out) . Wo + bo)) over the keys in their
    // slot (each lane reads and writes its own elements), which the
    // LayerNorm and its backward read back; the out projection in two
    // halves of 128 columns
    float sum[2] = {0.f, 0.f};
    {
      uint32_t of[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint4 v = ofv[h * 128];
        of[h][0] = v.x, of[h][1] = v.y, of[h][2] = v.z, of[h][3] = v.w;
      }
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float acc[64];
        fence_operands(of);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
          mma_bf16_rs_mn<128>(acc, of[h],
                              d_wo_mn + 2048 * hn + 128 * h,
                              h > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = 128 * hn + 8 * jj + 2 * t;
          const float2 b = ldg_f2(bo + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            unsigned char* at = ks + tile_off(R0 + 8 * r, col);
            const float2 kv = up2(lds_u32(at));
            const float x0 =
                round_bf16(kv.x + round_bf16(acc[4 * jj + 2 * r] + b.x));
            const float x1 =
                round_bf16(kv.y + round_bf16(acc[4 * jj + 2 * r + 1] + b.y));
            // exact: both are bf16 values
            *reinterpret_cast<uint32_t*>(at) = pack_bf16(x0, x1);
            sum[r] += x0 + x1;
          }
        }
      }
    }

    // the LayerNorm of rows g, g + 8 over the quad (the mean from the sums
    // above), and in one pass over res and dy its centred variance and its
    // backward's row sums of dyn = dy g and dyn (res - mu): mean dyn yn =
    // rstd mean(dyn (res - mu))
    mbar_wait(full + fd % RING, (fd / RING) & 1);  // dy landed
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mu = quad_sum(sum[r]) * (1.f / C);
      float v = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int j = 0; j < C / 8; ++j) {
        const int off = tile_off(R0 + 8 * r, 8 * j + 2 * t);
        const float2 gg = ldg_f2(g + 8 * j + 2 * t);
        const float2 d = up2(lds_u32(ys + off)), x = up2(lds_u32(ks + off));
        const float a0 = x.x - mu, a1 = x.y - mu;
        const float n0 = d.x * gg.x, n1 = d.y * gg.y;
        v = fmaf(a0, a0, fmaf(a1, a1, v));
        s1 += n0 + n1;
        s2 = fmaf(n0, a0, fmaf(n1, a1, s2));
      }
      const float rstd = rsqrtf(quad_sum(v) * (1.f / C) + eps);
      const float mdy = quad_sum(s1) * (1.f / C);
      const float mdyy = rstd * quad_sum(s2) * (1.f / C);
      if (t == 0) rowst[R0 + 8 * r] = make_float4(mu, rstd, mdy, mdyy);
    }
    named_sync(bar, 128);  // every row's statistics are in the scratch

    // a pass over the unit's rows, the lane's four columns of half of
    // them: d_res = rstd (dy g - mean dyn - yn mean(dyn yn)), rnd(d_res)
    // over dy in its slot (from there by TMA to the scratch rows), and the
    // column sums dg = sum dy yn, dbt = sum dy, dbo = sum d_res (f32)
#pragma unroll 4
    for (int R = rh; R < rh + RR / 2; ++R) {
      const float4 st = rowst[R];  // mu, rstd, mean dyn, mean dyn yn
      const int off = tile_off(R, c4);
      const uint2 dv = *reinterpret_cast<const uint2*>(ys + off);
      const uint2 xv = *reinterpret_cast<const uint2*>(ks + off);
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 d = up2(h ? dv.y : dv.x), x = up2(h ? xv.y : xv.x);
        const float y0 = (x.x - st.x) * st.y, y1 = (x.y - st.x) * st.y;
        const float e0 = st.y * (d.x * g2[h].x - st.z - y0 * st.w);
        const float e1 = st.y * (d.y * g2[h].y - st.z - y1 * st.w);
        w[h] = pack_bf16(e0, e1);
        if (h == 0) {
          a_dg.x = fmaf(d.x, y0, a_dg.x);
          a_dg.y = fmaf(d.y, y1, a_dg.y);
          a_dbt.x += d.x;
          a_dbt.y += d.y;
          a_dbo.x += e0;
          a_dbo.y += e1;
        } else {
          a_dg.z = fmaf(d.x, y0, a_dg.z);
          a_dg.w = fmaf(d.y, y1, a_dg.w);
          a_dbt.z += d.x;
          a_dbt.w += d.y;
          a_dbo.z += e0;
          a_dbo.w += e1;
        }
      }
      *reinterpret_cast<uint2*>(ys + off) = make_uint2(w[0], w[1]);
    }
    release(fk % RING);  // res read
    fence_proxy_async();
    named_sync(bar, 128);  // the slot holds rnd(d_res) of all 64 rows
    if (tid == 0) {  // (rows past M are not written)
#pragma unroll
      for (int b = 0; b < C / 64; ++b)
        tma_store_3d(&tm_dres, ys + b * BOX, 64 * b, r0, pair);
      bulk_commit();
    }

    // d_out = rnd(rnd(d_res) . Wo^T): a head's A fragment to the scratch
    // and to the rows
    {
      float acc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        mma_bf16_ss<128>(
            acc, d_ys + 512 * (kk >> 2) + 2 * (kk & 3),
            d_wo_k + 1024 * (kk >> 2) + 2 * (kk & 3),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      uint32_t df[2][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        uint32_t* d = df[h & 1];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = 2 * h + e2;
          d[2 * e2] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
          d[2 * e2 + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        qsv[h * 128] = make_uint4(d[0], d[1], d[2], d[3]);
        if (h & 1)
          store_heads(dout, row0, row1, ok0, ok1, h, df[0], df[1], t);
      }
    }

    // per head (two a step): d_p = d_out . v^T, d_score = rnd(p d_p - p
    // sum(p d_p)), d_qpre = rnd((d_score . k) / 4), the A fragment of
    // d_keys, to the scratch and the rows; dbq's f32 sums
#pragma unroll 1
    for (int h2 = 0; h2 < NH; h2 += 2) {
      uint32_t qd[2][4];
      float vq[8];
      const uint4 dv2[2] = {qsv[h2 * 128], qsv[(h2 + 1) * 128]};
      const float4 p42[2] = {pv[h2 * 128], pv[(h2 + 1) * 128]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = h2 + i;
        const uint4 dv = dv2[i];
        const float4 p4 = p42[i];
        const uint32_t df[4] = {dv.x, dv.y, dv.z, dv.w};
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        float x[2][4], part[2][TP], dp[2][2];
        unpack_head(df, x);
        head_dots(part, x, tv + 16 * h, n_tok);
        quad_tokens(part, dp, t);
        uint32_t dsp[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x0 = p[2 * r] * dp[r][0];
          const float x1 = p[2 * r + 1] * dp[r][1];
          const float sm = quad_sum(x0 + x1);
          // p == 0 past n_tok
          dsp[r] = pack_bf16(x0 - p[2 * r] * sm, x1 - p[2 * r + 1] * sm);
        }
        store_word(ds_out + row0 * (NH * TP) + TP * h + 2 * t, ok0, dsp[0]);
        store_word(ds_out + row1 * (NH * TP) + TP * h + 2 * t, ok1, dsp[1]);
        float y[2][4];
        head_mix(y, dsp, tk + 16 * h, n_tok, lane);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          y[0][k] *= SCALE;
          y[1][k] *= SCALE;
          vq[4 * i + k] = y[0][k] + y[1][k];
        }
        pack_head(qd[i], y);
        ofv[h * 128] = make_uint4(qd[i][0], qd[i][1], qd[i][2], qd[i][3]);
      }
      a_dbq[h2 >> 1] += group_sum8(vq, lane);
      store_heads(dqpre, row0, row1, ok0, ok1, h2 + 1, qd[0], qd[1], t);
    }

    // d_keys = rnd(d_res) + rnd(d_qpre) . Wq^T, in two halves of 128
    // columns, the accumulators first set to rnd(d_res) from the slot;
    // rnd(d_keys) over it once the TMA store of rnd(d_res) has read it,
    // then stored from there by TMA
    if (tid == 0) bulk_wait_read();
    named_sync(bar, 128);
    {
      uint32_t qd[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint4 v = ofv[h * 128];
        qd[h][0] = v.x, qd[h][1] = v.y, qd[h][2] = v.z, qd[h][3] = v.w;
      }
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float acc[64];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 x = up2(
                lds_u32(ys + tile_off(R0 + 8 * r, 128 * hn + 8 * jj + 2 * t)));
            acc[4 * jj + 2 * r] = x.x;
            acc[4 * jj + 2 * r + 1] = x.y;
          }
        fence_operands(qd);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
          mma_bf16_rs<128>(acc, qd[h],
                           d_wq_k + 2048 * (h >> 2) + 1024 * hn +
                               2 * (h & 3),
                           1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(
                ys + tile_off(R0 + 8 * r, 128 * hn + 8 * jj + 2 * t)) =
                pack_bf16(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_sync(bar, 128);  // the slot holds rnd(d_keys) of all 64 rows
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < C / 64; ++b)
        tma_store_3d(&tm_dkeys, ys + b * BOX, 64 * b, r0, pair);
      bulk_commit();
      bulk_wait_read();
    }
    release(fd % RING);  // (warp 0 after the store has read the slot)
  }

  if (tid == 0) bulk_wait();  // the last TMA stores are done
  const size_t pg = (size_t)blockIdx.x * 2 + wgi;  // the warpgroup's row
  auto halves = [&](float4 v) {  // rows 0..31, then rows 32..63
    v.x += __shfl_xor_sync(0xffffffffu, v.x, 16);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, 16);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, 16);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, 16);
    return v;
  };
  a_dg = halves(a_dg);
  a_dbt = halves(a_dbt);
  a_dbo = halves(a_dbo);
  if (rh == 0) {
    *reinterpret_cast<float4*>(dg_p + pg * C + c4) = a_dg;
    *reinterpret_cast<float4*>(dbt_p + pg * C + c4) = a_dbt;
    *reinterpret_cast<float4*>(dbo_p + pg * C + c4) = a_dbo;
  }
  const size_t pw = (size_t)blockIdx.x * WARPS + warp;  // the warp's row
#pragma unroll
  for (int grp = 0; grp < 4; ++grp)
    dbq_p[pw * I + group_col(grp, lane)] = a_dbq[grp];
}

// The forward on wgmma and TMA (i2t_fwd_wgmma_kernel). A unit is 64 image
// rows (one m64 tile) of one image: u = img * tpp + tile, tpp = ceil(m /
// 64); block b takes units b, b + G, b + 2 G, ... (G blocks), and its two
// warpgroups take them in turns, each a whole unit with all of its
// image's pb pairs, so that one warpgroup's products run beside the
// other's CUDA-core work. The pb pairs share the unit's keys, pe, qin and
// qs: the q projection runs once a unit. A warpgroup owns whole rows, and
// each of its warps 16 of them: every product's N is all of I or half of
// C, so the LayerNorm's row statistics reduce over a lane quad alone and
// no barrier joins two warps but the stores'.
//   loads: Wq and Wo once per block, as the row pass lands them (thread
//     0); a unit's keys into its warpgroup's 32 KB slot as boxes of 64
//     columns x 64 rows in the 128-byte swizzle (rows past M land as
//     zero), issued by the warpgroup's first thread once its last unit's
//     keys are read (while that unit's y is formed and stored).
//   per unit: qin = rnd(keys + pe) into the q projection's A
//     fragments (pe from device memory: 2 MB, in L2), qpre = qin . Wq (16
//     wgmma m64n128k16, Wq MN-major), qs = rnd(rnd(qpre + bq) * rnd(1/4))
//     kept as a head's A fragment each (32 registers); then per pair:
//       per head the scores (one m16n8k16 of qs against the pair's token
//       rows, head dim 16 x 8 tokens), the softmax in f32 over the lane
//       quad and rnd(out) = rnd(rnd(p) . v) (two m16n8k8): straight from
//       the accumulator fragments into the out projection's A fragments,
//       the token rows read through L1 (a pair's 4 KB serve all its
//       rows);
//       proj = rnd(out) . Wo in two halves of 128 columns (wgmma
//       m64n128k16, A in registers, Wo MN-major), res = rnd(keys +
//       rnd(proj + bo)) packed in registers (bf16 values: 64 words);
//       the LayerNorm over the lane quad (mean, then the centred
//       variance), y = rnd(yn g + bt) by halves of 128 columns into the
//       warp's 4 KB of its warpgroup's stage (16-byte row segments after a
//       quad transpose), stored from there by TMA, a warp its own 16 rows
//       (rows past M are not written), so no barrier joins the warps: y's
//       stores from registers cost the mma.sync kernel 0.06-0.08 ms and a
//       first version of this one 0.11-0.14 (NVIDIA H100 80GB HBM3 at
//       700 W, utils/kernel_variants.py --target k4_fwd). A half's values
//       are formed before the warp waits for its last store to read the
//       stage.
// Registers: qs 32, rnd(out) 32, an accumulator half 64 and res 64 at the
// widest point: more than a producer warpgroup's block leaves (168; 232
// after setmaxnreg still spilled), so there is none and each thread may
// take 255. Shared memory: Wq and Wo as the row pass holds them (128 KB),
// a keys slot and a y stage a warpgroup (2 x 48 KB): 225.1 KB.
namespace fwb {

using rwb::BOX;
using rwb::RR;
using rwb::SLOT;
using rwb::WEIGHTS;
using rwb::WO_SLAB;
using rwb::WQ_SLAB;

constexpr int RING = 2;                     // slots of a unit's keys
constexpr int STAGE = 2 * BOX;              // a warpgroup's y stage: 16 KB
constexpr int WROWS = 16;                   // a warp's rows: its y boxes
constexpr int NTH = 256;                    // two warpgroups
constexpr size_t SMEM =
    1024 + RING * (size_t)SLOT + 2 * (size_t)STAGE + WEIGHTS + 128;
static_assert(SMEM <= 232448, "shared memory of the bf16 forward");

}  // namespace fwb

__global__ void __launch_bounds__(fwb::NTH, 1)
    i2t_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_keys,
                         const __grid_constant__ CUtensorMap tm_wq,
                         const __grid_constant__ CUtensorMap tm_wo,
                         const __grid_constant__ CUtensorMap tm_y,
                         const bf16* pe, const bf16* tok_k, const bf16* tok_v,
                         const float* bq, const float* bo, const float* g,
                         const float* bt, int bp, int m, int pb, int n_tok,
                         float eps) {
  using namespace hop;
  using namespace fwb;
  using attn::mma::pack_bf16;
  using attn::mma::quad_sum;
  using attn::mma::round_bf16;
  using dec::quad_transpose;
  using rwb::ldg_f2;
  using rwb::lds_u32;
  using rwb::tile_off;
  using rwb::up2;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array (shared accesses)
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* ring = base;  // RING slots of a unit's keys
  unsigned char* stage = ring + RING * SLOT;  // the warpgroups' y stages
  unsigned char* wq_s = stage + 2 * STAGE;
  unsigned char* wo_s = wq_s + 2 * WQ_SLAB;
  // full[s]: slot s landed
  uint64_t* full = reinterpret_cast<uint64_t*>(wo_s + 4 * WO_SLAB);
  uint64_t* wbar = full + RING;
  const int tpp = (m + RR - 1) / RR, units = (bp / pb) * tpp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp >> 2, t = lane & 3;
  const int tid = threadIdx.x & 127, bar = 1 + wgi;
  const int R0 = 16 * (warp & 3) + (lane >> 2);  // the lane's rows R0, R0 + 8
  // the warp's rows of its warpgroup's stage: 2 KB of each 64-column box
  unsigned char* ys = stage + wgi * STAGE + (warp & 3) * WROWS * 128;
  // fill f: the keys of the block's f-th unit into slot f % RING, issued
  // where they are (a unit's first thread) once fill f - RING is read
  auto load_keys = [&](int f) {
    const int u = blockIdx.x + f * gridDim.x;
    if (u >= units) return;
    const int img = u / tpp, r0 = (u - img * tpp) * RR, sl = f % RING;
    mbar_expect_tx(full + sl, SLOT);
#pragma unroll
    for (int b = 0; b < C / 64; ++b)
      tma_load_3d(ring + sl * SLOT + b * BOX, &tm_keys, full + sl, 64 * b,
                  r0, img);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(full + i, 1);
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, WEIGHTS);
    for (int s = 0; s < 2; ++s)
      tma_load_2d(wq_s + s * WQ_SLAB, &tm_wq, wbar, 64 * s, 0);
    for (int s = 0; s < 4; ++s)
      tma_load_2d(wo_s + s * WO_SLAB, &tm_wo, wbar, 64 * s, 0);
    for (int f = 0; f < RING; ++f) load_keys(f);
  }

  const uint64_t d_wq_mn = desc(wq_s, WQ_SLAB, 1024, LAYOUT_SW128);
  const uint64_t d_wo_mn = desc(wo_s, WO_SLAB, 1024, LAYOUT_SW128);
  mbar_wait(wbar, 0);

  int n = 0;  // this warpgroup's units so far
  for (int u = blockIdx.x + wgi * gridDim.x; u < units;
       u += 2 * gridDim.x, ++n) {
    const int img = u / tpp, r0 = (u - img * tpp) * RR;
    const int f = 2 * n + wgi;  // the block's f-th unit
    unsigned char* ks = ring + (f % RING) * SLOT;

    // qin = rnd(keys + pe) as the q projection's A fragments (a row past
    // M reads pe row M - 1; its keys are zero and its y is not stored),
    // qpre = qin . Wq, qs = rnd(rnd(qpre + bq) * rnd(1/4)) as a head's A
    // fragment each
    mbar_wait(full + f % RING, (f / RING) & 1);
    uint32_t qf[NH][4];
    {
      const bf16* per[2] = {pe + (size_t)min(r0 + R0, m - 1) * C,
                            pe + (size_t)min(r0 + R0 + 8, m - 1) * C};
      uint32_t qa[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i & 1, col = 16 * kk + 8 * (i >> 1) + 2 * t;
          const float2 x = up2(lds_u32(ks + tile_off(R0 + 8 * r, col)));
          const float2 z = up2(__ldg(reinterpret_cast<const unsigned int*>(
              per[r] + col)));
          qa[kk][i] = pack_bf16(x.x + z.x, x.y + z.y);
        }
      float acc[64];
      fence_operands(qa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        mma_bf16_rs_mn<128>(acc, qa[kk], d_wq_mn + 128 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      const float scale = round_bf16(1.f / sqrtf((float)HD));
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = 2 * h + e2;
          const float2 b = ldg_f2(bq + 8 * j + 2 * t);
          qf[h][2 * e2] = pack_bf16(round_bf16(acc[4 * j] + b.x) * scale,
                                    round_bf16(acc[4 * j + 1] + b.y) * scale);
          qf[h][2 * e2 + 1] =
              pack_bf16(round_bf16(acc[4 * j + 2] + b.x) * scale,
                        round_bf16(acc[4 * j + 3] + b.y) * scale);
        }
    }

    TokenFrags tf;  // the pair's token rows, loaded a pair ahead
    token_frags(tf, tok_k + (size_t)img * pb * n_tok * I,
                tok_v + (size_t)img * pb * n_tok * I, n_tok, lane);
#pragma unroll 1
    for (int j = 0; j < pb; ++j) {
      const int pair = img * pb + j;
      // per head: softmax, rnd(out) as the out projection's A fragment of
      // k-step h
      uint32_t of[NH][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float p[4];
        head_softmax(p, qf[h], tf.k[h], n_tok, lane);
        head_out(of[h], p, tf.v[h]);
      }
      if (j + 1 < pb)  // the next pair's token rows, in flight meanwhile
        token_frags(tf, tok_k + (size_t)(pair + 1) * n_tok * I,
                    tok_v + (size_t)(pair + 1) * n_tok * I, n_tok, lane);
      // res = rnd(keys + rnd(rnd(out) . Wo + bo)), packed: res[r][jn] the
      // lane's columns 8 jn + 2t, + 1 of row R0 + 8 r
      uint32_t res[2][C / 8];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float acc[64];
        fence_operands(of);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h)
          mma_bf16_rs_mn<128>(acc, of[h], d_wo_mn + 2048 * hn + 128 * h,
                              h > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = 128 * hn + 8 * jj + 2 * t;
          const float2 b = ldg_f2(bo + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 kv = up2(lds_u32(ks + tile_off(R0 + 8 * r, col)));
            const float x0 =
                round_bf16(kv.x + round_bf16(acc[4 * jj + 2 * r] + b.x));
            const float x1 =
                round_bf16(kv.y + round_bf16(acc[4 * jj + 2 * r + 1] + b.y));
            res[r][16 * hn + jj] = pack_bf16(x0, x1);  // exact
            sum[r] += x0 + x1;
          }
        }
      }
      // the LayerNorm of rows R0, R0 + 8 over the quad (f32: the mean,
      // then the centred variance)
      float mu[2], rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mu[r] = quad_sum(sum[r]) * (1.f / C);
        float v = 0.f;
#pragma unroll
        for (int jn = 0; jn < C / 8; ++jn) {
          const float2 x = up2(res[r][jn]);
          const float a0 = x.x - mu[r], a1 = x.y - mu[r];
          v = fmaf(a0, a0, fmaf(a1, a1, v));
        }
        rs[r] = rsqrtf(quad_sum(v) * (1.f / C) + eps);
      }
      if (j == pb - 1) {
        named_sync(bar, 128);  // the unit's keys are read
        if (tid == 0) load_keys(f + RING);
      }
      // y = rnd(yn g + bt) (a product and a sum, each rounded, as the plain
      // version) by halves of 128 columns into the warp's rows of the
      // stage, four n-tiles a 16-byte segment of a row (a quad transpose),
      // then to the rows by TMA once the warp's last store has read them
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        uint32_t w[2][4][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int jn = 16 * hn + 4 * a + jj, col = 8 * jn + 2 * t;
              const float2 x = up2(res[r][jn]);
              const float2 gg = ldg_f2(g + col), tt = ldg_f2(bt + col);
              w[r][a][jj] = pack_bf16(
                  __fadd_rn(__fmul_rn(__fmul_rn(x.x - mu[r], rs[r]), gg.x),
                            tt.x),
                  __fadd_rn(__fmul_rn(__fmul_rn(x.y - mu[r], rs[r]), gg.y),
                            tt.y));
            }
            quad_transpose(w[r][a], t);
          }
        if (lane == 0) bulk_wait_read();
        __syncwarp();  // the warp's rows of the stage are free
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int a = 0; a < 4; ++a)
            *reinterpret_cast<uint4*>(
                ys + sw128_off<RR>(lane / 4 + 8 * r, 32 * a + 8 * t)) =
                make_uint4(w[r][a][0], w[r][a][1], w[r][a][2], w[r][a][3]);
        fence_proxy_async();
        __syncwarp();  // the stage holds y of the warp's rows
        if (lane == 0) {
          tma_store_3d(&tm_y, ys, 128 * hn, r0 + WROWS * (warp & 3), pair);
          tma_store_3d(&tm_y, ys + BOX, 128 * hn + 64,
                       r0 + WROWS * (warp & 3), pair);
          bulk_commit();
        }
      }
    }
  }
  if (lane == 0) bulk_wait();  // the warp's last TMA stores are done
}

// The bf16 weight pass on wgmma and TMA (i2t_bwd_dw_wgmma_kernel): block u
// sums, over the rows of its unit (a run of stages of one weight),
//   kind 0: dWo   [I][C] = rnd(out)^T . rnd(d_res)
//   kind 1: dWq^T [I][C] = rnd(d_qpre)^T . rnd(keys[pair / pb] + pe)
// into part[u], as one product of M = I = 128 rows x N = C = 256 columns
// over K = the unit's rows. Units 0..nchunks0-1 are dWo's chunks, the rest
// dWq^T's (ops/decoder_attn.py: dw_plan_bf16 gives dWq^T, which reads 1280
// bytes a row against dWo's 768, more and shorter chunks, so that the two
// kinds end together on one wave of blocks).
// A stage is dwb::SR = 32 rows of one pair: a pair's rows are cut into
// stages from its first row (its last stage may be shorter), and every
// tile comes by TMA as a box of a 3-D view (width, M, pairs) whose rows
// past M read as zero, so no row of a stage needs masking.
//   producer warp: per stage, X (rnd(out) or d_qpre: 2 boxes of 64 columns
//     x 32 rows) and Y (rnd(d_res), 4 boxes; kind 1: keys of the pair's
//     image and pe, 4 boxes each), all in the 128-byte swizzle, into a ring
//     of 8 stages of 24 KB (kind 0) or 5 of 40 KB (kind 1): 120-160 KB in
//     flight a block, enough to stream at the memory's rate.
//   consumers, two warpgroups: warpgroup w owns dW rows 64 w.. x all 256
//     columns (128 f32 accumulators a thread). bf16 wgmma reads both
//     operands MN-major from shared memory through its transpose bits, and
//     K (the row index) is the slow index of both tiles, so the boxes are
//     the operands as they land: X's box w is A = X^T, Y's four boxes are B
//     (LBO the 4 KB between them), one m64n256k16 per 16 rows. Kind 1 first
//     adds keys and pe in f32 and rounds the sum once to bf16, in place, as
//     the plain twin does (every consumer thread 4 x 16 bytes a stage), and
//     fences those writes for the async proxy. A stage's products run while
//     the next stage is added; the stage is given back once they are done.
// The partials are summed in unit order by i2t_dw_sum_kernel, launched
// after it: no atomics, the same bits every run.
namespace dwb {

constexpr int SR = 32;                         // rows of a stage
constexpr int BOX = SR * 128;                  // 64 bf16 columns x SR rows
constexpr int X_BYTES = (I / 64) * BOX;        // 8 KB
constexpr int Y_BYTES = (C / 64) * BOX;        // 16 KB, and as much of pe
constexpr int STAGE0 = X_BYTES + Y_BYTES;      // dWo: 24 KB
constexpr int STAGE1 = X_BYTES + 2 * Y_BYTES;  // dWq^T: 40 KB
constexpr int STAGES0 = 8, STAGES1 = 5;
constexpr int RING = STAGES1 * STAGE1;
constexpr int CONSUMERS = 256, NTH = CONSUMERS + 32;
constexpr size_t SMEM = 2048 + (size_t)RING;  // alignment slack, barriers
static_assert(STAGES0 * STAGE0 <= RING, "the dWo ring fits dWq^T's");
static_assert(SMEM <= 232448, "shared memory of the bf16 weight pass");

// rnd(keys + pe) in place of keys over a kind-1 stage's Y (keys and pe
// land in the same swizzled layout, so element i of one pairs with element
// i of the other), thread c of the consumers 4 x 16 bytes
__device__ __forceinline__ void add_pe(unsigned char* y, int c) {
  uint4* k = reinterpret_cast<uint4*>(y);
  const uint4* e = reinterpret_cast<const uint4*>(y + Y_BYTES);
#pragma unroll
  for (int i = c; i < Y_BYTES / 16; i += CONSUMERS) {
    uint4 a = k[i];
    const uint4 b = e[i];
    uint32_t* av = reinterpret_cast<uint32_t*>(&a);
    const uint32_t* bv = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(av + j));
      const float2 z = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bv + j));
      const __nv_bfloat162 sum = __floats2bfloat162_rn(x.x + z.x, x.y + z.y);
      av[j] = *reinterpret_cast<const uint32_t*>(&sum);
    }
    k[i] = a;
  }
}

}  // namespace dwb

__global__ void __launch_bounds__(dwb::NTH, 1)
    i2t_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_out,
                            const __grid_constant__ CUtensorMap tm_dqpre,
                            const __grid_constant__ CUtensorMap tm_dres,
                            const __grid_constant__ CUtensorMap tm_keys,
                            const __grid_constant__ CUtensorMap tm_pe,
                            float* part, int m, int pb, int stages_total,
                            int chunk0, int nchunks0, int chunk1) {
  using namespace hop;
  using namespace dwb;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array (shared accesses)
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + STAGES0;
  unsigned char* ring = base + 1024;
  const int u = blockIdx.x, kind = u >= nchunks0 ? 1 : 0;
  const int chunk = kind ? chunk1 : chunk0;
  const int s0 = (kind ? u - nchunks0 : u) * chunk;
  const int nst = min(stages_total, s0 + chunk) - s0;
  const int depth = kind ? STAGES1 : STAGES0;
  const int sbytes = kind ? STAGE1 : STAGE0;
  const int spp = (m + SR - 1) / SR;  // stages of a pair
  if (threadIdx.x == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);  // a lane of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == CONSUMERS / 32) {  // ----------------------------- producer ----
    if (lane != 0) return;
    for (int it = 0; it < nst; ++it) {
      const int st = it % depth, s = s0 + it;
      const int pair = s / spp, r0 = (s - pair * spp) * SR;
      unsigned char* x = ring + st * sbytes;
      mbar_wait(empty + st, ((it / depth) & 1) ^ 1);
      mbar_expect_tx(full + st, sbytes);
      for (int h = 0; h < I / 64; ++h)
        tma_load_3d(x + h * BOX, kind ? &tm_dqpre : &tm_out, full + st,
                    64 * h, r0, pair);
      for (int h = 0; h < C / 64; ++h) {
        unsigned char* y = x + X_BYTES + h * BOX;
        if (kind) {
          tma_load_3d(y, &tm_keys, full + st, 64 * h, r0, pair / pb);
          tma_load_3d(y + Y_BYTES, &tm_pe, full + st, 64 * h, r0, 0);
        } else {
          tma_load_3d(y, &tm_dres, full + st, 64 * h, r0, pair);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  const int wgi = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
  const int i0 = 64 * wgi + 16 * (warp & 3) + g;  // output rows i0, i0 + 8
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int it = 0; it < nst; ++it) {
    const int st = it % depth;
    unsigned char* x = ring + st * sbytes;
    mbar_wait(full + st, (it / depth) & 1);
    if (kind) {
      add_pe(x + X_BYTES, threadIdx.x);
      fence_proxy_async();
      named_sync(1, CONSUMERS);  // the whole B tile is written
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk)
      mma_bf16_ss_mn<256>(
          acc, desc(x + wgi * BOX + 2048 * kk, BOX, 1024, LAYOUT_SW128),
          desc(x + X_BYTES + 2048 * kk, BOX, 1024, LAYOUT_SW128), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    __syncwarp();
    if (it > 0 && lane == 0) mbar_arrive(empty + (it - 1) % depth);
  }
  wgmma_wait<0>();
  float* out = part + ((size_t)u * I + i0) * C;
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      dec32::st2(out + (size_t)(8 * h) * C + 8 * j + 2 * t,
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// a: keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy; d_keys, d_qpre, p,
// d_score, d_out, rnd(out), rnd(d_res); the partials of dbq, dbo, dg, dbt
// (blocks x rwb::WARPS rows each); the scratch of p, blocks x 2 x 8 x 512
// f32. The rows land through tensor maps over
// (C, M, images or pairs) bf16, boxes of 64 columns x 64 rows, the weights
// through maps over Wq (I, C) and Wo (C, I), boxes of 64 columns x all rows,
// all in the 128-byte swizzle.
// A (C, m, planes) bf16 row tensor as a 3-D tensor map: boxes of 64
// columns x `rows` rows in the 128-byte swizzle, what the wgmma kernels'
// slots hold (rows past m read as zero, and are not written by a store).
bool row_map(CUtensorMap* map, const void* src, int m, int planes,
             int rows = rwb::RR) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)m,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {2ull * C, 2ull * C * m};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return hop::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, src, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Wq (C, I) and Wo (I, C) as 2-D tensor maps: boxes of 64 columns x all
// rows in the 128-byte swizzle (the wgmma kernels' weight slabs)
bool weight_maps(CUtensorMap* maps, const void* wq, const void* wo) {
  const int wdims[2][2] = {{I, C}, {C, I}};
  const void* wsrc[2] = {wq, wo};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)wdims[i][0],
                                (cuuint64_t)wdims[i][1]};
    const cuuint64_t strides[1] = {2ull * wdims[i][0]};
    const cuuint32_t box[2] = {64, (cuuint32_t)wdims[i][1]};
    if (!hop::tensor_map(maps + i, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         wsrc[i], dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
      return false;
  }
  return true;
}

int launch_bwd_rows(void* const* a, int bp, int m, int pb, int n_tok,
                    int blocks, float eps, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || blocks < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  // keys and dy, then the rows stored from the slots: d_res, d_keys
  const void* srcs[4] = {a[0], a[10], a[17], a[11]};
  const int planes[4] = {bp / pb, bp, bp, bp};
  for (int i = 0; i < 4; ++i)
    if (!row_map(maps + i, srcs[i], m, planes[i]))
      return (int)cudaErrorInvalidValue;
  if (!weight_maps(maps + 4, a[4], a[6])) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_rows_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rwb::SMEM);
  if (e != cudaSuccess) return (int)e;
  auto in = [&](int i) { return static_cast<const bf16*>(a[i]); };
  auto out = [&](int i) { return static_cast<bf16*>(a[i]); };
  auto f = [&](int i) { return static_cast<float*>(a[i]); };
  i2t_bwd_rows_wgmma_kernel<<<blocks, rwb::NTH, rwb::SMEM, stream>>>(
      maps[0], maps[1], maps[4], maps[5], maps[2], maps[3], in(1), in(2),
      in(3), f(5), f(7), f(8), out(12), out(13), out(14), out(15), out(16),
      f(18), f(19), f(20), f(21), f(22), bp, m, pb, n_tok, eps);
  return (int)cudaGetLastError();
}

// out[kind] = the sum of the kind's partials (units 0..n0-1 for dWo, then
// n0..n0+n1-1 for dWq^T), unit by unit in order: a thread a float4 column.
// The partials were just written and sit in L2; with one float4 column a
// thread there are only 16 K threads, so each issues SUM_LOADS partials'
// loads before it adds them in order, to keep enough bytes in flight.
constexpr int SUM_LOADS = 16, SUM_THREADS = 256;
__global__ void __launch_bounds__(SUM_THREADS)
    i2t_dw_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                      int n0, int n1) {
  constexpr int COLS = I * C / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * COLS) return;
  const int kind = i >= COLS ? 1 : 0, col = i - kind * COLS;
  const int hi = kind ? n0 + n1 : n0;
  const float4* p = part + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float4 x) {
    acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
  };
  int u = kind ? n0 : 0;
  for (; u + SUM_LOADS <= hi; u += SUM_LOADS) {
    float4 x[SUM_LOADS];
#pragma unroll
    for (int j = 0; j < SUM_LOADS; ++j)
      x[j] = __ldg(p + (size_t)(u + j) * COLS);
#pragma unroll
    for (int j = 0; j < SUM_LOADS; ++j) add(x[j]);
  }
  for (; u < hi; ++u) add(__ldg(p + (size_t)u * COLS));
  out[i] = acc;
}

// a: keys, pe, d_qpre, rnd(out), rnd(d_res), part, out. chunk0 / chunk1:
// stages a dWo / dWq^T unit (the last of each kind may hold fewer),
// nchunks0 / nchunks1 their units; one block a unit, then the partials
// summed into out [2][I][C] (dWo, dWq^T).
int launch_bwd_dw(void* const* a, int bp, int m, int pb, int chunk0,
                  int nchunks0, int chunk1, int nchunks1,
                  cudaStream_t stream) {
  const int total = bp * ((m + dwb::SR - 1) / dwb::SR);
  auto covers = [&](int chunk, int n) {
    return chunk >= 1 && n >= 1 && (n - 1) * chunk < total &&
           n * chunk >= total;
  };
  if (pb < 1 || bp % pb || m < 1 || !covers(chunk0, nchunks0) ||
      !covers(chunk1, nchunks1))
    return (int)cudaErrorInvalidValue;
  // (width, M, pairs or images) bf16, boxes of 64 columns x SR rows
  CUtensorMap maps[5];
  const int widths[5] = {I, I, C, C, C};
  const int planes[5] = {bp, bp, bp, bp / pb, 1};
  const void* srcs[5] = {a[3], a[2], a[4], a[0], a[1]};
  for (int i = 0; i < 5; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)widths[i], (cuuint64_t)m,
                                (cuuint64_t)planes[i]};
    const cuuint64_t strides[2] = {2ull * widths[i], 2ull * widths[i] * m};
    const cuuint32_t box[3] = {64, (cuuint32_t)dwb::SR, 1};
    if (!hop::tensor_map(maps + i, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         srcs[i], dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dwb::SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_bwd_dw_wgmma_kernel<<<nchunks0 + nchunks1, dwb::NTH, dwb::SMEM,
                            stream>>>(maps[0], maps[1], maps[2], maps[3],
                                      maps[4], static_cast<float*>(a[5]), m,
                                      pb, total, chunk0, nchunks0, chunk1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i2t_dw_sum_kernel<<<(2 * I * C / 4 + SUM_THREADS - 1) / SUM_THREADS,
                      SUM_THREADS, 0, stream>>>(
      static_cast<const float4*>(a[5]), static_cast<float4*>(a[6]), nchunks0,
      nchunks1);
  return (int)cudaGetLastError();
}

int launch_fwd_wgmma(const void* keys, const void* pe, const void* tok_k,
                     const void* tok_v, const void* wq, const void* bq,
                     const void* wo, const void* bo, const void* g,
                     const void* bt, void* out, int bp, int m, int pb,
                     int n_tok, int blocks, float eps, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];  // keys, Wq, Wo, y (in boxes of a warp's rows)
  if (!row_map(maps, keys, m, bp / pb) || !weight_maps(maps + 1, wq, wo) ||
      !row_map(maps + 3, out, m, bp, fwb::WROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwb::SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_fwd_wgmma_kernel<<<blocks, fwb::NTH, fwb::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(pe),
      static_cast<const bf16*>(tok_k), static_cast<const bf16*>(tok_v),
      static_cast<const float*>(bq), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(bt), bp, m, pb,
      n_tok, eps);
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

// The f32 weight pass on wgmma and TMA: block units (chunk, kind) sum over
// the chunk's rows
//   kind 0: dWo   [I][C] = rnd(out)^T . rnd(d_res)
//   kind 1: dWq^T [I][C] = d_qpre^T . (keys[pair / pb] + pe)
// into part[kind][chunk], as one product of M = I = 128 rows x N = C = 256
// columns over K = the chunk's rows. Persistent blocks walk the units with
// a producer warp and two consumer warpgroups, warpgroup w owning output
// rows 64 w.. x all 256 columns (128 f32 accumulators a thread).
//   producer: per stage of dw32::KR = 16 rows, the X rows (rnd(out) or
//     d_qpre, 16 x 128 f32) and the Y rows (rnd(d_res), 16 x 256) by TMA;
//     for kind 1 the keys rows of each row's image and the pe rows, 1 KB
//     each, by bulk copies on the same mbarrier; a ring of dw32::STAGES.
//   consumers: TF32 wgmma reads shared operands K-major only, and K (the
//     row index) is the slow one in both operands. So Y (kind 1: keys + pe,
//     added here in f32 as the plain twin adds them) is split once per
//     element into hi and lo and written transposed, K-major without
//     swizzle, into one of two B buffers by the 256 consumer threads (a
//     thread a column, 16-byte stores of 4 rows); X is the register A
//     operand, each element loaded and split by the one thread whose
//     fragment holds it. Per k-step of 8 rows, wgmma m64n256k8 three times
//     (lo.hi, hi.lo, hi.hi) into the one f32 accumulator; the next stage's
//     transpose runs while the products are in flight. Rows past the chunk
//     enter as zero A values (a kind-1 row past the last is a copy of the
//     last row: finite).
// The partials are summed by the wrapper in a fixed order: no atomics, the
// same bits every run.
namespace dw32 {

constexpr int KR = 16;                     // rows of a stage: two k-steps
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256, NTH = CONSUMERS + 32;
constexpr int X_BYTES = KR * I * 4;        // 8 KB
constexpr int Y_BYTES = KR * C * 4;        // 16 KB, and as much of pe
constexpr int STAGE_BYTES = X_BYTES + 2 * Y_BYTES;
constexpr int KSTEP_BYTES = C * 8 * 4;     // one k-step of Y^T, hi or lo
constexpr int B_BYTES = 2 * (KR / 8) * KSTEP_BYTES;  // a stage's hi and lo
constexpr size_t SMEM = 2048 + (size_t)STAGES * STAGE_BYTES + 2 * B_BYTES;
static_assert(KR == 16, "kind 1: one lane per keys row and per pe row");
static_assert(SMEM <= 232448, "shared memory of the f32 weight pass");

// rows 0..15 of a stage's Y (plus pe for kind 1) -> its B buffer: split
// into TF32 hi and lo, K-major without swizzle (core matrices of 8 columns
// x 4 rows, 128 bytes; LBO 128 between the two row halves of a k-step, SBO
// 256 between 8-column groups), hi then lo per k-step. Thread c of the 256
// consumers takes column c.
__device__ __forceinline__ void transpose_split(const unsigned char* stage,
                                               unsigned char* bbuf, int kind,
                                               int c) {
  const float* y = reinterpret_cast<const float*>(stage + X_BYTES);
  const float* e = y + KR * C;
#pragma unroll
  for (int q = 0; q < KR / 4; ++q) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * q + k;
      stf32::split(kind ? y[r * C + c] + e[r * C + c] : y[r * C + c], h[k],
                   l[k]);
    }
    unsigned char* dst = bbuf + (q >> 1) * 2 * KSTEP_BYTES + (c >> 3) * 256 +
                         (q & 1) * 128 + (c & 7) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + KSTEP_BYTES) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace dw32

__global__ void __launch_bounds__(dw32::NTH, 1)
    i2t_bwd_dw_tf32_kernel(const __grid_constant__ CUtensorMap tm_out,
                           const __grid_constant__ CUtensorMap tm_dqpre,
                           const __grid_constant__ CUtensorMap tm_dres,
                           const float* keys, const float* pe, float* part,
                           int m, int pb, int rows, int chunk, int nchunks) {
  using namespace hop;
  using namespace dw32;
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + STAGES;
  unsigned char* stages = base + 1024;
  unsigned char* bbufs = stages + STAGES * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int units = 2 * nchunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == CONSUMERS / 32) {  // --------------------------- producer ----
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int kind = u & 1, lo = (u >> 1) * chunk;
      const int hi = min(rows, lo + chunk);
      for (int r0 = lo; r0 < hi; r0 += KR, ++it) {
        const int st = it % STAGES;
        unsigned char* x = stages + st * STAGE_BYTES;
        mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + st, X_BYTES + (kind ? 2 : 1) * Y_BYTES);
          tma_load_2d(x, kind ? &tm_dqpre : &tm_out, full + st, 0, r0);
          if (kind == 0) tma_load_2d(x + X_BYTES, &tm_dres, full + st, 0, r0);
        }
        __syncwarp();
        if (kind) {  // lane i: keys row r0 + i; lane 16 + i: its pe row
          const int i = lane & (KR - 1);
          const int row = min(r0 + i, rows - 1), pair = row / m;
          const int rr = row - pair * m;
          if (lane < KR)
            bulk_load(x + X_BYTES + i * C * 4,
                      keys + ((size_t)(pair / pb) * m + rr) * C, C * 4,
                      full + st);
          else
            bulk_load(x + X_BYTES + Y_BYTES + i * C * 4, pe + (size_t)rr * C,
                      C * 4, full + st);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  const int ct = threadIdx.x, wgi = ct >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 64 * wgi + 16 * (warp & 3) + g;  // output rows i0, i0 + 8
  float acc[128];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kind = u & 1, chunk_i = u >> 1, lo = chunk_i * chunk;
    const int hi = min(rows, lo + chunk), nst = (hi - lo + KR - 1) / KR;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    transpose_split(stages + (it % STAGES) * STAGE_BYTES, bbufs, kind, ct);
    fence_proxy_async();
    named_sync(1, CONSUMERS);
    for (int s = 0; s < nst; ++s, ++it) {
      const int st = it % STAGES;
      const float* x =
          reinterpret_cast<const float*>(stages + st * STAGE_BYTES);
      uint32_t ah[KR / 8][4], al[KR / 8][4];  // split A fragments of X^T
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * kk + t + 4 * (q >> 1), col = i0 + 8 * (q & 1);
          const float v = lo + s * KR + r < hi ? x[r * I + col] : 0.f;
          stf32::split(v, ah[kk][q], al[kk][q]);
        }
      mbar_arrive(empty + st);  // X in registers, Y already transposed
      const unsigned char* b = bbufs + (s & 1) * B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 8; ++kk) {
        const uint64_t bh = desc(b + 2 * kk * KSTEP_BYTES, 128, 256,
                                 LAYOUT_NONE);
        const uint64_t bl = desc(b + (2 * kk + 1) * KSTEP_BYTES, 128, 256,
                                 LAYOUT_NONE);
        mma_tf32_rs<256>(acc, al[kk], bh, 1);  // the small terms first
        mma_tf32_rs<256>(acc, ah[kk], bl, 1);
        mma_tf32_rs<256>(acc, ah[kk], bh, 1);
      }
      wgmma_commit();
      if (s + 1 < nst) {  // the next stage's B while these run
        const int nx = it + 1;
        mbar_wait(full + nx % STAGES, (nx / STAGES) & 1);
        transpose_split(stages + (nx % STAGES) * STAGE_BYTES,
                        bbufs + ((s + 1) & 1) * B_BYTES, kind, ct);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      named_sync(1, CONSUMERS);  // B written, both buffers' products done
    }
    float* out = part + ((size_t)(kind * nchunks + chunk_i) * I + i0) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dec32::st2(out + (size_t)(8 * h) * C + 8 * j + 2 * t,
                   acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
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
                       int nchunks, int blocks, cudaStream_t stream) {
  const int rows = bp * m;
  if (pb < 1 || bp % pb || chunk < 1 || chunk % dw32::KR || nchunks < 1 ||
      (nchunks - 1) * chunk >= rows || nchunks * chunk < rows || blocks < 1)
    return (int)cudaErrorInvalidValue;
  // row-major (rows, width) f32, boxes of DW32_KR rows
  CUtensorMap maps[3];
  const int widths[3] = {I, I, C};
  const void* srcs[3] = {a[3], a[2], a[4]};  // rnd(out), d_qpre, rnd(d_res)
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)widths[i], (cuuint64_t)rows};
    const cuuint64_t strides[1] = {4ull * widths[i]};
    const cuuint32_t box[2] = {(cuuint32_t)widths[i], (cuuint32_t)dw32::KR};
    if (!hop::tensor_map(maps + i, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, srcs[i],
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_dw_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dw32::SMEM);
  if (e != cudaSuccess) return (int)e;
  i2t_bwd_dw_tf32_kernel<<<blocks, dw32::NTH, dw32::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(a[0]),
      static_cast<const float*>(a[1]), static_cast<float*>(a[5]), m, pb,
      rows, chunk, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward on `blocks` persistent blocks: bf16 i2t_fwd_wgmma_kernel (the
// plan of ops/decoder_attn.py::fwd_plan_bf16), f32 i2t_fwd_tf32_kernel.
int dhoct_i2t_fwd(const void* keys, const void* pe, const void* tok_k,
                  const void* tok_v, const void* wq, const void* bq,
                  const void* wo, const void* bo, const void* g,
                  const void* bt, void* out, int bp, int m, int pb, int n_tok,
                  int blocks, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || m < 1)
    return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_fwd_wgmma(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g,
                                bt, out, bp, m, pb, n_tok, blocks, eps, s)
             : launch_fwd_tf32(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                               out, bp, m, pb, n_tok, blocks, eps, s);
}

// The row pass on `blocks` persistent blocks (bf16 i2t_bwd_rows_wgmma_kernel, f32
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

// The weight pass (bf16 i2t_bwd_dw_wgmma_kernel, f32 i2t_bwd_dw_tf32_kernel).
// a: keys, pe, d_qpre, rnd(out), rnd(d_res), and the partials. f32: row
// chunks of `chunk` rows, partials [2][nchunks][I][C] (dWo, dWq^T), on
// `blocks` persistent blocks (chunk1, nchunks1 unused); the caller sums
// them. bf16: units of `chunk` stages of dWo (nchunks of them), then of
// `chunk1` stages of dWq^T (nchunks1), partials [nchunks + nchunks1][I][C],
// one block a unit (blocks unused), summed in unit order into a[6], [2][I]
// [C] (dWo, dWq^T).
int dhoct_i2t_bwd_dw(void* const* a, int bp, int m, int pb, int chunk,
                     int nchunks, int chunk1, int nchunks1, int blocks,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd_dw(a, bp, m, pb, chunk, nchunks, chunk1, nchunks1, s)
             : launch_bwd_dw_tf32(a, bp, m, pb, chunk, nchunks, blocks, s);
}

const char* dhoct_i2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
