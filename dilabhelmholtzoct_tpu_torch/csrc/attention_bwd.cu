// K5 in bf16: the flash backward of the encoder attention K1 / K2 (both the
// bf16 K6 kernel's instances at head dim 64, attention_relpos_wgmma.cu),
// from the logsumexp rows the forward saved.
//
//   qkv   (B, N, 3C)      feature order (3, heads, 64), as the forward
//   rel_h (B, heads, N, H), rel_w (B, heads, N, W)   bias factors
//   g     (B, N, C)       dO, the output's cotangent in qkv's type
//   lse   (B, heads, N)   f32, L = m + log(l) of the forward
//   dvec  (B, heads, N)   f32, D = rowsum(dO * O) per head
//   dqkv  (B, N, 3C)      dq, dk, dv written straight into their q / k / v
//                         column blocks (no concat afterwards)
//   drel_h, drel_w        like rel_h, rel_w
//
//   s  = q.k / 8 + rel_h[q, k / W] + rel_w[q, k % W]
//   p  = exp(s - L),  dp = dO.v,  ds = p * (dp - D)
//   dq = ds.k / 8,  dk = ds^T.(q / 8),  dv = p^T.dO
//   drel_h[q, r] = sum over keys k of row r of ds[q, k]; drel_w likewise
//   over the keys of column c
//
// Replaces dilabhelmholtzoct_tpu/ops/attention.py::_flash_packed_bwd in
// bf16, as two kernels like the TPU's:
//   the dq kernel (_packed_bwd_dq_kernel): each unit of a persistent block
//     owns a tile of query rows, loops over key tiles and accumulates dq
//     and drel in registers (or drel in shared memory): no atomics, a fixed
//     summation order, a deterministic result.
//   the dk/dv kernel (_packed_bwd_dkv_kernel): persistent blocks walk units
//     of (batch, head, 128 keys), loop over query tiles and accumulate dk
//     and dv in registers.
// Both serve every N (global 64x64 = 4096, 14x14 = 196 windows, ragged
// grids): the last tile of either kind is masked, so K5 needs no windowed
// variant. Windows that the partition zero-padded are ordinary inputs here:
// their pad tokens are live keys, as in the forward. The f32 kernels, in
// split TF32 on wgmma and TMA, are attention_bwd_wgmma_tf32.cu's.
//
// Rounding where the TPU kernels round: q/8 is exact; the dq kernel takes
// ds = bf16(p * (dp - D)) with p in f32; the dk/dv kernel rounds p first,
// p_b = bf16(p), and takes ds = bf16(p_b * (dp - D)), so the two kernels'
// ds differ on purpose; dq = bf16(sum * 1/8); drel sums the bf16 ds in f32
// and rounds once.
//
// Bound on an H100 SXM (700 W), one global layer at B = 4, 12 heads:
//    dq kernel: 3 products (s, dp, dq) = 6 * 4096^2 * 64 * 48 = 309 GFLOP;
//    dk/dv kernel: 4 products (s, dp, dv, dk) = 412 GFLOP. Over the 989
//    TFLOP/s bf16 tensor-core rate: 0.31 + 0.42 ms; the bytes (qkv, dO,
//    rel, L, D in, dqkv and drel out: ~0.3 GB) take 0.09 ms.
//    Compute-bound. The windowed layer (100 windows of 196, B = 4) is bound
//    by its bytes.
// What the kernels do about it (attn_bwd_dq_wgmma_kernel,
//    attn_bwd_dkv_wgmma_kernel, below): every product on wgmma, the only
//    way to the tensor cores' full rate, their operands landed by TMA in
//    the layouts wgmma reads (no thread spends registers or instructions on
//    a copy, no ldmatrix); persistent blocks whose producer keeps the next
//    tiles and the next unit's rows in flight; the two score products as
//    one chain each, with the kernel's own side (queries for dq, keys for
//    dk/dv) as the accumulator rows, so that ds (and p_b) are register A
//    fragments of the gradient products; per pair of scores one packing
//    conversion for each rounded value (the conversions run on the same
//    slow pipe as the exponential); the elementwise work of one warpgroup
//    runs beside the other's products (the dk/dv kernel's warpgroups take
//    turns issuing, the dq kernel's issue as they come), and a tile's
//    scores go out with the previous tile's gradient products (operand
//    fences keep other instructions out of the wgmma pipeline, which ptxas
//    would otherwise serialize). A 14 x 14 window is two units of a persistent block's
//    walk, whose loads overlap the unit before (the mma.sync kernels before
//    them took two (dk/dv) or four (dq) blocks, each reading the window
//    from device memory and waiting for it); the dq kernel reads the
//    window's keys in two tiles of 7 grid rows and sums drel in registers.
//    What stays on the CUDA cores per score: the scale and the bias, the
//    exponential, the roundings, the masks, the drel sums.
// A fused single kernel is later work.

#include <type_traits>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;


// ------------------------------------------- dk / dv, bf16, wgmma + TMA ----
// attn_bwd_dkv_wgmma_kernel<ROW_TILE>: persistent blocks over units of (batch,
// head, 128 keys), 384 threads: two consumer warpgroups and two producer
// warps (of a warpgroup that gives its registers back); warpgroup w owns
// keys 64 w.. of a unit.
//   producers: per unit, K and V (TMA, rows past N zero) into a ring of two
//     K / V stages; per 64-query tile of the unit, Q and dO (TMA), the
//     tile's L, D (cp.async, 4 bytes a query, zero past N) and, by the
//     second warp, its bias factors into a ring of query stages (the
//     deepest that fits), running ahead across units (the next unit's K,
//     V and first tiles load while this one computes). ROW_TILE: the
//     tile's rel_w rows by TMA (one box of 64 x 64, 128-byte swizzle) and
//     of rel_h the two values the unit's warpgroups take (cp.async, 4
//     bytes a query); else both factors' rows by cp.async: padded rows
//     where a row is a multiple of 8 values, else the contiguous run with
//     its alignment slack. Each stage has a full and an empty mbarrier.
//   consumers: per query tile, S^T = K . Q^T and dP^T = V . dO^T as two
//     wgmma m64n64k16 chains (both operands K-major in shared memory), so
//     keys are the accumulator rows; on the accumulators s = S^T / 8 +
//     rel_h + rel_w, p_b = bf16(exp(s - L)), ds = bf16(p_b (dP^T - D)), 0
//     for a query past N, each pair of query columns rounded and packed by
//     one conversion into the A fragment word of p_b^T or ds^T, the A
//     operands of dV += p_b^T . dO and dK += ds^T . Q (wgmma m64n64k16, B
//     MN-major through the transpose bit). A tile's S^T and dP^T go out
//     with the previous tile's dV and dK products, and the two warpgroups
//     take turns issuing (named barriers), so one warpgroup's exponentials
//     run beside the other's products. dk = dK / 8 after the f32 sum, dv
//     and dk rounded once, staged in the warpgroup's half of the finished
//     K / V stage and written in whole 128-byte rows; a unit owns its
//     keys: no atomics. A column group of queries past N skips the
//     elementwise work.
//   A 14 x 14 window (N = 196) is two units; the second reads the
//   window's query tiles from L2, loaded there by the first, and both
//   overlap the loads of their block's next unit.
// ROW_TILE (W == 64 and an even H, every ViT global layer): a warpgroup's
// 64 keys are one grid row, so rel_h is one value a query and a lane reads
// rel_w at fixed columns of the swizzled box; else each key's grid (row,
// column) is looked up in the staged factor rows.
namespace dkv {

using mma::bf16;

constexpr int KEYS = 128, QT = 64;     // keys of a unit, queries of a tile
constexpr int TILE_BYTES = QT * D * 2;  // 64 rows of one head, 8 KB
constexpr int KV_BYTES = 2 * KEYS * D * 2;  // a unit's K and V
constexpr int CONSUMERS = 256, NTH = CONSUMERS + 128;
// 168 registers a thread at launch (a sub-partition's 16K over its three
// warps); the producer's warpgroup gives back all but 56, the consumers
// take them (128 x 56 + 256 x 224 = 384 x 168): a consumer holds S^T,
// dP^T, dK and dV (4 x 32 f32) and p_b^T, ds^T (2 x 16 packed)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int KV_STAGES = 2, MAX_STAGES = 6;
// named barriers 1, 2: the warpgroups' turns; 3, 4: a warpgroup's own
// (its dk, dv staged)
constexpr int TURN = 1, OUT = 3;
constexpr int SMEM_FIXED = 1024 + 128;  // alignment slack, mbarriers

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// a tile's factor rows in shared memory: rows of len + 8 values (16 bytes
// of padding: the rows a warp reads at once start on other banks) where
// len is a multiple of 8, else the contiguous run of the tile's rows with
// 8 values of slack at each end (its copy starts and ends on 16 bytes)
__host__ __device__ constexpr bool padded(int len) { return len % 8 == 0; }
__host__ __device__ constexpr int factor_bytes(int len) {
  return padded(len) ? 2 * QT * (len + 8) : round_up(2 * (QT * len + 16), 16);
}
// a query stage: Q | dO (TILE_BYTES each) | rel_h rows | rel_w rows | L |
// D (f32), rounded up to 1 KB (the next stage's Q is 1024-aligned for its
// swizzle); ROW_TILE: Q | dO | rel_w (a swizzled 64 x 64 box) | rel_h (two
// values a query) | L | D
struct Layout {
  int rh, rw, l, d, stage;
  __host__ __device__ Layout(int h, int w, bool row_tile)
      : rh(row_tile ? 3 * TILE_BYTES : 2 * TILE_BYTES),
        rw(row_tile ? 2 * TILE_BYTES : rh + factor_bytes(h)),
        l(row_tile ? rh + QT * 4 : rw + factor_bytes(w)),
        d(l + 4 * QT),
        stage(round_up(d + 4 * QT, 1024)) {}
  __host__ __device__ size_t smem(int stages) const {
    return SMEM_FIXED + (size_t)KV_STAGES * KV_BYTES + (size_t)stages * stage;
  }
};

struct Args {
  const bf16* rel_h;
  const bf16* rel_w;
  const float* lse;
  const float* dvec;
  bf16* dqkv;
  long long rel_h_len, rel_w_len;  // elements of rel_h, rel_w
  int n, heads, H, W, qtiles, stages, kblocks, units;
};

// `rows` factor rows of `len` values from element e0 of src (len_all
// elements) -> dst, by the 32 lanes of a warp with cp.async: padded rows
// (rows past nq zero), or the contiguous run from e0 rounded down to 8
// (element e0 at dst[e0 % 8]; zero past len_all)
__device__ __forceinline__ void copy_factors(unsigned char* dst,
                                             const bf16* src, long long e0,
                                             int len, int nq,
                                             long long len_all, int lane) {
  if (padded(len)) {
    const int pieces = len / 8;
    for (int i = lane; i < QT * pieces; i += 32) {
      const int r = i / pieces, c = (i - r * pieces) * 8;
      const bool ok = r < nq;
      hop::cp_async16_fill(dst + 2 * (r * (len + 8) + c),
                           src + (ok ? e0 + (long long)r * len + c : 0),
                           ok ? 16 : 0);
    }
  } else {
    const long long a0 = e0 & ~7LL;
    const int pieces = (int)((e0 + (long long)QT * len - a0 + 7) >> 3);
    for (int i = lane; i < pieces; i += 32) {
      const long long e = a0 + 8LL * i;
      const int bytes =
          e >= len_all ? 0 : (int)min(16LL, 2 * (len_all - e));
      hop::cp_async16_fill(dst + 16 * i, src + (bytes ? e : 0), bytes);
    }
  }
}

}  // namespace dkv

template <bool ROW_TILE>
__global__ void __launch_bounds__(dkv::NTH, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_kv,
                          const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_rw,
                          const dkv::Args a) {
  using namespace hop;
  using namespace dkv;
  using mma::exp2_approx;
  using mma::LOG2E;
  using mma::pack_bf16;
  const Layout L(a.H, a.W, ROW_TILE);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array: every access below
  // stays a shared-memory one
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* kvs = base;  // K / V stage i: K (16 KB), then V
  unsigned char* stages = kvs + KV_STAGES * KV_BYTES;
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(stages + a.stages * L.stage);
  uint64_t* kvempty = kvfull + KV_STAGES;
  uint64_t* full = kvempty + KV_STAGES;
  uint64_t* empty = full + MAX_STAGES;
  const int C = a.heads * D;
  if (threadIdx.x == 0) {
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(kvfull + i, 1);
      mbar_init(kvempty + i, CONSUMERS / 32);  // a lane of each warp
    }
    for (int i = 0; i < a.stages; ++i) {
      // the TMA lane's arrive + the cp.async ones of both producer warps
      mbar_init(full + i, 65);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp is done with a stage (its products waited on): one arrive
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (warp >= CONSUMERS / 32) {  // ----------------------------- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    // two warps load: the first K, V and a tile's Q, dO (TMA), L and D;
    // the second the tile's bias factors
    const int pw = warp - CONSUMERS / 32;
    if (pw > 1) return;
    int it = 0, uu = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
      const int kb = u % a.kblocks, bh = u / a.kblocks;
      const int head = bh % a.heads, b = bh / a.heads, k0 = kb * KEYS;
      const long long head_row = (long long)bh * a.n;
      const int ks = uu % KV_STAGES;
      if (pw == 0) mbar_wait(kvempty + ks, ((uu / KV_STAGES) & 1) ^ 1);
      if (pw == 0 && lane == 0) {
        unsigned char* kv = kvs + ks * KV_BYTES;
        mbar_expect_tx(kvfull + ks, KV_BYTES);
        tma_load_3d(kv, &tm_kv, kvfull + ks, C + head * D, k0, b);
        tma_load_3d(kv + KV_BYTES / 2, &tm_kv, kvfull + ks, 2 * C + head * D,
                    k0, b);
      }
      for (int t = 0; t < a.qtiles; ++t, ++it) {
        const int st = it % a.stages, q0 = t * QT;
        unsigned char* sg = stages + st * L.stage;
        mbar_wait(empty + st, ((it / a.stages) & 1) ^ 1);
        const int nq = min(QT, a.n - q0);
        const long long row = head_row + q0;
        if (pw == 0) {
          if (lane == 0) {
            mbar_expect_tx(full + st, (ROW_TILE ? 3 : 2) * TILE_BYTES);
            tma_load_3d(sg, &tm_q, full + st, head * D, q0, b);
            tma_load_3d(sg + TILE_BYTES, &tm_g, full + st, head * D, q0, b);
            if (ROW_TILE)
              tma_load_2d(sg + L.rw, &tm_rw, full + st, 0, (int)row);
          }
          float* ls = reinterpret_cast<float*>(sg + L.l);
          float* ds = reinterpret_cast<float*>(sg + L.d);
          for (int i = lane; i < QT; i += 32) {
            const bool ok = i < nq;
            mma::cp_async4(ls + i, a.lse + row + (ok ? i : 0), ok);
            mma::cp_async4(ds + i, a.dvec + row + (ok ? i : 0), ok);
          }
        } else if (ROW_TILE) {
          // rel_h at the unit's grid rows kr, kr + 1 (kr even, H even)
          uint32_t* rh2 = reinterpret_cast<uint32_t*>(sg + L.rh);
          const int kr = k0 / 64;
          for (int q = lane; q < QT; q += 32) {
            const bool ok = q < nq && kr < a.H;
            mma::cp_async4(rh2 + q,
                           a.rel_h + (ok ? (row + q) * a.H + kr : 0), ok);
          }
        } else {
          copy_factors(sg + L.rh, a.rel_h, row * a.H, a.H, nq, a.rel_h_len,
                       lane);
          copy_factors(sg + L.rw, a.rel_w, row * a.W, a.W, nq, a.rel_w_len,
                       lane);
        }
        mbar_arrive_cp_async(full + st);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ldh = padded(a.H) ? a.H + 8 : a.H;
  const int ldw = padded(a.W) ? a.W + 8 : a.W;
  // the two warpgroups take turns issuing their products: barrier TURN +
  // wgi is this warpgroup's turn, the other arrives on it after each of
  // its issues (warpgroup 0 goes first)
  if (wgi == 1) named_arrive(TURN, CONSUMERS);
  int it = 0, uu = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
    const int kb = u % a.kblocks, bh = u / a.kblocks;
    const int head = bh % a.heads, b = bh / a.heads;
    const long long head_row = (long long)bh * a.n;
    const int ks = uu % KV_STAGES;
    const unsigned char* kw = kvs + ks * KV_BYTES + wgi * TILE_BYTES;
    const unsigned char* vw = kw + KV_BYTES / 2;
    const int k0 = kb * KEYS + 64 * wgi;  // the warpgroup's keys
    // the lane's keys k0 + 16 (warp % 4) + g + 8 h (accumulator rows) at
    // grid row kr[h], column kc[h] (0 past N: unused); ROW_TILE: kcs[h][e]
    // is the byte offset of the key's rel_w in swizzled box row q, for e
    // = q % 2 (q % 8 = 2 t + e for every query column of the lane)
    int kr[2], kc[2], kcs[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + 16 * (warp & 3) + g + 8 * h;
      kr[h] = key < a.n ? key / a.W : 0;
      kc[h] = key < a.n ? key - kr[h] * a.W : 0;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kcs[h][e] = ((((key - k0) >> 3) ^ (2 * t + e)) << 4) |
                    (((key - k0) & 7) << 1);
    }
    float dk[D / 2], dv[D / 2];
    uint32_t pp[QT / 16][4], pd[QT / 16][4];  // p_b^T, ds^T as A fragments
    auto stage = [&](int tile) {
      return stages + ((it + tile) % a.stages) * L.stage;
    };

    // p_b and ds of query tile `tile` from S^T (s) and dP^T (dp): each
    // key's pair of query columns q, q + 1 (e = 0, 1) rounded to bf16 and
    // packed at once; the word of A fragment k16-step k, register i goes to
    // s[8 k + i] (dp[8 k + i]), a slot read before. FULL: no query of the
    // tile is past N (no masks; else column groups past N are zero)
    auto grads_body = [&](auto full, float* s, float* dp, int tile) {
      constexpr bool FULL = decltype(full)::value;
      const unsigned char* sg = stage(tile);
      const int q0 = tile * QT, nq = min(QT, a.n - q0);
      const long long row = head_row + q0;
      const bf16* rh = reinterpret_cast<const bf16*>(sg + L.rh) +
                       (ROW_TILE ? wgi : padded(a.H) ? 0 : (row * a.H) & 7);
      const bf16* rw = reinterpret_cast<const bf16*>(sg + L.rw) +
                       (ROW_TILE || padded(a.W) ? 0 : (row * a.W) & 7);
      const float* ls = reinterpret_cast<const float*>(sg + L.l);
      const float* dsv = reinterpret_cast<const float*>(sg + L.d);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        if (!FULL && 8 * j >= nq) {  // no query of the group: p_b = ds = 0
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int slot = 8 * (j >> 1) + 2 * (j & 1) + h;
            s[slot] = dp[slot] = 0.f;
          }
          continue;
        }
        const int q2 = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + q2);
        const float2 d2 = *reinterpret_cast<const float2*>(dsv + q2);
        const float lb[2] = {l2.x * LOG2E, l2.y * LOG2E};
        const float dq[2] = {d2.x, d2.y};
        // ROW_TILE: rel_h log2 e - L of each query (both keys share it);
        // else rel_h of the lane's first key
        float c0[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          c0[e] = ROW_TILE
                      ? fmaf(__bfloat162float(rh[2 * (q2 + e)]), LOG2E, -lb[e])
                      : __bfloat162float(rh[(q2 + e) * ldh + kr[0]]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = q2 + e;
            const float x = s[4 * j + 2 * h + e];
            float y;  // log2 of p: (S / 8 + rel_h + rel_w) log2 e - L
            if (ROW_TILE) {
              const float bw = __bfloat162float(
                  *reinterpret_cast<const bf16*>(
                      reinterpret_cast<const unsigned char*>(rw) + q * 128 +
                      kcs[h][e]));
              y = fmaf(x, 0.125f * LOG2E, fmaf(bw, LOG2E, c0[e]));
            } else {
              const float bh =
                  h == 0 ? c0[e] : __bfloat162float(rh[q * ldh + kr[h]]);
              const float sv = fmaf(
                  x, 0.125f, bh + __bfloat162float(rw[q * ldw + kc[h]]));
              y = fmaf(sv, LOG2E, -lb[e]);
            }
            p[e] = exp2_approx(y);
            if (!FULL && q >= nq) p[e] = 0.f;
          }
          // p_b, rounded once; ds = bf16(p_b (dp - D)) from its halves
          const uint32_t pw = pack_bf16(p[0], p[1]);
          const uint32_t dw = pack_bf16(
              __uint_as_float(pw << 16) * (dp[4 * j + 2 * h] - dq[0]),
              __uint_as_float(pw & 0xffff0000u) *
                  (dp[4 * j + 2 * h + 1] - dq[1]));
          const int slot = 8 * (j >> 1) + 2 * (j & 1) + h;
          s[slot] = __uint_as_float(pw);
          dp[slot] = __uint_as_float(dw);
        }
      }
    };
    auto grads = [&](float* s, float* dp, int tile) {
      if ((tile + 1) * QT <= a.n)
        grads_body(std::true_type{}, s, dp, tile);
      else
        grads_body(std::false_type{}, s, dp, tile);
    };
    // the A fragments of k16-step k: the words grads left in s and dp
    auto pack = [&](const float* s, const float* dp) {
#pragma unroll
      for (int k = 0; k < QT / 16; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[k][i] = __float_as_uint(s[8 * k + i]);
          pd[k][i] = __float_as_uint(dp[8 * k + i]);
        }
    };
    // S^T = K . Q^T and dP^T = V . dO^T of the tile in stage sg
    auto scores = [&](float* s, float* dp, const unsigned char* sg) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_ss<QT>(s, desc(kw + 32 * kk, 16, 1024, LAYOUT_SW128),
                        desc(sg + 32 * kk, 16, 1024, LAYOUT_SW128), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_ss<QT>(dp, desc(vw + 32 * kk, 16, 1024, LAYOUT_SW128),
                        desc(sg + TILE_BYTES + 32 * kk, 16, 1024,
                             LAYOUT_SW128),
                        kk > 0);
    };
    // dV += p_b^T . dO and dK += ds^T . Q of the tile in stage sg
    auto grad_products = [&](const unsigned char* sg, bool acc) {
#pragma unroll
      for (int k = 0; k < QT / 16; ++k)
        mma_bf16_rs_mn<D>(dv, pp[k],
                          desc(sg + TILE_BYTES + 2048 * k, 16, 1024,
                               LAYOUT_SW128),
                          acc || k > 0);
#pragma unroll
      for (int k = 0; k < QT / 16; ++k)
        mma_bf16_rs_mn<D>(dk, pd[k],
                          desc(sg + 2048 * k, 16, 1024, LAYOUT_SW128),
                          acc || k > 0);
    };
    auto full_bar = [&](int tile) { return full + (it + tile) % a.stages; };
    auto parity = [&](int tile) { return ((it + tile) / a.stages) & 1; };

    mbar_wait(kvfull + ks, (uu / KV_STAGES) & 1);
    {  // the first tile: its scores alone
      float s[QT / 2], dp[QT / 2];
      mbar_wait(full_bar(0), parity(0));
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      scores(s, dp, stage(0));
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      grads(s, dp, 0);
      pack(s, dp);
    }
    // each further tile: one turn issues its scores and the previous
    // tile's gradient products; its p_b and ds are formed while those run
    for (int tile = 1; tile < a.qtiles; ++tile) {
      float s[QT / 2], dp[QT / 2];
      mbar_wait(full_bar(tile), parity(tile));
      fence_operands(pp);
      fence_operands(pd);
      fence_operands(dk);
      fence_operands(dv);
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      scores(s, dp, stage(tile));
      wgmma_commit();
      grad_products(stage(tile - 1), tile > 1);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<1>();  // the scores are in; the products may still run
      fence_operands(s);
      fence_operands(dp);
      grads(s, dp, tile);
      wgmma_wait<0>();  // the previous tile's products are done
      fence_operands(pp);  // read by them until here
      fence_operands(pd);
      release(empty + (it + tile - 1) % a.stages);
      pack(s, dp);
    }
    // the last tile's gradient products
    fence_operands(pp);
    fence_operands(pd);
    fence_operands(dk);
    fence_operands(dv);
    named_sync(TURN + wgi, CONSUMERS);
    wgmma_fence();
    grad_products(stage(a.qtiles - 1), a.qtiles > 1);
    wgmma_commit();
    named_arrive(TURN + (wgi ^ 1), CONSUMERS);
    wgmma_wait<0>();
    fence_operands(dk);
    fence_operands(dv);
    release(empty + (it + a.qtiles - 1) % a.stages);
    it += a.qtiles;

    // dk and dv through the warpgroup's half of the K / V stage (done with:
    // the unit's products are waited on), 64 rows of 128 bytes each in the
    // 128-byte swizzle, then out in whole rows, 16 bytes a thread
    unsigned char* kst = const_cast<unsigned char*>(kw);
    unsigned char* vst = const_cast<unsigned char*>(vw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (warp & 3) + g + 8 * h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int off = r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
        // dk = ds^T.(q / 8): the scale after the f32 sum, exact
        *reinterpret_cast<uint32_t*>(kst + off) =
            pack_bf16(dk[4 * j + 2 * h] * 0.125f,
                      dk[4 * j + 2 * h + 1] * 0.125f);
        *reinterpret_cast<uint32_t*>(vst + off) =
            pack_bf16(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
    named_sync(OUT + wgi, 128);
    for (int i = threadIdx.x & 127; i < 2 * 64 * 8; i += 128) {
      const int v = i >> 9, r = (i >> 3) & 63, c = i & 7;
      if (k0 + r >= a.n) continue;
      const uint4 x = *reinterpret_cast<const uint4*>(
          (v ? vst : kst) + r * 128 + ((c ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(a.dqkv + ((size_t)b * a.n + k0 + r) * 3 * C +
                                (v + 1) * C + head * D + 8 * c) = x;
    }
    fence_proxy_async();  // before TMA writes the stage again
    release(kvempty + ks);
  }
  if (wgi == 0) named_sync(TURN, CONSUMERS);  // warpgroup 1's last arrive
}

// ------------------------------------------- dq / drel, bf16, wgmma + TMA ----
// attn_bwd_dq_wgmma_kernel<MODE, NK>: persistent blocks over units of
// (batch, head, 128 queries), 384 threads: two consumer warpgroups and a
// producer warp (of a warpgroup that gives its registers back); warpgroup
// w owns queries 64 w.. of a unit, which owns their dq, drel_h and drel_w
// rows: no atomics, a fixed summation order.
//   producer: per unit, Q and dO (TMA, 128 rows each, rows past N zero),
//     L, D (cp.async, 4 bytes a query, zero past N) and the rows' bias
//     factors (cp.async, 16-byte pieces of the contiguous (N, H) / (N, W)
//     block) into a ring of u_stages unit stages; per key tile of NK key
//     slots, K and V (TMA) into a ring of kv_stages stages, running ahead
//     across units. Each stage has a full and an empty mbarrier.
//   consumers: per key tile, S = Q . K^T and dP = dO . V^T as two wgmma
//     m64nNKk16 chains (both operands K-major in shared memory, queries the
//     accumulator rows); on the accumulators s = S / 8 + rel_h + rel_w,
//     p = exp(s - L) in f32, ds = bf16(p (dP - D)), each pair of key
//     columns rounded and packed by one conversion into the A fragment word
//     of dQ += ds . K (wgmma m64n64k16, K the MN-major B through the
//     transpose bit: the same swizzled K tile serves both products). A
//     tile's S and dP go out with the previous tile's dQ product, whose
//     run hides behind this tile's elementwise work; the two warpgroups
//     issue as they come (taking turns, as K6 and the dk/dv kernel do, was
//     slower here: the elementwise work, not the products, bounds this
//     kernel). dq = bf16(dQ / 8) after the f32 sum; drel sums the bf16 ds
//     in f32 and rounds once.
// How a tile's key slots map to keys, and drel, by MODE:
//   ROW_TILE (W == 64, every ViT global layer; NK = 64): a tile is one grid
//     row, so rel_h is one value a query, the lane holds its rel_w columns
//     in registers for the unit, drel_h[q][r] is the tile's row sum (the
//     lane's 16 values, then the quad) and drel_w[q][c] gathers column c of
//     every tile in the lane's own accumulator.
//   GRID (a window of H <= 14, W <= 16: the windowed layers; NK = 112): K
//     and V come through a 4-D view (cols, W, H, B) in boxes of 16 x 7 grid
//     cells, so slot 16 kr + kc holds key (kr, kc) of the tile's 7 grid
//     rows and the slots past W (and past H) are zero rows, masked (their
//     bias -inf). Column 8 j + 2 t + e of a lane is grid row j / 2, grid
//     column 8 (j % 2) + 2 t + e: drel_h of a grid row is the lane's 4
//     values plus the quad, drel_w sums the lane's 8 columns over the
//     tiles, all in registers.
//   GENERIC (the other grids; NK = 64): slot k0 + c is key k0 + c, each
//     column finds its grid (row, column) by a multiply-high and reads both
//     factors from device memory (L1); drel through the warpgroup's shared
//     ds tile (bf16, exact), each (query, grid row) and (query, grid
//     column) slot summed by one thread in key order into f32 rows.
namespace dq {

using mma::bf16;

constexpr int QROWS = 128;                 // query rows of a unit
constexpr int ROWS_BYTES = QROWS * D * 2;  // a unit's Q (or dO), 16 KB
constexpr int CONSUMERS = 256, NTH = CONSUMERS + 128;
// registers a thread: 168 at launch (64K over 384 threads, in steps of 8);
// the producer's warpgroup gives back all but 24, the consumers take them
// (128 x 24 + 256 x 240 = 384 x 168): a consumer holds S, dP (NK / 2 f32
// each) and dQ (32), ds as NK / 4 packed words, its drel_w sums and rel_w
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int MAX_KV_STAGES = 4, MAX_U_STAGES = 2;
// named barriers 1, 2: a warpgroup's own (GENERIC: its ds tile written,
// summed)
constexpr int SUMS = 1;
constexpr int SMEM_FIXED = 1024 + 128;  // alignment slack, mbarriers
// elements of slack a unit's bias block takes (its copy starts and ends on
// 16-byte boundaries around the block)
constexpr int REL_PAD = 16;
constexpr int SLD = 64 + 8;  // GENERIC: a bf16 row of the ds tile
enum Mode { GENERIC, ROW_TILE, GRID };
constexpr int GRID_W = 16, GRID_ROWS = 7, GRID_NK = GRID_W * GRID_ROWS;
constexpr int GRID_H = 14;  // GRID: a window of at most 14 x 16

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The shared memory of a launch, from a 1024-aligned base: the K / V
// stages (kv bytes each; K then V), the unit stages (unit bytes each: Q |
// dO | L | D | but for GENERIC rel_h rows | rel_w rows), GENERIC the two
// warpgroups' sums (sums bytes each: the bf16 ds tile, dRh and dRw in
// f32), the mbarriers; SMEM_FIXED + u_stages * unit + kv_stages * kv + 2
// sums in all (ops/attention.py: dq_plan)
__host__ __device__ constexpr int rel_bytes(int len, bool generic) {
  return generic ? 0 : round_up(2 * (QROWS * len + REL_PAD), 16);
}
struct Layout {
  int l, d, rel_h, rel_w, unit, kv, sums;
  __host__ __device__ Layout(int nk, int h, int w, bool generic)
      : l(2 * ROWS_BYTES),
        d(l + 4 * QROWS),
        rel_h(d + 4 * QROWS),
        rel_w(rel_h + rel_bytes(h, generic)),
        unit(round_up(rel_w + rel_bytes(w, generic), 1024)),
        kv(2 * nk * D * 2),
        sums(generic ? 2 * 64 * SLD + 4 * 64 * (h + w) : 0) {}
  __host__ __device__ size_t smem(int u_stages, int kv_stages) const {
    return SMEM_FIXED + (size_t)u_stages * unit + (size_t)kv_stages * kv +
           2 * (size_t)sums;
  }
};

struct Args {
  const bf16* rel_h;
  const bf16* rel_w;
  const float* lse;
  const float* dvec;
  bf16* dqkv;
  bf16* drel_h;
  bf16* drel_w;
  long long rel_h_len, rel_w_len;  // elements of rel_h, rel_w
  int n, heads, H, W, qblocks, units, ntiles, kv_stages, u_stages;
  unsigned w_magic;  // floor(2^32 / W) + 1: key / W = umulhi(key, w_magic)
};

// a ring of `stages` stages walked in order: the current stage and the
// parity of its phase (a division-free it % stages, it / stages & 1)
struct Ring {
  int stages, stage = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void next() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// elements [e0, e0 + cnt) of src (len elements) -> dst, element e0 at
// dst[e0 % 8]: cp.async 16-byte pieces from e0 rounded down to 8, zero past
// len; by the 32 lanes of a warp
__device__ __forceinline__ void copy_run(unsigned char* dst, const bf16* src,
                                         long long e0, int cnt, long long len,
                                         int lane) {
  const long long a0 = e0 & ~7LL;
  const int pieces = (int)((e0 + cnt - a0 + 7) >> 3);
  for (int i = lane; i < pieces; i += 32) {
    const long long e = a0 + 8LL * i;
    const int bytes = e >= len ? 0 : (int)min(16LL, 2 * (len - e));
    hop::cp_async16_fill(dst + 16 * i, src + (bytes ? e : 0), bytes);
  }
}

}  // namespace dq

template <dq::Mode MODE, int NK>
__global__ void __launch_bounds__(dq::NTH, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_g,
                         const __grid_constant__ CUtensorMap tm_kv,
                         const dq::Args a) {
  using namespace hop;
  using namespace dq;
  using mma::exp2_approx;
  using mma::LOG2E;
  using mma::pack_bf16;
  using mma::quad_sum;
  constexpr int KSTEPS = NK / 16;
  static_assert(NK % 16 == 0 && (MODE == GRID) == (NK == GRID_NK) &&
                    (MODE == GRID || NK == 64),
                "key tile");
  const Layout L(NK, a.H, a.W, MODE == GENERIC);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  // 1024-aligned, by an offset from the shared array: every access below
  // stays a shared-memory one
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* kvbase = base;
  unsigned char* ubase = kvbase + a.kv_stages * L.kv;
  unsigned char* sums = ubase + a.u_stages * L.unit;
  uint64_t* ufull = reinterpret_cast<uint64_t*>(sums + 2 * L.sums);
  uint64_t* uempty = ufull + MAX_U_STAGES;
  uint64_t* kvfull = uempty + MAX_U_STAGES;
  uint64_t* kvempty = kvfull + MAX_KV_STAGES;
  const int C = a.heads * D;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.u_stages; ++i) {
      mbar_init(ufull + i, 33);  // the TMA lane's arrive + 32 cp.async ones
      mbar_init(uempty + i, CONSUMERS / 32);  // a lane of each warp
    }
    for (int i = 0; i < a.kv_stages; ++i) {
      mbar_init(kvfull + i, 1);
      mbar_init(kvempty + i, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp is done with a stage (its products waited on): one arrive
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (warp >= CONSUMERS / 32) {  // ----------------------------- producer ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > CONSUMERS / 32) return;  // one warp loads
    Ring uring(a.u_stages), kvring(a.kv_stages);
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, uring.next()) {
      const int qb = u % a.qblocks, bh = u / a.qblocks;
      const int head = bh % a.heads, b = bh / a.heads, q0 = qb * QROWS;
      const int us = uring.stage;
      unsigned char* ust = ubase + us * L.unit;
      mbar_wait(uempty + us, uring.phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(ufull + us, 2 * ROWS_BYTES);
        tma_load_3d(ust, &tm_q, ufull + us, head * D, q0, b);
        tma_load_3d(ust + ROWS_BYTES, &tm_g, ufull + us, head * D, q0, b);
      }
      const int nq = min(QROWS, a.n - q0);
      const long long row = (long long)bh * a.n + q0;
      float* ls = reinterpret_cast<float*>(ust + L.l);
      float* dsv = reinterpret_cast<float*>(ust + L.d);
      for (int i = lane; i < QROWS; i += 32) {
        const bool ok = i < nq;
        mma::cp_async4(ls + i, a.lse + row + (ok ? i : 0), ok);
        mma::cp_async4(dsv + i, a.dvec + row + (ok ? i : 0), ok);
      }
      if constexpr (MODE != GENERIC) {
        copy_run(ust + L.rel_h, a.rel_h, row * a.H, nq * a.H, a.rel_h_len,
                 lane);
        copy_run(ust + L.rel_w, a.rel_w, row * a.W, nq * a.W, a.rel_w_len,
                 lane);
      }
      mbar_arrive_cp_async(ufull + us);
      for (int tile = 0; tile < a.ntiles; ++tile, kvring.next()) {
        const int ks = kvring.stage;
        unsigned char* kst = kvbase + ks * L.kv;
        mbar_wait(kvempty + ks, kvring.phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(kvfull + ks, L.kv);
          if constexpr (MODE == GRID) {
            tma_load_4d(kst, &tm_kv, kvfull + ks, C + head * D, 0,
                        GRID_ROWS * tile, b);
            tma_load_4d(kst + L.kv / 2, &tm_kv, kvfull + ks,
                        2 * C + head * D, 0, GRID_ROWS * tile, b);
          } else {
            tma_load_3d(kst, &tm_kv, kvfull + ks, C + head * D, tile * NK, b);
            tma_load_3d(kst + L.kv / 2, &tm_kv, kvfull + ks,
                        2 * C + head * D, tile * NK, b);
          }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wgi = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wt = threadIdx.x & 127;  // the thread's index in its warpgroup
  const int r0 = 64 * wgi + 16 * (warp & 3) + g;  // the lane's rows r0, r0 + 8
  // GENERIC: the warpgroup's ds tile (64 x SLD bf16), dRh (64 x H), dRw
  // (64 x W)
  bf16* Ss = reinterpret_cast<bf16*>(sums + wgi * L.sums);
  float* dRh = reinterpret_cast<float*>(Ss + 64 * SLD);
  float* dRw = dRh + 64 * a.H;
  if constexpr (MODE == GENERIC)
    for (int i = wt; i < 64 * (a.H + a.W); i += 128) dRh[i] = 0.f;
  // the f32 value of half e of a bf16 pair
  auto half = [](uint32_t w, int e) {
    return __uint_as_float(e ? w & 0xffff0000u : w << 16);
  };
  Ring uring(a.u_stages), kvring(a.kv_stages);
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, uring.next()) {
    const int qb = u % a.qblocks, bh = u / a.qblocks;
    const int head = bh % a.heads, b = bh / a.heads, q0 = qb * QROWS;
    const int us = uring.stage;
    const unsigned char* ust = ubase + us * L.unit;
    const long long row = (long long)bh * a.n + q0;
    const int nq = min(QROWS, a.n - q0);
    // the unit's bias rows: staged in the unit stage, GENERIC in device
    // memory
    const bf16* Rh =
        MODE == GENERIC
            ? a.rel_h + row * a.H
            : reinterpret_cast<const bf16*>(ust + L.rel_h) + ((row * a.H) & 7);
    const bf16* Rw =
        MODE == GENERIC
            ? a.rel_w + row * a.W
            : reinterpret_cast<const bf16*>(ust + L.rel_w) + ((row * a.W) & 7);
    mbar_wait(ufull + us, uring.phase);
    // L (in log2 units) and D of the lane's rows. A row past N takes L =
    // +inf: its p is 0 and its ds +-0 (its Q and dO rows are zero, so are S,
    // dP and D), with no select in the loop; its outputs are not stored
    bool live[2];
    float Lb[2], Dq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r0 + 8 * r;
      live[r] = q < nq;
      Lb[r] = live[r] ? reinterpret_cast<const float*>(ust + L.l)[q] * LOG2E
                      : INFINITY;
      Dq[r] = reinterpret_cast<const float*>(ust + L.d)[q];
    }
    // the lane's rel_w values for the unit: ROW_TILE its columns 8 j + 2 t
    // + e of a grid row times log2 e, in f32 (rwl[r][2 j + e]); GRID its
    // grid columns 8 h + 2 t, + 1 as bf16 pairs (low half first), -inf past
    // W (the slot is empty)
    float rwl[2][MODE == ROW_TILE ? 16 : 1];
    uint32_t rw2[2][MODE == GRID ? 2 : 1];
    if constexpr (MODE == ROW_TILE) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              Rw + (r0 + 8 * r) * 64 + 8 * j + 2 * t);
          rwl[r][2 * j] = half(w, 0) * LOG2E;
          rwl[r][2 * j + 1] = half(w, 1) * LOG2E;
        }
    } else if constexpr (MODE == GRID) {
      const unsigned short* rw_bits =
          reinterpret_cast<const unsigned short*>(Rw);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = 8 * h + 2 * t + e;
            const uint32_t bits =
                kc < a.W ? rw_bits[(r0 + 8 * r) * a.W + kc] : 0xff80u;
            w |= bits << (16 * e);
          }
          rw2[r][h] = w;
        }
    }
    // drel_w sums of the lane: ROW_TILE its 32 accumulator columns, GRID
    // its 8 (grid column 8 h + 2 t + e of row r at 4 h + 2 r + e)
    float dw[MODE == ROW_TILE ? NK / 2 : MODE == GRID ? 8 : 1] = {};
    float dqa[D / 2];            // dQ: first written by the first product
    uint32_t pds[KSTEPS][4];     // the previous tile's ds: its A fragments

    // ds of key tile `tile` from S (s) and dP (dp): each pair of key
    // columns rounded to bf16 and packed at once; the word of A fragment
    // k16-step k, register i goes to s[8 k + i], a slot read before. Then
    // this tile's share of drel.
    bf16* dh = a.drel_h + (row + r0) * a.H;  // the lane's drel_h rows
    auto grads = [&](float* s, const float* dp, int tile) {
      // the part of each row's exponent that is constant over a grid row of
      // keys: rel_h log2 e - L (GRID: -inf past H, empty slots); ROW_TILE
      // the tile's one grid row, GRID the grid row of the current pair of
      // column groups
      auto row_part = [&](int r, int row_k) {
        return row_k < a.H
                   ? fmaf(__bfloat162float(Rh[(r0 + 8 * r) * a.H + row_k]),
                          LOG2E, -Lb[r])
                   : -INFINITY;
      };
      float c0[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};  // rs: drel_h partials
      if constexpr (MODE == ROW_TILE) {
        c0[0] = row_part(0, tile);
        c0[1] = row_part(1, tile);
      }
      const int k0 = tile * NK;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        // GRID: column groups j = 2 kr, 2 kr + 1 are the tile's grid row kr
        const int row_k = GRID_ROWS * tile + (j >> 1);
        if constexpr (MODE == GRID) {
          if ((j & 1) == 0) {
            c0[0] = row_part(0, row_k);
            c0[1] = row_part(1, row_k);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[4 * j + 2 * r + e];
            float y;  // log2 of p: (S / 8 + rel_h + rel_w) log2 e - L
            if constexpr (MODE == ROW_TILE) {
              y = fmaf(x, 0.125f * LOG2E, rwl[r][2 * j + e] + c0[r]);
            } else if constexpr (MODE == GRID) {
              y = fmaf(x, 0.125f * LOG2E,
                       fmaf(half(rw2[r][j & 1], e), LOG2E, c0[r]));
            } else {
              // key k0 + 8 j + 2 t + e at grid (kr, kc), clamped in bounds
              // past N (its p is 0); a row past N reads row 0
              const int key = k0 + 8 * j + 2 * t + e;
              const int kr = min((int)__umulhi(key, a.w_magic), a.H - 1);
              const int kc = min(key - kr * a.W, a.W - 1);
              const int q = live[r] ? r0 + 8 * r : 0;
              const float sv =
                  fmaf(x, 0.125f,
                       __bfloat162float(Rh[q * a.H + kr]) +
                           __bfloat162float(Rw[q * a.W + kc]));
              y = key < a.n ? fmaf(sv, LOG2E, -Lb[r]) : -INFINITY;
            }
            p[e] = exp2_approx(y);  // f32 p
          }
          // ds = bf16(p (dp - D)), both columns rounded at once
          const uint32_t w = pack_bf16(p[0] * (dp[4 * j + 2 * r] - Dq[r]),
                                       p[1] * (dp[4 * j + 2 * r + 1] - Dq[r]));
          if constexpr (MODE == GENERIC) {
            *reinterpret_cast<uint32_t*>(Ss + (r0 - 64 * wgi + 8 * r) * SLD +
                                         8 * j + 2 * t) = w;
          } else {
            const float d0 = half(w, 0), d1 = half(w, 1);
            rs[r] += d0 + d1;
            const int i = (MODE == ROW_TILE ? 4 * j : 4 * (j & 1)) + 2 * r;
            dw[i] += d0;
            dw[i + 1] += d1;
          }
          s[8 * (j >> 1) + 2 * (j & 1) + r] = __uint_as_float(w);
        }
        // drel_h of a finished grid row: the lane's sums, then the quad
        const bool row_done =
            MODE == GRID ? (j & 1) == 1 : MODE == ROW_TILE && j == NK / 8 - 1;
        if (row_done) {
          const int rk = MODE == GRID ? row_k : tile;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float sum = quad_sum(rs[r]);
            rs[r] = 0.f;
            if (t == 0 && live[r] && rk < a.H)
              dh[8 * r * a.H + rk] = __float2bfloat16(sum);
          }
        }
      }
      if constexpr (MODE == GENERIC) {
        // each (query, grid row) and (query, grid column) slot of this tile
        // is summed by one thread of the warpgroup, in key order
        named_sync(SUMS + wgi, 128);
        const int kend = min(k0 + NK, a.n);
        const int rr0 = k0 / a.W, nr = (kend - 1) / a.W - rr0 + 1;
        for (int x = wt; x < 64 * nr; x += 128) {
          const int q = x / nr, rr = rr0 + x % nr;
          const int lo = max(rr * a.W, k0) - k0;
          const int hi = min((rr + 1) * a.W, kend) - k0;
          float sum = 0.f;
          for (int kl = lo; kl < hi; ++kl)
            sum += __bfloat162float(Ss[q * SLD + kl]);
          dRh[q * a.H + rr] += sum;
        }
        for (int x = wt; x < 64 * a.W; x += 128) {
          const int q = x / a.W, c = x % a.W;
          float sum = 0.f;
          for (int kl = (c - k0 % a.W + a.W) % a.W; kl < kend - k0;
               kl += a.W)
            sum += __bfloat162float(Ss[q * SLD + kl]);
          dRw[x] += sum;
        }
        named_sync(SUMS + wgi, 128);  // the tile is summed: Ss is free
      }
    };
    // the A fragments of k16-step k: the words grads left in s
    auto pack = [&](const float* s) {
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) pds[k][i] = __float_as_uint(s[8 * k + i]);
    };
    // the descriptors of the warpgroup's Q and dO rows; a k16 step moves
    // one by 32 bytes (2 in its address field, which never carries: shared
    // addresses stay below 2^18)
    const uint64_t dq_desc =
        desc(ust + wgi * (ROWS_BYTES / 2), 16, 1024, LAYOUT_SW128);
    const uint64_t dg_desc = dq_desc + (ROWS_BYTES >> 4);
    // S = Q . K^T and dP = dO . V^T over the tile in K / V stage kst
    auto scores = [&](float* s, float* dp, const unsigned char* kst) {
      const uint64_t dk = desc(kst, 16, 1024, LAYOUT_SW128);
      const uint64_t dv = dk + (L.kv >> 5);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_ss<NK>(s, dq_desc + 2 * kk, dk + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16_ss<NK>(dp, dg_desc + 2 * kk, dv + 2 * kk, kk > 0);
    };
    // dQ += ds . K over the tile in K / V stage kst (a k16 step: 16 rows of
    // 128 bytes, 128 in the address field)
    auto dq_product = [&](const unsigned char* kst, bool acc) {
      const uint64_t dk = desc(kst, 16, 1024, LAYOUT_SW128);
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
        mma_bf16_rs_mn<D>(dqa, pds[k], dk + 128 * k, acc || k > 0);
    };

    int ks = kvring.stage;
    const unsigned char* kst = kvbase + ks * L.kv;
    {  // the first tile: its scores alone
      float s[NK / 2], dp[NK / 2];
      mbar_wait(kvfull + ks, kvring.phase);
      wgmma_fence();
      scores(s, dp, kst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      grads(s, dp, 0);
      pack(s);
    }
    // each further tile: its scores go out with the previous tile's dQ
    // product; its ds is formed while that product runs
    for (int tile = 1; tile < a.ntiles; ++tile) {
      const int ks_prev = ks;
      const unsigned char* kst_prev = kst;
      kvring.next();
      ks = kvring.stage;
      kst = kvbase + ks * L.kv;
      float s[NK / 2], dp[NK / 2];
      mbar_wait(kvfull + ks, kvring.phase);
      fence_operands(pds);
      fence_operands(dqa);
      wgmma_fence();
      scores(s, dp, kst);
      wgmma_commit();
      dq_product(kst_prev, tile > 1);
      wgmma_commit();
      wgmma_wait<1>();  // the scores are in; the product may still run
      fence_operands(s);
      fence_operands(dp);
      grads(s, dp, tile);
      wgmma_wait<0>();  // the previous tile's product is done
      fence_operands(pds);  // read by it until here
      release(kvempty + ks_prev);
      pack(s);
    }
    release(uempty + us);  // Q, dO, L, D and the bias rows are read
    // the last tile's dQ product
    fence_operands(pds);
    fence_operands(dqa);
    wgmma_fence();
    dq_product(kst, a.ntiles > 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dqa);
    release(kvempty + ks);
    kvring.next();

    // dq = bf16(dQ / 8) (the scale after the f32 sum, exact) and drel_w
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const int q = r0 + 8 * r;
      bf16* dst = a.dqkv + ((size_t)b * a.n + q0 + q) * 3 * C + head * D +
                  2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(dqa[4 * j + 2 * r] * 0.125f,
                      dqa[4 * j + 2 * r + 1] * 0.125f);
      bf16* dw_row = a.drel_w + (row + q) * a.W + 2 * t;
      if constexpr (MODE == ROW_TILE) {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
          *reinterpret_cast<uint32_t*>(dw_row + 8 * j) =
              pack_bf16(dw[4 * j + 2 * r], dw[4 * j + 2 * r + 1]);
      } else if constexpr (MODE == GRID) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * h + 2 * t + e < a.W)
              dw_row[8 * h + e] = __float2bfloat16(dw[4 * h + 2 * r + e]);
      }
    }
    if constexpr (MODE == GENERIC) {
      // the warpgroup's rows of drel (all tiles summed: the last named
      // barrier of grads), then zero for the next unit
      const int nw = max(0, min(64, nq - 64 * wgi));
      const long long row_w = row + 64 * wgi;
      for (int x = wt; x < nw * a.H; x += 128)
        a.drel_h[row_w * a.H + x] = __float2bfloat16(dRh[x]);
      for (int x = wt; x < nw * a.W; x += 128)
        a.drel_w[row_w * a.W + x] = __float2bfloat16(dRw[x]);
      named_sync(SUMS + wgi, 128);
      for (int i = wt; i < 64 * (a.H + a.W); i += 128) dRh[i] = 0.f;
    }
  }
}

template <dq::Mode MODE, int NK>
int launch_dq_inst(const CUtensorMap (&maps)[3], const dq::Args& a,
                   size_t smem, int blocks, cudaStream_t stream) {
  auto kernel = attn_bwd_dq_wgmma_kernel<MODE, NK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, dq::NTH, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The launch plan (ops/attention.py: dq_plan): nk the key tile (112: GRID,
// a window of at most 14 x 16 grid cells in tiles of 7 grid rows; 64:
// ROW_TILE where W = 64, else GENERIC), kv_stages (2 at least where a unit
// has more than one tile) / u_stages the ring depths, blocks the
// persistent blocks
int launch_dq_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                   const void* g, const float* lse, const float* dvec,
                   void* dqkv, void* drel_h, void* drel_w, int batch, int n,
                   int heads, int h, int w, int nk, int kv_stages,
                   int u_stages, int blocks, cudaStream_t stream) {
  using mma::bf16;
  const bool grid = nk == dq::GRID_NK && h <= dq::GRID_H && w <= dq::GRID_W;
  const bool row_tile = nk == 64 && w == 64;
  const int ntiles = grid ? (h + dq::GRID_ROWS - 1) / dq::GRID_ROWS
                          : (n + nk - 1) / nk;
  if (n < 1 || n != h * w || !(grid || nk == 64) ||
      kv_stages < (ntiles > 1 ? 2 : 1) || kv_stages > dq::MAX_KV_STAGES ||
      u_stages < 1 || u_stages > dq::MAX_U_STAGES || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const dq::Layout L(nk, h, w, !grid && !row_tile);
  const size_t smem = L.smem(u_stages, kv_stages);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // qkv as (3C, N, B): boxes of one head's 64 columns x 128 query rows (Q)
  // or x NK key rows (K, V; GRID: the 4-D view (3C, W, H, B), boxes of 16
  // x 7 grid cells); g as (C, N, B), boxes of 64 x 128
  const int c = heads * attn::D;
  CUtensorMap maps[3] = {};
  const cuuint64_t dq3[3] = {(cuuint64_t)(3 * c), (cuuint64_t)n,
                             (cuuint64_t)batch};
  const cuuint64_t sq3[2] = {6ull * c, 6ull * c * n};
  const cuuint64_t dq4[4] = {(cuuint64_t)(3 * c), (cuuint64_t)w,
                             (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t sq4[3] = {6ull * c, 6ull * c * w, 6ull * c * n};
  const cuuint64_t dg[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t sg[2] = {2ull * c, 2ull * c * n};
  const cuuint32_t box_q[3] = {attn::D, dq::QROWS, 1};
  const cuuint32_t box_kv[3] = {attn::D, (cuuint32_t)nk, 1};
  const cuuint32_t box_grid[4] = {attn::D, dq::GRID_W, dq::GRID_ROWS, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hop::tensor_map(maps, bf, 3, qkv, dq3, sq3, box_q, sw) ||
      !hop::tensor_map(maps + 1, bf, 3, g, dg, sg, box_q, sw) ||
      !(grid ? hop::tensor_map(maps + 2, bf, 4, qkv, dq4, sq4, box_grid, sw)
             : hop::tensor_map(maps + 2, bf, 3, qkv, dq3, sq3, box_kv, sw)))
    return (int)cudaErrorInvalidValue;
  dq::Args a;
  a.rel_h = static_cast<const bf16*>(rel_h);
  a.rel_w = static_cast<const bf16*>(rel_w);
  a.lse = lse, a.dvec = dvec;
  a.dqkv = static_cast<bf16*>(dqkv);
  a.drel_h = static_cast<bf16*>(drel_h);
  a.drel_w = static_cast<bf16*>(drel_w);
  a.rel_h_len = (long long)batch * heads * n * h;
  a.rel_w_len = (long long)batch * heads * n * w;
  a.n = n, a.heads = heads, a.H = h, a.W = w;
  a.qblocks = (n + dq::QROWS - 1) / dq::QROWS;
  a.units = batch * heads * a.qblocks;
  a.ntiles = ntiles;
  a.kv_stages = kv_stages, a.u_stages = u_stages;
  a.w_magic = (unsigned)(0x100000000ull / (unsigned)w) + 1u;
  blocks = min(blocks, a.units);
  if (grid)
    return launch_dq_inst<dq::GRID, dq::GRID_NK>(maps, a, smem, blocks,
                                                 stream);
  if (row_tile)
    return launch_dq_inst<dq::ROW_TILE, 64>(maps, a, smem, blocks, stream);
  return launch_dq_inst<dq::GENERIC, 64>(maps, a, smem, blocks, stream);
}

// `blocks` persistent blocks (one an SM) over the units; the query ring
// is the deepest (up to MAX_STAGES) that fits beside the K / V stages, and
// at least two (a consumer holds one tile while it waits for the next)
int launch_dkv_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                    const void* g, const float* lse, const float* dvec,
                    void* dqkv, int batch, int n, int heads, int h, int w,
                    int blocks, cudaStream_t stream) {
  using mma::bf16;
  const bool row_tile = w == 64 && h % 2 == 0;
  const dkv::Layout L(h, w, row_tile);
  int stages = dkv::MAX_STAGES;
  while (stages > 2 && L.smem(stages) > 232448) --stages;
  const size_t smem = L.smem(stages);
  if (n < 1 || n != h * w || blocks < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  // qkv as (3C, N, B): boxes of one head's 64 columns x 64 query rows (Q)
  // or x 128 key rows (K, V); g as (C, N, B), boxes of 64 x 64
  const int c = heads * attn::D;
  CUtensorMap maps[4] = {};
  const cuuint64_t dq[3] = {(cuuint64_t)(3 * c), (cuuint64_t)n,
                            (cuuint64_t)batch};
  const cuuint64_t sq[2] = {6ull * c, 6ull * c * n};
  const cuuint64_t dg[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t sg[2] = {2ull * c, 2ull * c * n};
  const cuuint32_t box_q[3] = {attn::D, dkv::QT, 1};
  const cuuint32_t box_kv[3] = {attn::D, dkv::KEYS, 1};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hop::tensor_map(maps, bf, 3, qkv, dq, sq, box_q, sw) ||
      !hop::tensor_map(maps + 1, bf, 3, qkv, dq, sq, box_kv, sw) ||
      !hop::tensor_map(maps + 2, bf, 3, g, dg, sg, box_q, sw))
    return (int)cudaErrorInvalidValue;
  // ROW_TILE: rel_w as (64, B heads N), boxes of 64 x 64 query rows
  const cuuint64_t dw[2] = {64, (cuuint64_t)batch * heads * n};
  const cuuint64_t sw_[1] = {128};
  const cuuint32_t box_w[2] = {64, dkv::QT};
  if (row_tile && !hop::tensor_map(maps + 3, bf, 2, rel_w, dw, sw_, box_w, sw))
    return (int)cudaErrorInvalidValue;
  dkv::Args a;
  a.rel_h = static_cast<const bf16*>(rel_h);
  a.rel_w = static_cast<const bf16*>(rel_w);
  a.lse = lse, a.dvec = dvec;
  a.dqkv = static_cast<bf16*>(dqkv);
  a.rel_h_len = (long long)batch * heads * n * h;
  a.rel_w_len = (long long)batch * heads * n * w;
  a.n = n, a.heads = heads, a.H = h, a.W = w;
  a.qtiles = (n + dkv::QT - 1) / dkv::QT, a.stages = stages;
  a.kblocks = (n + dkv::KEYS - 1) / dkv::KEYS;
  a.units = batch * heads * a.kblocks;
  auto kernel = row_tile ? attn_bwd_dkv_wgmma_kernel<true>
                         : attn_bwd_dkv_wgmma_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<min(blocks, a.units), dkv::NTH, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), bfloat16 (qkv, rel, g, dqkv and drel; lse and dvec
// are f32; the f32 kernels are attention_bwd_wgmma_tf32.cu's). The dq
// kernel writes the q columns of dqkv and drel; the dk/dv kernel the k and
// v columns. Each launches on `stream` and returns the cudaError_t of its
// launch (0 = success); the caller raises on non-zero.
extern "C" {

// nk, kv_stages, u_stages, blocks: the kernel's plan (launch_dq_bf16)
int dhoct_attn_bwd_dq(const void* qkv, const void* rel_h, const void* rel_w,
                      const void* g, const void* lse, const void* dvec,
                      void* dqkv, void* drel_h, void* drel_w, int batch,
                      int n, int heads, int h, int w, int nk, int kv_stages,
                      int u_stages, int blocks, void* stream) {
  return launch_dq_bf16(qkv, rel_h, rel_w, g, static_cast<const float*>(lse),
                        static_cast<const float*>(dvec), dqkv, drel_h, drel_w,
                        batch, n, heads, h, w, nk, kv_stages, u_stages, blocks,
                        static_cast<cudaStream_t>(stream));
}

// blocks: the kernel's persistent blocks (the card's SMs)
int dhoct_attn_bwd_dkv(const void* qkv, const void* rel_h, const void* rel_w,
                       const void* g, const void* lse, const void* dvec,
                       void* dqkv, int batch, int n, int heads, int h, int w,
                       int blocks, void* stream) {
  return launch_dkv_bf16(qkv, rel_h, rel_w, g, static_cast<const float*>(lse),
                         static_cast<const float*>(dvec), dqkv, batch, n,
                         heads, h, w, blocks, static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
