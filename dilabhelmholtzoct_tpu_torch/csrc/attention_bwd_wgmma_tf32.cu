// K5 in f32 on Hopper's wgmma and TMA, every product in split TF32: the
// backward of the encoder attention K1 / K2 from the logsumexp rows the
// forward saved (the f32 K1 and K2 are attention_relpos_wgmma_tf32.cu's
// kernel at head dim 64). The
// bf16 twin, with the operands and the math spelled out, is
// attention_bwd.cu:
//
//   s  = q.k / 8 + rel_h[q, k / W] + rel_w[q, k % W]
//   p  = exp(s - L),  dp = dO.v,  ds = p * (dp - D)
//   dq = ds.k / 8,  dk = ds^T.(q / 8),  dv = p^T.dO
//   drel_h[q, r] = sum over the keys k of grid row r of ds[q, k]; drel_w
//   likewise over the keys of grid column c
//
// It replaces dilabhelmholtzoct_tpu/ops/attention.py::_flash_packed_bwd in
// f32, as two kernels like the TPU's: attn_bwd_dq_wgmma_tf32_kernel for
// _packed_bwd_dq_kernel (pallas_call :1096), attn_bwd_dkv_wgmma_tf32_kernel
// for _packed_bwd_dkv_kernel (pallas_call :1147). f32 rounds nowhere: p and
// ds stay f32, every sum is f32, the 1/8 comes after the sums (exact).
//
// Split TF32 (split_tf32.cuh): x = trunc(x) + lo, the raw f32 its own hi
// (the tensor cores read the top 19 bits of a .tf32 operand) and lo = x -
// trunc(x) exact in f32 (lo_trunc); a product a.b is lo_a.hi_b + hi_a.lo_b
// + hi_a.hi_b on wgmma ... .f32.tf32.tf32 with f32 accumulators. What that
// drops (lo_a.lo_b, the bits of lo past TF32) is about 2^-20 of each
// product; tests/test_torch_split_tf32.py emulates both kernels'
// arithmetic on the CPU.
//
// Bound on an H100 SXM (700 W), ViT-B's global layer at B = 4 (12 heads
// of 64, N = 4096) over split TF32's rate (495 / 3 = 165 TFLOP/s): the dq
// kernel's three products 309 GFLOP = 1.87 ms, the dk/dv kernel's four 412
// GFLOP = 2.50 ms, against ~0.09 ms of bytes; the windowed layer (100
// windows of 196) 0.107 / 0.143 ms. Operation-bound.
//
// What the design does about it. Every product is a wgmma, its operands in
// the layouts TF32 wgmma reads: shared operands K-major only (no transpose
// bit for TF32), so the products whose K is the other side's rows (dk +=
// ds^T.q, dv += p^T.dO, dq += ds.k) read q, dO and k transposed. Each
// kernel starts with a pre-pass in the same call, one block a tile of 32
// rows of the other side (dq: 32 key slots, dk/dv: 32 queries), that
// writes the tile's image in device memory: its rows' lo parts and its
// transposes raw and lo, each a part of 32 x 64 f32 (8 KB) already in the
// 128-byte swizzle wgmma reads, the transposed ones with the keys (queries)
// of each k8 step in the order 0 2 4 6 1 3 5 7, so that a score
// accumulator is the A fragment of the next product as it stands (d[4j],
// d[4j + 2], d[4j + 1], d[4j + 3] are k8 step j's a0..a3); the dk/dv
// image also holds the tile's L, D and bias rows. The main kernel lands an
// image with one bulk copy beside the tile's raw rows and its own side's
// rows (dk/dv: K and V; dq: Q and dO), both by TMA; its consumers hold the
// own rows' lo parts in registers as A fragments and let wgmma read their
// raw part from shared memory. A score product per k8 step: a_lo.b (RS),
// a.b_lo (SS), a.b (SS), m64n32k8; a gradient product per k8 step of the
// tile: x_lo.bT, x.bT_lo, x.bT (RS, m64n64k8). Persistent blocks, a
// producer warp, two consumer warpgroups taking turns to issue (one's
// elementwise work runs beside the other's products).
//
// Bytes and registers. An image is 32 KB a key tile (dq), 16 KB on the
// windows (GRID: a producer warp writes the lo rows in the kernel, where
// the image bytes cost more than that pass), or 57 KB a query tile (dk/dv
// at W = 64: six parts, L, D and 32 rel_w rows of 68 f32), written once a
// layer and read by each unit of its (batch, head) from L2: at B = 4 ~200
// and ~350 MB, 0.05-0.2 ms of the call. Shared memory: dk/dv a unit's K and
// V (64 KB) and two query stages (73 KB at W = 64); dq one unit stage of Q
// and dO (64 KB; 101 KB at W = 64 with L, D and the unit's rel_w rows) and
// two K / V stages of 48 KB (GRID: two of each). Registers: a consumer
// holds ~200 (the unit rows' lo fragments 2 x 32, the gradient
// accumulators 64, the scores 32 and their lo parts 32); the producer
// warpgroup keeps 24 (dk/dv) or 32 (dq). An in-kernel transpose (a
// producer warpgroup writing each tile's transposes as it lands) needs
// ~56 there, which leaves the consumers 224: the dk/dv consumers spill
// below 240.

#include <type_traits>

#include "attention_mma.cuh"
#include "hopper.cuh"
#include "split_tf32.cuh"

namespace {

using namespace attn;

namespace bt {

constexpr int T32 = 32;          // rows of a tile of the other side
constexpr int UNIT = 128;        // rows of a unit (keys: dk/dv, queries: dq)
constexpr int CONSUMERS = 256;   // two warpgroups of 64 unit rows each
constexpr int NTH = CONSUMERS + 128;
// registers a thread: 168 at launch (64K over 384 threads, in steps of 8);
// the producer's warpgroup gives back all but P, the consumers take them
// up to C (128 P + 256 C <= 384 x 168): a consumer holds its rows' lo
// parts as A fragments (2 x 32), its gradient accumulators (dk and dv, or
// dq and for ROW 32 drel_w sums: 64 each), the scores (2 x 16) and their
// lo parts (2 x 16). The dk/dv kernel takes 24 / 240 (at 232 its windowed
// instance spills), the dq kernel 32 / 232 (its ROW producers spill at 24)
constexpr int DKV_PRODUCER_REGS = 24, DKV_CONSUMER_REGS = 240;
constexpr int DQ_PRODUCER_REGS = 32, DQ_CONSUMER_REGS = 232;
constexpr int TURN = 1;  // named barriers 1, 2: the warpgroups' turns
constexpr int SMEM_FIXED = 1024 + 128;  // alignment slack, mbarriers
constexpr int PART = T32 * D * 4;       // 8 KB: one part of an image
constexpr int PSLAB = T32 * 128;        // 4 KB: 32 columns of a part's rows
constexpr int SLAB = UNIT * 128;        // 16 KB: 32 columns of a unit's rows
constexpr int UNIT_KV = 4 * SLAB;       // dk/dv: a unit's K and V
constexpr int MAX_Q_STAGES = 3, MAX_KV_STAGES = 4, MAX_U_STAGES = 2;
// the parts of a tile's stage: dk/dv Q, dO (raw rows), Q lo, dO lo (rows),
// Q^T, Q^T lo, dO^T, dO^T lo (transposed); dq K, V (raw rows), K lo, V lo
// (rows), K^T, K^T lo (transposed). TMA lands the raw rows from qkv (g);
// the rest is the tile's image, from RAW on, but for the dq kernel's GRID
// instance, whose second producer warp writes K's and V's lo rows beside
// the raw ones (an elementwise pass in the same swizzled layout; on the
// windows the pre-pass's bytes cost more than that), so that its image is
// the transposes alone, from ROWS on
constexpr int Q_RAW = 0, G_RAW = 1, Q_LO = 2, G_LO = 3, Q_T = 4, G_T = 6;
constexpr int K_RAW = 0, V_RAW = 1, K_LO = 2, V_LO = 3, K_T = 4;
constexpr int RAW = 2 * PART, ROWS = 4 * PART;
constexpr int KV_STAGE = 6 * PART;  // dq: a key tile's stage
// dq: the bytes of a key tile's image (tpr 0: GRID), which fills the last
// bytes of its stage
__host__ __device__ constexpr int kv_image(int tpr) {
  return KV_STAGE - (tpr ? RAW : ROWS);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// a staged row of `len` bias factors in the dk/dv image: 4 floats of
// padding where len is a multiple of 8 (W = 64: the 32 lanes of a warp read
// 32 banks)
__host__ __device__ constexpr int pitch(int len) {
  return len % 8 ? len : len + 4;
}
// dq ROW: a staged rel_w row of the unit, its tpr tiles' 32 tpr slots and
// 8 floats of padding (rows start 8 banks apart: a warp's float2 reads of
// 8 rows x 4 column pairs hit distinct banks in each half). tpr, tiles of
// a grid row: 0 where a tile is two grid rows of 16
// key slots (GRID, W <= 16), else a grid row of W <= 64 keys in 32-slot
// tiles
__host__ __device__ constexpr int rw_pitch(int tpr) { return 32 * tpr + 8; }

// byte offset of (row, col) of 64 f32 columns in two slabs of 32 (128-byte
// rows, their 16-byte chunks XORed with row % 8: TMA's 128-byte swizzle),
// slabs `slab` bytes apart
__host__ __device__ constexpr int swz(int row, int col, int slab) {
  return (col >> 5) * slab + row * 128 +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}
// byte offset of (head column d, position pos) of a transposed part: 64
// rows of 32 positions, the same swizzle
__host__ __device__ constexpr int t_off(int d, int pos) {
  return d * 128 + (((pos >> 2) ^ (d & 7)) << 4) + (pos & 3) * 4;
}
// the row of the tile at position pos of a transposed part: a k8 step's
// positions hold its rows 0 2 4 6 1 3 5 7
__host__ __device__ constexpr int t_row(int pos) {
  return (pos & ~7) + ((pos & 7) < 4 ? 2 * (pos & 7) : 2 * (pos & 7) - 7);
}

// dk/dv: a query tile's stage (8 parts, then L, D, rel_w rows and, but for
// ROW_TILE, rel_h rows, rounded up to 1 KB; offsets from the stage's
// start), its image (the stage past RAW) and the shared memory of a launch
// (ops/attention.py: dkv_plan_f32)
struct QImage {
  int l, d, rw, rh, bytes, image;
  __host__ __device__ QImage(int h, int w, bool row_tile)
      : l(8 * PART),
        d(l + 4 * T32),
        rw(d + 4 * T32),
        rh(rw + 4 * T32 * pitch(w)),
        bytes(round_up(rh + (row_tile ? 0 : 4 * T32 * pitch(h)), 1024)),
        image(bytes - RAW) {}
  __host__ __device__ size_t smem(int stages) const {
    return SMEM_FIXED + (size_t)UNIT_KV + (size_t)stages * bytes;
  }
};

// dq: a unit stage (Q, dO: two slabs each; for ROW the unit's L, D and
// rel_w rows of rw_pitch(tpr) f32) and the shared memory of a launch
// (ops/attention.py: dq_plan_f32). GRID reads L and D through L1: two
// values a lane and unit, and the stage stays at 64 KB, so that two unit
// stages fit beside two K / V stages (ROW keeps them in the stage: held in
// registers from the loads, they tip the ROW instance's wgmma into
// serialization, C7511)
struct QUnit {
  int l, d, rw, bytes;
  __host__ __device__ explicit QUnit(int tpr)
      : l(4 * SLAB),
        d(l + 4 * UNIT),
        rw(d + 4 * UNIT),
        bytes(tpr ? round_up(rw + 4 * UNIT * rw_pitch(tpr), 1024) : l) {}
  __host__ __device__ size_t smem(int u_stages, int kv_stages) const {
    return SMEM_FIXED + (size_t)u_stages * bytes +
           (size_t)kv_stages * KV_STAGE;
  }
};

// ------------------------------------------------------------ pre-pass ----
// a staged tile x (32 rows of 64 f32) into a tile's image whose first byte
// is the stage's `first`: where lp >= 0 its lo rows as stage part lp, where
// tp >= 0 its transposes as parts tp (raw), tp + 1 (lo); by the block's
// 256 threads, 16 bytes a store
__device__ __forceinline__ float4 lo4(float4 v) {
  using stf32::lo_trunc;
  return make_float4(lo_trunc(v.x), lo_trunc(v.y), lo_trunc(v.z),
                     lo_trunc(v.w));
}

__device__ __forceinline__ void write_tile(unsigned char* image, int first,
                                           const float (*x)[D + 1], int lp,
                                           int tp) {
  for (int i = threadIdx.x; lp >= 0 && i < T32 * D / 4; i += 256) {
    const int r = i >> 4, c = (i & 15) * 4;
    const float4 v = make_float4(x[r][c], x[r][c + 1], x[r][c + 2],
                                 x[r][c + 3]);
    *reinterpret_cast<float4*>(image + lp * PART - first +
                               swz(r, c, PSLAB)) = lo4(v);
  }
  if (tp < 0) return;
  for (int i = threadIdx.x; i < D * T32 / 4; i += 256) {
    const int dc = i >> 3, p = (i & 7) * 4;
    const float4 v = make_float4(x[t_row(p)][dc], x[t_row(p + 1)][dc],
                                 x[t_row(p + 2)][dc], x[t_row(p + 3)][dc]);
    unsigned char* dst = image + tp * PART - first + t_off(dc, p);
    *reinterpret_cast<float4*>(dst) = v;
    *reinterpret_cast<float4*>(dst + PART) = lo4(v);
  }
}

// dk/dv: the image of query tile blockIdx.x of (batch, head) blockIdx.y:
// Q's and dO's lo rows and transposes, L (+inf past N: p = 0 there), D,
// the tile's rel_w rows and, but for ROW_TILE, rel_h rows (zero past N)
__global__ void __launch_bounds__(256)
dkv_images_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec,
                  const float* __restrict__ rel_h,
                  const float* __restrict__ rel_w,
                  unsigned char* __restrict__ img, int n, int heads, int H,
                  int W, int qtiles, int row_tile) {
  __shared__ float xs[2][T32][D + 1];
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, head = bh % heads, q0 = tile * T32;
  const int C = heads * D;
  const QImage I(H, W, row_tile);
  for (int i = threadIdx.x; i < T32 * D; i += 256) {
    const int r = i / D, c = i % D, q = q0 + r;
    const bool ok = q < n;
    const size_t row = (size_t)b * n + (ok ? q : 0);
    xs[0][r][c] = ok ? qkv[row * 3 * C + head * D + c] : 0.f;
    xs[1][r][c] = ok ? g[row * C + head * D + c] : 0.f;
  }
  __syncthreads();
  unsigned char* out = img + ((size_t)bh * qtiles + tile) * I.image;
  write_tile(out, RAW, xs[0], Q_LO, Q_T);
  write_tile(out, RAW, xs[1], G_LO, G_T);
  const size_t head_row = (size_t)bh * n;
  if (threadIdx.x < T32) {
    const int q = q0 + threadIdx.x;
    reinterpret_cast<float*>(out + I.l - RAW)[threadIdx.x] =
        q < n ? lse[head_row + q] : INFINITY;
    reinterpret_cast<float*>(out + I.d - RAW)[threadIdx.x] =
        q < n ? dvec[head_row + q] : 0.f;
  }
  float* rw = reinterpret_cast<float*>(out + I.rw - RAW);
  for (int i = threadIdx.x; i < T32 * W; i += 256) {
    const int r = i / W, c = i - r * W, q = q0 + r;
    rw[r * pitch(W) + c] = q < n ? rel_w[(head_row + q) * W + c] : 0.f;
  }
  if (!row_tile) {
    float* rh = reinterpret_cast<float*>(out + I.rh - RAW);
    for (int i = threadIdx.x; i < T32 * H; i += 256) {
      const int r = i / H, c = i - r * H, q = q0 + r;
      rh[r * pitch(H) + c] = q < n ? rel_h[(head_row + q) * H + c] : 0.f;
    }
  }
}

// dq: the image of key tile blockIdx.x of (batch, head) blockIdx.y: K's
// transposes and, but for GRID, K's and V's lo rows. Slot s of the tile is
// key (kr, kc): tpr
// 0 (GRID) kr = 2 tile + s / 16, kc = s % 16; else kr = tile / tpr, kc =
// 32 (tile % tpr) + s. A slot past W or H is a zero row (as TMA lands the
// raw rows through a (W, H) view of qkv).
__global__ void __launch_bounds__(256)
dq_images_kernel(const float* __restrict__ qkv,
                 unsigned char* __restrict__ img, int n, int heads, int H,
                 int W, int ntiles, int tpr) {
  __shared__ float xs[2][T32][D + 1];
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, head = bh % heads, C = heads * D;
  for (int i = threadIdx.x; i < T32 * D; i += 256) {
    const int s = i / D, c = i % D;
    const int kr = tpr ? tile / tpr : 2 * tile + (s >> 4);
    const int kc = tpr ? 32 * (tile % tpr) + s : s & 15;
    const bool ok = kr < H && kc < W;
    const size_t row = (size_t)b * n + (ok ? kr * W + kc : 0);
    xs[0][s][c] = ok ? qkv[row * 3 * C + C + head * D + c] : 0.f;
    if (tpr) xs[1][s][c] = ok ? qkv[row * 3 * C + 2 * C + head * D + c] : 0.f;
  }
  __syncthreads();
  const int first = KV_STAGE - kv_image(tpr);
  unsigned char* out = img + ((size_t)bh * ntiles + tile) * kv_image(tpr);
  write_tile(out, first, xs[0], tpr ? K_LO : -1, K_T);
  if (tpr) write_tile(out, first, xs[1], V_LO, -1);
}

// the lo parts of a stage's raw rows (parts 0, 1 -> 2, 3), by a warp
__device__ __forceinline__ void lo_rows(unsigned char* stage, int lane) {
  const float4* src = reinterpret_cast<const float4*>(stage);
  float4* dst = reinterpret_cast<float4*>(stage + RAW);
  for (int i = lane; i < RAW / 16; i += 32) dst[i] = lo4(src[i]);
}

// -------------------------------------------------------- the products ----
// acc (the warpgroup's 64 unit rows x 32 tile rows) = A . B^T over the
// head's 64 columns in split TF32: A the unit's rows (raw: `a_unit`, slabs
// of SLAB; lo: the lane's A fragments al), B the tile's rows (raw part b,
// lo part blo; slabs of PSLAB). Per k8 step a_lo.b, a.b_lo, a.b (the
// small terms first); a k8 step is 32 bytes on (2 in the descriptor's
// address field, which holds bytes / 16)
__device__ __forceinline__ void score_product(float* acc,
                                              const uint32_t (*al)[4],
                                              const unsigned char* a_unit,
                                              const unsigned char* b,
                                              const unsigned char* blo,
                                              int wgi) {
  using namespace hop;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint64_t ad =
        desc(a_unit + s * SLAB + wgi * 64 * 128, 16, 1024, LAYOUT_SW128);
    const uint64_t bd = desc(b + s * PSLAB, 16, 1024, LAYOUT_SW128);
    const uint64_t bl = desc(blo + s * PSLAB, 16, 1024, LAYOUT_SW128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_tf32_rs<T32>(acc, al[4 * s + kk], bd + 2 * kk, s > 0 || kk > 0);
      mma_tf32_ss<T32>(acc, ad + 2 * kk, bl + 2 * kk, 1);
      mma_tf32_ss<T32>(acc, ad + 2 * kk, bd + 2 * kk, 1);
    }
  }
}

// acc (64 unit rows x 64 head columns) += X . B over the tile's 32 rows in
// split TF32: X the scores' A fragments (raw xh, lo xl; k8 step j's rows in
// the transposed parts' order), B a transposed part (raw bt, lo btl)
__device__ __forceinline__ void grad_product(float* acc,
                                             const uint32_t (*xh)[4],
                                             const uint32_t (*xl)[4],
                                             const unsigned char* bt,
                                             const unsigned char* btl,
                                             bool accumulate) {
  using namespace hop;
  const uint64_t bd = desc(bt, 16, 1024, LAYOUT_SW128);
  const uint64_t bl = desc(btl, 16, 1024, LAYOUT_SW128);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_tf32_rs<D>(acc, xl[j], bd + 2 * j, accumulate || j > 0);
    mma_tf32_rs<D>(acc, xh[j], bl + 2 * j, 1);
    mma_tf32_rs<D>(acc, xh[j], bd + 2 * j, 1);
  }
}

// the lane's lo A fragments of the k8 steps of unit rows r0, r0 + 8 from
// raw rows in slabs of SLAB: a0 (row r0, col t), a1 (r0 + 8, t), a2 (r0,
// t + 4), a3 (r0 + 8, t + 4) of each step
__device__ __forceinline__ void lo_fragments(uint32_t (*al)[4],
                                             const unsigned char* rows,
                                             int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      al[kk][i] = __float_as_uint(stf32::lo_trunc(
          *reinterpret_cast<const float*>(
              rows + swz(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1),
                         SLAB))));
}

// the A fragments of an accumulator tile of 32 columns (raw, lo): k8 step j
// is d[4j], d[4j + 2], d[4j + 1], d[4j + 3]
__device__ __forceinline__ void acc_fragments(uint32_t (*xh)[4],
                                              uint32_t (*xl)[4],
                                              const float* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xh[j][i] = __float_as_uint(f[i]);
      xl[j][i] = __float_as_uint(stf32::lo_trunc(f[i]));
    }
  }
}

// a ring of `stages` stages walked in order: the current stage and the
// parity of its phase
struct Ring {
  int stages, stage = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void next() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// ------------------------------------------------------ dk / dv, f32 ----
// attn_bwd_dkv_wgmma_tf32_kernel<ROW_TILE>: persistent blocks over units of
// (batch, head, 128 keys); warpgroup w owns keys 64 w.. of a unit, the
// rows of every product.
//   producer (one lane): per unit K and V (TMA, 32-column slabs of 128 rows
//     in the 128-byte swizzle, rows past N zero) into the unit's K / V
//     stage; per tile of 32 queries its Q and dO rows (TMA, slabs of 32
//     rows) and its image (one bulk copy) into a ring of query stages (2 at
//     W = 64: 2 x 73 KB beside 64 KB of K and V).
//   consumers: K's and V's lo parts of the warpgroup's rows as A fragments
//     for the unit; per tile S^T = K . Q^T and dP^T = V . dO^T
//     (score_product), p = exp(S^T / 8 + rel_h + rel_w - L), ds = p (dP^T
//     - D) in f32 (a query past N has L = +inf: p = ds = 0), then dV += p^T
//     . dO and dK += ds^T . Q (grad_product on the image's dO^T, Q^T). dk =
//     dK / 8 after the f32 sums; a unit owns its keys: no atomics.
// ROW_TILE (W = 64, even H: every ViT global layer): a warpgroup's 64 keys
// are one grid row, so rel_h is one value a query (read through L1);
// else each key's grid (row, column) is looked up in the staged rows.
struct DkvArgs {
  const unsigned char* img;
  const float* rel_h;
  float* dqkv;
  int n, heads, H, W, qtiles, kblocks, units, stages;
};

template <bool ROW_TILE>
__global__ void __launch_bounds__(NTH, 1)
attn_bwd_dkv_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap tm_kv,
                               const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_g,
                               const DkvArgs a) {
  using namespace hop;
  using mma::exp2_approx;
  using mma::LOG2E;
  const QImage I(a.H, a.W, ROW_TILE);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* kv = base;  // K slabs 0, 1, then V slabs 0, 1
  unsigned char* stages = kv + UNIT_KV;
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(stages + a.stages * I.bytes);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvempty + 1;
  uint64_t* empty = full + MAX_Q_STAGES;
  const int C = a.heads * D;
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, CONSUMERS / 32);  // a lane of each warp
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
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
    setmaxnreg_dec<DKV_PRODUCER_REGS>();
    if (warp > CONSUMERS / 32 || lane != 0) return;
    Ring ring(a.stages);
    int uu = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
      const int kb = u % a.kblocks, bh = u / a.kblocks;
      const int head = bh % a.heads, b = bh / a.heads;
      mbar_wait(kvempty, (uu & 1) ^ 1);
      mbar_expect_tx(kvfull, UNIT_KV);
#pragma unroll
      for (int s = 0; s < 4; ++s)  // K's slabs, then V's
        tma_load_3d(kv + s * SLAB, &tm_kv, kvfull,
                    (1 + (s >> 1)) * C + head * D + 32 * (s & 1), kb * UNIT,
                    b);
      for (int t = 0; t < a.qtiles; ++t, ring.next()) {
        unsigned char* sg = stages + ring.stage * I.bytes;
        uint64_t* f = full + ring.stage;
        mbar_wait(empty + ring.stage, ring.phase ^ 1);
        mbar_expect_tx(f, I.bytes);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          tma_load_3d(sg + Q_RAW * PART + s * PSLAB, &tm_q, f,
                      head * D + 32 * s, t * T32, b);
          tma_load_3d(sg + G_RAW * PART + s * PSLAB, &tm_g, f,
                      head * D + 32 * s, t * T32, b);
        }
        bulk_load(sg + RAW, a.img + ((size_t)bh * a.qtiles + t) * I.image,
                  I.image, f);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<DKV_CONSUMER_REGS>();
  const int wgi = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wgi + 16 * (warp & 3) + g;  // the lane's rows r0, + 8
  const int ph = pitch(a.H), pw = pitch(a.W);
  // the two warpgroups take turns issuing their products: barrier TURN +
  // wgi is this warpgroup's turn, the other arrives on it after each of
  // its issues (warpgroup 0 goes first)
  if (wgi == 1) named_arrive(TURN, CONSUMERS);
  Ring ring(a.stages);
  int uu = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++uu) {
    const int kb = u % a.kblocks, bh = u / a.kblocks;
    const int head = bh % a.heads, b = bh / a.heads, k0 = kb * UNIT;
    const long long head_row = (long long)bh * a.n;
    // the lane's keys k0 + r0 + 8 h at grid row kr[h], column kc[h] (0 past
    // N: their rows are not stored); ROW_TILE: the warpgroup's grid row krw
    int kr[2], kc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + r0 + 8 * h;
      kr[h] = key < a.n ? key / a.W : 0;
      kc[h] = key < a.n ? key - kr[h] * a.W : 0;
    }
    const int krw = k0 / 64 + wgi;
    mbar_wait(kvfull, uu & 1);
    uint32_t kl[D / 8][4], vl[D / 8][4];
    lo_fragments(kl, kv, r0, t);
    lo_fragments(vl, kv + 2 * SLAB, r0, t);
    fence_operands(kl);
    fence_operands(vl);
    float dk[D / 2], dv[D / 2];
    for (int tile = 0; tile < a.qtiles; ++tile, ring.next()) {
      const unsigned char* sg = stages + ring.stage * I.bytes;
      mbar_wait(full + ring.stage, ring.phase);
      float s[T32 / 2], dp[T32 / 2];
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      score_product(s, kl, kv, sg + Q_RAW * PART, sg + Q_LO * PART, wgi);
      score_product(dp, vl, kv + 2 * SLAB, sg + G_RAW * PART,
                    sg + G_LO * PART, wgi);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      // ROW_TILE: rel_h of the lane's queries 8 j + 2 t + e at the
      // warpgroup's grid row, loaded while the products run (a query past
      // N reads row N - 1: its p is 0)
      float rhq[8];
      if constexpr (ROW_TILE) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = min(tile * T32 + 8 * (i >> 1) + 2 * t + (i & 1),
                            a.n - 1);
          rhq[i] = __ldg(a.rel_h + (head_row + q) * a.H + krw);
        }
      }
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      // K and V are read by the unit's last scores: the next unit's load
      if (tile == a.qtiles - 1) release(kvempty);
      // p and ds in f32, never rounded: s[4 j + 2 h + e] is key h's score
      // of query 8 j + 2 t + e
      const float* ls = reinterpret_cast<const float*>(sg + I.l);
      const float* dsv = reinterpret_cast<const float*>(sg + I.d);
      const float* rw = reinterpret_cast<const float*>(sg + I.rw);
      const float* rh = reinterpret_cast<const float*>(sg + I.rh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q2 = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + q2);
        const float2 d2 = *reinterpret_cast<const float2*>(dsv + q2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q2 + e;
          const float lb = (e ? l2.y : l2.x) * LOG2E, dd = e ? d2.y : d2.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float bias =
                (ROW_TILE ? rhq[2 * j + e] : rh[q * ph + kr[h]]) +
                rw[q * pw + kc[h]];
            const float p = exp2_approx(
                fmaf(fmaf(s[i], 0.125f, bias), LOG2E, -lb));
            dp[i] = p * (dp[i] - dd);
            s[i] = p;
          }
        }
      }
      uint32_t xh[4][4], xl[4][4], yh[4][4], yl[4][4];
      acc_fragments(xh, xl, s);   // p^T
      acc_fragments(yh, yl, dp);  // ds^T
      fence_operands(xh);
      fence_operands(xl);
      fence_operands(yh);
      fence_operands(yl);
      fence_operands(dk);
      fence_operands(dv);
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      grad_product(dv, xh, xl, sg + G_T * PART, sg + (G_T + 1) * PART,
                   tile > 0);
      grad_product(dk, yh, yl, sg + Q_T * PART, sg + (Q_T + 1) * PART,
                   tile > 0);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<0>();
      fence_operands(dk);
      fence_operands(dv);
      release(empty + ring.stage);
    }
    // dk = dK / 8 (the scale after the f32 sum, exact), dv: the lane's
    // columns 8 j + 2 t, + 1 of its two keys
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + r0 + 8 * h;
      if (key >= a.n) continue;
      float* dst = a.dqkv + ((size_t)b * a.n + key) * 3 * C + head * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst + C + 8 * j) = make_float2(
            dk[4 * j + 2 * h] * 0.125f, dk[4 * j + 2 * h + 1] * 0.125f);
        *reinterpret_cast<float2*>(dst + 2 * C + 8 * j) =
            make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
  if (wgi == 0) named_sync(TURN, CONSUMERS);  // warpgroup 1's last arrive
}

// ------------------------------------------------------- dq / drel, f32 ----
// attn_bwd_dq_wgmma_tf32_kernel<TPR>: persistent blocks over units of
// (batch, head, 128 queries); warpgroup w owns queries 64 w.. of a unit,
// which owns their dq, drel_h and drel_w rows: no atomics, a fixed
// summation order, the same bits on every run.
//   producer (two warps): the first per unit Q and dO (TMA, two 32-column
//     slabs of 128 rows each, rows past N zero) into a ring of unit stages,
//     per key tile its K and V rows (TMA through a (W, H) view of qkv: the
//     empty slots land as zero rows) and its image (one bulk copy) into a
//     ring of K / V stages, running ahead across units; the second for ROW
//     the unit's L, D and rel_w rows (cp.async), for GRID each key tile's
//     K and V lo rows once its raw rows landed.
//   consumers: q's and dO's lo parts as A fragments for the unit; per tile
//     S = q . K^T and dP = dO . V^T (score_product), p = exp(S / 8 + rel_h
//     + rel_w - L), ds = p (dP - D) in f32 (an empty slot's bias is -inf:
//     p = ds = 0; a row past N has L = +inf), drel summed in registers,
//     dQ += ds . K (grad_product on the image's K^T); dq = dQ / 8 after the
//     f32 sum.
// How a tile's 32 key slots map to keys (the images' slots), and drel:
//   GRID (TPR = 0, W <= 16: the windows): two grid rows of 16 slots, so
//     the lane's column 8 j + 2 t + e is grid row 2 tile + j / 2, column 8
//     (j % 2) + 2 t + e: drel_h of a grid row is the lane's 4 values, then
//     the quad; drel_w sums the lane's 8 columns over the tiles; the lane's
//     rel_w values sit in registers for the unit, rel_h comes through L1.
//   ROW (TPR = 1, 2: 16 < W <= 64, every ViT global layer at 2): a grid row
//     is TPR tiles of 32 slots, drel_h[q][r] its row sum (the lane's 8 TPR
//     values, then the quad), drel_w gathers column c of every row in the
//     lane's own 16 TPR sums; rel_w comes from the unit stage's rows.
struct DqArgs {
  const unsigned char* img;
  const float* rel_h;
  const float* rel_w;
  const float* lse;
  const float* dvec;
  float* dqkv;
  float* drel_h;
  float* drel_w;
  int n, heads, H, W, qblocks, units, ntiles, kv_stages, u_stages;
};

template <int TPR>
__global__ void __launch_bounds__(NTH, 1)
attn_bwd_dq_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_g,
                              const __grid_constant__ CUtensorMap tm_k,
                              const DqArgs a) {
  using namespace hop;
  using mma::exp2_approx;
  using mma::LOG2E;
  using mma::quad_sum;
  constexpr bool GRID = TPR == 0;
  constexpr int PW = rw_pitch(TPR);
  const QUnit U(TPR);
  extern __shared__ __align__(16) unsigned char smem_tma[];
  unsigned char* base = smem_tma + ((1024 - (smem(smem_tma) & 1023)) & 1023);
  unsigned char* ubase = base;
  unsigned char* kvbase = ubase + a.u_stages * U.bytes;
  uint64_t* ufull =
      reinterpret_cast<uint64_t*>(kvbase + a.kv_stages * KV_STAGE);
  uint64_t* uempty = ufull + MAX_U_STAGES;
  uint64_t* kvfull = uempty + MAX_U_STAGES;   // the raw rows, the image
  uint64_t* kvready = kvfull + MAX_KV_STAGES;  // GRID: and the lo rows
  uint64_t* kvempty = kvready + MAX_KV_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.u_stages; ++i) {
      mbar_init(ufull + i, 33);  // the TMA lane's arrive + 32 cp.async ones
      mbar_init(uempty + i, CONSUMERS / 32);  // a lane of each warp
    }
    for (int i = 0; i < a.kv_stages; ++i) {
      mbar_init(kvfull + i, 1);
      mbar_init(kvready + i, 32);  // each lane of the second producer warp
      mbar_init(kvempty + i, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (warp >= CONSUMERS / 32) {  // ----------------------------- producer ----
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    // two warps load: the first Q, dO and the key tiles; the second L, D
    // and the unit's rel_w rows (ROW), and its lanes' arrives on the unit
    // stage (their copies landed), and for GRID each key tile's lo rows
    if (warp > CONSUMERS / 32 + 1) return;
    const bool second = warp > CONSUMERS / 32;
    const int C = a.heads * D;
    Ring uring(a.u_stages), kvring(a.kv_stages);
    for (int u = blockIdx.x; u < a.units; u += gridDim.x, uring.next()) {
      const int qb = u % a.qblocks, bh = u / a.qblocks;
      const int head = bh % a.heads, b = bh / a.heads, q0 = qb * UNIT;
      unsigned char* ust = ubase + uring.stage * U.bytes;
      uint64_t* uf = ufull + uring.stage;
      mbar_wait(uempty + uring.stage, uring.phase ^ 1);
      if (second) {
        if constexpr (!GRID) {  // 0 past N
          const int nq = min(UNIT, a.n - q0);
          const long long row = (long long)bh * a.n + q0;
          const float* lse = a.lse + row;
          const float* dvec = a.dvec + row;
          const float* src = a.rel_w + row * a.W;
          float* ls = reinterpret_cast<float*>(ust + U.l);
          float* dsv = reinterpret_cast<float*>(ust + U.d);
          for (int i = lane; i < UNIT; i += 32) {
            const bool ok = i < nq;
            mma::cp_async4(ls + i, lse + (ok ? i : 0), ok);
            mma::cp_async4(dsv + i, dvec + (ok ? i : 0), ok);
          }
          float* rw = reinterpret_cast<float*>(ust + U.rw);
          if (a.W % 4 == 0) {
            const int pieces = a.W / 4;
            for (int i = lane; i < UNIT * pieces; i += 32) {
              const int r = i / pieces, c = 4 * (i - r * pieces);
              const bool ok = r < nq;
              mma::cp_async16(rw + r * PW + c, src + (ok ? r * a.W + c : 0),
                              ok);
            }
          } else {
            for (int i = lane; i < UNIT * a.W; i += 32) {
              const int r = i / a.W, c = i - r * a.W;
              const bool ok = r < nq;
              mma::cp_async4(rw + r * PW + c, src + (ok ? r * a.W + c : 0),
                             ok);
            }
          }
        }
        mbar_arrive_cp_async(uf);
        if constexpr (GRID)
          for (int tile = 0; tile < a.ntiles; ++tile, kvring.next()) {
            unsigned char* kst = kvbase + kvring.stage * KV_STAGE;
            mbar_wait(kvfull + kvring.stage, kvring.phase);
            lo_rows(kst, lane);
            fence_proxy_async();  // our writes -> the wgmma reads
            mbar_arrive(kvready + kvring.stage);
          }
        continue;
      }
      if (lane == 0) {
        mbar_expect_tx(uf, 4 * SLAB);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          tma_load_3d(ust + s * SLAB, &tm_q, uf, head * D + 32 * s, q0, b);
          tma_load_3d(ust + (2 + s) * SLAB, &tm_g, uf, head * D + 32 * s, q0,
                      b);
        }
      }
      for (int tile = 0; tile < a.ntiles; ++tile, kvring.next()) {
        unsigned char* kst = kvbase + kvring.stage * KV_STAGE;
        uint64_t* f = kvfull + kvring.stage;
        mbar_wait(kvempty + kvring.stage, kvring.phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(f, RAW + kv_image(TPR));
          // the tile's first key slot at grid (kr, kc)
          const int kr = GRID ? 2 * tile : tile / max(TPR, 1);
          const int kc = GRID ? 0 : 32 * (tile % max(TPR, 1));
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            tma_load_4d(kst + K_RAW * PART + s * PSLAB, &tm_k, f,
                        C + head * D + 32 * s, kc, kr, b);
            tma_load_4d(kst + V_RAW * PART + s * PSLAB, &tm_k, f,
                        2 * C + head * D + 32 * s, kc, kr, b);
          }
          bulk_load(kst + KV_STAGE - kv_image(TPR),
                    a.img + ((size_t)bh * a.ntiles + tile) * kv_image(TPR),
                    kv_image(TPR), f);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ----
  setmaxnreg_inc<DQ_CONSUMER_REGS>();
  const int wgi = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wgi + 16 * (warp & 3) + g;  // the lane's rows r0, + 8
  if (wgi == 1) named_arrive(TURN, CONSUMERS);
  Ring uring(a.u_stages), kvring(a.kv_stages);
  for (int u = blockIdx.x; u < a.units; u += gridDim.x, uring.next()) {
    const int qb = u % a.qblocks, bh = u / a.qblocks;
    const int head = bh % a.heads, b = bh / a.heads, q0 = qb * UNIT;
    const unsigned char* ust = ubase + uring.stage * U.bytes;
    const long long row = (long long)bh * a.n + q0;
    const int nq = min(UNIT, a.n - q0);
    // the lane's rows' first elements of rel_h and rel_w (a row past N
    // reads row N - 1: its p is 0)
    int rh_row[2], rw_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = bh * a.n + min(q0 + r0 + 8 * r, a.n - 1);
      rh_row[r] = qr * a.H;
      rw_row[r] = qr * a.W;
    }
    // GRID: the lane's rel_w values for the unit, its grid columns 8 (i /
    // 2) + 2 t + i % 2 (-inf past W: the slot is empty)
    float rwg[2][GRID ? 4 : 1];
    if constexpr (GRID) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = 8 * (i >> 1) + 2 * t + (i & 1);
          rwg[r][i] = kc < a.W ? __ldg(a.rel_w + rw_row[r] + kc) : -INFINITY;
        }
    }
    // L (log2 units; +inf past N: p = 0) and D of the lane's rows
    bool live[2];
    float Lb[2], Dq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r0 + 8 * r;
      live[r] = q < nq;
      if constexpr (GRID) {
        Lb[r] = live[r] ? __ldg(a.lse + row + q) * LOG2E : INFINITY;
        Dq[r] = live[r] ? __ldg(a.dvec + row + q) : 0.f;
      }
    }
    mbar_wait(ufull + uring.stage, uring.phase);
    if constexpr (!GRID) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r0 + 8 * r;
        Lb[r] = live[r]
                    ? reinterpret_cast<const float*>(ust + U.l)[q] * LOG2E
                    : INFINITY;
        Dq[r] = reinterpret_cast<const float*>(ust + U.d)[q];
      }
    }
    uint32_t ql[D / 8][4], gl[D / 8][4];
    lo_fragments(ql, ust, r0, t);
    lo_fragments(gl, ust + 2 * SLAB, r0, t);
    fence_operands(ql);
    fence_operands(gl);
    float dqa[D / 2];
    // drel_w sums of the lane: GRID grid column 8 jj + 2 t + e of row r at
    // 4 r + 2 jj + e; ROW column 32 c + 8 j + 2 t + e at 8 (TPR r + c) + 2
    // j + e
    float dw[GRID ? 8 : 16 * TPR] = {};
    float rs[2] = {0.f, 0.f};  // ROW: the current grid row's drel_h sums
    float* dh = a.drel_h + (row + r0) * a.H;  // the lane's first drel_h row

    // key tile `tile`, its slots' part c of their grid row (ROW)
    auto tile_body = [&](auto cc, int tile) {
      [[maybe_unused]] constexpr int c = decltype(cc)::value;
      const unsigned char* kst = kvbase + kvring.stage * KV_STAGE;
      mbar_wait(kvfull + kvring.stage, kvring.phase);
      if constexpr (GRID) mbar_wait(kvready + kvring.stage, kvring.phase);
      float s[T32 / 2], dp[T32 / 2];
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      score_product(s, ql, ust, kst + K_RAW * PART, kst + K_LO * PART, wgi);
      score_product(dp, gl, ust + 2 * SLAB, kst + V_RAW * PART,
                    kst + V_LO * PART, wgi);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      // rel_h of the tile, loaded while the products run: ROW one value a
      // row (grid row tile / TPR), GRID two (grid rows 2 tile, + 1; -inf
      // past H: empty slots)
      float rh[2][GRID ? 2 : 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (GRID) {
#pragma unroll
          for (int k = 0; k < 2; ++k)
            rh[r][k] = 2 * tile + k < a.H
                           ? __ldg(a.rel_h + rh_row[r] + 2 * tile + k)
                           : -INFINITY;
        } else {
          rh[r][0] = __ldg(a.rel_h + rh_row[r] + tile / TPR);
        }
      }
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      // GRID: the tile's drel_h sums, row r, grid row k
      [[maybe_unused]] float rg[2][2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 w2 = make_float2(0.f, 0.f);  // ROW: rel_w of the two slots
          if constexpr (!GRID)
            w2 = *reinterpret_cast<const float2*>(
                ust + U.rw + 4 * ((r0 + 8 * r) * PW + 32 * c + 8 * j + 2 * t));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float bias;
            if constexpr (GRID) {
              bias = rh[r][j >> 1] + rwg[r][2 * (j & 1) + e];
            } else {
              bias = 32 * c + 8 * j + 2 * t + e < a.W
                         ? rh[r][0] + (e ? w2.y : w2.x)
                         : -INFINITY;
            }
            const float p = exp2_approx(
                fmaf(fmaf(s[i], 0.125f, bias), LOG2E, -Lb[r]));
            const float ds = p * (dp[i] - Dq[r]);
            s[i] = ds;
            if constexpr (GRID) {
              rg[r][j >> 1] += ds;
              dw[4 * r + 2 * (j & 1) + e] += ds;
            } else {
              rs[r] += ds;
              dw[8 * (TPR * r + c) + 2 * j + e] += ds;
            }
          }
        }
      }
      // drel_h of the grid rows this tile finished: the lane's sums, then
      // the quad's, in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (GRID) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float sum = quad_sum(rg[r][k]);
            if (t == 0 && live[r] && 2 * tile + k < a.H)
              dh[8 * r * a.H + 2 * tile + k] = sum;
          }
        } else if (c == TPR - 1) {
          const float sum = quad_sum(rs[r]);
          rs[r] = 0.f;
          if (t == 0 && live[r]) dh[8 * r * a.H + tile / TPR] = sum;
        }
      }
      uint32_t xh[4][4], xl[4][4];
      acc_fragments(xh, xl, s);  // ds
      fence_operands(xh);
      fence_operands(xl);
      fence_operands(dqa);
      named_sync(TURN + wgi, CONSUMERS);
      wgmma_fence();
      grad_product(dqa, xh, xl, kst + K_T * PART, kst + (K_T + 1) * PART,
                   tile > 0);
      wgmma_commit();
      named_arrive(TURN + (wgi ^ 1), CONSUMERS);
      wgmma_wait<0>();
      fence_operands(dqa);
      release(kvempty + kvring.stage);
      kvring.next();
    };
    if constexpr (GRID) {
      for (int tile = 0; tile < a.ntiles; ++tile)
        tile_body(std::integral_constant<int, 0>{}, tile);
    } else {
      for (int tile = 0; tile < a.ntiles; tile += TPR) {
        tile_body(std::integral_constant<int, 0>{}, tile);
        if constexpr (TPR == 2)
          tile_body(std::integral_constant<int, 1>{}, tile + 1);
      }
    }
    release(uempty + uring.stage);  // Q, dO (L, D, rel_w) are read

    // dq = dQ / 8 (the scale after the f32 sum, exact) and drel_w
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const int q = r0 + 8 * r;
      float* dst =
          a.dqkv + ((size_t)b * a.n + q0 + q) * 3 * a.heads * D + head * D +
          2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(dqa[4 * j + 2 * r] * 0.125f,
                        dqa[4 * j + 2 * r + 1] * 0.125f);
      float* dw_row = a.drel_w + (row + q) * a.W;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (GRID) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int kc = 8 * jj + 2 * t + e;
            if (kc < a.W) dw_row[kc] = dw[4 * r + 2 * jj + e];
          }
        } else {
#pragma unroll
          for (int c = 0; c < TPR; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int kc = 32 * c + 8 * j + 2 * t + e;
              if (kc < a.W) dw_row[kc] = dw[8 * (TPR * r + c) + 2 * j + e];
            }
        }
      }
    }
  }
  if (wgi == 0) named_sync(TURN, CONSUMERS);  // warpgroup 1's last arrive
}

}  // namespace bt

// the tiles of a dq unit's keys: tpr 0 (GRID) a tile per two grid rows,
// else tpr tiles a grid row
int dq_tiles(int h, int tpr) { return tpr ? h * tpr : (h + 1) / 2; }

// qkv (or g) as (cols, N, B) f32: boxes of 32 columns x `rows` rows in the
// 128-byte swizzle
bool rows_map(CUtensorMap* map, const void* p, int cols, int n, int batch,
              int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {4ull * cols, 4ull * cols * n};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  return hop::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// qkv as (cols, W, H, B) f32: a dq key tile's 32 slots, boxes of 32
// columns x 16 x 2 grid cells (tpr 0, GRID) or 32 x 1 (a part of a grid
// row), in the 128-byte swizzle; cells past W or H land as zeros
bool grid_map(CUtensorMap* map, const void* qkv, int cols, int h, int w,
              int batch, int tpr) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {4ull * cols, 4ull * cols * w,
                                 4ull * cols * w * h};
  const cuuint32_t box[4] = {32, tpr ? 32u : 16u, tpr ? 1u : 2u, 1};
  return hop::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, qkv, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

bool rel_fits(int batch, int heads, int n, int h, int w) {
  // the bias factors are indexed with int offsets
  return (long long)batch * heads * n * (h > w ? h : w) < (1ll << 31);
}

template <bool ROW_TILE>
int launch_dkv_inst(const CUtensorMap (&maps)[3], const bt::DkvArgs& a,
                    size_t smem, int blocks, cudaStream_t stream) {
  auto kernel = bt::attn_bwd_dkv_wgmma_tf32_kernel<ROW_TILE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, bt::NTH, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The launch plan (ops/attention.py: dkv_plan_f32): image_bytes a query
// tile's image (QImage::image, checked), stages the query ring's depth,
// blocks the persistent blocks. img holds (batch heads) x ceil(N / 32)
// images.
int launch_dkv(const void* qkv, const void* rel_h, const void* rel_w,
               const void* g, const float* lse, const float* dvec,
               void* dqkv, void* img, int batch, int n, int heads, int h,
               int w, int image_bytes, int stages, int blocks,
               cudaStream_t stream) {
  const bool row_tile = w == 64 && h % 2 == 0;
  const bt::QImage I(h, w, row_tile);
  const size_t smem = I.smem(stages);
  if (n < 1 || n != h * w || !rel_fits(batch, heads, n, h, w) ||
      image_bytes != I.image || stages < 1 || stages > bt::MAX_Q_STAGES ||
      blocks < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int c = heads * attn::D, qtiles = (n + bt::T32 - 1) / bt::T32;
  bt::dkv_images_kernel<<<dim3(qtiles, batch * heads), 256, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), lse, dvec,
      static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      static_cast<unsigned char*>(img), n, heads, h, w, qtiles, row_tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // K, V: boxes of 128 rows; a query tile's Q, dO: 32
  CUtensorMap maps[3] = {};
  if (!rows_map(maps, qkv, 3 * c, n, batch, bt::UNIT) ||
      !rows_map(maps + 1, qkv, 3 * c, n, batch, bt::T32) ||
      !rows_map(maps + 2, g, c, n, batch, bt::T32))
    return (int)cudaErrorInvalidValue;
  bt::DkvArgs a;
  a.img = static_cast<const unsigned char*>(img);
  a.rel_h = static_cast<const float*>(rel_h);
  a.dqkv = static_cast<float*>(dqkv);
  a.n = n, a.heads = heads, a.H = h, a.W = w;
  a.qtiles = qtiles;
  a.kblocks = (n + bt::UNIT - 1) / bt::UNIT;
  a.units = batch * heads * a.kblocks;
  a.stages = stages;
  blocks = min(blocks, a.units);
  return row_tile ? launch_dkv_inst<true>(maps, a, smem, blocks, stream)
                  : launch_dkv_inst<false>(maps, a, smem, blocks, stream);
}

template <int TPR>
int launch_dq_inst(const CUtensorMap (&maps)[3], const bt::DqArgs& a,
                   size_t smem, int blocks, cudaStream_t stream) {
  auto kernel = bt::attn_bwd_dq_wgmma_tf32_kernel<TPR>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, bt::NTH, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The launch plan (ops/attention.py: dq_plan_f32): tpr (0: GRID, W <= 16;
// else ceil(W / 32), W <= 64), tiles (checked), kv_stages / u_stages the
// ring depths, blocks the persistent blocks. img holds (batch heads) x
// tiles key tile images.
int launch_dq(const void* qkv, const void* rel_h, const void* rel_w,
              const void* g, const float* lse, const float* dvec, void* dqkv,
              void* drel_h, void* drel_w, void* img, int batch, int n,
              int heads, int h, int w, int tpr, int tiles, int kv_stages,
              int u_stages, int blocks, cudaStream_t stream) {
  const int want_tpr = w <= 16 ? 0 : (w + 31) / 32;
  const bt::QUnit U(tpr);
  const size_t smem = U.smem(u_stages, kv_stages);
  if (n < 1 || n != h * w || w > 64 || tpr != want_tpr ||
      !rel_fits(batch, heads, n, h, w) || tiles != dq_tiles(h, tpr) ||
      kv_stages < (tiles > 1 ? 2 : 1) || kv_stages > bt::MAX_KV_STAGES ||
      u_stages < 1 || u_stages > bt::MAX_U_STAGES || blocks < 1 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int c = heads * attn::D;
  bt::dq_images_kernel<<<dim3(tiles, batch * heads), 256, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<unsigned char*>(img), n,
      heads, h, w, tiles, tpr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // Q, dO: boxes of 128 rows; K, V: a key tile's slots
  CUtensorMap maps[3] = {};
  if (!rows_map(maps, qkv, 3 * c, n, batch, bt::UNIT) ||
      !rows_map(maps + 1, g, c, n, batch, bt::UNIT) ||
      !grid_map(maps + 2, qkv, 3 * c, h, w, batch, tpr))
    return (int)cudaErrorInvalidValue;
  bt::DqArgs a;
  a.img = static_cast<const unsigned char*>(img);
  a.rel_h = static_cast<const float*>(rel_h);
  a.rel_w = static_cast<const float*>(rel_w);
  a.lse = lse, a.dvec = dvec;
  a.dqkv = static_cast<float*>(dqkv);
  a.drel_h = static_cast<float*>(drel_h);
  a.drel_w = static_cast<float*>(drel_w);
  a.n = n, a.heads = heads, a.H = h, a.W = w;
  a.qblocks = (n + bt::UNIT - 1) / bt::UNIT;
  a.units = batch * heads * a.qblocks;
  a.ntiles = tiles;
  a.kv_stages = kv_stages, a.u_stages = u_stages;
  blocks = min(blocks, a.units);
  switch (tpr) {
    case 0:
      return launch_dq_inst<0>(maps, a, smem, blocks, stream);
    case 1:
      return launch_dq_inst<1>(maps, a, smem, blocks, stream);
    default:
      return launch_dq_inst<2>(maps, a, smem, blocks, stream);
  }
}

}  // namespace

// C interface (ctypes), float32. Each call launches its pre-pass, then its
// kernel, on `stream` and returns the cudaError_t of the launches (0 =
// success); the caller raises on non-zero. The dq kernel writes the q
// columns of dqkv and drel; the dk/dv kernel the k and v columns. img is
// the caller's scratch for the images (ops/attention.py sizes it from the
// plan).
extern "C" {

int dhoct_attn_bwd_dq_f32(const void* qkv, const void* rel_h,
                          const void* rel_w, const void* g, const void* lse,
                          const void* dvec, void* dqkv, void* drel_h,
                          void* drel_w, void* img, int batch, int n,
                          int heads, int h, int w, int tpr, int tiles,
                          int kv_stages, int u_stages, int blocks,
                          void* stream) {
  return launch_dq(qkv, rel_h, rel_w, g, static_cast<const float*>(lse),
                   static_cast<const float*>(dvec), dqkv, drel_h, drel_w, img,
                   batch, n, heads, h, w, tpr, tiles, kv_stages, u_stages,
                   blocks, static_cast<cudaStream_t>(stream));
}

int dhoct_attn_bwd_dkv_f32(const void* qkv, const void* rel_h,
                           const void* rel_w, const void* g, const void* lse,
                           const void* dvec, void* dqkv, void* img, int batch,
                           int n, int heads, int h, int w, int image_bytes,
                           int stages, int blocks, void* stream) {
  return launch_dkv(qkv, rel_h, rel_w, g, static_cast<const float*>(lse),
                    static_cast<const float*>(dvec), dqkv, img, batch, n,
                    heads, h, w, image_bytes, stages, blocks,
                    static_cast<cudaStream_t>(stream));
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
