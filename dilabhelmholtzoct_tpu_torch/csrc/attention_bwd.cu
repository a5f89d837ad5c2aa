// K5: the flash backward of the encoder attention K1 / K2 (attention.cu),
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
// Replaces dilabhelmholtzoct_tpu/ops/attention.py::_flash_packed_bwd, as two
// kernels like the TPU's:
//   the dq kernel (_packed_bwd_dq_kernel): one block per (batch, head,
//     query tile) loops over 64-key tiles and accumulates dq and drel in
//     registers (or drel in shared memory). The block owns its query rows:
//     no atomics, a fixed summation order, a deterministic result.
//   the dk/dv kernel (_packed_bwd_dkv_kernel): one block per (batch, head,
//     128-key tile) loops over 64-query tiles and accumulates dk and dv in
//     registers.
// Both serve every N (global 64x64 = 4096, 14x14 = 196 windows, ragged
// grids): the last tile of either kind is masked, so K5 needs no windowed
// variant. Windows that the partition zero-padded are ordinary inputs here:
// their pad tokens are live keys, as in the forward.
//
// Rounding where the TPU kernels round (bf16; f32 rounds nowhere: p and ds
// stay f32): q/8 is exact; the dq kernel takes ds = bf16(p * (dp - D))
// with p in f32; the dk/dv kernel rounds p first, p_b = bf16(p), and takes
// ds = bf16(p_b * (dp - D)), so the two kernels' ds differ on purpose;
// dq = bf16(sum * 1/8); drel sums the bf16 ds in f32 and rounds once.
//
// Two instances of each kernel, both on the tensor cores. f32 (the serving
// type's training path, compute_dtype='float32'): attn_bwd_dq_tf32_kernel /
// attn_bwd_dkv_tf32_kernel, every product in split TF32 (attention_tf32.cuh:
// hi.hi + hi.lo + lo.hi, f32 accuracy). bf16 (the full fine-tune path):
// attn_bwd_dq_mma_kernel / attn_bwd_dkv_mma_kernel, mma.sync m16n8k16
// (attention_mma.cuh).
//
// Bound on an H100 SXM (700 W), one global layer at B = 4, 12 heads:
//    dq kernel: 3 products (s, dp, dq) = 6 * 4096^2 * 64 * 48 = 309 GFLOP;
//    dk/dv kernel: 4 products (s, dp, dv, dk) = 412 GFLOP. In bf16 over
//    the 989 TFLOP/s tensor-core rate: 0.31 + 0.42 ms; in f32 over the
//    split-TF32 rate (495 / 3 = 165 TFLOP/s): 1.87 + 2.50 ms (over the 67
//    TFLOP/s of the CUDA cores: 4.62 + 6.15); the bytes (qkv, dO, rel, L, D
//    in, dqkv and drel out: ~0.3 GB in bf16) take 0.09 ms. Compute-bound.
// What this design does about it: warps of 16 rows, the other side's tiles
//    streamed through a 2-stage cp.async ring from padded shared rows. The
//    dq kernel recomputes s and p per key tile, takes dp = dO.v^T, ds = p *
//    (dp - D) (bf16: rounded) and dq += ds.k with ds fed from registers;
//    drel sums ds in a fixed order: where a key tile is one grid row (W =
//    64, every ViT's global layer) from registers (the row sum over the
//    lane quad for drel_h, a per-lane accumulator for drel_w), else through
//    a shared tile, one thread per slot in key order. The dk/dv kernel (8
//    warps, 128 keys per block) computes s^T = k.q^T so that p^T and ds^T
//    land in registers with keys as rows: dv += p^T.dO, dk += ds^T.q, times
//    1/8 at the end (exact); bf16 rounds p first, p_b = bf16(p), and takes
//    ds = bf16(p_b * (dp - D)).
//    bf16: 4 warps per dq block, ldmatrix from rows of 72 bf16.
//    f32: operands stay f32 in shared memory (rows of 68 floats: every
//    fragment load on 32 banks) and are split into hi / lo TF32 as their
//    fragments are loaded (an A fragment once per k step for all its n
//    tiles); p and ds are never rounded. A key (or query) tile goes in two
//    halves of 32 and the two score products share one k loop: fewer
//    registers live, more accumulator chains in flight. The dq block holds
//    8 warps (128 query rows) wherever the shared memory allows (every ViT
//    layer), else 4; where ROW_TILE it sums drel_w in the lanes' own slots
//    of a shared tile.
//    Each qkv and dO byte is read from device memory once per tile of the
//    other side.
// A fused single kernel and wgmma with TMA are later work.

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

using namespace attn;


// ------------------------------------------------- dq / drel, f32 ----
// grid (ceil(N / R), heads, B), R = 16 WARPS query rows per block, 32 WARPS
// threads: warp w owns query rows 16 w + g and 16 w + g + 8 (lane = 4 g +
// t). Every product in split TF32 (attention_tf32.cuh), a 64-key tile in
// two halves of 32 keys (half the score registers live). Shared (f32, rows
// of LDF unless stated):
//   Qs R | Gs R | Ks stage 0, 1 (64) | Vs stage 0, 1 (64) | Rh R x
//   factor_ld(H), where ROW_TILE dRw R x LDF | Rw R x factor_ld(W); unless
//   ROW_TILE, then Ss R | dRh R x H | dRw R x W.
// ROW_TILE (W == 64, every ViT global layer): a 64-key tile is one grid
// row, so the bias of a query row over the tile is one Rh value (read from
// device memory) plus Rw over the 64 columns, drel_h[q][r] is the tile's
// row sum (in registers) and drel_w[q][c] gathers the same column of every
// tile, in the lane's own slots of dRw. WARPS is 8 wherever the shared
// memory holds it (always where ROW_TILE), else 4.
size_t dq_tf32_smem_bytes(int h, int w, int warps) {
  using namespace tf32;
  const size_t rows = 16 * warps;
  const bool row_tile = w == TILE;
  size_t floats = (2 * rows + 4 * TILE) * LDF +
                  rows * ((row_tile ? LDF : factor_ld(h)) + factor_ld(w));
  if (!row_tile) floats += rows * (LDF + h + w);
  return sizeof(float) * floats;
}

template <bool ROW_TILE, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
attn_bwd_dq_tf32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ rel_h,
                        const float* __restrict__ rel_w,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        float* __restrict__ dqkv, float* __restrict__ drel_h,
                        float* __restrict__ drel_w, int n, int heads, int H,
                        int W) {
  using namespace tf32;
  using mma::LOG2E;
  constexpr int R = 16 * WARPS, NTH = 32 * WARPS, KH = TILE / 2;
  extern __shared__ __align__(16) float smem[];
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  float* Qs = smem;
  float* Gs = Qs + R * LDF;
  float* Ks = Gs + R * LDF;
  float* Vs = Ks + 2 * TILE_FLOATS;
  float* Rh = Vs + 2 * TILE_FLOATS;  // ROW_TILE: dRw, R x LDF
  float* Rw = Rh + R * (ROW_TILE ? LDF : ldh);
  float* Ss = Rw + R * ldw;
  float* dRh = Ss + R * LDF;
  float* dRw = ROW_TILE ? Rh : dRh + R * H;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * R;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int t = lane & 3, qa = r0 + (lane >> 2), qb = qa + 8;
  const float* base = qkv + (size_t)b * n * stride + head * D;
  const size_t row = ((size_t)b * heads + head) * n + q0;
  const int nq = min(R, n - q0);

  load_tile<NTH>(Qs, base, stride, q0, n, R);
  load_tile<NTH>(Gs, g + (size_t)b * n * C + head * D, C, q0, n, R);
  if (!ROW_TILE) load_factors<NTH>(Rh, rel_h + row * H, H, nq, R);
  load_factors<NTH>(Rw, rel_w + row * W, W, nq, R);
  load_tile<NTH>(Ks, base + C, stride, 0, n);
  load_tile<NTH>(Vs, base + 2 * C, stride, 0, n);
  mma::cp_commit();
  for (int i = threadIdx.x; i < (ROW_TILE ? R * LDF : R * (H + W)); i += NTH)
    (ROW_TILE ? dRw : dRh)[i] = 0.f;

  // L (in log2 units) and D of the lane's two query rows
  const int ql[2] = {qa, qb};
  bool live[2];
  float Lb[2], Dq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = ql[r] < nq;
    Lb[r] = live[r] ? lse[row + ql[r]] * LOG2E : 0.f;
    Dq[r] = live[r] ? dvec[row + ql[r]] : 0.f;
  }

  float dq[D / 8][4] = {};
  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    const float* Kc = Ks + (it & 1) * TILE_FLOATS;
    const float* Vc = Vs + (it & 1) * TILE_FLOATS;
    float rh[2] = {0.f, 0.f};  // ROW_TILE: rel_h of the lane's rows here
    if (ROW_TILE) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (live[r]) rh[r] = rel_h[(row + ql[r]) * H + it];
    }
    if (it + 1 < ntiles) {  // the stage consumed in the previous iteration
      load_tile<NTH>(Ks + ((it + 1) & 1) * TILE_FLOATS, base + C, stride,
                     k0 + TILE, n);
      load_tile<NTH>(Vs + ((it + 1) & 1) * TILE_FLOATS, base + 2 * C, stride,
                     k0 + TILE, n);
    }
    mma::cp_commit();
    mma::cp_wait<1>();  // this tile (and Q, dO, the factors) have landed
    __syncthreads();

    float rsum[2] = {0.f, 0.f};  // ROW_TILE: the lane's share of drel_h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kh = KH * h;
      // ROW_TILE: s starts at 8 x the bias (exact), the product adds q.k,
      // and the 1/8 scale then applies to both (exact)
      float s[KH / 8][4], dp[KH / 8][4] = {};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < KH / 8; ++j) {
          const float2 rw =
              ROW_TILE ? *reinterpret_cast<const float2*>(
                             Rw + ql[r] * ldw + kh + 8 * j + 2 * t)
                       : make_float2(0.f, 0.f);
          s[j][2 * r] = 8.f * (rh[r] + rw.x);
          s[j][2 * r + 1] = 8.f * (rh[r] + rw.y);
        }
      }
      // s += q.k^T, dp = dO.v^T
      product_nk2<KH / 8>(s, Qs, Kc + kh * LDF, dp, Gs, Vc + kh * LDF, r0,
                          lane);
      // then p and ds = p * (dp - D) in f32, never rounded; 0 past n
      if (ROW_TILE) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < KH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[j][2 * r + e];
              const float p =
                  mma::exp2_approx(fmaf(x, 0.125f * LOG2E, -Lb[r]));
              x = live[r] ? p * (dp[j][2 * r + e] - Dq[r]) : 0.f;
            }
      } else {
        mma::KeyWalk key(k0 + kh + 2 * t, W);
#pragma unroll
        for (int j = 0; j < KH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool kv = k0 + kh + 8 * j + 2 * t + e < n;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              // computed for every slot, then selected (a key past n reads
              // in-bounds shared memory, discarded)
              const float sv = fmaf(s[j][2 * r + e], 0.125f,
                                    Rh[ql[r] * ldh + key.r] +
                                        Rw[ql[r] * ldw + key.c]);
              const float p = mma::exp2_approx(fmaf(sv, LOG2E, -Lb[r]));
              const float ds = p * (dp[j][2 * r + e] - Dq[r]);
              s[j][2 * r + e] = kv && live[r] ? ds : 0.f;
            }
            key.step(e);
          }
      }
      product_kn<KH / 8>(dq, s, Kc + kh * LDF, lane);  // dq += ds.k

      if (ROW_TILE) {
        // drel_h[q][k0 / 64] is this tile's row sum: the lane's 16 values,
        // then the quad, in a fixed order; drel_w[q][c] gathers column c of
        // every tile in the lane's own slots of dRw
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < KH / 8; ++j) {
            rsum[r] += s[j][2 * r] + s[j][2 * r + 1];
            float2* dw = reinterpret_cast<float2*>(dRw + ql[r] * LDF + kh +
                                                   8 * j + 2 * t);
            const float2 x = *dw;
            *dw = make_float2(x.x + s[j][2 * r], x.y + s[j][2 * r + 1]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < KH / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(Ss + ql[r] * LDF + kh + 8 * j +
                                       2 * t) =
                make_float2(s[j][2 * r], s[j][2 * r + 1]);
      }
    }

    if (ROW_TILE) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = mma::quad_sum(rsum[r]);
        if (t == 0 && live[r]) drel_h[(row + ql[r]) * H + it] = sum;
      }
    } else {
      __syncthreads();
      // each (query, grid row) and (query, grid column) slot of this tile
      // is summed by one thread, in key order
      const int kend = min(k0 + TILE, n);
      const int rr0 = k0 / W, nr = (kend - 1) / W - rr0 + 1;
      for (int x = threadIdx.x; x < R * nr; x += NTH) {
        const int q = x / nr, rr = rr0 + x % nr;
        const int lo = max(rr * W, k0) - k0, hi = min((rr + 1) * W, kend) - k0;
        float sum = 0.f;
        for (int kl = lo; kl < hi; ++kl) sum += Ss[q * LDF + kl];
        dRh[q * H + rr] += sum;
      }
      for (int x = threadIdx.x; x < R * W; x += NTH) {
        const int q = x / W, c = x % W;
        float sum = 0.f;
        for (int kl = (c - k0 % W + W) % W; kl < kend - k0; kl += W)
          sum += Ss[q * LDF + kl];
        dRw[x] += sum;
      }
    }
    __syncthreads();  // every warp is done with this stage (and Ss)
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    float* dst = dqkv + ((size_t)b * n + q0 + ql[r]) * stride + head * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) =
          make_float2(dq[dn][2 * r] * 0.125f, dq[dn][2 * r + 1] * 0.125f);
    if (ROW_TILE) {
      float* dw_row = drel_w + (row + ql[r]) * W + 2 * t;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
        *reinterpret_cast<float2*>(dw_row + 8 * j) =
            *reinterpret_cast<const float2*>(dRw + ql[r] * LDF + 8 * j +
                                             2 * t);
    }
  }
  if (!ROW_TILE) {
    for (int x = threadIdx.x; x < nq * H; x += NTH) drel_h[row * H + x] = dRh[x];
    for (int x = threadIdx.x; x < nq * W; x += NTH) drel_w[row * W + x] = dRw[x];
  }
}

// ------------------------------------------------------ dk / dv, f32 ----
// grid (ceil(N / 128), heads, B), 256 threads: warp w owns key rows
// 16 w + g and 16 w + g + 8 of the block's 128 keys, as the bf16 kernel
// below; every product in split TF32, a 64-query tile in two halves of QH
// = 32 queries (half the score registers live). Shared (f32): Ks | Vs
// (128 x LDF) | Qs stage 0, 1 | Gs stage 0, 1 (64 x LDF) | Rh stage 0, 1
// (64 x factor_ld(H)) | Rw stage 0, 1 (64 x factor_ld(W)) | Ls stage 0, 1 |
// Ds stage 0, 1 (64 each)
constexpr int DKV_KEYS = 128, DKV_NT = 256;

size_t dkv_tf32_smem_bytes(int h, int w) {
  using namespace tf32;
  return sizeof(float) *
         ((size_t)(2 * DKV_KEYS + 4 * TILE) * LDF +
          2 * TILE * (factor_ld(h) + factor_ld(w)) + 4 * TILE);
}

// ROW_TILE (W == 64): a warp's 16 keys lie in one grid row, so both of a
// lane's keys take the same Rh value of a query.
template <bool ROW_TILE>
__global__ void __launch_bounds__(DKV_NT, 1)
attn_bwd_dkv_tf32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ rel_h,
                         const float* __restrict__ rel_w,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         float* __restrict__ dqkv, int n, int heads, int H,
                         int W) {
  using namespace tf32;
  using mma::LOG2E;
  // of parts of 8, 16 and 32 queries, each with 1 to 8 of the score
  // products' k steps unrolled, timed on an H100 at ViT-B's global layer,
  // B = 4: 32 and 4 were the fastest whose registers stay clear of spills
  constexpr int QH = TILE / 2, DKU = 4;
  extern __shared__ __align__(16) float smem[];
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  float* Ks = smem;
  float* Vs = Ks + DKV_KEYS * LDF;
  float* Qs = Vs + DKV_KEYS * LDF;
  float* Gs = Qs + 2 * TILE_FLOATS;
  float* Rh = Gs + 2 * TILE_FLOATS;
  float* Rw = Rh + 2 * TILE * ldh;
  float* Ls = Rw + 2 * TILE * ldw;
  float* Ds = Ls + 2 * TILE;

  const int head = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * DKV_KEYS;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const float* base = qkv + (size_t)b * n * stride + head * D;
  const float* gbase = g + (size_t)b * n * C + head * D;
  // this (batch, head)'s rows of the factors, L and D
  const size_t head_row = ((size_t)b * heads + head) * n;
  const float* rh_rows = rel_h + head_row * H;
  const float* rw_rows = rel_w + head_row * W;
  const float* l_rows = lse + head_row;
  const float* d_rows = dvec + head_row;

  // one query tile's operands into stage st
  auto load_q_tile = [&](int st, int q0) {
    const int nq = min(TILE, n - q0);
    load_tile<DKV_NT>(Qs + st * TILE_FLOATS, base, stride, q0, n);
    load_tile<DKV_NT>(Gs + st * TILE_FLOATS, gbase, C, q0, n);
    load_factors<DKV_NT>(Rh + st * TILE * ldh, rh_rows + (size_t)q0 * H, H,
                         nq, TILE);
    load_factors<DKV_NT>(Rw + st * TILE * ldw, rw_rows + (size_t)q0 * W, W,
                         nq, TILE);
    const int i = threadIdx.x & (TILE - 1);
    const bool ok = i < nq;
    const int src = q0 + (ok ? i : 0);
    if (threadIdx.x < TILE)
      mma::cp_async4(Ls + st * TILE + i, l_rows + src, ok);
    else if (threadIdx.x < 2 * TILE)
      mma::cp_async4(Ds + st * TILE + i, d_rows + src, ok);
  };

  load_tile<DKV_NT>(Ks, base + C, stride, k0, n, DKV_KEYS);
  load_tile<DKV_NT>(Vs, base + 2 * C, stride, k0, n, DKV_KEYS);
  load_q_tile(0, 0);
  mma::cp_commit();

  // the lane's two keys: grid row and column
  int kr[2], kc[2];
  bool kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + (lane >> 2) + 8 * r;
    kv[r] = key < n;
    kr[r] = kv[r] ? key / W : 0;  // a key past n reads row 0, unused
    kc[r] = kv[r] ? key - kr[r] * W : 0;
  }

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * TILE, st = it & 1;
    if (it + 1 < ntiles) load_q_tile(st ^ 1, q0 + TILE);
    mma::cp_commit();
    mma::cp_wait<1>();
    __syncthreads();
    const float* Qc = Qs + st * TILE_FLOATS;
    const float* Gc = Gs + st * TILE_FLOATS;
    const float* Rhc = Rh + st * TILE * ldh;
    const float* Rwc = Rw + st * TILE * ldw;
    const float* Lc = Ls + st * TILE;
    const float* Dc = Ds + st * TILE;

#pragma unroll
    for (int h = 0; h < TILE / QH; ++h) {
      const int qh = QH * h;
      float s[QH / 8][4] = {}, dp[QH / 8][4] = {};  // [key][query]
      // s = k.q^T, dp = v.dO^T
      product_nk2<QH / 8, DKU>(s, Ks, Qc + qh * LDF, dp, Vs, Gc + qh * LDF,
                                 r0, lane);
#pragma unroll
      for (int j = 0; j < QH / 8; ++j) {
        const int q2 = qh + 8 * j + 2 * t;
        const float2 L2 = *reinterpret_cast<const float2*>(Lc + q2);
        const float2 D2 = *reinterpret_cast<const float2*>(Dc + q2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q2 + e;
          const bool qv = q0 + q < n;
          const float Lb = (e ? L2.y : L2.x) * LOG2E, Dq = e ? D2.y : D2.x;
          const float rh0 = Rhc[q * ldh + kr[0]];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // computed for every slot, then selected
            const float rh = ROW_TILE || r == 0 ? rh0 : Rhc[q * ldh + kr[r]];
            const float sv = fmaf(s[j][2 * r + e], 0.125f,
                                  rh + Rwc[q * ldw + kc[r]]);
            const float p = mma::exp2_approx(fmaf(sv, LOG2E, -Lb));
            const float ds = p * (dp[j][2 * r + e] - Dq);
            const bool ok = qv && kv[r];
            s[j][2 * r + e] = ok ? p : 0.f;
            dp[j][2 * r + e] = ok ? ds : 0.f;
          }
        }
        // no factor load is hoisted across query columns (registers: it
        // would spill)
        asm volatile("" ::: "memory");
      }
      // dv += p^T.dO, dk += ds^T.q
      product_kn2<QH / 8>(dv, s, Gc + qh * LDF, dk, dp, Qc + qh * LDF, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!kv[r]) continue;
    const int key = k0 + r0 + (lane >> 2) + 8 * r;
    float* dst = dqkv + ((size_t)b * n + key) * stride + head * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      // dk = ds^T.(q / 8): the scale after the f32 sum, exact
      *reinterpret_cast<float2*>(dst + C + 8 * dn) =
          make_float2(dk[dn][2 * r] * 0.125f, dk[dn][2 * r + 1] * 0.125f);
      *reinterpret_cast<float2*>(dst + 2 * C + 8 * dn) =
          make_float2(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

// ------------------------------------------------- dq / drel, bf16 ----
// grid (ceil(N / 64), heads, B), 128 threads: warp w owns query rows
// 16 w + g and 16 w + g + 8 of the tile (lane = 4 g + t). Shared (bf16):
//   Qs | Gs | Ks stage 0, 1 | Vs stage 0, 1 (64 x LDS) | Rh 64 x
//   factor_ld(H) | Rw 64 x factor_ld(W); unless ROW_TILE, then (f32) Ss
//   64 x SLD | dRh 64 x H | dRw 64 x W.
// ROW_TILE (W == 64, every ViT global layer): a 64-key tile is one grid
// row: the bias of a query row over the tile is one Rh value plus Rw over
// the 64 columns (in the lane's registers for the whole loop), drel_h[q][r]
// is the tile's row sum and drel_w[q][c] gathers the same column of every
// tile, in registers.
constexpr int SLD = mma::TILE + 4;

size_t dq_mma_smem_bytes(int h, int w) {
  using namespace mma;
  size_t bytes = sizeof(bf16) * (size_t)(6 * TILE_ELEMS +
                                         TILE * (factor_ld(h) + factor_ld(w)));
  if (w != TILE) bytes += sizeof(float) * (size_t)(TILE * SLD + TILE * (h + w));
  return bytes;
}

template <bool ROW_TILE>
__global__ void __launch_bounds__(mma::NT, 2)
attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ rel_h,
                       const __nv_bfloat16* __restrict__ rel_w,
                       const __nv_bfloat16* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dqkv,
                       __nv_bfloat16* __restrict__ drel_h,
                       __nv_bfloat16* __restrict__ drel_w, int n, int heads,
                       int H, int W) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + TILE_ELEMS;
  bf16* Ks = Gs + TILE_ELEMS;
  bf16* Vs = Ks + 2 * TILE_ELEMS;
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  bf16* Rh = Vs + 2 * TILE_ELEMS;
  bf16* Rw = Rh + TILE * ldh;
  float* Ss = reinterpret_cast<float*>(Rw + TILE * ldw);
  float* dRh = Ss + TILE * SLD;
  float* dRw = dRh + TILE * H;

  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TILE;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int t = lane & 3, qa = r0 + (lane >> 2), qb = qa + 8;
  const bf16* base = qkv + (size_t)b * n * stride + head * D;
  const size_t row = ((size_t)b * heads + head) * n + q0;
  const int nq = min(TILE, n - q0);

  load_tile_async(Qs, base, stride, q0, n);
  load_tile_async(Gs, g + (size_t)b * n * C + head * D, C, q0, n);
  load_factors(Rh, rel_h + row * H, H, nq);
  load_factors(Rw, rel_w + row * W, W, nq);
  load_tile_async(Ks, base + C, stride, 0, n);
  load_tile_async(Vs, base + 2 * C, stride, 0, n);
  cp_commit();
  if (!ROW_TILE) {
    for (int i = threadIdx.x; i < TILE * (H + W); i += NT) dRh[i] = 0.f;
  }

  // L (in log2 units) and D of the lane's two query rows
  const int ql[2] = {qa, qb};
  bool live[2];
  float Lb[2], Dq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = ql[r] < nq;
    Lb[r] = live[r] ? lse[row + ql[r]] * LOG2E : 0.f;
    Dq[r] = live[r] ? dvec[row + ql[r]] : 0.f;
  }

  float dq[D / 8][4] = {}, dw[ROW_TILE ? TILE / 8 : 1][4] = {};
  uint32_t rwp[ROW_TILE ? TILE / 8 : 1][2];  // ROW_TILE: Rw as bf16 pairs
  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * TILE;
    const bf16* Kc = Ks + (it & 1) * TILE_ELEMS;
    const bf16* Vc = Vs + (it & 1) * TILE_ELEMS;
    if (it + 1 < ntiles) {
      load_tile_async(Ks + ((it + 1) & 1) * TILE_ELEMS, base + C, stride,
                      k0 + TILE, n);
      load_tile_async(Vs + ((it + 1) & 1) * TILE_ELEMS, base + 2 * C, stride,
                      k0 + TILE, n);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (ROW_TILE && it == 0) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rwp[ROW_TILE ? j : 0][r] = *reinterpret_cast<const uint32_t*>(
              Rw + ql[r] * ldw + 8 * j + 2 * t);
    }

    // ROW_TILE: s starts at 8 x the bias (exact), the product adds q.k,
    // and the 1/8 scale then applies to both (exact): the same scores as
    // q.k / 8 + bias up to the order of the f32 sum
    float s[TILE / 8][4], dp[TILE / 8][4] = {};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rh =
          ROW_TILE ? __bfloat162float(Rh[ql[r] * ldh + it]) : 0.f;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 rw =
            ROW_TILE ? __bfloat1622float2(
                           *reinterpret_cast<const __nv_bfloat162*>(
                               &rwp[ROW_TILE ? j : 0][r]))
                     : make_float2(0.f, 0.f);
        s[j][2 * r] = 8.f * (rh + rw.x);
        s[j][2 * r + 1] = 8.f * (rh + rw.y);
      }
    }
    product_nk<1>(&s, Qs, r0, Kc, lane);   // q.k^T
    product_nk<1>(&dp, Gs, r0, Vc, lane);  // dO.v^T
    // then p in f32 and ds = bf16(p * (dp - D)); 0 past n
    if (ROW_TILE) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            const float p =
                exp2_approx(fmaf(x, 0.125f * LOG2E, -Lb[r]));  // f32 p
            x = live[r] ? round_bf16(p * (dp[j][2 * r + e] - Dq[r])) : 0.f;
          }
    } else {
      KeyWalk key(k0 + 2 * t, W);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool kv = k0 + 8 * j + 2 * t + e < n;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // computed for every slot, then selected (no branch around the
            // loads; a key past n reads in-bounds shared memory, discarded)
            const float sv = fmaf(s[j][2 * r + e], 0.125f,
                                  __bfloat162float(Rh[ql[r] * ldh + key.r]) +
                                      __bfloat162float(Rw[ql[r] * ldw + key.c]));
            const float p = exp2_approx(fmaf(sv, LOG2E, -Lb[r]));
            const float ds = round_bf16(p * (dp[j][2 * r + e] - Dq[r]));
            s[j][2 * r + e] = kv && live[r] ? ds : 0.f;
          }
          key.step(e);
        }
    }
    uint32_t pk[TILE / 8][2];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      pk[j][0] = pack_bf16(s[j][0], s[j][1]);  // exact: ds is rounded
      pk[j][1] = pack_bf16(s[j][2], s[j][3]);
    }
    product_kn<1>(&dq, &pk, Kc, lane);  // dq += ds.k

    if (ROW_TILE) {
      // drel_h[q][k0 / 64] is this tile's row sum: the lane's 16 values,
      // then the quad, in a fixed order; drel_w[q][c] gathers column c of
      // every tile in the lane's own register
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          sum += s[j][2 * r] + s[j][2 * r + 1];
          dw[ROW_TILE ? j : 0][2 * r] += s[j][2 * r];
          dw[ROW_TILE ? j : 0][2 * r + 1] += s[j][2 * r + 1];
        }
        sum = quad_sum(sum);
        if (t == 0 && live[r])
          drel_h[(row + ql[r]) * H + it] = __float2bfloat16(sum);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          Ss[ql[r] * SLD + 8 * j + 2 * t] = s[j][2 * r];
          Ss[ql[r] * SLD + 8 * j + 2 * t + 1] = s[j][2 * r + 1];
        }
      __syncthreads();
      // each (query, grid row) and (query, grid column) slot of this tile
      // is summed by one thread, in key order
      const int kend = min(k0 + TILE, n);
      const int rr0 = k0 / W, nr = (kend - 1) / W - rr0 + 1;
      for (int x = threadIdx.x; x < TILE * nr; x += NT) {
        const int q = x / nr, rr = rr0 + x % nr;
        const int lo = max(rr * W, k0) - k0, hi = min((rr + 1) * W, kend) - k0;
        float sum = 0.f;
        for (int kl = lo; kl < hi; ++kl) sum += Ss[q * SLD + kl];
        dRh[q * H + rr] += sum;
      }
      for (int x = threadIdx.x; x < TILE * W; x += NT) {
        const int q = x / W, c = x % W;
        float sum = 0.f;
        for (int kl = (c - k0 % W + W) % W; kl < kend - k0; kl += W)
          sum += Ss[q * SLD + kl];
        dRw[x] += sum;
      }
    }
    __syncthreads();  // every warp is done with this stage (and Ss)
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    bf16* dst = dqkv + ((size_t)b * n + q0 + ql[r]) * stride + head * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dst + 8 * dn) =
          pack_bf16(dq[dn][2 * r] * 0.125f, dq[dn][2 * r + 1] * 0.125f);
    if (ROW_TILE) {
      bf16* dw_row = drel_w + (row + ql[r]) * W + 2 * t;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
        *reinterpret_cast<uint32_t*>(dw_row + 8 * j) = pack_bf16(
            dw[ROW_TILE ? j : 0][2 * r], dw[ROW_TILE ? j : 0][2 * r + 1]);
    }
  }
  if (!ROW_TILE) {
    for (int x = threadIdx.x; x < nq * H; x += NT)
      drel_h[row * H + x] = __float2bfloat16(dRh[x]);
    for (int x = threadIdx.x; x < nq * W; x += NT)
      drel_w[row * W + x] = __float2bfloat16(dRw[x]);
  }
}

// --------------------------------------------------------- dk / dv, bf16 ----
// grid (ceil(N / 128), heads, B), 256 threads: warp w owns key rows
// 16 w + g and 16 w + g + 8 of the block's 128 keys, so each query tile (q,
// dO and the bias factors, as many bytes again as q and dO) is read once
// per 128 keys. Shared (bf16): Ks | Vs (128 x LDS) | Qs stage 0, 1 | Gs
// stage 0, 1 (64 x LDS) | Rh stage 0, 1 (64 x factor_ld(H)) | Rw stage 0, 1
// (64 x factor_ld(W)); then (f32) Ls stage 0, 1 | Ds stage 0, 1 (64 each)
size_t dkv_mma_smem_bytes(int h, int w) {
  using namespace mma;
  return sizeof(bf16) * (size_t)(2 * DKV_KEYS * LDS + 4 * TILE_ELEMS +
                                 2 * TILE * (factor_ld(h) + factor_ld(w))) +
         sizeof(float) * 4 * TILE;
}

// ROW_TILE (W == 64): a warp's 16 keys lie in one grid row, so both of a
// lane's keys take the same Rh value of a query.
template <bool ROW_TILE>
__global__ void __launch_bounds__(DKV_NT, 1)
attn_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ rel_h,
                        const __nv_bfloat16* __restrict__ rel_w,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                        int H, int W) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + DKV_KEYS * LDS;
  bf16* Qs = Vs + DKV_KEYS * LDS;
  bf16* Gs = Qs + 2 * TILE_ELEMS;
  const int ldh = factor_ld(H), ldw = factor_ld(W);
  bf16* Rh = Gs + 2 * TILE_ELEMS;
  bf16* Rw = Rh + 2 * TILE * ldh;
  float* Ls = reinterpret_cast<float*>(Rw + 2 * TILE * ldw);
  float* Ds = Ls + 2 * TILE;

  const int head = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * DKV_KEYS;
  const int C = heads * D, stride = 3 * C;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const bf16* base = qkv + (size_t)b * n * stride + head * D;
  const bf16* gbase = g + (size_t)b * n * C + head * D;
  const size_t head_row = ((size_t)b * heads + head) * n;

  // one query tile's operands into stage st
  auto load_q_tile = [&](int st, int q0) {
    const int nq = min(TILE, n - q0);
    load_tile_async<DKV_NT>(Qs + st * TILE_ELEMS, base, stride, q0, n);
    load_tile_async<DKV_NT>(Gs + st * TILE_ELEMS, gbase, C, q0, n);
    load_factors<DKV_NT>(Rh + st * TILE * ldh, rel_h + (head_row + q0) * H, H,
                         nq);
    load_factors<DKV_NT>(Rw + st * TILE * ldw, rel_w + (head_row + q0) * W, W,
                         nq);
    const int i = threadIdx.x & (TILE - 1);
    const bool ok = i < nq;
    const size_t src = head_row + q0 + (ok ? i : 0);
    if (threadIdx.x < TILE)
      cp_async4(Ls + st * TILE + i, lse + src, ok);
    else if (threadIdx.x < 2 * TILE)
      cp_async4(Ds + st * TILE + i, dvec + src, ok);
  };

  load_tile_async<DKV_NT>(Ks, base + C, stride, k0, n, DKV_KEYS);
  load_tile_async<DKV_NT>(Vs, base + 2 * C, stride, k0, n, DKV_KEYS);
  load_q_tile(0, 0);
  cp_commit();

  // the lane's two keys: grid row and column
  int kr[2], kc[2];
  bool kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + (lane >> 2) + 8 * r;
    kv[r] = key < n;
    kr[r] = kv[r] ? key / W : 0;  // a key past n reads row 0, unused
    kc[r] = kv[r] ? key - kr[r] * W : 0;
  }

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const int ntiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * TILE, st = it & 1;
    if (it + 1 < ntiles) load_q_tile(st ^ 1, q0 + TILE);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Qc = Qs + st * TILE_ELEMS;
    const bf16* Gc = Gs + st * TILE_ELEMS;
    const bf16* Rhc = Rh + st * TILE * ldh;
    const bf16* Rwc = Rw + st * TILE * ldw;
    const float* Lc = Ls + st * TILE;
    const float* Dc = Ds + st * TILE;

    float s[TILE / 8][4] = {}, dp[TILE / 8][4] = {};  // [key][query]
    product_nk<1>(&s, Ks, r0, Qc, lane);   // k.q^T
    product_nk<1>(&dp, Vs, r0, Gc, lane);  // v.dO^T
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 L2 = *reinterpret_cast<const float2*>(Lc + 8 * j + 2 * t);
      const float2 D2 = *reinterpret_cast<const float2*>(Dc + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * j + 2 * t + e;
        const bool qv = q0 + q < n;
        const float Lb = (e ? L2.y : L2.x) * LOG2E, Dq = e ? D2.y : D2.x;
        const float rh0 = __bfloat162float(Rhc[q * ldh + kr[0]]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // computed for every slot, then selected: with a branch around
          // the loads the kernel ran far slower on the H100
          const float rh =
              ROW_TILE || r == 0 ? rh0
                                 : __bfloat162float(Rhc[q * ldh + kr[r]]);
          const float sv = fmaf(s[j][2 * r + e], 0.125f,
                                rh + __bfloat162float(Rwc[q * ldw + kc[r]]));
          const float p = round_bf16(exp2_approx(fmaf(sv, LOG2E, -Lb)));
          const float ds = round_bf16(p * (dp[j][2 * r + e] - Dq));
          const bool ok = qv && kv[r];
          s[j][2 * r + e] = ok ? p : 0.f;  // p_b
          dp[j][2 * r + e] = ok ? ds : 0.f;
        }
      }
    }
    uint32_t pp[TILE / 8][2], pd[TILE / 8][2];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      pp[j][0] = pack_bf16(s[j][0], s[j][1]);  // exact: both are rounded
      pp[j][1] = pack_bf16(s[j][2], s[j][3]);
      pd[j][0] = pack_bf16(dp[j][0], dp[j][1]);
      pd[j][1] = pack_bf16(dp[j][2], dp[j][3]);
    }
    product_kn<1>(&dv, &pp, Gc, lane);  // dv += p_b^T.dO
    product_kn<1>(&dk, &pd, Qc, lane);  // dk += ds^T.q
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!kv[r]) continue;
    const int key = k0 + r0 + (lane >> 2) + 8 * r;
    bf16* dst = dqkv + ((size_t)b * n + key) * stride + head * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      // dk = ds^T.(q / 8): the scale after the f32 sum, exact
      *reinterpret_cast<uint32_t*>(dst + C + 8 * dn) =
          pack_bf16(dk[dn][2 * r] * 0.125f, dk[dn][2 * r + 1] * 0.125f);
      *reinterpret_cast<uint32_t*>(dst + 2 * C + 8 * dn) =
          pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

int launch_dq_f32(const void* qkv, const void* rel_h, const void* rel_w,
                  const void* g, const float* lse, const float* dvec,
                  void* dqkv, void* drel_h, void* drel_w, int batch, int n,
                  int heads, int h, int w, cudaStream_t stream) {
  const bool row_tile = w == mma::TILE;
  const int warps = dq_tf32_smem_bytes(h, w, 8) <= 232448 ? 8 : 4;
  const size_t smem = dq_tf32_smem_bytes(h, w, warps);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // where ROW_TILE the shared memory does not depend on H: always 8 warps
  auto kernel = row_tile     ? attn_bwd_dq_tf32_kernel<true, 8>
                : warps == 8 ? attn_bwd_dq_tf32_kernel<false, 8>
                             : attn_bwd_dq_tf32_kernel<false, 4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = 16 * warps;
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(g), lse,
      dvec, static_cast<float*>(dqkv), static_cast<float*>(drel_h),
      static_cast<float*>(drel_w), n, heads, h, w);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const void* qkv, const void* rel_h, const void* rel_w,
                   const void* g, const float* lse, const float* dvec,
                   void* dqkv, int batch, int n, int heads, int h, int w,
                   cudaStream_t stream) {
  const size_t smem = dkv_tf32_smem_bytes(h, w);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = w == mma::TILE ? attn_bwd_dkv_tf32_kernel<true>
                               : attn_bwd_dkv_tf32_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + DKV_KEYS - 1) / DKV_KEYS, heads, batch);
  kernel<<<grid, DKV_NT, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(g), lse,
      dvec, static_cast<float*>(dqkv), n, heads, h, w);
  return (int)cudaGetLastError();
}

int launch_dq_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                   const void* g, const float* lse, const float* dvec,
                   void* dqkv, void* drel_h, void* drel_w, int batch, int n,
                   int heads, int h, int w, cudaStream_t stream) {
  using mma::bf16;
  const size_t smem = dq_mma_smem_bytes(h, w);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = w == mma::TILE ? attn_bwd_dq_mma_kernel<true>
                               : attn_bwd_dq_mma_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + mma::TILE - 1) / mma::TILE, heads, batch);
  kernel<<<grid, mma::NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<const bf16*>(g), lse, dvec,
      static_cast<bf16*>(dqkv), static_cast<bf16*>(drel_h),
      static_cast<bf16*>(drel_w), n, heads, h, w);
  return (int)cudaGetLastError();
}

int launch_dkv_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                    const void* g, const float* lse, const float* dvec,
                    void* dqkv, int batch, int n, int heads, int h, int w,
                    cudaStream_t stream) {
  using mma::bf16;
  const size_t smem = dkv_mma_smem_bytes(h, w);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = w == mma::TILE ? attn_bwd_dkv_mma_kernel<true>
                               : attn_bwd_dkv_mma_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + DKV_KEYS - 1) / DKV_KEYS, heads, batch);
  kernel<<<grid, DKV_NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<const bf16*>(g), lse, dvec,
      static_cast<bf16*>(dqkv), n, heads, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16 (qkv, rel, g,
// dqkv and drel share it; lse and dvec are f32). The dq kernel writes the q
// columns of dqkv and drel; the dk/dv kernel the k and v columns. Each
// launches on `stream` and returns the cudaError_t of its launch
// (0 = success); the caller raises on non-zero.
extern "C" {

int dhoct_attn_bwd_dq(const void* qkv, const void* rel_h, const void* rel_w,
                      const void* g, const void* lse, const void* dvec,
                      void* dqkv, void* drel_h, void* drel_w, int batch,
                      int n, int heads, int h, int w, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dv = static_cast<const float*>(dvec);
  if (dtype == 1)
    return launch_dq_bf16(qkv, rel_h, rel_w, g, l, dv, dqkv, drel_h, drel_w,
                          batch, n, heads, h, w, s);
  return launch_dq_f32(qkv, rel_h, rel_w, g, l, dv, dqkv, drel_h, drel_w,
                       batch, n, heads, h, w, s);
}

int dhoct_attn_bwd_dkv(const void* qkv, const void* rel_h, const void* rel_w,
                       const void* g, const void* lse, const void* dvec,
                       void* dqkv, int batch, int n, int heads, int h, int w,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dv = static_cast<const float*>(dvec);
  if (dtype == 1)
    return launch_dkv_bf16(qkv, rel_h, rel_w, g, l, dv, dqkv, batch, n, heads,
                           h, w, s);
  return launch_dkv_f32(qkv, rel_h, rel_w, g, l, dv, dqkv, batch, n, heads, h,
                        w, s);
}

const char* dhoct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
