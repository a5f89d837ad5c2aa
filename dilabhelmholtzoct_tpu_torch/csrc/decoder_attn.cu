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
//    _fused_fwd (:264, body _fwd_kernel :120-130, math _chain :86-117).
//    * bf16 (the training path): i2t_fwd_mma_kernel on the tensor cores,
//      persistent 8-warp blocks with Wq and Wo in shared memory; a warp
//      pair walks units of 16 image rows and the pb pairs of each image
//      (the q projection once per image tile).
//    * f32: i2t_fwd_kernel, one SIMT block per (pair, 32-row tile) (not on
//      a main path: the JAX package routes K4 only in bf16).
// The backward replaces the same file's _fused_bwd (:287, body _bwd_kernel
//    :133-218): it recomputes the chain, runs the LayerNorm and softmax
//    backward per row, writes d_keys and the per-row d_qpre, p, d_score and
//    d_out (the token and positional gradients are einsums over these rows
//    outside the kernel, as in the JAX package), and sums dWq, dbq, dWo,
//    dbo and the LayerNorm gradients over rows. The JAX kernel carries dW
//    in one output block across its sequential grid; here blocks run in
//    parallel, so every sum over rows is one partial per block (or warp),
//    added up by the wrapper in a fixed order -- no atomics, so the
//    gradients repeat bit for bit.
//    * bf16 (the training path): two launches on the tensor cores
//      (decoder_mma.cuh). i2t_bwd_rows_kernel is the row pass: persistent
//      8-warp blocks with Wq and Wo in shared memory, a warp pair per
//      16-row tile; it also writes rnd(out) and rnd(d_res) per row as bf16
//      scratch. i2t_bwd_dw_kernel is the weight pass: dWo = sum_r
//      rnd(out)^T rnd(d_res) and dWq^T = sum_r rnd(d_qpre)^T rnd(keys +
//      pe), split-K over row chunks.
//    * f32: i2t_bwd_kernel, one fused SIMT kernel, one block per (pair,
//      split) looping over 32-row tiles (not on a main path: the JAX
//      package routes K4 only in bf16).
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096 rows,
//    bf16): forward 135 kFLOP/row = 35.3 GFLOP over 989 TFLOP/s = 0.036 ms,
//    bytes (keys in, y out, ~270 MB per pair layer) 0.081 ms: byte-bound;
//    with the shared first layer (pb = 8) the keys read is per image and
//    the bound is ~0.045 ms. Backward ~400 kFLOP/row = 105 GFLOP = 0.106 ms,
//    bytes (keys, dy in; d_keys, d_qpre, p, d_score, d_out out) ~603 MB =
//    0.18 ms: byte-bound; the weight pass's bf16 scratch (201 MB written
//    and read) adds 0.12 ms of bytes.
// What the kernels do about it: every intermediate of the chain stays in
//    shared memory or registers, so device memory sees only the rows in and
//    out. The bf16 kernels run every product on the tensor cores (mma.sync
//    bf16 -> f32, chained from accumulator to A fragment where the operand
//    is a rounding point of the JAX kernel, so each tensor-core term is
//    exact): q and out projections as m16n8k16 over the warp's 16 x 128
//    (or 16 x 64) accumulators; per head the scores (one m16n8k16, head dim
//    16 x 8 tokens) and p . v (m16n8k8 over the 8 tokens); the backward
//    adds d_out = d_res . Wo^T, d_keys = d_qpre . Wq^T + d_res, d_p = d_out
//    . v^T and d_score . k. The softmax over <= 8 tokens, the LayerNorm and
//    their backwards run in f32 registers over a lane quad. The forward
//    copies the next unit's pe and keys rows while the current unit
//    computes, and writes y as 16-byte row segments (quad_transpose). The
//    f32 kernels are SIMT register tiles (one column per thread over the
//    tile's rows, 16-byte broadcast loads of the row operand); their
//    attention runs one thread per (row, head) with the 8 tokens in
//    registers and k/v tiles padded to 17 floats per head against bank
//    conflicts -- not the TPU's block-diagonal K'/V' expansions with iota
//    masks, nor its pre-transposed padded k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decoder_mma.cuh"

namespace {

constexpr int C = 256;            // channels
constexpr int I = 128;            // internal lanes
constexpr int NH = 8;             // heads
constexpr int HD = I / NH;        // 16
constexpr int HP = HD + 1;        // padded head stride in shared memory
constexpr int TP = 8;             // token capacity
constexpr int TM = 32;            // rows per tile
constexpr int THREADS = 256;
constexpr int RPW = TM / (THREADS / 32);  // rows per warp in the LayerNorms
static_assert(THREADS == C && THREADS == 2 * I && THREADS == TM * NH,
              "thread maps assume 256 threads");

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return __ldg(p); }

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the pair's n_tok tokens of k and v -> shared [TP][NH][HP], zeros past
// n_tok
template <typename T>
__device__ void load_tokens(float* tk_s, float* tv_s, const T* tok_k,
                            const T* tok_v, int n_tok) {
  for (int i = threadIdx.x; i < TP * I; i += THREADS) {
    const int t = i / I, l = i % I;
    const int o = t * NH * HP + (l / HD) * HP + l % HD;
    tk_s[o] = t < n_tok ? ld(tok_k + (size_t)t * I + l) : 0.f;
    tv_s[o] = t < n_tok ? ld(tok_v + (size_t)t * I + l) : 0.f;
  }
}

// qin_s[r][c] = rnd(keys + pe); with keys_s (optional) the keys themselves
template <typename T>
__device__ void load_qin(float* qin_s, float* keys_s, const T* keys_img,
                         const T* pe, int row0, int m) {
  for (int i = threadIdx.x; i < TM * C; i += THREADS) {
    const int r = i / C, c = i % C;
    float kv = 0.f, pv = 0.f;
    if (row0 + r < m) {
      kv = ld(keys_img + (size_t)(row0 + r) * C + c);
      pv = ld(pe + (size_t)(row0 + r) * C + c);
    }
    qin_s[i] = rnd<T>(kv + pv);
    if (keys_s) keys_s[i] = kv;
  }
}

// q_s[r][h][d] = rnd(rnd(qin . Wq + bq) * scale); thread (i, row half)
template <typename T>
__device__ void q_projection(float* q_s, const float* qin_s, const T* wq,
                             const float* bq, float scale) {
  const int i = threadIdx.x % I, r0 = (threadIdx.x / I) * (TM / 2);
  float acc[TM / 2];
#pragma unroll
  for (int r = 0; r < TM / 2; ++r) acc[r] = 0.f;
  for (int c = 0; c < C; c += 4) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld(wq + (size_t)(c + u) * I + i);
#pragma unroll
    for (int r = 0; r < TM / 2; ++r) {
      const float4 a = lds4(qin_s + (r0 + r) * C + c);
      acc[r] = fmaf(a.x, w[0], acc[r]);
      acc[r] = fmaf(a.y, w[1], acc[r]);
      acc[r] = fmaf(a.z, w[2], acc[r]);
      acc[r] = fmaf(a.w, w[3], acc[r]);
    }
  }
  const float b = bq[i];
#pragma unroll
  for (int r = 0; r < TM / 2; ++r)
    q_s[(r0 + r) * NH * HP + (i / HD) * HP + i % HD] =
        rnd<T>(rnd<T>(acc[r] + b) * scale);
}

// thread (row r, head h): scores over the tokens, per-head softmax (p kept
// in f32 for the backward), out = rnd(rnd(p) . v) -> o_s[r][h * HD + d]
template <typename T>
__device__ void attend(float (&p)[TP], float* o_s, const float* q_s,
                       const float* tk_s, const float* tv_s, int n_tok) {
  const int r = threadIdx.x / NH, h = threadIdx.x % NH;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = q_s[r * NH * HP + h * HP + d];
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    float s = -INFINITY;
    if (t < n_tok) {
      s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], tk_s[t * NH * HP + h * HP + d], s);
    }
    p[t] = s;
    mx = fmaxf(mx, s);
  }
  float den = 0.f;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    p[t] = t < n_tok ? expf(p[t] - mx) : 0.f;
    den += p[t];
  }
  const float inv = 1.f / den;
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    p[t] *= inv;
    const float pr = rnd<T>(p[t]);
#pragma unroll
    for (int d = 0; d < HD; ++d)
      o[d] = fmaf(pr, tv_s[t * NH * HP + h * HP + d], o[d]);
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) o_s[r * I + h * HD + d] = rnd<T>(o[d]);
}

// res[r][c] = rnd(keys + rnd(o . Wo + bo)), in place over keys_s; thread c
template <typename T>
__device__ void out_projection(float* keys_s, const float* o_s, const T* wo,
                               const float* bo) {
  const int c = threadIdx.x;
  float acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0.f;
  for (int i = 0; i < I; i += 4) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld(wo + (size_t)(i + u) * C + c);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float4 a = lds4(o_s + r * I + i);
      acc[r] = fmaf(a.x, w[0], acc[r]);
      acc[r] = fmaf(a.y, w[1], acc[r]);
      acc[r] = fmaf(a.z, w[2], acc[r]);
      acc[r] = fmaf(a.w, w[3], acc[r]);
    }
  }
  const float b = bo[c];
#pragma unroll
  for (int r = 0; r < TM; ++r)
    keys_s[r * C + c] = rnd<T>(keys_s[r * C + c] + rnd<T>(acc[r] + b));
}

constexpr size_t FWD_SMEM = sizeof(float) * (size_t)(
    2 * TM * C + TM * NH * HP + 2 * TP * NH * HP + TM * I);

template <typename T>
__global__ void __launch_bounds__(THREADS)
    i2t_fwd_kernel(const T* keys, const T* pe, const T* tok_k,
                   const T* tok_v, const T* wq, const float* bq, const T* wo,
                   const float* bo, const float* g, const float* bt, T* out,
                   int m, int pb, int n_tok, float eps) {
  extern __shared__ float smem[];
  float* qin_s = smem;                // [TM][C]
  float* res_s = qin_s + TM * C;      // [TM][C] keys, then res
  float* q_s = res_s + TM * C;        // [TM][NH][HP]
  float* tk_s = q_s + TM * NH * HP;   // [TP][NH][HP]
  float* tv_s = tk_s + TP * NH * HP;  // [TP][NH][HP]
  float* o_s = tv_s + TP * NH * HP;   // [TM][I]
  const int pair = blockIdx.y, row0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tokens(tk_s, tv_s, tok_k + (size_t)pair * n_tok * I,
              tok_v + (size_t)pair * n_tok * I, n_tok);
  load_qin(qin_s, res_s, keys + (size_t)(pair / pb) * m * C, pe, row0, m);
  __syncthreads();
  q_projection<T>(q_s, qin_s, wq, bq, rnd<T>(1.f / sqrtf((float)HD)));
  __syncthreads();
  float p[TP];
  attend<T>(p, o_s, q_s, tk_s, tv_s, n_tok);
  __syncthreads();
  out_projection<T>(res_s, o_s, wo, bo);
  __syncthreads();
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    float x[C / 32];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      x[k] = res_s[r * C + lane + 32 * k];
      s += x[k];
    }
    const float mu = warp_sum(s) * (1.f / C);
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      x[k] -= mu;
      v = fmaf(x[k], x[k], v);
    }
    const float rs = rsqrtf(warp_sum(v) * (1.f / C) + eps);
    if (row0 + r < m) {
      T* dst = out + ((size_t)pair * m + row0 + r) * C;
#pragma unroll
      for (int k = 0; k < C / 32; ++k) {
        const int c = lane + 32 * k;
        st(dst + c, x[k] * rs * g[c] + bt[c]);
      }
    }
  }
}

constexpr size_t BWD_SMEM = sizeof(float) * (size_t)(
    3 * TM * C + 2 * TM * NH * HP + 2 * TP * NH * HP + 2 * TM * I);

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    i2t_bwd_kernel(const T* keys, const T* pe, const T* tok_k,
                   const T* tok_v, const T* wq, const T* wqt, const float* bq,
                   const T* wo, const T* wot, const float* bo, const float* g,
                   const float* bt, const T* dy, T* dkeys, T* dqpre, T* p_out,
                   T* ds_out, T* dout, float* dwqt_p, float* dbq_p,
                   float* dwo_p, float* dbo_p, float* dg_p, float* dbt_p,
                   int m, int pb, int n_tok, int splits, float eps) {
  extern __shared__ float smem[];
  float* qin_s = smem;                // [TM][C]
  float* res_s = qin_s + TM * C;      // [TM][C] keys -> res -> y normalised
  float* dres_s = res_s + TM * C;     // [TM][C] rnd(d_res)
  float* q_s = dres_s + TM * C;       // [TM][NH][HP] q * scale
  float* do_s = q_s + TM * NH * HP;   // [TM][NH][HP] rnd(d_out)
  float* tk_s = do_s + TM * NH * HP;  // [TP][NH][HP]
  float* tv_s = tk_s + TP * NH * HP;  // [TP][NH][HP]
  float* o_s = tv_s + TP * NH * HP;   // [TM][I] rnd(out)
  float* dq_s = o_s + TM * I;         // [TM][I] rnd(d_qpre)

  const int pair = blockIdx.y, split = blockIdx.x;
  const int blk = pair * splits + split;
  const int ntiles = (m + TM - 1) / TM;
  const int per = (ntiles + splits - 1) / splits;
  const int t0 = split * per, t1 = min(ntiles, t0 + per);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ar = tid / NH, ah = tid % NH;  // (row, head) of the attention
  const float scale_in = rnd<T>(1.f / sqrtf((float)HD));
  const float scale_f32 = 1.f / sqrtf((float)HD);
  const T* keys_img = keys + (size_t)(pair / pb) * m * C;

  load_tokens(tk_s, tv_s, tok_k + (size_t)pair * n_tok * I,
              tok_v + (size_t)pair * n_tok * I, n_tok);

  float dg[C / 32], dbt[C / 32], dbo[C / 32];  // columns lane + 32 k
#pragma unroll
  for (int k = 0; k < C / 32; ++k) dg[k] = dbt[k] = dbo[k] = 0.f;
  float dbq[HD];  // lanes ah * HD + d
#pragma unroll
  for (int d = 0; d < HD; ++d) dbq[d] = 0.f;

  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * TM;
    const bool first = tile == t0;
    __syncthreads();  // the previous tile is done with shared memory
    load_qin(qin_s, res_s, keys_img, pe, row0, m);
    __syncthreads();
    q_projection<T>(q_s, qin_s, wq, bq, scale_in);
    __syncthreads();
    float p[TP];
    attend<T>(p, o_s, q_s, tk_s, tv_s, n_tok);
    __syncthreads();
    out_projection<T>(res_s, o_s, wo, bo);
    __syncthreads();

    // LayerNorm recompute and backward, one warp per RPW rows
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const bool valid = row0 + r < m;
      float x[C / 32];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < C / 32; ++k) {
        x[k] = res_s[r * C + lane + 32 * k];
        s += x[k];
      }
      const float mu = warp_sum(s) * (1.f / C);
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < C / 32; ++k) {
        x[k] -= mu;
        v = fmaf(x[k], x[k], v);
      }
      const float rs = rsqrtf(warp_sum(v) * (1.f / C) + eps);
      float dyn[C / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < C / 32; ++k) {
        const int c = lane + 32 * k;
        x[k] *= rs;  // y normalised
        const float dyv =
            valid ? ld(dy + ((size_t)pair * m + row0 + r) * C + c) : 0.f;
        dg[k] = fmaf(dyv, x[k], dg[k]);
        dbt[k] += dyv;
        dyn[k] = dyv * g[c];
        s1 += dyn[k];
        s2 = fmaf(dyn[k], x[k], s2);
      }
      const float mdy = warp_sum(s1) * (1.f / C);
      const float mdyy = warp_sum(s2) * (1.f / C);
#pragma unroll
      for (int k = 0; k < C / 32; ++k) {
        const float dr = rs * (dyn[k] - mdy - x[k] * mdyy);
        dbo[k] += dr;
        dres_s[r * C + lane + 32 * k] = rnd<T>(dr);
      }
    }
    __syncthreads();

    // dWo[i][c] partial (thread c) and d_out (thread (i, row half))
    {
      const int c = tid;
      float dcol[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) dcol[r] = dres_s[r * C + c];
      float* dst = dwo_p + (size_t)blk * I * C + c;
#pragma unroll 1
      for (int i = 0; i < I; i += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(o_s + r * I + i);
          s[0] = fmaf(a.x, dcol[r], s[0]);
          s[1] = fmaf(a.y, dcol[r], s[1]);
          s[2] = fmaf(a.z, dcol[r], s[2]);
          s[3] = fmaf(a.w, dcol[r], s[3]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* q = dst + (size_t)(i + u) * C;
          *q = first ? s[u] : *q + s[u];
        }
      }
    }
    {
      const int i = tid % I, r0 = (tid / I) * (TM / 2);
      float acc[TM / 2];
#pragma unroll
      for (int r = 0; r < TM / 2; ++r) acc[r] = 0.f;
      for (int c = 0; c < C; c += 4) {
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = ld(wot + (size_t)(c + u) * I + i);
#pragma unroll
        for (int r = 0; r < TM / 2; ++r) {
          const float4 a = lds4(dres_s + (r0 + r) * C + c);
          acc[r] = fmaf(a.x, w[0], acc[r]);
          acc[r] = fmaf(a.y, w[1], acc[r]);
          acc[r] = fmaf(a.z, w[2], acc[r]);
          acc[r] = fmaf(a.w, w[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < TM / 2; ++r) {
        const float v = rnd<T>(acc[r]);
        do_s[(r0 + r) * NH * HP + (i / HD) * HP + i % HD] = v;
        if (row0 + r0 + r < m)
          st(dout + ((size_t)pair * m + row0 + r0 + r) * I + i, v);
      }
    }
    __syncthreads();

    // softmax backward and d_qpre, thread (row, head)
    {
      float dsb[TP];
      float pdp_sum = 0.f;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d)
          dp = fmaf(do_s[ar * NH * HP + ah * HP + d],
                    tv_s[t * NH * HP + ah * HP + d], dp);
        dsb[t] = p[t] * dp;
        pdp_sum += dsb[t];
      }
      const bool valid = row0 + ar < m;
      const size_t prow = ((size_t)pair * m + row0 + ar) * (NH * TP) + ah * TP;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        dsb[t] = rnd<T>(dsb[t] - p[t] * pdp_sum);  // p == 0 on pad tokens
        if (valid) {
          st(p_out + prow + t, p[t]);
          st(ds_out + prow + t, dsb[t]);
        }
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        float a = 0.f;
#pragma unroll
        for (int t = 0; t < TP; ++t)
          a = fmaf(dsb[t], tk_s[t * NH * HP + ah * HP + d], a);
        a *= scale_f32;
        dbq[d] += a;
        const float ab = rnd<T>(a);
        dq_s[ar * I + ah * HD + d] = ab;
        if (valid)
          st(dqpre + ((size_t)pair * m + row0 + ar) * I + ah * HD + d, ab);
      }
    }
    __syncthreads();

    // dWq^T[i][c] partial and d_keys, thread c
    {
      const int c = tid;
      float qcol[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) qcol[r] = qin_s[r * C + c];
      float* dst = dwqt_p + (size_t)blk * I * C + c;
#pragma unroll 1
      for (int i = 0; i < I; i += 4) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(dq_s + r * I + i);
          s[0] = fmaf(a.x, qcol[r], s[0]);
          s[1] = fmaf(a.y, qcol[r], s[1]);
          s[2] = fmaf(a.z, qcol[r], s[2]);
          s[3] = fmaf(a.w, qcol[r], s[3]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* q = dst + (size_t)(i + u) * C;
          *q = first ? s[u] : *q + s[u];
        }
      }
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      for (int i = 0; i < I; i += 4) {
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = ld(wqt + (size_t)(i + u) * C + c);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 a = lds4(dq_s + r * I + i);
          acc[r] = fmaf(a.x, w[0], acc[r]);
          acc[r] = fmaf(a.y, w[1], acc[r]);
          acc[r] = fmaf(a.z, w[2], acc[r]);
          acc[r] = fmaf(a.w, w[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (row0 + r < m)
          st(dkeys + ((size_t)pair * m + row0 + r) * C + c,
             dres_s[r * C + c] + acc[r]);
    }
  }

  // the block's per-lane sums: combine the threads that share a lane in a
  // fixed order (shared memory is free once the last tile is done)
  __syncthreads();
  float* red = smem;  // [8 warps][3][C], then [TM][I]
#pragma unroll
  for (int k = 0; k < C / 32; ++k) {
    const int c = lane + 32 * k;
    red[(warp * 3 + 0) * C + c] = dg[k];
    red[(warp * 3 + 1) * C + c] = dbt[k];
    red[(warp * 3 + 2) * C + c] = dbo[k];
  }
  __syncthreads();
  {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      s0 += red[(w * 3 + 0) * C + tid];
      s1 += red[(w * 3 + 1) * C + tid];
      s2 += red[(w * 3 + 2) * C + tid];
    }
    dg_p[(size_t)blk * C + tid] = s0;
    dbt_p[(size_t)blk * C + tid] = s1;
    dbo_p[(size_t)blk * C + tid] = s2;
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) red[ar * I + ah * HD + d] = dbq[d];
  __syncthreads();
  if (tid < I) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += red[r * I + tid];
    dbq_p[(size_t)blk * I + tid] = s;
  }
}

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

int launch_fwd_f32(const void* keys, const void* pe, const void* tok_k,
                   const void* tok_v, const void* wq, const void* bq,
                   const void* wo, const void* bo, const void* g,
                   const void* bt, void* out, int bp, int m, int pb,
                   int n_tok, float eps, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      i2t_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TM - 1) / TM, bp);
  i2t_fwd_kernel<float><<<grid, THREADS, FWD_SMEM, stream>>>(
      static_cast<const float*>(keys), static_cast<const float*>(pe),
      static_cast<const float*>(tok_k), static_cast<const float*>(tok_v),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<float*>(out), m, pb, n_tok, eps);
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

template <typename T>
int launch_bwd(void* const* a, int bp, int m, int pb, int n_tok, int splits,
               float eps, cudaStream_t stream) {
  const int ntiles = (m + TM - 1) / TM;
  // every block must own at least one tile: its partial sums are written,
  // never accumulated into a zeroed buffer
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb || splits < 1 ||
      (splits - 1) * ((ntiles + splits - 1) / splits) >= ntiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(splits, bp);
  i2t_bwd_kernel<T><<<grid, THREADS, BWD_SMEM, stream>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const float*>(a[9]),
      static_cast<const float*>(a[10]), static_cast<const float*>(a[11]),
      static_cast<const T*>(a[12]), static_cast<T*>(a[13]),
      static_cast<T*>(a[14]), static_cast<T*>(a[15]), static_cast<T*>(a[16]),
      static_cast<T*>(a[17]), static_cast<float*>(a[18]),
      static_cast<float*>(a[19]), static_cast<float*>(a[20]),
      static_cast<float*>(a[21]), static_cast<float*>(a[22]),
      static_cast<float*>(a[23]), m, pb, n_tok, splits, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes). dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); the caller raises on non-zero.
extern "C" {

// The forward: bf16 on `blocks` persistent blocks (i2t_fwd_mma_kernel),
// f32 one block per (pair, 32-row tile) (i2t_fwd_kernel; `blocks` unused).
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
             : launch_fwd_f32(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                              out, bp, m, pb, n_tok, eps, s);
}

// The f32 backward (i2t_bwd_kernel). Operands in order: keys, pe, tok_k,
// tok_v, wq, wq^T, bq, wo, wo^T, bo, g, bt, dy; outputs: d_keys, d_qpre, p,
// d_score, d_out, dWq^T, dbq, dWo, dbo, dg, dbt partials. dtype must be 0:
// the bf16 backward is the two launches below.
int dhoct_i2t_bwd(void* a0, void* a1, void* a2, void* a3, void* a4, void* a5,
                  void* a6, void* a7, void* a8, void* a9, void* a10,
                  void* a11, void* a12, void* o0, void* o1, void* o2,
                  void* o3, void* o4, void* o5, void* o6, void* o7, void* o8,
                  void* o9, void* o10, int bp, int m, int pb, int n_tok,
                  int splits, int dtype, float eps, void* stream) {
  void* const a[24] = {a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11,
                       a12, o0, o1, o2, o3, o4, o5, o6, o7, o8, o9, o10};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd<float>(a, bp, m, pb, n_tok, splits, eps,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 row pass (i2t_bwd_rows_kernel) on `blocks` persistent blocks.
// a[22]: keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy; outputs d_keys,
// d_qpre, p, d_score, d_out, the rnd(out) and rnd(d_res) scratch rows, and
// per-warp partials of dbq, dbo, dg, dbt.
int dhoct_i2t_bwd_rows(void* const* a, int bp, int m, int pb, int n_tok,
                       int blocks, float eps, void* stream) {
  return launch_bwd_rows(a, bp, m, pb, n_tok, blocks, eps,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 weight pass (i2t_bwd_dw_kernel). a[6]: keys, pe, d_qpre,
// rnd(out), rnd(d_res), and the partials [2][nchunks][I][C] (dWo, dWq^T)
// of row chunks of `chunk` rows.
int dhoct_i2t_bwd_dw(void* const* a, int bp, int m, int pb, int chunk,
                     int nchunks, void* stream) {
  return launch_bwd_dw(a, bp, m, pb, chunk, nchunks,
                       static_cast<cudaStream_t>(stream));
}

const char* dhoct_i2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
