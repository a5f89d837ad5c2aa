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
// i2t_fwd_kernel replaces dilabhelmholtzoct_tpu/ops/decoder_attn.py
//    _fused_fwd (:264, body _fwd_kernel :120-130). One block per (pair,
//    32-row tile).
// i2t_bwd_kernel replaces the same file's _fused_bwd (:287, body
//    _bwd_kernel :133-218). It recomputes the chain, runs the LayerNorm and
//    softmax backward per row, writes d_keys and the per-row d_qpre, p,
//    d_score and d_out (the token and positional gradients are einsums over
//    these rows outside the kernel, as in the JAX package), and sums dWq,
//    dbq, dWo, dbo and the LayerNorm gradients over rows inside each block
//    (one block per (pair, split), looping over its row tiles) into one
//    partial sum per block, which the wrapper adds up over the blocks in a
//    fixed order — no atomics, so the gradients repeat bit for bit.
//
// Bound on an H100 SXM (700 W) at the training shapes (64 pairs x 4096 rows,
//    bf16): forward 135 kFLOP/row = 35.3 GFLOP over 989 TFLOP/s = 0.036 ms,
//    bytes (keys in, y out, ~270 MB per pair layer) 0.081 ms: byte-bound;
//    with the shared first layer (pb = 8) the keys read is per image and
//    the bound is ~0.045 ms. Backward ~400 kFLOP/row = 105 GFLOP = 0.106 ms,
//    bytes (keys, dy in; d_keys, d_qpre, p, d_score, d_out out) ~603 MB =
//    0.18 ms: byte-bound.
// What this design does about it: every intermediate of the chain stays in
//    shared memory or registers, so device memory sees only the rows in and
//    out (and the five per-row outputs the backward must emit). The two
//    projections are f32 SIMT register tiles (one column per thread over
//    the tile's rows, 16-byte broadcast loads of the row operand); the
//    attention runs one thread per (row, head) with the 8 tokens in
//    registers, a per-head softmax, and k/v tiles padded to 17 floats per
//    head against bank conflicts — not the TPU's block-diagonal K'/V'
//    expansions with iota masks, nor its pre-transposed padded k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
int launch_fwd(const void* keys, const void* pe, const void* tok_k,
               const void* tok_v, const void* wq, const void* bq,
               const void* wo, const void* bo, const void* g, const void* bt,
               void* out, int bp, int m, int pb, int n_tok, float eps,
               cudaStream_t stream) {
  if (n_tok < 1 || n_tok > TP || pb < 1 || bp % pb)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      i2t_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TM - 1) / TM, bp);
  i2t_fwd_kernel<T><<<grid, THREADS, FWD_SMEM, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(pe),
      static_cast<const T*>(tok_k), static_cast<const T*>(tok_v),
      static_cast<const T*>(wq), static_cast<const float*>(bq),
      static_cast<const T*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(g), static_cast<const float*>(bt),
      static_cast<T*>(out), m, pb, n_tok, eps);
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

int dhoct_i2t_fwd(const void* keys, const void* pe, const void* tok_k,
                  const void* tok_v, const void* wq, const void* bq,
                  const void* wo, const void* bo, const void* g,
                  const void* bt, void* out, int bp, int m, int pb, int n_tok,
                  int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_fwd<__nv_bfloat16>(keys, pe, tok_k, tok_v, wq, bq, wo,
                                         bo, g, bt, out, bp, m, pb, n_tok,
                                         eps, s)
             : launch_fwd<float>(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g,
                                 bt, out, bp, m, pb, n_tok, eps, s);
}

// operands in order: keys, pe, tok_k, tok_v, wq, wq^T, bq, wo, wo^T, bo, g,
// bt, dy; outputs: d_keys, d_qpre, p, d_score, d_out, dWq^T, dbq, dWo, dbo,
// dg, dbt partials
int dhoct_i2t_bwd(void* a0, void* a1, void* a2, void* a3, void* a4, void* a5,
                  void* a6, void* a7, void* a8, void* a9, void* a10,
                  void* a11, void* a12, void* o0, void* o1, void* o2,
                  void* o3, void* o4, void* o5, void* o6, void* o7, void* o8,
                  void* o9, void* o10, int bp, int m, int pb, int n_tok,
                  int splits, int dtype, float eps, void* stream) {
  void* const a[24] = {a0, a1, a2, a3, a4, a5, a6, a7, a8, a9, a10, a11,
                       a12, o0, o1, o2, o3, o4, o5, o6, o7, o8, o9, o10};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_bwd<__nv_bfloat16>(a, bp, m, pb, n_tok, splits, eps, s)
             : launch_bwd<float>(a, bp, m, pb, n_tok, splits, eps, s);
}

const char* dhoct_i2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
