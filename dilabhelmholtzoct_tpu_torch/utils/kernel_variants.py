"""Where a kernel's time goes, by variants built from a copy of its source.

    python -m dilabhelmholtzoct_tpu_torch.utils.kernel_variants \
        [--target k2 | k4_rows | k3_rows | k4_fwd | k3_fwd | k3_rows_f32]
        [--only a,b]
        [--out build/variants.json]

Each variant is the kernel's source with a text patch: one part of the work
taken out (its results are then wrong by design), or another configuration
of the same function. The variants are built by nvcc into
``build/variants/<target>/`` with the flags of ``kernels.NVCC_FLAGS``, in
parallel, and each is loaded in place of the package's library, so that the
public wrapper launches it on its own plan. The unpatched build is held
against the plain version first. For each variant and case it prints the
profiler's device time of the kernel per launch (the CUDA-event mean beside
it) and every wgmma ptxas serialized (C7511 / C7512) or spill it reported.
Needs a card.

Targets:

* ``k2``: ``attn_relpos_wgmma_tf32_kernel``'s GRID mode
  (``csrc/attention_relpos_wgmma_tf32.cu``), the f32 K2 (ViT-B's windows,
  heads of 64, B = 1 and 4: 25 and 100 windows of 196, 12 heads) and the
  f32 K6's windowed layer (ViT-H: 25 windows, 16 heads of 80); only the
  head dims 64 and 80 instantiated. Variants: the DP 64 instances
  configured as the DP 80 ones (q_hi read from shared memory with the
  warpgroups' turns, rel_w held in registers for the unit: the
  configuration ptxas serialized), and without the transformers' split of
  K and V, the score products, the p . v products or the exponentials.
* ``k4_rows``: the bf16 K4 row pass ``i2t_bwd_rows_wgmma_kernel``
  (``csrc/decoder_attn.cu``) at 64 pairs x 4096 rows, pb 1 and 8, 7
  tokens. Variants without the forward's or the backward's per-head work
  on the CUDA cores, without the pass that sums dg, dbt and dbo over a
  unit's rows, without reading the token rows, without the row outputs'
  stores, or without the per-warpgroup scratch in device memory (its
  per-head stores alone, the values kept live in registers; or its
  per-head stores and loads, the loads' values made up in registers).
* ``k3_rows``: the bf16 K3 row pass ``upscale_bwd_rows_wgmma_kernel``
  (``csrc/upscaler.cu``) at 64 pairs x 4096 rows, n_out 1 and 4: without
  its scratch-row, d_up or d_hyper stores, with tanh made linear, or with
  dm and hyper made up.
* ``k3_fwd``: the bf16 K3 forward ``upscale_fwd_wgmma_kernel`` at 64 pairs
  x 4096 rows, n_out 1 and 4: its wgmma chains cut to one k-step each,
  without the hypernetwork sums on mma.sync, the GELUs made linear, without
  the LayerNorm's reductions, the up rows not loaded, the outputs not
  stored; and the hypernetwork sums on wgmma m64n8k16 from a shared
  hyper^T instead of mma.sync (``hyper_wgmma``).
* ``k3_rows_f32``: the f32 K3 row pass ``upscale_bwd_rows_tf32_kernel``
  (split TF32 on mma.sync) at 64 pairs x 4096 rows, n_out 1 and 4:
  without its W2 products, its d_up product and W1^T's stream, its u1pre
  product and W1's stream, the erf GELU and its derivative made linear,
  without the LayerNorms' reductions, the up rows not loaded and dm made
  up, without its scratch-row, d_up or per-16-row d_hyper stores.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time
from pathlib import Path

import torch

from .. import kernels
from ..device import full_fp32
from ..ops import attention as attn
from ..ops import decoder_attn as i2t
from ..ops import upscaler as up_op

# ------------------------------------------------------------------ k2 ----
# the head dims built: 64 (ViT-B / L) and 80 (ViT-H)
_ALL_DIMS = ("    DHOCT_ND(1) DHOCT_ND(2) DHOCT_ND(3) DHOCT_ND(4)\n"
             "    DHOCT_ND(5) DHOCT_ND(6) DHOCT_ND(7) DHOCT_ND(8)\n")
_SOME_DIMS = "    DHOCT_ND(4) DHOCT_ND(5)\n"
_QHR = "return (mode == ROW_TILE && dp <= 80) || (mode == GRID && dp <= 64);"
_RWT = "return mode == GRID && dp <= 64;"
QHI_SHARED = [(_QHR, "return mode == ROW_TILE && dp <= 80;")]
RW_HELD = [(_RWT, "return false;")]

K2_VARIANTS = {
    "base": [],
    # DP 64's GRID instance as DP 80's
    "rw_held_qhi_shared": RW_HELD + QHI_SHARED,
    "rw_held": RW_HELD,
    "qhi_shared": QHI_SHARED,
    # the transformers land nothing: no K lo, no V^T hi / lo
    "no_split": [
        ("for (int i = tt; i < NK * DP / 4; i += TRANSFORMERS)",
         "for (int i = tt; i < 0; i += TRANSFORMERS)"),
        ("for (int i = tt; i < KSTEPS * 2 * DP; i += TRANSFORMERS)",
         "for (int i = tt; i < 0; i += TRANSFORMERS)"),
    ],
    # no score products (s = 0)
    "no_qk": [
        ("qk_slabs<DP, QHR, 0>(s, ql, qh, ust, kst, kst + L.k_bytes, wgi);",
         "for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;"),
    ],
    # no p . v products
    "no_pv": [
        ("for (int j = 0; j < KSTEPS; ++j) {\n"
         "        mma_tf32_rs<DP>(o, pl[j]",
         "for (int j = 0; j < 0; ++j) {\n"
         "        mma_tf32_rs<DP>(o, pl[j]"),
    ],
    # no exponentials in the softmax
    "no_exp": [
        ("x = exp2_approx(fmaf(x, LOG2E, -mb));",
         "x = fmaf(x, LOG2E, -mb);"),
    ],
}
K2_CASES = [("k2_vitb_b1", 25, 12, 64), ("k2_vitb_b4", 100, 12, 64),
            ("k6_vith_windowed", 25, 16, 80)]
HW = (14, 14)


def _k2_cases(dev, gen):
    for case, b, heads, d in K2_CASES:
        n = HW[0] * HW[1]
        qkv = 0.5 * torch.randn((b, n, 3 * heads * d), generator=gen,
                                device=dev)
        rel_h = 0.3 * torch.randn((b, heads, n, HW[0]), generator=gen,
                                  device=dev)
        rel_w = 0.3 * torch.randn((b, heads, n, HW[1]), generator=gen,
                                  device=dev)
        kw = dict(hw=HW, num_heads=heads)
        if d == attn.HEAD_DIM:  # the f32 K2, with its LSE rows
            run = lambda: attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                                  return_lse=True, **kw)
            plain = lambda: attn.packed_attention_plain(
                qkv, rel_h, rel_w, return_lse=True, **kw)
        else:
            run = lambda: attn.attention_relpos_cuda(qkv, rel_h, rel_w, **kw)
            plain = lambda: attn.relpos_attention_plain(qkv, rel_h, rel_w,
                                                        **kw)
        yield case, run, plain


# ------------------------------------------------------------- k4_rows ----
_KEEP = ("namespace rwb {\n",
         "namespace rwb {\n"
         "__device__ __forceinline__ void keep(uint4 v) {\n"
         '  asm volatile("" ::"r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));\n'
         "}\n"
         "__device__ __forceinline__ void keep(float4 v) {\n"
         '  asm volatile("" ::"f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));\n'
         "}\n")
_SCRATCH_STORES = [_KEEP] + [
    (f"{at}[h * 128] = {val};", f"keep({val});") for at, val in (
        ("qsv", "make_uint4(q[0], q[1], q[2], q[3])"),
        ("pv", "make_float4(p[0], p[1], p[2], p[3])"),
        ("ofv", "make_uint4(of[i][0], of[i][1], of[i][2], of[i][3])"),
        ("qsv", "make_uint4(d[0], d[1], d[2], d[3])"),
        ("ofv", "make_uint4(qd[i][0], qd[i][1], qd[i][2], qd[i][3])"))]
_MADE_UP = "make_uint4({h}, lane, tid, 0)"
_SCRATCH_LOADS = [
    (f"{v}[2] = {{qsv[h2 * 128], qsv[(h2 + 1) * 128]}};",
     f"{v}[2] = {{" + _MADE_UP.format(h="h2") + ", "
     + _MADE_UP.format(h="h2 + 1") + "};") for v in ("qv2", "dv2")
] + [
    ("const uint4 v = ofv[h * 128];\n        of[h][0]",
     "const uint4 v = " + _MADE_UP.format(h="h") + ";\n        of[h][0]"),
    ("const uint4 v = ofv[h * 128];\n        qd[h][0]",
     "const uint4 v = " + _MADE_UP.format(h="h") + ";\n        qd[h][0]"),
    ("{pv[h2 * 128], pv[(h2 + 1) * 128]}",
     "{make_float4(0.25f, 0.25f, 0.25f, 0.25f), "
     "make_float4(0.25f, 0.25f, 0.25f, 0.25f)}"),
]
K4_VARIANTS = {
    "base": [],
    # the forward's per-head scores and p . v: stand-ins from the lane's
    # own q values, no token loads, no shuffles
    "no_fwd_heads": [
        ("        head_dots(part, x, tk + 16 * h, n_tok);\n"
         "        quad_tokens(part, s, t);\n",
         "        for (int r = 0; r < 2; ++r)\n"
         "          s[r][0] = x[r][0], s[r][1] = x[r][1];\n"),
        ("        head_mix(y, pr, tv + 16 * h, n_tok, lane);\n",
         "        for (int r = 0; r < 2; ++r)\n"
         "          for (int k = 0; k < 4; ++k) y[r][k] = x[r][k];\n"),
    ],
    # the backward's per-head d_p and d_qpre likewise
    "no_bwd_heads": [
        ("        head_dots(part, x, tv + 16 * h, n_tok);\n"
         "        quad_tokens(part, dp, t);\n",
         "        for (int r = 0; r < 2; ++r)\n"
         "          dp[r][0] = x[r][0], dp[r][1] = x[r][1];\n"),
        ("        head_mix(y, dsp, tk + 16 * h, n_tok, lane);\n",
         "        for (int r = 0; r < 2; ++r)\n"
         "          for (int k = 0; k < 4; ++k) y[r][k] = x[r][k];\n"),
    ],
    # no column-sum pass over the unit's rows (dg, dbt, dbo)
    "no_col_pass": [
        ("    for (int R = rh; R < rh + RR / 2; ++R) {",
         "    for (int R = rh; R < rh; ++R) {"),
    ],
    # the token rows not read (their addresses stand in for them)
    "no_tok_loads": [
        ('  asm volatile("ld.global.nc.u32 %0, [%1];\\n" : "=r"(v) : "l"(p));',
         "  v = (uint32_t)(uintptr_t)p;"),
    ],
    # the token rows, g and the slots read by plain loads the compiler may
    # move and merge
    "plain_loads": [
        ('  asm volatile("ld.global.nc.u32 %0, [%1];\\n" : "=r"(v) : "l"(p));',
         "  v = __ldg(reinterpret_cast<const unsigned int*>(p));"),
        ('  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\\n"\n'
         '               : "=f"(v.x), "=f"(v.y)\n'
         '               : "l"(p));',
         "  v = __ldg(reinterpret_cast<const float2*>(p));"),
        ("using hop::lds_u32;\n",
         "__device__ __forceinline__ uint32_t lds_u32(const void* p) {\n"
         "  return *reinterpret_cast<const uint32_t*>(p);\n"
         "}\n"),
    ],
    # the per-head values not stored to the scratch (kept live, so that
    # no work that feeds them is dropped); its loads stay
    "no_scratch_stores": _SCRATCH_STORES,
    # no per-head scratch traffic at all: the stores as above, and the
    # loads' values made up from the lane's indices
    "no_scratch": _SCRATCH_STORES + _SCRATCH_LOADS,
    # no row outputs written (the scratch and the partials stay)
    "no_row_stores": [
        ("using dec::store_quad;\n",
         "__device__ __forceinline__ void store_quad(bf16* row, bool ok,\n"
         "                                           uint32_t (&w)[4], int t)"
         " {\n"
         "  dec::store_quad(row, ok && false, w, t);\n"
         "}\n"),
        ("  if (ok) *reinterpret_cast<uint32_t*>(at) = w;",
         "  if (ok && false) *reinterpret_cast<uint32_t*>(at) = w;"),
    ],
}


def _k4_cases(dev, gen):
    bp, m, bf = 64, 4096, torch.bfloat16
    r = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    for pb in (1, 8):
        args = (r(bp // pb, m, 256).to(bf), r(1, m, 256).to(bf),
                r(bp, 7, 128).to(bf), r(bp, 7, 128).to(bf),
                r(256, 128, k=0.06).to(bf), r(128, k=0.1),
                r(128, 256, k=0.09).to(bf), r(256, k=0.1),
                1 + r(256, k=0.1), r(256, k=0.1), r(bp, m, 256).to(bf))
        kw = dict(nh=8, pb=pb, eps=1e-6)
        yield (f"k4_rows_pb{pb}",
               lambda: i2t.i2t_bwd_rows_cuda(*args, **kw),
               lambda: i2t.i2t_bwd_rows_plain(*args, **kw))

# ------------------------------------------------------------- k3_rows ----
_KEEP_K3 = ("// tanh as 1 - 2 / (e^{2x} + 1) from ex2.approx and rcp.approx: within\n",
            "__device__ __forceinline__ void keep(float a) {\n"
            '  asm volatile("" ::"f"(a));\n'
            "}\n"
            "// tanh as 1 - 2 / (e^{2x} + 1) from ex2.approx and rcp.approx: within\n")
def _no_store(call):
    """A store_quad of a row output whose store is switched off (the quad
    transpose stays)."""
    head, _, w, t = call.rsplit(", ", 3)
    return (call, f"{head}, false, {w}, {t}")


K3_VARIANTS = {
    "base": [],
    # u1g, rnd(d_u2pre) and rnd(d_u1pre) not written to their rows (each
    # value also feeds a product, so no work is dropped)
    "no_scratch_stores": [_no_store(
        f"store_quad(d2_rows + {r} * 4 * LQ + LQ * de + 32 * a, {ok}, {v}, t)")
        for r, ok, v in (("row0", "ok0", "w0"), ("row1", "ok1", "w1"))] + [
        ("tma_store_3d(&tm_u1g, du_s + de * BOX, C1 * de, r0, pair);",
         "(void)0;"),
        ("tma_store_3d(&tm_du1, du_s + b * BOX, 64 * b, r0, pair);",
         "(void)b;"),
        ("            tma_store_3d(&tm_d2, up_s + (2 * wgi + b) * BOX,\n"
         "                         LQ * de + 64 * b, r0, pair);",
         "            (void)b;")],
    # d_up not stored from its stage (the stage still written)
    "no_dup_stores": [
        ("          tma_store_3d(&tm_dup, du_s + (2 * wgi + b) * BOX,\n"
         "                       128 * wgi + 64 * b, r0, pair);",
         "          (void)b;")],
    # the per-unit d_hyper partials not stored (their sums kept live)
    "no_dht_stores": [_KEEP_K3, (
        "        dht_u[((size_t)u * n_out + tt) * 4 * LQ + LQ * de + tid] =\n"
        "            dhg[tt * LQ + tid] + dhg[(MAXT + tt) * LQ + tid] +\n"
        "            dhg[(2 * MAXT + tt) * LQ + tid] + dhg[(3 * MAXT + tt) * LQ + tid];",
        "        keep(dhg[tt * LQ + tid] + dhg[(MAXT + tt) * LQ + tid] +\n"
        "             dhg[(2 * MAXT + tt) * LQ + tid] +\n"
        "             dhg[(3 * MAXT + tt) * LQ + tid]);")],
    # tanh (1024 a row, two MUFU operations each) made linear
    "no_tanh": [
        ("  return 1.f - __fdividef(2.f, attn::mma::exp2_approx(2.8853900817779268f * x) +\n"
         "                                   1.f);",
         "  return 0.25f * x;")],
    # dm and hyper made up from indices instead of loaded
    "made_up_dm_hyper": [
        (f"dmq[{r}][tt] = (tt < n_out && ok{r}) ? __ldg(reinterpret_cast<const float4*>(\n"
         f"                                               dm + row{r} * lanes + l))\n"
         "                                         : z;",
         f"dmq[{r}][tt] = (tt < n_out && ok{r}) ? make_float4(0.01f * l, 0.02f, "
         f"0.03f, 0.04f * {r + 1})\n"
         "                                         : z;") for r in (0, 1)] + [
        ("hy[tt] = up2(hyb[tt * (C2 / 2) + 4 * jj + t]);",
         "hy[tt] = make_float2(0.01f * (tt + jj), 0.02f * t);"),
    ],
}


def _k3_cases(dev, gen):
    bp, m, bf = 64, 4096, torch.bfloat16
    r = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    for n_out in (1, 4):
        args = (r(bp, m, 256).to(bf), r(bp, m, n_out * 16),
                r(256, 2, 2, 64, k=0.06).to(bf), r(64, k=0.1),
                1 + r(64, k=0.1), r(64, k=0.1),
                r(64, 2, 2, 32, k=0.12).to(bf), r(32, k=0.1),
                r(bp, n_out, 32).to(bf))
        yield (f"k3_rows_n{n_out}",
               lambda: up_op.upscale_bwd_rows_cuda(*args),
               lambda: up_op.upscale_bwd_rows_plain(*args))


# -------------------------------------------------------------- k4_fwd ----
K4_FWD_VARIANTS = {
    "base": [],
    # no per-head scores, softmax or p . v: rnd(out) made from qs
    "no_heads": [(
        "        float p[4];\n"
        "        head_softmax(p, qf[h], tf.k[h], n_tok, lane);\n"
        "        head_out(of[h], p, tf.v[h]);\n",
        "        of[h][0] = qf[h][0] ^ tf.k[h][0], of[h][1] = qf[h][1];\n"
        "        of[h][2] = qf[h][2] ^ tf.v[h][0], of[h][3] = qf[h][3];\n")],

    # each pair's token rows loaded as the pair starts, not a pair ahead
    "tokens_per_pair": [
        ("    TokenFrags tf;  // the pair's token rows, loaded a pair ahead\n"
         "    token_frags(tf, tok_k + (size_t)img * pb * n_tok * I,\n"
         "                tok_v + (size_t)img * pb * n_tok * I, n_tok, lane);\n",
         ""),
        ("      const int pair = img * pb + j;\n"
         "      // per head: softmax, rnd(out) as the out projection's A fragment of\n",
         "      const int pair = img * pb + j;\n"
         "      TokenFrags tf;\n"
         "      token_frags(tf, tok_k + (size_t)pair * n_tok * I,\n"
         "                  tok_v + (size_t)pair * n_tok * I, n_tok, lane);\n"
         "      // per head: softmax, rnd(out) as the out projection's A fragment of\n"),
        ("      if (j + 1 < pb)  // the next pair's token rows, in flight meanwhile\n"
         "        token_frags(tf, tok_k + (size_t)(pair + 1) * n_tok * I,\n"
         "                    tok_v + (size_t)(pair + 1) * n_tok * I, n_tok, lane);\n",
         ""),
    ],
    # the residual's keys not read from their slot
    "no_res_loads": [
        ("            const float2 kv = up2(lds_u32(ks + tile_off(R0 + 8 * r, col)));",
         "            const float2 kv = make_float2(0.f, (float)col);")],
    # y not stored from the stage to its rows (the stage still written)
    "no_y_stores": [(
        "          tma_store_3d(&tm_y, ys, 128 * hn, r0 + WROWS * (warp & 3), pair);\n"
        "          tma_store_3d(&tm_y, ys + BOX, 128 * hn + 64,\n"
        "                       r0 + WROWS * (warp & 3), pair);\n",
        "")],
}


def _k4_fwd_cases(dev, gen):
    bp, m, bf = 64, 4096, torch.bfloat16
    r = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    for pb in (1, 8):
        args = (r(bp // pb, m, 256).to(bf), r(1, m, 256).to(bf),
                r(bp, 7, 128).to(bf), r(bp, 7, 128).to(bf),
                r(256, 128, k=0.06).to(bf), r(128, k=0.1),
                r(128, 256, k=0.09).to(bf), r(256, k=0.1),
                1 + r(256, k=0.1), r(256, k=0.1))
        kw = dict(nh=8, pb=pb, eps=1e-6)
        yield (f"k4_fwd_pb{pb}", lambda: i2t.i2t_fwd_cuda(*args, **kw),
               lambda: i2t.i2t_fwd_plain(*args, **kw))


# --------------------------------------------------- k3_fwd, k3_rows_f32 ----
def _keep_fn(anchor):
    """A patch that puts ``keep(float)`` (a value kept live, no work) before
    ``anchor``."""
    return (anchor, "__device__ __forceinline__ void keep(float a) {\n"
                    '  asm volatile("" ::"f"(a));\n'
                    "}\n" + anchor)


_HYPER_WGMMA = [
    ("namespace fwu {\n",
     "namespace fwu {\n"
     "// d (m64 x 8 f32) (+)= A . B, bf16, A from registers, B K-major\n"
     "__device__ __forceinline__ void mma_n8(float* d, const uint32_t (&a)[4],\n"
     "                                       uint64_t db, int acc) {\n"
     "  asm volatile(\n"
     '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %9, 0;\\n"\n'
     '      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "\n'
     '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\\n}\\n"\n'
     '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
     '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));\n'
     "}\n"),
    ("constexpr size_t SMEM = 1024 + rwu::WEIGHTS + 2 * (size_t)rwu::SLOT + 64;",
     "constexpr size_t SMEM = 1024 + rwu::WEIGHTS + 2 * (size_t)rwu::SLOT + 64 + 1024;"),
    ("  uint64_t* wbar = full + 2;\n"
     "  const int tpp = (m + RR - 1) / RR, units = bp * tpp, lanes = n_out * 16;\n"
     "  // the up rows of unit u into slot s (thread 0)",
     "  uint64_t* wbar = full + 2;\n"
     "  unsigned char* hy_s = reinterpret_cast<unsigned char*>(full + 8);\n"
     "  const int tpp = (m + RR - 1) / RR, units = bp * tpp, lanes = n_out * 16;\n"
     "  // the up rows of unit u into slot s (thread 0)"),
    ("    named_sync(1, NTH);  // both warpgroups are done with the other slot\n",
     "    if (threadIdx.x < 64) {  // hyper^T: [k16 step][k half][token][8]\n"
     "      const int n = threadIdx.x & 7, kh = (threadIdx.x >> 3) & 1,\n"
     "                kq = threadIdx.x >> 4;\n"
     "      *reinterpret_cast<uint4*>(hy_s + (k & 1) * 512 + 16 * threadIdx.x) =\n"
     "          n < n_out ? *reinterpret_cast<const uint4*>(\n"
     "                          hyper + ((size_t)pair * n_out + n) * C2 + 16 * kq + 8 * kh)\n"
     "                    : make_uint4(0u, 0u, 0u, 0u);\n"
     "    }\n"
     "    fence_proxy_async();\n"
     "    named_sync(1, NTH);  // both warpgroups are done with the other slot\n"
     "    const uint64_t d_hy = desc(hy_s + (k & 1) * 512, 128, 256, LAYOUT_NONE);\n"),
    ("      float o[4][4];\n"
     "#pragma unroll\n"
     "      for (int fg = 0; fg < 4; ++fg) {\n"
     "        uint32_t ha[2][4];\n",
     "      float o[4][4];\n"
     "      uint32_t hall[4][2][4];\n"
     "#pragma unroll\n"
     "      for (int fg = 0; fg < 4; ++fg) {\n"
     "        uint32_t (&ha)[2][4] = hall[fg];\n"),
    ("        o[fg][0] = o[fg][1] = o[fg][2] = o[fg][3] = 0.f;\n"
     "        mma16816(o[fg], ha[0], hb[0][0], hb[0][1]);\n"
     "        mma16816(o[fg], ha[1], hb[1][0], hb[1][1]);\n"
     "      }\n",
     "      }\n"
     "#pragma unroll\n"
     "      for (int fg = 0; fg < 4; ++fg) fence_operands(hall[fg]);\n"
     "      wgmma_fence();\n"
     "#pragma unroll\n"
     "      for (int fg = 0; fg < 4; ++fg) {\n"
     "        fwu::mma_n8(o[fg], hall[fg][0], d_hy, 0);\n"
     "        fwu::mma_n8(o[fg], hall[fg][1], d_hy + 16, 1);\n"
     "      }\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"
     "#pragma unroll\n"
     "      for (int fg = 0; fg < 4; ++fg) fence_operands(o[fg]);\n"
     "      (void)hb;\n"),
]

K3_FWD_VARIANTS = {
    "base": [],
    # the two wgmma chains cut to one k-step each (u1pre: 1 of 16, u2pre: 1
    # of 4)
    "no_products": [
        ("      for (int ks = 0; ks < C / 16; ++ks)",
         "      for (int ks = 0; ks < 1; ++ks)"),
        ("      for (int ks = 0; ks < C1 / 16; ++ks)",
         "      for (int ks = 0; ks < 1; ++ks)")],
    # the hypernetwork sums on mma.sync as adds of their operands
    "no_hyper_mma": [
        ("        mma16816(o[fg], ha[0], hb[0][0], hb[0][1]);\n"
         "        mma16816(o[fg], ha[1], hb[1][0], hb[1][1]);",
         "        o[fg][0] = __uint_as_float(ha[0][0] ^ ha[1][1] ^ hb[0][0]);\n"
         "        o[fg][1] = __uint_as_float(ha[0][2] ^ ha[1][3] ^ hb[1][1]);\n"
         "        o[fg][2] = __uint_as_float(ha[0][1] ^ hb[0][1]);\n"
         "        o[fg][3] = __uint_as_float(ha[1][0] ^ hb[1][0]);")],
    # the hypernetwork sums on wgmma m64n8k16 instead (A: u2g from
    # registers, B: the pair's hyper^T, tokens padded to 8, K-major in
    # shared memory; a unit's copy written by 64 threads, double-buffered
    # by unit): all four (f, g) of a block issued, then one wait
    "hyper_wgmma": _HYPER_WGMMA,
    # the GELUs (768 a row) made linear
    "no_gelu": [
        ("  return 1.f - __fdividef(2.f, attn::mma::exp2_approx(2.8853900817779268f * x) +\n"
         "                                   1.f);",
         "  return 0.25f * x;")],
    # the LayerNorm's quad reductions and rsqrt taken out (rwu::layer_norm)
    "no_ln_sums": [
        ("  const float mu[2] = {dec::quad_sum(su[0]) * (1.f / C1),\n"
         "                       dec::quad_sum(su[1]) * (1.f / C1)};",
         "  const float mu[2] = {su[0] * (1.f / C1), su[1] * (1.f / C1)};"),
        ("    rs[r] = rsqrtf(dec::quad_sum(v[r]) * (1.f / C1) + eps);",
         "    rs[r] = v[r] * (1.f / C1) + eps;")],
    # tanh as one MUFU operation (tanh.approx.f32) instead of ex2 and rcp
    "tanh_approx": [
        ("  return 1.f - __fdividef(2.f, attn::mma::exp2_approx(2.8853900817779268f * x) +\n"
         "                                   1.f);",
         "  float y;\n"
         '  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
         "  return y;")],
    # the up rows not loaded (the barrier completed without bytes)
    "no_row_loads": [
        ("    mbar_expect_tx(full + s, SLOT);\n"
         "#pragma unroll\n"
         "    for (int b = 0; b < C / 64; ++b)\n"
         "      tma_load_3d(up_s + s * SLOT + b * BOX, &tm_up, full + s, 64 * b, r0,\n"
         "                  pair);",
         "    mbar_arrive(full + s);\n"
         "    (void)r0;")],
    # the output rows not stored (their values kept live)
    "no_out_stores": [
        _keep_fn("namespace fwu {\n"),
        ("        if (ok0)\n"
         "          *reinterpret_cast<float4*>(row0 + l + 16 * h) =\n"
         "              make_float4(o[0][h], o[1][h], o[2][h], o[3][h]);\n"
         "        if (ok1)\n"
         "          *reinterpret_cast<float4*>(row1 + l + 16 * h) =\n"
         "              make_float4(o[0][2 + h], o[1][2 + h], o[2][2 + h], o[3][2 + h]);",
         "        keep(o[0][h] + o[1][h] + o[2][h] + o[3][h] + o[0][2 + h] +\n"
         "             o[1][2 + h] + o[2][2 + h] + o[3][2 + h]);")],
}

K3_ROWS_F32_VARIANTS = {
    "base": [],
    # the two W2 products (u2pre, d_u1g) as adds of their operands
    "no_w2_products": [
        ("    for (int j = 0; j < 8; ++j) mma3(a2[j], a, b[8 * j], b[4 * LDW2F + 8 * j]);",
         "    for (int j = 0; j < 8; ++j) a2[j][0] += a.lo[0] + b[8 * j] + b[4 * LDW2F + 8 * j];"),
        ("            mma3(a3[jn], a, v.x, v.y);",
         "            a3[jn][0] += a.lo[0] + v.x + v.y;")],
    # no d_up product and no stream of W1^T
    "no_dup_product": [
        ("    dec32::stream_product<L1, C, W1_KS, 16>(\n"
         "        a4, w1t, ring, 128 * sub,\n"
         "        [&](Frag& f, int k0) { load_a(f, ts, LDT, 0, k0, lane); }, lane);",
         "    a4[0][0] = ts[lane];")],
    # no u1pre product and no stream of W1 (u1pre = up's own values)
    "no_u1pre_product": [
        ("  dec32::stream_product<C, L1, W1_KS, 16>(\n"
         "      a, w1, ring, 128 * sub,\n"
         "      [&](Frag& f, int k0) { load_a(f, ts, LDT, 0, k0, lane); }, lane);",
         "  for (int j = 0; j < 16; ++j) a[j][0] = ts[j * 4 + lane];\n"
         "  __syncthreads();")],
    # the erf GELU and its derivative made linear
    "no_gelu": [
        ("  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));\n}",
         "  return 0.5f * x;\n}"),
        ("  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;\n"
         "  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * phi;",
         "  return 0.5f + 0.25f * x;")],
    # the LayerNorms' quad reductions (forward and backward) taken out
    "no_ln_sums": [
        ("    rs[d][0] = rsqrtf(quad_sum(v0) * (1.f / C1) + eps);\n"
         "    rs[d][1] = rsqrtf(quad_sum(v1) * (1.f / C1) + eps);",
         "    rs[d][0] = v0 * (1.f / C1) + eps;\n"
         "    rs[d][1] = v1 * (1.f / C1) + eps;"),
        ("    const float mu0 = quad_sum(su0) * (1.f / C1);\n"
         "    const float mu1 = quad_sum(su1) * (1.f / C1);\n"
         "    float v0 = 0.f, v1 = 0.f;",
         "    const float mu0 = su0 * (1.f / C1);\n"
         "    const float mu1 = su1 * (1.f / C1);\n"
         "    float v0 = 0.f, v1 = 0.f;"),
        ("      const float m10 = quad_sum(sa0) * (1.f / C1), m20 = quad_sum(sb0) * (1.f / C1);\n"
         "      const float m11 = quad_sum(sa1) * (1.f / C1), m21 = quad_sum(sb1) * (1.f / C1);",
         "      const float m10 = sa0 * (1.f / C1), m20 = sb0 * (1.f / C1);\n"
         "      const float m11 = sa1 * (1.f / C1), m21 = sb1 * (1.f / C1);")],
    # the up rows not copied in, dm made up from indices
    "no_row_loads": [
        ("    dec32::rows_async<C, LDT>(t_s, up + ((size_t)pair * m + srow0) * C,\n"
         "                              m - srow0);",
         "    (void)srow0;"),
        ("            dmv[0][t] = (t < n_out && ok0) ? dm0[l] : 0.f;\n"
         "            dmv[1][t] = (t < n_out && ok1) ? dm1[l] : 0.f;",
         "            dmv[0][t] = (t < n_out && ok0) ? 0.01f * l : 0.f;\n"
         "            dmv[1][t] = (t < n_out && ok1) ? 0.02f * l : 0.f;")],
    # the scratch rows u1g, d_u2pre, d_u1pre not stored
    "no_scratch_stores": [
        ("        if (ok0) dec32::st2(u1g_rows + r0 * L1 + col, u0, u1);\n"
         "        if (ok1) dec32::st2(u1g_rows + r1 * L1 + col, u2, u3);",
         "        keep(u0 + u1 + u2 + u3);"),
        ("            if (ok0) dec32::st2(d2_rows + r0 * 4 * LQ + q, a2[j][0], a2[j][1]);\n"
         "            if (ok1) dec32::st2(d2_rows + r1 * 4 * LQ + q, a2[j][2], a2[j][3]);",
         "            (void)q;"),
        ("          if (ok0) dec32::st2(du1_rows + r0 * L1 + C1 * de + c, e0, e1);\n"
         "          if (ok1) dec32::st2(du1_rows + r1 * L1 + C1 * de + c, e2, e3);",
         ""),
        _keep_fn("// W2 [C1][LQ] -> the ring's space, rows of LDW2F, asynchronously\n")],
    # d_up not stored
    "no_dup_stores": [
        ("      if (ok0) dec32::st2(d_up + r0 * C + c, a4[j][0], a4[j][1]);\n"
         "      if (ok1) dec32::st2(d_up + r1 * C + c, a4[j][2], a4[j][3]);",
         "      keep(a4[j][0] + a4[j][1] + a4[j][2] + a4[j][3]);"),
        _keep_fn("// W2 [C1][LQ] -> the ring's space, rows of LDW2F, asynchronously\n")],
    # the per-16-row d_hyper partials not stored (their sums kept live)
    "no_dht_stores": [
        ("                ht[(size_t)t * 4 * LQ] = group_sum8(vh, lane);",
         "                keep(group_sum8(vh, lane));"),
        _keep_fn("// W2 [C1][LQ] -> the ring's space, rows of LDW2F, asynchronously\n")],
}


def _k3_fwd_cases(dev, gen):
    bp, m, bf = 64, 4096, torch.bfloat16
    r = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    for n_out in (1, 4):
        args = (r(bp, m, 256).to(bf), r(256, 2, 2, 64, k=0.06).to(bf),
                r(64, k=0.1), 1 + r(64, k=0.1), r(64, k=0.1),
                r(64, 2, 2, 32, k=0.12).to(bf), r(32, k=0.1),
                r(bp, n_out, 32).to(bf))
        yield (f"k3_fwd_n{n_out}", lambda: up_op.upscale_fwd_cuda(*args),
               lambda: up_op.upscale_fwd_plain(*args))


def _k3_rows_f32_cases(dev, gen):
    bp, m = 64, 4096
    r = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    for n_out in (1, 4):
        args = (r(bp, m, 256), r(bp, m, n_out * 16), r(256, 2, 2, 64, k=0.06),
                r(64, k=0.1), 1 + r(64, k=0.1), r(64, k=0.1),
                r(64, 2, 2, 32, k=0.12), r(32, k=0.1), r(bp, n_out, 32))
        yield (f"k3_rows_f32_n{n_out}",
               lambda: up_op.upscale_bwd_rows_cuda(*args),
               lambda: up_op.upscale_bwd_rows_plain(*args))


def _k2_dims(src):
    assert src.count(_ALL_DIMS) == 1, "the head-dim switch moved"
    return src.replace(_ALL_DIMS, _SOME_DIMS)


# target -> (library, source, kernel name, variants, cases, source edit)
TARGETS = {
    "k2": ("attention_relpos_wgmma_tf32", "attention_relpos_wgmma_tf32.cu",
           "attn_relpos_wgmma_tf32_kernel", K2_VARIANTS, _k2_cases,
           _k2_dims),
    "k4_rows": ("decoder_attn", "decoder_attn.cu",
                "i2t_bwd_rows_wgmma_kernel", K4_VARIANTS, _k4_cases,
                lambda s: s),
    "k3_rows": ("upscaler", "upscaler.cu", "upscale_bwd_rows_wgmma_kernel",
                K3_VARIANTS, _k3_cases, lambda s: s),
    "k4_fwd": ("decoder_attn", "decoder_attn.cu", "i2t_fwd_wgmma_kernel",
               K4_FWD_VARIANTS, _k4_fwd_cases, lambda s: s),
    "k3_fwd": ("upscaler", "upscaler.cu", "upscale_fwd_wgmma_kernel",
               K3_FWD_VARIANTS, _k3_fwd_cases, lambda s: s),
    "k3_rows_f32": ("upscaler", "upscaler.cu", "upscale_bwd_rows_tf32_kernel",
                    K3_ROWS_F32_VARIANTS, _k3_rows_f32_cases, lambda s: s),
}


def patched(target: str, name: str) -> str:
    """The variant's source text; raises where a patch finds no target."""
    _, source, _, variants, _, edit = TARGETS[target]
    text = edit((kernels.CSRC / source).read_text())
    for old, new in variants[name]:
        found = text.count(old)
        if found != 1:
            raise ValueError(f"{target} {name}: patch target found {found} "
                             f"times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(target: str, root: Path, names=None) -> dict:
    """Patch and build the named variants (every one by default) in
    parallel; returns {name: (library path, ptxas log)}."""
    source, variants = TARGETS[target][1], TARGETS[target][3]
    nvcc = kernels.cuda_tool()
    procs = {}
    for name in variants:
        if names is not None and name not in names:
            continue
        d = root / target / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(patched(target, name))
        lib = d / "lib.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
               str(lib), str(d / source)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        out[name] = (lib, log)
    return out


def _use(library: str, path) -> None:
    """Load the variant at ``path`` as the package's ``library``: the
    wrappers bind it at their next call."""
    kernels._LOADED[library] = ctypes.CDLL(str(path))
    if library in attn._BOUND:
        attn._BOUND[library] = False
    i2t._BOUND = False
    up_op._BOUND = False


def _device_ms(fn, kernel, reps=20):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3 / reps if us > 0 else None


def _event_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _max_rel(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--target", choices=sorted(TARGETS), default="k2")
    parser.add_argument("--out", default=None,
                        help="also write the results to this JSON file")
    parser.add_argument("--only", default=None,
                        help="comma-separated variants to build and time "
                             "(with base; default all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}; target {args.target}")
    library, _, kernel, _, cases, _ = TARGETS[args.target]
    t0 = time.perf_counter()
    names = None if args.only is None else {"base", *args.only.split(",")}
    built = build_variants(args.target, kernels.BUILD_DIR.parent / "variants",
                           names)
    print(f"variants built in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "(C751" in line:
                print(f"ptxas {name}: {line.strip()}")
            if "Function properties" in line and kernel in line:
                print(f"ptxas {name}: {' '.join(lines[i + 1:i + 3])}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    results = {}
    with full_fp32():
        for case, run, plain in cases(dev, gen):
            _use(library, built["base"][0])
            err = _max_rel(run(), plain())
            print(f"{case}: base vs plain, max |diff| / max |plain| "
                  f"{err:.3g}")
            results[f"{case}_err"] = err
            for name, (path, _) in built.items():
                _use(library, path)
                ev, dv = _event_ms(run), _device_ms(run, kernel)
                results[f"{case}/{name}"] = {"event_ms": ev, "device_ms": dv}
                print(f"{case} {name}: device "
                      + ("not measured" if dv is None else f"{dv:.4f} ms")
                      + f", events {ev:.4f} ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "target": args.target,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
