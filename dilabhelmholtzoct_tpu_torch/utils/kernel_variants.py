"""Where a kernel's time goes, by variants built from a copy of its source.

    python -m dilabhelmholtzoct_tpu_torch.utils.kernel_variants \
        [--target k2 | k4_rows | k3_rows | k4_fwd] [--only a,b]
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
