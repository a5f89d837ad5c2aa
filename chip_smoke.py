#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):

1. Device facts: the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. Build: every CUDA kernel of the serving, training and evaluation paths from
   ``dilabhelmholtzoct_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
   source, all started together (build seconds and the ptxas report). Then
   the bf16 K1-K7 kernels' SASS (``cuobjdump -sass`` on the built
   libraries) must hold tensor-core instructions (HMMA, or HGMMA), the f32
   K1-K7 kernels' (split TF32) TF32 ones (HMMA.1688.F32.TF32),
   and their ptxas reports no spills, printed per kernel beside its
   registers.
3. Kernels at SAM ViT-B shapes — K1 global attention (B=1, N=4096, 12 heads)
   and K2 windowed attention (25 windows of 196 tokens, 12 heads) — in f32
   and bf16, and K1 in f32 at B=4 (the f32 full fine-tune's shape): each
   held against its plain PyTorch version on the same card tensors (f32
   within 1e-4; bf16 within 2 bf16 ulps of the case's own output scale,
   2 * 2^-8 * max |plain|, printed beside the error; the same limits hold
   K6 and K7) and bit-equal to itself on a second run, then timed with
   CUDA events (kernel, plain version, and one
   ``scaled_dot_product_attention`` call with the materialised bias as the
   library yardstick), beside the bound computed from the shapes (the f32
   kernels on the tensor cores against the split-TF32 rate, 495 / 3
   TFLOP/s, with their bound over the CUDA cores' 67 beside it).
4. Serving at full ViT-B width: random weights from a seeded
   torch.Generator (non-zero rel-pos tables), a synthetic 496x512 OCT-shaped
   uint8 image (the exact-2x preprocess), a box, a point and a 3-box request
   through ``SegmentationEngine.segment``. Launch counts are zeroed just
   before and read just after: 4 K1 and 8 K2 launches for the one encode,
   none for the cached prompts, and no K3/K4 launch at all (serving is
   f32). The box request's probabilities and masks are held against the
   same engine on ``device="cpu"``.
5. Kernels of the training path at its shapes (64 (image, prompt) pairs x
   4096 rows, C = 256, 7 tokens) — K3 upscaler and K4 image->token
   attention (with pb = 1 and the shared first layer's pb = 8), the
   forward, the backward's row pass and weight pass and the whole
   backward, in f32 (split TF32) and bf16: each held against its plain
   PyTorch version (relative to the max |value| of each output, within
   ``K34_TOL``) and bit-equal to itself on a second run, then timed with
   CUDA events beside the bound from the shapes (f32: split TF32's rate,
   the CUDA cores' bound beside it). No single PyTorch call computes
   either fused chain, so their library_ms is null.
6. Training at full ViT-B width, bf16, cached embeddings: random weights
   (non-zero rel-pos), 16 train + 8 valid synthetic 496x512 OCT images with
   label maps of background + 7 non-touching blobs (bucket 8, 64 pairs per
   batch of 8). ``precompute_embeddings`` launches K1 x4 and K2 x8 per
   image; 10 ``make_train_step`` steps on one batch launch K3 fwd/bwd x1 and
   K4 fwd/bwd x2 each, with a finite, falling loss; one step with the
   encoder inside (B = 2) launches K1/K2 too.
6b. f32 decoder fine-tuning on the fused route: ViT-B, cached f32
   embeddings of 8 images x bucket 8 (64 pairs), ``compute_dtype=
   'float32'`` under ``set_fused_i2t('on')`` and
   ``set_fused_upscaler('interpret')``: 8 steps, each launching the f32 K4
   x2 and K3 x1 (forward, row pass and weight pass) and nothing else, a
   falling loss; the same 8 steps under 'auto' (the unfused chain, no
   K3 / K4), both median steps printed; the first-step losses of the two
   routes within ``F32_STEP_LOSS_RTOL``. Both switches end at 'auto'.
7. The card against the CPU: the same first step on 1 image x bucket 8 on
   both — the loss and the signs of the decoder updates.
8. The epoch loop: ``training(config, splits=...)`` for 2 epochs, then
   resumed to 3; finite losses, one checkpoint kept.
9. K5, the attention backward (its dq and dk/dv kernels), and the
   logsumexp rows K1 / K2 write for it, at ViT-B shapes (global B = 1,
   25 windows; 12 heads) in f32 and bf16, each output held against its
   plain version relative to its max |plain|, and the same bits on a second
   run (f32: split TF32 on the tensor cores); then each K5 kernel timed
   with CUDA events at the training shapes (global B = 4, 100 windows)
   beside its bound, the plain version and the backward of one
   ``scaled_dot_product_attention`` call with a bias that requires grad
   (the library yardstick; it computes more: the full (N, N) bias
   gradient).
10. Full fine-tuning (``trainable='all'``, bf16, the encoder inside the
   gradient with every layer checkpointed; BASELINE config 5 geometry):
   ViT-B at bs 4 for 10 steps on one batch of 496x512 synthetic OCT images
   (bucket 8), each step launching K1 4 + 4 and K2 8 + 8 (forward and
   recompute), K5's two kernels 12 each, K3 1 + 1 and K4 2 + 2; a finite,
   falling loss and a moved patch embedding; then ViT-L (full width and
   depth) at bs 2 for 3 steps: K1 4 + 4, K2 20 + 20, K5 24 + 24.
11. The card against the CPU: the first full fine-tune step on 1 image at
   ViT-B width, its depth cut to 2 layers (one windowed, one global) — the
   loss and the signs of the updates over every parameter.
12. The full fine-tune epoch loop: ``training(trainable='all')`` at ViT-B
   for 1 epoch of 2 steps; finite losses, one checkpoint.
12b. The f32 full fine-tune (``compute_dtype='float32'``): ViT-B at bs 4
   for 5 steps on one batch, each step K1 x8, K2 x16 and K5's two kernels
   x12 in f32 and no K3 / K4; a falling loss, the median step ms; the card
   against the CPU at the 2-layer cut (loss within ``F32_STEP_LOSS_RTOL``,
   update signs).

13. K6, the any-head-dim attention, at ViT-H shapes (16 heads of 80; the
   global layer B = 1, N = 4096; 25 windows of 196), at the test-size
   model's (4 heads of 16) and at head dims whose rows the kernels pad
   (20 and 48), in f32 (split TF32) and bf16: held against its plain
   version and bit-equal to itself on a second run, then timed beside its
   bound (f32: the split-TF32 rate, the CUDA cores' beside it), the plain
   version and one ``scaled_dot_product_attention`` call with the
   materialised bias.
14. K7, the image-layout windowed attention, at ViT-B (B = 1, 12 heads,
   64x64, windows of 14) and on a ragged 28x20 grid, in f32 and bf16: held
   against its plain version and, bit for bit, against K2 on the partitioned
   windows of the same qkv; timed beside K2's bound. Then one ViT-B layer's
   windowed attention (LayerNorm output to projected output) through the
   image-layout route and through the partitioned route (pad, partition,
   qkv, K2, projection, un-partition, crop): agreement and both times.
15. Serving at full ViT-H width and depth (32 layers, 1280 wide, 16 heads
   of 80, f32, random weights with non-zero rel-pos tables): box, point and
   3-box requests; exactly 32 K6 launches for the one encode, none for the
   cached prompts, no other kernel; cold and cached ms, peak memory; the box
   request held against the same engine on the CPU at full depth.
16. ViT-B serving under ``set_fused_windowed('on')``: one encode launches K1
   x4, K7 x8 and K2 x0; probabilities within tolerance of the default
   route's on the card; a bf16 encode under each route (K2 x8 or K7 x8),
   the embeddings within 2e-2 of their max of each other; encode ms of both
   routes in f32 and in bf16. The switch is reset.
17. Evaluation: ``evaluate_metrics`` over 8 synthetic OCT items at full
   ViT-H (32 K6 launches per image) with a finite report; the same call at a
   depth cut (2 layers: one windowed, one global) on the card against
   ``device="cpu"``; ``training(evaluate=True)`` for one short ViT-B epoch
   returns ``metrics``.
18. Decoder fine-tuning at full ViT-H (``TrainConfig(base_model=
   'facebook/sam-vit-huge')``, bf16, ``prepare_model``'s seeded random
   weights): the precompute of 16 synthetic images launches K6 exactly x32
   per image and nothing else; one epoch of 2 cached-embedding steps, each
   K3 x1 and K4 x2 forward and backward; precompute ms per image, step ms
   and peak memory; ``training()`` for 1 epoch (16 + 8 images, 2 steps);
   the bf16 embeddings of 2 images at a 2-layer cut (full width) on the
   card against the CPU, within ``EMB_ULPS`` bf16 ulps of their scale.

The line before the last is a JSON object with one entry per kernel (K1/K2
numbers from the serving path in f32; K1 in f32 at B = 4
(``attn_global_b4``), its launches counted on the f32 full fine-tune run;
K1 and K2 in bf16 as their own
kernels (``attn_global_bf16``, ``attn_windowed_bf16``: the tensor-core
kernels, at ViT-B B = 1, their launches counted on the ViT-B full
fine-tune run); K3/K4 from the training path in bf16, and in f32
(``*_f32``, split TF32, with ``bound_cuda_cores_ms``) counted on the f32
fused decoder run; K5 from the global
layer at B = 4 in bf16, its launches counted on the ViT-B full fine-tune
run, and in f32 (``attn_bwd_dq_f32``, ``attn_bwd_dkv_f32``), its launches
counted on the f32 full fine-tune run; K6 from the ViT-H global layer
(``attn_relpos``) and windowed layer (``attn_relpos_windowed``) in f32,
their launches (one kernel, one count) counted on the ViT-H serving run,
and in bf16 (``attn_relpos_bf16``, ``attn_relpos_windowed_bf16``), counted
on the ViT-H bf16 precompute and steps; K7 at ViT-B in f32, its
launches counted on the ``set_fused_windowed('on')`` encode); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# f32 products on the tensor cores in split TF32 (hi.hi + hi.lo + lo.hi):
# three TF32 products at 495 TFLOP/s for each f32 one
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
F32_ATOL = 1e-4    # kernel vs plain, f32: summation order over <= 4096 keys
PROB_ATOL = 1e-3   # card engine vs CPU engine, probabilities (ViT-B, f32)
BF16_ULPS = 2      # attention forward vs plain, bf16: ulps of the output scale
# K3/K4 kernel vs plain, max |diff| / max |plain| per output: f32 summation
# order; bf16 one flipped rounding of an intermediate (2^-8 relative) before
# further products
K34_TOL = {"f32": 1e-4, "bf16": 2e-2}
STEP_LOSS_RTOL = 2e-2   # bf16 train step, card vs CPU: bf16 roundings of the
#                         decoder in another summation order
F32_STEP_LOSS_RTOL = 1e-4  # f32 full fine-tune step, card vs CPU, and f32
#                            decoder step, fused route vs 'auto': f32 sums in
#                            another order (the split-TF32 products keep f32's
#                            digits; TF32 is off for the library calls)
SIGN_AGREE_MIN = 0.90   # card vs CPU, share of moved decoder weights whose
#                         first-step update agrees in sign (Adam step 1 is
#                         ~lr * sign(g); tiny gradients may flip in bf16)
EVAL_ATOL = 2e-3   # evaluation report, card vs CPU (2-layer cut): a few of
#                    254k pixels per mask may cross 0.5 between summation orders
TRAIN_SHAPES = dict(bp=64, m=4096, n_tok=7, n_out=1)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_tol(ref):
    """An attention forward kernel (K1, K2, K6, K7) against its plain
    version: ``F32_ATOL`` in f32; in bf16
    ``BF16_ULPS`` bf16 ulps of this case's output scale, 2 * 2^-8 * max
    |plain| (the outputs average thousands of values and are far below 1,
    so a fixed limit sized for |out| ~ 1 would pass a wrong kernel)."""
    import torch

    if ref.dtype == torch.float32:
        return F32_ATOL
    return BF16_ULPS * 2.0 ** -8 * ref.float().abs().max().item()


def cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, n, heads, hw, itemsize, peak_flops, d=64):
    """Least time for one call: the larger of its operations (q.k and p.v,
    2 * 2 * N^2 * d per head) over the type's peak and its bytes (qkv and
    both bias factors read once, the output written once) over 3.35 TB/s."""
    c = heads * d
    flops = 4.0 * b * heads * n * n * d
    nbytes = itemsize * b * n * (3 * c + heads * (hw[0] + hw[1]) + c)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _sdpa_ms(torch, qkv, rel_h, rel_w, hw, heads, iters=5):
    """The library yardstick of an attention forward: one
    ``scaled_dot_product_attention`` call on head-major views of the same
    qkv with the bias materialised beforehand."""
    b, n, c3 = qkv.shape
    x = qkv.view(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    mask = (rel_h.reshape(b, heads, n, hw[0], 1)
            + rel_w.reshape(b, heads, n, 1, hw[1])).reshape(b, heads, n, n)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        x[0], x[1], x[2], attn_mask=mask), iters)


# the kernels on the tensor cores: library -> kernel names, bf16 (HMMA on
# bf16) and f32 in split TF32 (HMMA.1688.F32.TF32)
MMA_KERNELS = {"attention": ("attn_global_mma_kernel",
                             "attn_windowed_mma_kernel"),
               "attention_bwd": ("attn_bwd_dq_mma_kernel",
                                 "attn_bwd_dkv_mma_kernel"),
               "attention_relpos": ("attn_relpos_mma_kernel",),
               "attention_winimg": ("attn_winimg_mma_kernel",),
               "upscaler": ("upscale_fwd_mma_kernel", "upscale_bwd_rows_kernel",
                            "upscale_bwd_dw_kernel"),
               "decoder_attn": ("i2t_fwd_mma_kernel", "i2t_bwd_rows_kernel",
                                "i2t_bwd_dw_kernel")}
TF32_KERNELS = {"attention": ("attn_global_tf32_kernel",
                              "attn_windowed_tf32_kernel"),
                "attention_bwd": ("attn_bwd_dq_tf32_kernel",
                                  "attn_bwd_dkv_tf32_kernel"),
                "attention_relpos": ("attn_relpos_tf32_kernel",),
                "attention_winimg": ("attn_winimg_tf32_kernel",),
                "upscaler": ("upscale_fwd_tf32_kernel",
                             "upscale_bwd_rows_tf32_kernel",
                             "upscale_bwd_dw_tf32_kernel"),
                "decoder_attn": ("i2t_fwd_tf32_kernel",
                                 "i2t_bwd_rows_tf32_kernel",
                                 "i2t_bwd_dw_tf32_kernel")}


def _ptxas_by_function(log):
    """{mangled kernel name: "N registers, S bytes spill stores, ..."} from
    an ``-Xptxas -v`` report."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def tensor_core_check(kernels):
    """Fail unless the SASS of every tensor-core kernel -- bf16 K1 / K2 /
    K5 / K6 / K7, the K3 / K4 forwards and both launches of their
    backwards in bf16 and in f32, and f32
    K1 / K2 / K5 / K6 / K7 in split TF32 -- holds tensor-core
    instructions (HMMA from mma.sync, HGMMA from wgmma; TF32 ones for the
    f32 kernels) and its ptxas report shows no spills; print the count of
    each instance beside its registers and spills."""
    cuobjdump = kernels.cuda_tool("cuobjdump")
    for lib in MMA_KERNELS:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(kernels.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = [0, 0]
            elif fn and ("HMMA" in line or "HGMMA" in line):
                counts[fn][0] += 1
                counts[fn][1] += "TF32" in line
        report = _ptxas_by_function(kernels.BUILD_LOG.get(lib, ""))
        for name in MMA_KERNELS[lib] + TF32_KERNELS.get(lib, ()):
            tf32 = name in TF32_KERNELS.get(lib, ())
            found = [f for f in counts if name in f]
            check(found, f"{name} is not in the SASS of {lib}")
            for f in found:
                n_mma, n_tf32 = counts[f]
                check(n_mma > 0 and (n_tf32 > 0 if tf32 else True),
                      f"{f}: no {'TF32 ' if tf32 else ''}tensor-core "
                      "instruction in its SASS")
                rep = report.get(f, "not rebuilt in this run")
                check(f not in report or ("0 bytes spill stores" in rep
                                          and "0 bytes spill loads" in rep),
                      f"{f} spills: {rep}")
                print(f"sass {f}: {n_mma} tensor-core instructions"
                      f"{f' ({n_tf32} on TF32)' if tf32 else ''}; ptxas "
                      f"{rep}")


def _cuda_core_bound(row, ms, split, bound):
    """For an f32 kernel in split TF32: its bound over the CUDA cores' f32
    rate kept in the row beside the split-TF32 one (``bound_cuda_cores_ms``)
    and the text for its line, so that a share above 1 against the CUDA
    cores is not read as a share of the tensor cores' bound."""
    if not split:
        return ""
    row["bound_cuda_cores_ms"] = bound[0]
    return (f"; bound over the CUDA cores (67 TFLOP/s f32) {bound[0]:.4f} "
            f"({bound[1]}), share {bound[0] / ms:.3f}")


def kernel_phase(torch, attn):
    """K1 / K2 vs their plain versions at ViT-B shapes, and the same bits on
    a second run; returns the numbers of each kernel for the result line:
    f32 (the serving path's type) under its name, bf16 (the tensor-core
    kernels of the precompute and full fine-tune paths) as
    ``<name>_bf16``, and the f32 K1 at B = 4 (the f32 full fine-tune's
    shape) as ``attn_global_b4``."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    both = (torch.float32, torch.bfloat16)
    # (the f32 row's key, the kernel's counter, B, grid, the TPU kernel,
    # types)
    cases = [
        ("attn_global", "attn_global", 1, (64, 64),
         "dilabhelmholtzoct_tpu/ops/attention.py:819", both),
        ("attn_windowed", "attn_windowed", 25, (14, 14),
         "dilabhelmholtzoct_tpu/ops/attention.py:770", both),
        ("attn_global_b4", "attn_global", 4, (64, 64),
         "dilabhelmholtzoct_tpu/ops/attention.py:819", (torch.float32,)),
    ]
    heads = 12
    rows = {}
    for f32_key, name, b, hw, replaces, dtypes in cases:
        n = hw[0] * hw[1]
        for dtype in dtypes:
            qkv = torch.randn((b, n, 3 * heads * 64), generator=gen,
                              device=dev).to(dtype)
            rel_h = (0.3 * torch.randn((b, heads, n, hw[0]), generator=gen,
                                       device=dev)).to(dtype)
            rel_w = (0.3 * torch.randn((b, heads, n, hw[1]), generator=gen,
                                       device=dev)).to(dtype)
            args = (qkv, rel_h, rel_w)
            kw = dict(hw=hw, num_heads=heads)
            with full_fp32():
                before = attn.LAUNCHES[name]
                out = attn.flash_attention_packed(*args, **kw)
                torch.cuda.synchronize()
                check(attn.LAUNCHES[name] == before + 1,
                      f"{name} did not launch its kernel")
                ref = attn.packed_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = kernel_tol(ref)
                check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                      f"{name} {dtype}: bad output")
                check(err <= tol, f"{name} {dtype}: max |kernel - plain| "
                                  f"{err:.3g} > {tol:.3g}")
                check(torch.equal(out, attn.flash_attention_packed(*args, **kw)),
                      f"{name} {dtype}: a second run gave other bits")
                iters = 20 if name == "attn_global" else 50
                ms = cuda_ms(lambda: attn.flash_attention_packed(*args, **kw),
                             iters)
                plain_ms = cuda_ms(
                    lambda: attn.packed_attention_plain(*args, **kw), 5)
                lib_ms = _sdpa_ms(torch, qkv, rel_h, rel_w, hw, heads)
            # the f32 kernels run on the tensor cores in split TF32
            split = dtype == torch.float32
            peak = PEAK_TF32X3_FLOPS if split else PEAK_BF16_FLOPS
            bound, bound_by = attention_bound_ms(b, n, heads, hw,
                                                 qkv.element_size(), peak)
            tname = "f32" if split else "bf16"
            key = f32_key if split else f"{name}_bf16"
            rows[key] = {
                "name": key, "route": "cuda",
                "source": "dilabhelmholtzoct_tpu_torch/csrc/attention.cu",
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms,
            }
            print(f"kernel {name} {tname} B={b} N={n} heads={heads}: "
                  f"max_abs_err={err:.3g} (limit {tol:.3g}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.4f} ({bound_by}"
                  f"{', split TF32' if split else ''}) "
                  f"share_of_bound={bound / ms:.3f}"
                  + _cuda_core_bound(rows[key], ms, split, attention_bound_ms(
                      b, n, heads, hw, qkv.element_size(), PEAK_F32_FLOPS)))
            del qkv, rel_h, rel_w, out, ref
    torch.cuda.empty_cache()
    return rows


def serving_phase(torch, attn):
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.inference.engine import SegmentationEngine
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base

    cfg = sam_vit_base()
    sd = synthetic.random_params(cfg, seed=0)
    engine = SegmentationEngine(sd, cfg)  # the card, by default
    check(engine.device.type == "cuda", "engine is not on the card")
    img = synthetic.oct_image(seed=0)
    box, point, boxes3 = synthetic.BOX, synthetic.POINT, synthetic.BOXES3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # --- main path starts
    t0 = time.perf_counter()
    bin_box, p_box = engine.segment(img, box, "bbox")
    cold_ms = 1e3 * (time.perf_counter() - t0)
    after_encode = dict(attn.LAUNCHES)
    bin_pt, p_pt = engine.segment(img, point, "points")
    bin_3, p_3 = engine.segment(img, boxes3, "bbox")
    launches = dict(attn.LAUNCHES)  # --- main path ends
    fused = {k: v for k, v in _counts().items() if k not in launches}
    check(not any(fused.values()),
          f"f32 serving launched training kernels: {fused}")
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"serving launches after the first request {after_encode}, "
          f"after all three {launches}")
    check(after_encode == {**dict.fromkeys(attn.LAUNCHES, 0),
                           "attn_global": 4, "attn_windowed": 8},
          f"one ViT-B encode must launch K1 x4 and K2 x8 (and no backward, "
          f"no K6, no K7), got {after_encode}")
    check(launches == after_encode,
          "a cached prompt launched encoder attention kernels")
    for b_, p_, n in ((bin_box, p_box, 1), (bin_pt, p_pt, 1), (bin_3, p_3, 3)):
        check(b_.shape == p_.shape == (n, 496, 512), f"shape {b_.shape}")
        check(b_.dtype == np.uint8 and set(np.unique(b_)) <= {0, 1},
              "masks are not 0/1 uint8")
        check(bool(np.isfinite(p_).all()) and p_.min() >= 0 and p_.max() <= 1,
              "probabilities are not finite in [0, 1]")

    cached = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.segment(img, box, "bbox")
        cached.append(1e3 * (time.perf_counter() - t0))
    cached_ms = statistics.median(cached)

    cpu = SegmentationEngine(sd, cfg, device="cpu")
    cbin, cprob = cpu.segment(img, box, "bbox")
    diff = float(np.abs(cprob - p_box).max())
    near = np.abs(cprob - 0.5) <= PROB_ATOL
    mism = int((cbin != bin_box)[~near].sum())
    print(f"serving vs cpu engine (box): max |p_card - p_cpu| = {diff:.3g} "
          f"(atol {PROB_ATOL}), mask pixels that differ away from 0.5: {mism}, "
          f"foreground share {bin_box.mean():.4f}")
    check(diff <= PROB_ATOL, f"card probabilities differ from the CPU engine "
                             f"by {diff:.3g}")
    check(mism == 0, f"{mism} mask pixels differ from the CPU engine")
    print(f"serving ViT-B f32: cold encode+decode {cold_ms:.2f} ms, cached "
          f"prompt-to-mask median of 10 {cached_ms:.2f} ms (all "
          f"{[round(c, 2) for c in cached]}), max_memory_allocated "
          f"{peak_bytes / 2**20:.1f} MiB")
    return launches


def k3_bound_ms(bp, m, n_out, itemsize, peak, backward, part=None):
    """Least time for one K3 call at C = 256: the products of the chain
    (forward 2*256*256 + 4*2*64*128 + 2*512*n_out per row; the backward adds
    the recompute's twin products for d_up, dW1, d_u1g, dW2 and the
    hypernetwork terms) over the type's peak, against the bytes (up, and dm
    for the backward, read once; the mask rows or d_up written once).
    ``part`` bounds one launch of the backward: "rows" (the chain, d_up,
    d_u1g and the hypernetwork terms; its scratch rows u1g, rnd(d_u2pre)
    and rnd(d_u1pre) written, in the input dtype: f32 rows in f32) or "dw"
    (dW1 and dW2 from up and the scratch, read once; the weight gradients
    written once). ``peak``: the type's rate (f32: split TF32 on the
    tensor cores, or the CUDA cores' for the line beside it)."""
    first, second = 2 * 256 * 256, 4 * 2 * 64 * 128
    fwd = first + second + 2 * 512 * n_out
    rows, scratch = bp * m, itemsize * bp * m * (256 + 512 + 256)
    out_f32 = 4 * rows * n_out * 16
    if part == "dw":
        return _bound(rows * (first + second), itemsize * rows * 256 + scratch
                      + 4 * (256 * 256 + 4 * 64 * 128), peak)
    if part == "rows":
        return _bound(rows * (fwd + first + second + 2 * 512 * n_out),
                      2 * itemsize * rows * 256 + out_f32 + scratch, peak)
    flops = rows * (fwd if not backward
                    else fwd + 2 * (first + second) + 2 * 2 * 512 * n_out)
    nbytes = itemsize * rows * 256 + (
        out_f32 if not backward else out_f32 + itemsize * rows * 256)
    return _bound(flops, nbytes, peak)


def k4_bound_ms(bp, pb, m, n_tok, itemsize, peak, backward, part=None):
    """Least time for one K4 call at C = 256, I = 128: the q and out
    projections and the token attention (2*(2*256*128 + 2*128*n_tok) per
    row; the backward adds dWo, d_out, dWq, d_keys and the softmax
    products) over the type's peak, against the bytes (keys per image, pe,
    and dy for the backward, read once; y, or d_keys, d_qpre, p, d_score and
    d_out, written once). ``part`` bounds one launch of the backward:
    "rows" (all but dWo and dWq; its scratch rows rnd(out) and rnd(d_res)
    written, in the input dtype) or "dw" (dWo and dWq from the keys, pe,
    d_qpre and the scratch, read once; the weight gradients written once).
    ``peak`` as in ``k3_bound_ms``."""
    proj, att = 2 * 256 * 128, 2 * 128 * n_tok
    fwd = 2 * proj + 2 * att
    rows_in = (bp // pb) * m * 256 + m * 256
    row_out = bp * m * (256 + 128 + 64 + 64 + 128)
    if part == "dw":
        return _bound(bp * m * 2 * proj,
                      itemsize * (rows_in + bp * m * (128 + 128 + 256))
                      + 4 * 2 * 128 * 256, peak)
    if part == "rows":
        return _bound(bp * m * (fwd + 2 * proj + 2 * att),
                      itemsize * (rows_in + bp * m * 256 + row_out
                                  + bp * m * (128 + 256)), peak)
    flops = bp * m * (fwd if not backward else fwd + 4 * proj + 2 * att)
    if not backward:
        nbytes = itemsize * (rows_in + bp * m * 256)
    else:
        nbytes = itemsize * (rows_in + bp * m * 256 + row_out)  # + dy
    return _bound(flops, nbytes, peak)


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _check_outputs(torch, name, tname, got, want):
    """Every output of a kernel against its plain version, each relative to
    its own scale; returns (max abs error, max relative error)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst_abs = worst_rel = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name} {tname} output {i}: {a.shape} {a.dtype} vs plain "
              f"{b.shape} {b.dtype}")
        check(bool(torch.isfinite(a.float()).all()),
              f"{name} {tname} output {i} not finite")
        err = float((a.float() - b.float()).abs().max())
        rel = err / max(float(b.float().abs().max()), 1e-30)
        check(rel <= K34_TOL[tname], f"{name} {tname} output {i}: max |kernel "
                                     f"- plain| / max |plain| = {rel:.3g} > "
                                     f"{K34_TOL[tname]}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def k34_kernel_phase(torch):
    """K3 and K4, forward and backward, against their plain versions at the
    training shapes in f32 and bf16, on the tensor cores (f32 in split
    TF32). Each forward gives the same bits on a second run (bf16: K4's
    share of outputs bit-equal to ``i2t_fwd_plain`` printed); each backward
    is two launches, the row pass and the weight pass: each is held against
    its plain twin (the weight pass on the row pass's own scratch rows), the
    composed backward against ``*_bwd_plain`` and against itself on a second
    run (the same bits), and each launch is timed beside its bound (f32:
    split TF32's rate, the CUDA cores' bound beside it). Returns the numbers
    per launch for the result line: bf16 rows under the launch names, f32
    rows under the names with ``_f32``."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bp, m, n_tok, n_out = (TRAIN_SHAPES[k] for k in ("bp", "m", "n_tok",
                                                     "n_out"))
    f32 = torch.float32
    rows = {}

    def rnd(*shape, k=1.0, dt=f32):
        return (k * torch.randn(shape, generator=gen, device=dev)).to(dt)

    def run(name, tname, kernel, plain, counter, bound, replaces, iters,
            tag="", row=None, bits=False, cores=None):
        """``name`` is the launch count the kernel call adds one to; ``row``
        the result line's entry it fills (pb = 1; ``_f32`` added in f32);
        ``replaces`` the kernel's source file, its name and the TPU kernel's
        call site; ``bits`` prints the share of outputs bit-equal to the
        plain version; ``cores`` the f32 bound over the CUDA cores. Every
        launch must give the same bits on a second run."""
        before = counter[name]
        out = kernel()
        torch.cuda.synchronize()
        check(counter[name] == before + 1,
              f"{name}{tag} did not launch its kernel")
        ref = plain()
        torch.cuda.synchronize()
        err, rel = _check_outputs(torch, name + tag, tname, out, ref)
        same = ""
        if bits:
            same = (" bit-equal to plain "
                    f"{float((out == ref).float().mean()):.5f};")
        del ref
        again = kernel()
        pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{row or name}{tag} {tname}: a second run gave other bits")
        same, again = same + " same bits on a second run;", None
        del out
        ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, 2)
        b_ms, b_by = bound
        key = None if row is None or tag else row + (
            "" if tname == "bf16" else "_f32")
        entry = {}
        core_txt = _cuda_core_bound(entry, ms, cores is not None, cores)
        print(f"kernel {row or name}{tag} {tname}: max_abs_err={err:.3g} "
              f"max_rel_err={rel:.3g};{same} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=null bound_ms={b_ms:.4f} "
              f"({b_by}{'; split TF32' if cores else ''}) "
              f"share_of_bound={b_ms / ms:.3f}{core_txt}")
        if key:
            entry.update({
                "name": key, "route": "cuda",
                "source": f"dilabhelmholtzoct_tpu_torch/csrc/{replaces[0]}",
                "kernel": replaces[1][tname], "replaces": replaces[2],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
            })
            rows[key] = entry
        return ms

    k3 = "upscaler.cu", "dilabhelmholtzoct_tpu/ops/upscaler.py"
    k4 = "decoder_attn.cu", "dilabhelmholtzoct_tpu/ops/decoder_attn.py"
    names = lambda bf, f: {"bf16": bf, "f32": f}
    k3_fwd = k3[0], names("upscale_fwd_mma_kernel",
                          "upscale_fwd_tf32_kernel"), f"{k3[1]}:295"
    k3_bwd = k3[0], names("upscale_bwd_rows_kernel",
                          "upscale_bwd_rows_tf32_kernel"), f"{k3[1]}:329"
    k3_dw = k3[0], names("upscale_bwd_dw_kernel",
                         "upscale_bwd_dw_tf32_kernel"), f"{k3[1]}:329"
    k4_fwd = k4[0], names("i2t_fwd_mma_kernel",
                          "i2t_fwd_tf32_kernel"), f"{k4[1]}:264"
    k4_bwd = k4[0], names("i2t_bwd_rows_kernel",
                          "i2t_bwd_rows_tf32_kernel"), f"{k4[1]}:287"
    k4_dw = k4[0], names("i2t_bwd_dw_kernel",
                         "i2t_bwd_dw_tf32_kernel"), f"{k4[1]}:287"
    with full_fp32():
        for dt, tname in ((f32, "f32"), (torch.bfloat16, "bf16")):
            bf = dt == torch.bfloat16
            peak = PEAK_BF16_FLOPS if bf else PEAK_TF32X3_FLOPS
            isz = torch.empty((), dtype=dt).element_size()

            def bounds(fn, *a):
                """(bound over the type's peak, f32 bound over the CUDA
                cores or None)"""
                return fn(*a, peak), (None if bf else fn(*a, PEAK_F32_FLOPS))

            def k3b(backward, part=None):
                return bounds(lambda pk: k3_bound_ms(bp, m, n_out, isz, pk,
                                                     backward, part))

            # K3 at 64 pairs x 4096 rows
            up_args = (rnd(bp, m, 256, dt=dt), rnd(256, 2, 2, 64, k=0.06,
                                                   dt=dt),
                       rnd(64, k=0.1), 1 + rnd(64, k=0.1), rnd(64, k=0.1),
                       rnd(64, 2, 2, 32, k=0.12, dt=dt), rnd(32, k=0.1),
                       rnd(bp, n_out, 32, dt=dt))
            dm = rnd(bp, m, n_out * 16)
            bwd_args = (up_args[0], dm) + up_args[1:]
            b, c = k3b(False)
            run("upscale_fwd", tname, lambda: up_op.upscale_fwd_cuda(*up_args),
                lambda: up_op.upscale_fwd_plain(*up_args), up_op.LAUNCHES,
                b, k3_fwd, 10, row="upscale_fwd", cores=c)
            b, c = k3b(True)
            total = run("upscale_bwd", tname,
                        lambda: up_op.upscale_bwd_cuda(*bwd_args),
                        lambda: up_op.upscale_bwd_plain(*bwd_args),
                        up_op.LAUNCHES, b, k3_bwd, 5, cores=c)
            got = up_op.upscale_bwd_rows_cuda(*bwd_args)
            scratch = (up_args[0],) + got[1:4]
            del got
            b, c = k3b(True, "rows")
            t_rows = run("upscale_bwd", tname,
                         lambda: up_op.upscale_bwd_rows_cuda(*bwd_args),
                         lambda: up_op.upscale_bwd_rows_plain(*bwd_args),
                         up_op.LAUNCHES, b, k3_bwd, 5, row="upscale_bwd",
                         cores=c)
            b, c = k3b(True, "dw")
            t_dw = run("upscale_bwd_dw", tname,
                       lambda: up_op.upscale_bwd_dw_cuda(*scratch),
                       lambda: up_op.upscale_bwd_dw_plain(*scratch),
                       up_op.LAUNCHES, b, k3_dw, 5, row="upscale_bwd_dw",
                       cores=c)
            print(f"K3 {tname} backward: {total:.4f} ms composed (row pass "
                  f"{t_rows:.4f} + weight pass {t_dw:.4f} timed alone)")
            del up_args, dm, bwd_args, scratch
            # K4 per-pair layer (pb = 1) and shared first layer (pb = 8)
            for pb in (1, 8):
                args = (rnd(bp // pb, m, 256, dt=dt), rnd(1, m, 256, dt=dt),
                        rnd(bp, n_tok, 128, dt=dt), rnd(bp, n_tok, 128, dt=dt),
                        rnd(256, 128, k=0.06, dt=dt), rnd(128, k=0.1),
                        rnd(128, 256, k=0.09, dt=dt), rnd(256, k=0.1),
                        1 + rnd(256, k=0.1), rnd(256, k=0.1))
                dy = rnd(bp, m, 256, dt=dt)
                kw = dict(nh=8, pb=pb, eps=1e-6)
                tag = "" if pb == 1 else "_pb8"

                def k4b(backward, part=None):
                    return bounds(lambda pk: k4_bound_ms(
                        bp, pb, m, n_tok, isz, pk, backward, part))

                b, c = k4b(False)
                run("i2t_fwd", tname, lambda: i2t.i2t_fwd_cuda(*args, **kw),
                    lambda: i2t.i2t_fwd_plain(*args, **kw), i2t.LAUNCHES,
                    b, k4_fwd, 10, tag, row="i2t_fwd", bits=bf, cores=c)
                b, c = k4b(True)
                total = run("i2t_bwd", tname,
                            lambda: i2t.i2t_bwd_cuda(*args, dy, **kw),
                            lambda: i2t.i2t_bwd_plain(*args, dy, **kw),
                            i2t.LAUNCHES, b, k4_bwd, 5, tag, cores=c)
                got = i2t.i2t_bwd_rows_cuda(*args, dy, **kw)
                scratch = (args[0], args[1], got[1], got[5], got[6])
                del got
                b, c = k4b(True, "rows")
                t_rows = run(
                    "i2t_bwd", tname,
                    lambda: i2t.i2t_bwd_rows_cuda(*args, dy, **kw),
                    lambda: i2t.i2t_bwd_rows_plain(*args, dy, **kw),
                    i2t.LAUNCHES, b, k4_bwd, 5, tag, row="i2t_bwd", cores=c)
                b, c = k4b(True, "dw")
                t_dw = run(
                    "i2t_bwd_dw", tname,
                    lambda: i2t.i2t_bwd_dw_cuda(*scratch, pb=pb),
                    lambda: i2t.i2t_bwd_dw_plain(*scratch, pb=pb),
                    i2t.LAUNCHES, b, k4_dw, 5, tag, row="i2t_bwd_dw",
                    cores=c)
                print(f"K4{tag} {tname} backward: {total:.4f} ms composed "
                      f"(row pass {t_rows:.4f} + weight pass {t_dw:.4f} "
                      "timed alone)")
                del args, dy, scratch
            torch.cuda.empty_cache()
    return rows


def _device_batch(torch, batch, dev, emb=None):
    out = {k: torch.as_tensor(batch[k]).to(dev)
           for k in ("prompts", "comp_map", "channel_mask") if k in batch}
    if emb is not None:
        out["embeddings"] = emb.index_select(
            0, torch.as_tensor(batch["indices"], dtype=torch.long).to(dev))
    else:
        out["image"] = torch.as_tensor(batch["image"]).to(dev)
    return out


def _counts():
    from dilabhelmholtzoct_tpu_torch.ops import attention as attn
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    return {**attn.LAUNCHES, **up_op.LAUNCHES, **i2t.LAUNCHES}


def _reset_counts():
    from dilabhelmholtzoct_tpu_torch.ops import attention as attn
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    for mod in (attn, up_op, i2t):
        mod.reset_launch_counts()


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


STEP_LAUNCHES = {"attn_global": 0, "attn_windowed": 0, "attn_bwd_dq": 0,
                 "attn_bwd_dkv": 0, "attn_relpos": 0, "attn_windowed_image": 0,
                 "upscale_fwd": 1, "upscale_bwd": 1, "upscale_bwd_dw": 1,
                 "i2t_fwd": 2, "i2t_bwd": 2, "i2t_bwd_dw": 2}


def training_phase(torch):
    """The training main path at full ViT-B width in bf16; returns the K3/K4
    launch counts of its 10 cached-embedding steps."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    train_items = synthetic.oct_training_items(16, seed=1)
    valid_items = synthetic.oct_training_items(8, seed=2)
    config = tr.TrainConfig(evaluate=False, batch_size=8)  # bf16, lr 1e-3
    orig_hw = (496, 512)
    ds = PromptedDataset(train_items, seed=0)

    def fresh(device):
        sd = {k: v.to(device) for k, v in sd_host.items()}
        decoder, frozen = tr._split_params(sd)
        for v in decoder.values():
            v.requires_grad_(True)
        return sd, decoder, frozen, tr.make_optimizer(config,
                                                      decoder.values())

    sd, decoder, frozen, opt = fresh(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # --- training main path starts
    t0 = time.perf_counter()
    emb = tr.precompute_embeddings(sd, cfg, ds, dtype=torch.bfloat16)
    pre_s = time.perf_counter() - t0
    c = _counts()
    check(c["attn_global"] == 4 * len(ds) and c["attn_windowed"] == 8 * len(ds),
          f"precompute of {len(ds)} images must launch K1 x4 and K2 x8 per "
          f"image, got {c}")
    check(emb.shape == (16, 64, 64, 256) and emb.dtype == torch.bfloat16
          and bool(torch.isfinite(emb.float()).all()), "bad embeddings")
    batch = list(batches(ds, 8, with_images=False, num_workers=2))[0]
    check(batch["channel_mask"].shape == (8, 8)
          and batch["channel_mask"].min() == 1, "the batch is not 8 x bucket 8")
    db = _device_batch(torch, batch, dev, emb)
    step = tr.make_train_step(cfg, config, opt, orig_hw, True)
    losses, times = [], []
    _reset_counts()
    for i in range(10):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoder, opt, loss = step(decoder, opt, frozen, db)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        d = _delta(_counts(), before)
        check(d == STEP_LAUNCHES, f"step {i} launched {d}, want {STEP_LAUNCHES}")
        losses.append(float(loss))
    step_launches = {k: v for k, v in _counts().items()
                     if not k.startswith("attn")}  # --- main path ends
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    med = statistics.median(times[1:])
    print(f"training ViT-B bf16, 8 images x bucket 8 (64 pairs): precompute "
          f"{pre_s:.2f} s for {len(ds)} images ({pre_s / len(ds) * 1e3:.1f} "
          f"ms/image incl. first use), losses {[round(x, 4) for x in losses]}")
    print(f"training step ms: first {times[0]:.1f}, median of steps 2-10 "
          f"{med:.2f} ({8e3 / med:.1f} img/s), all "
          f"{[round(t, 1) for t in times]}; max_memory_allocated "
          f"{peak / 2**20:.1f} MiB")

    # the encoder inside the step (cache_embeddings=False), B = 2
    b2 = list(batches(ds, 2, with_images=True, num_workers=2))[0]
    step_nc = tr.make_train_step(cfg, config, opt, orig_hw, False)
    before = _counts()
    decoder, opt, loss = step_nc(decoder, opt, frozen,
                                 _device_batch(torch, b2, dev))
    torch.cuda.synchronize()
    d = _delta(_counts(), before)
    want = {**STEP_LAUNCHES, "attn_global": 8, "attn_windowed": 16}
    check(d == want, f"encoder-in-step launched {d}, want {want}")
    check(bool(np.isfinite(float(loss))), "encoder-in-step loss not finite")
    print(f"encoder-in-step (B=2) loss {float(loss):.4f}, launches {d}")

    card_vs_cpu(torch, tr, cfg, config, sd_host, fresh, ds, emb, orig_hw)
    del sd, decoder, frozen, opt, emb, db
    torch.cuda.empty_cache()
    epoch_loop(torch, tr, config, sd_host, train_items, valid_items)
    return step_launches


F32_FUSED_STEPS = 8  # steps of each route in the f32 fused decoder phase


def decoder_f32_fused_phase(torch):
    """f32 decoder fine-tuning on the fused route: ViT-B (full width, the
    decoder's 256 channels and 8 heads), ``compute_dtype='float32'``,
    ``trainable='decoder'``, cached embeddings of 8 images x bucket 8 (64
    pairs per step) through ``make_train_step``, under
    ``set_fused_i2t('on')`` and ``set_fused_upscaler('interpret')``: each
    step launches the f32 K4 twice and K3 once (forward, row pass and
    weight pass each) and nothing else, the loss falls; the same steps from
    the same weights under 'auto' (the unfused f32 chain, no K3 / K4) give
    the median step beside it, and the two first-step losses agree within
    ``F32_STEP_LOSS_RTOL``. Both switches are back at 'auto' on exit.
    Returns the fused run's K3 / K4 launch counts."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models import sam as psam
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    config = tr.TrainConfig(evaluate=False, batch_size=8,
                            compute_dtype="float32")  # decoder, lr 1e-3
    ds = PromptedDataset(synthetic.oct_training_items(8, seed=1), seed=0)
    sd = {k: v.to(dev) for k, v in sd_host.items()}
    emb = tr.precompute_embeddings(sd, cfg, ds, dtype=torch.float32,
                                   verbose=False)
    del sd
    batch = list(batches(ds, 8, with_images=False, num_workers=2))[0]
    check(batch["channel_mask"].shape == (8, 8)
          and batch["channel_mask"].min() == 1, "the batch is not 8 x bucket 8")
    db = _device_batch(torch, batch, dev, emb)
    fused = {"upscale_fwd": 1, "upscale_bwd": 1, "upscale_bwd_dw": 1,
             "i2t_fwd": 2, "i2t_bwd": 2, "i2t_bwd_dw": 2}
    out = {}
    try:
        for route, modes in (("fused", ("on", "interpret")),
                             ("auto", ("auto", "auto"))):
            psam.set_fused_i2t(modes[0])
            psam.set_fused_upscaler(modes[1])
            sd = {k: v.to(dev, copy=True) for k, v in sd_host.items()}
            decoder, frozen = tr._split_params(sd)
            for v in decoder.values():
                v.requires_grad_(True)
            opt = tr.make_optimizer(config, decoder.values())
            step = tr.make_train_step(cfg, config, opt, (496, 512), True)
            want = {k: (v if route == "fused" else 0)
                    for k, v in STEP_LAUNCHES.items()
                    if not k.startswith("attn")}
            losses, times = [], []
            torch.cuda.synchronize()
            _reset_counts()  # --- main path starts
            for i in range(F32_FUSED_STEPS):
                before = _counts()
                t0 = time.perf_counter()
                decoder, opt, loss = step(decoder, opt, frozen, db)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                d = _delta(_counts(), before)
                check(d == {**dict.fromkeys(d, 0), **want},
                      f"f32 {route} step {i} launched {d}, want {want}")
                losses.append(float(loss))
            launches = {k: v for k, v in _counts().items()
                        if k in fused}  # --- main path ends
            check(all(np.isfinite(losses)), f"f32 {route}: losses {losses}")
            check(losses[-1] < losses[0],
                  f"f32 {route}: the loss did not fall: {losses}")
            med = statistics.median(times[1:])
            out[route] = (losses, med, launches)
            print(f"f32 decoder fine-tune ViT-B, 8 images x bucket 8 (64 "
                  f"pairs), route {route} (set_fused_i2t({modes[0]!r}), "
                  f"set_fused_upscaler({modes[1]!r})): losses "
                  f"{[round(x, 6) for x in losses]}; step ms first "
                  f"{times[0]:.1f}, median of steps 2-{F32_FUSED_STEPS} "
                  f"{med:.2f} ({8e3 / med:.1f} img/s), all "
                  f"{[round(t, 1) for t in times]}; launches {launches}")
            del sd, decoder, frozen, opt, step
            torch.cuda.empty_cache()
    finally:
        psam.set_fused_i2t("auto")
        psam.set_fused_upscaler("auto")
    l_fused, l_auto = out["fused"][0][0], out["auto"][0][0]
    rel = abs(l_fused - l_auto) / abs(l_auto)
    print(f"f32 decoder step, fused route against 'auto': first-step loss "
          f"{l_fused:.8f} vs {l_auto:.8f} (rel {rel:.3g}, rtol "
          f"{F32_STEP_LOSS_RTOL}); median step {out['fused'][1]:.2f} vs "
          f"{out['auto'][1]:.2f} ms")
    check(rel <= F32_STEP_LOSS_RTOL,
          "the f32 fused and unfused decoder steps' losses differ")
    check(out["fused"][2] == {k: F32_FUSED_STEPS * v
                              for k, v in fused.items()},
          f"fused launches {out['fused'][2]}")
    return out["fused"][2]


def card_vs_cpu(torch, tr, cfg, config, sd_host, fresh, ds, emb, orig_hw):
    """One first step on 1 image x bucket 8, on the card and on the host,
    from the same weights and embeddings."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import batches

    b1 = list(batches(ds, 1, with_images=False, num_workers=1))[0]
    out = {}
    for name, device in (("card", torch.device("cuda")),
                         ("cpu", torch.device("cpu"))):
        _, decoder, frozen, opt = fresh(device)
        before = {k: v.detach().clone() for k, v in decoder.items()}
        step = tr.make_train_step(cfg, config, opt, orig_hw, True)
        db = _device_batch(torch, b1, device, emb.to(device))
        decoder, opt, loss = step(decoder, opt, frozen, db)
        out[name] = (float(loss), {k: (v.detach() - before[k]).cpu()
                                   for k, v in decoder.items()})
    (l_card, d_card), (l_cpu, d_cpu) = out["card"], out["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    agree = total = 0
    for k, dc in d_cpu.items():
        moved = dc.abs() > 1e-3 * config.learning_rate
        agree += int((torch.sign(dc) == torch.sign(d_card[k]))[moved].sum())
        total += int(moved.sum())
    share = agree / max(total, 1)
    print(f"card vs cpu, first bf16 step on 1 image x bucket 8: loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (rel {rel:.3g}, rtol "
          f"{STEP_LOSS_RTOL}); update signs agree on {share:.4f} of {total} "
          f"moved weights (min {SIGN_AGREE_MIN})")
    check(rel <= STEP_LOSS_RTOL, "card and CPU step losses differ")
    check(share >= SIGN_AGREE_MIN, "card and CPU updates disagree in sign")


def epoch_loop(torch, tr, config, sd_host, train_items, valid_items):
    """training(config, splits=...): 2 epochs, then resumed to 3."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(sd_host, ckpt)
        cfg_loop = dataclasses.replace(
            config, checkpoint=os.path.join(tmp, "ck"), epochs=2,
            ckpt_keep=1, pretrained_checkpoint=ckpt, display_name="smoke",
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        splits = (train_items, valid_items)
        t0 = time.perf_counter()
        r1 = tr.training(cfg_loop, splits=splits)
        r2 = tr.training(dataclasses.replace(cfg_loop, epochs=3, resume=True),
                         splits=splits)
        hist = r1["history"] + r2["history"]
        check([h["epoch"] for h in hist] == [0, 1, 2],
              f"epochs run: {[h['epoch'] for h in hist]}")
        check(all(np.isfinite([h["train_loss"] for h in hist]))
              and all(np.isfinite([h["valid_loss"] for h in hist])),
              "non-finite epoch losses")
        steps = sorted(d for d in os.listdir(r2["checkpoint_dir"])
                       if d.startswith("step_"))
        check(steps == ["step_2"], f"checkpoints left: {steps}")
        runs = [(h["epoch"], round(h["train_loss"], 4),
                 round(h["valid_loss"], 4)) for h in hist]
        print(f"epoch loop (epoch, train, valid): {runs} in "
              f"{time.perf_counter() - t0:.1f} s; checkpoints {steps}")


def k5_bound_ms(kind, b, n, heads, hw, itemsize, peak):
    """Least time for one call of a K5 kernel: its products (the dq kernel
    s, dp and dq, 3 x 2*N^2*64 per head; the dk/dv kernel s, dp, dv and dk,
    4 x) over the type's peak, against its bytes (qkv, dO and both bias
    factors read once, L and D in f32; the dq kernel writes dq and both
    drel, the dk/dv kernel dk and dv) over 3.35 TB/s."""
    c, rel = heads * 64, heads * (hw[0] + hw[1])
    flops = (3 if kind == "dq" else 4) * 2.0 * b * heads * n * n * 64
    nbytes = (itemsize * b * n * (4 * c + rel) + 4 * 2 * b * heads * n
              + itemsize * b * n * (c + rel if kind == "dq" else 2 * c))
    return _bound(flops, nbytes, peak)


def _attn_inputs(torch, gen, b, heads, hw, dtype):
    n, dev = hw[0] * hw[1], torch.device("cuda")

    def rnd(*shape, k=1.0):
        return (k * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    return (rnd(b, n, 3 * heads * 64, k=0.5), rnd(b, heads, n, hw[0], k=0.3),
            rnd(b, heads, n, hw[1], k=0.3), rnd(b, n, heads * 64))


def k5_kernel_phase(torch, attn):
    """K5 (and the logsumexp rows K1 / K2 write for it) against the plain
    versions at ViT-B shapes — global B = 1 (the plain (N, N) intermediates
    at B = 4 are ~13 GB) and 25 windows, 12 heads — in f32 and bf16; then
    each K5 kernel timed with CUDA events at the training shapes (global
    B = 4, 100 windows) beside the bound, the plain version and the
    backward of ``scaled_dot_product_attention`` with a materialised bias
    that requires grad. Returns the result-line rows of the global layer:
    bf16 under the kernels' names (the full fine-tune path), f32 (split TF32
    on the tensor cores) as ``attn_bwd_dq_f32`` / ``attn_bwd_dkv_f32``."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(3)
    heads, rows = 12, {}
    src = "dilabhelmholtzoct_tpu_torch/csrc/attention_bwd.cu"
    replaces = {"dq": "dilabhelmholtzoct_tpu/ops/attention.py:1096",
                "dkv": "dilabhelmholtzoct_tpu/ops/attention.py:1147"}
    for kind, b_chk, b_time, hw in (("global", 1, 4, (64, 64)),
                                    ("windowed", 25, 100, (14, 14))):
        fwd = "attn_global" if kind == "global" else "attn_windowed"
        kw = dict(hw=hw, num_heads=heads)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            tname = "f32" if f32 else "bf16"
            # both types on the tensor cores, f32 in split TF32
            peak = PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS
            with full_fp32():
                qkv, rel_h, rel_w, g = _attn_inputs(torch, gen, b_chk, heads,
                                                    hw, dtype)
                before = dict(attn.LAUNCHES)
                out, lse = attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                                   return_lse=True, **kw)
                dvec = attn.bwd_dvec(g, out, heads)
                got = attn.attention_bwd_cuda(qkv, rel_h, rel_w, g, lse, dvec,
                                              **kw)
                torch.cuda.synchronize()
                d = _delta(attn.LAUNCHES, before)
                want_d = {k: int(k in (fwd, "attn_bwd_dq", "attn_bwd_dkv"))
                          for k in d}
                check(d == want_d, f"K5 {kind} {tname} launched {d}")
                _, want_lse = attn.packed_attention_plain(
                    qkv, rel_h, rel_w, return_lse=True, **kw)
                lse_abs, lse_rel = _check_outputs(torch, f"{fwd} lse", tname,
                                                  lse, want_lse)
                want = attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g,
                                                       lse, dvec, **kw)
                err, rel = _check_outputs(torch, f"attn_bwd {kind}", tname,
                                          got, want)
                # no atomics, a fixed summation order: the same bits again
                again = attn.attention_bwd_cuda(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
                check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                      f"attn_bwd {kind} {tname}: a second run differs")
                print(f"kernel attn_bwd {kind} {tname} B={b_chk}: dqkv/drel "
                      f"max_abs_err={err:.3g} max_rel_err={rel:.3g} (limit "
                      f"{K34_TOL[tname]}), the same bits on a second run; "
                      f"{fwd} lse max_abs_err={lse_abs:.3g} rel={lse_rel:.3g}")
                del again
                del qkv, rel_h, rel_w, g, out, lse, dvec, got, want, want_lse
                torch.cuda.empty_cache()

                # timing at the training shape
                qkv, rel_h, rel_w, g = _attn_inputs(torch, gen, b_time, heads,
                                                    hw, dtype)
                out, lse = attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                                   return_lse=True, **kw)
                dvec = attn.bwd_dvec(g, out, heads)
                dqkv = torch.empty_like(qkv)
                args = (qkv, rel_h, rel_w, g, lse, dvec, dqkv)
                iters = 5 if kind == "global" else 20
                ms = {"dq": cuda_ms(lambda: attn.attention_bwd_dq_cuda(
                          *args, **kw), iters),
                      "dkv": cuda_ms(lambda: attn.attention_bwd_dkv_cuda(
                          *args, **kw), iters)}
                plain_ms = cuda_ms(lambda: attn.packed_attention_bwd_plain(
                    *args[:6], **kw), 2)
                lib_ms = _sdpa_bwd_ms(torch, qkv, rel_h, rel_w, g, hw, heads)
            for k in ("dq", "dkv"):
                bound, bound_by = k5_bound_ms(k, b_time, hw[0] * hw[1], heads,
                                              hw, qkv.element_size(), peak)
                row = {"name": f"attn_bwd_{k}" + ("_f32" if f32 else ""),
                       "route": "cuda", "source": src,
                       "replaces": replaces[k], "max_abs_err": err,
                       "ms": ms[k], "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": lib_ms}
                print(f"kernel attn_bwd_{k} {kind} {tname} B={b_time}: "
                      f"ms={ms[k]:.4f} bound_ms={bound:.4f} ({bound_by}"
                      f"{', split TF32' if f32 else ''}) "
                      f"share_of_bound={bound / ms[k]:.4f}; both kernels "
                      f"{ms['dq'] + ms['dkv']:.4f} ms, plain_ms (both) "
                      f"{plain_ms:.4f}, library_ms (SDPA backward with a "
                      f"bias gradient) {lib_ms:.4f}"
                      + _cuda_core_bound(row, ms[k], f32, k5_bound_ms(
                          k, b_time, hw[0] * hw[1], heads, hw,
                          qkv.element_size(), PEAK_F32_FLOPS)))
                if kind == "global":
                    rows[row["name"]] = row
            del qkv, rel_h, rel_w, g, out, lse, dvec, dqkv, args
            torch.cuda.empty_cache()
    return rows


def _sdpa_bwd_ms(torch, qkv, rel_h, rel_w, g, hw, heads):
    """The library yardstick of K5: the backward alone of one
    ``scaled_dot_product_attention`` call with the bias materialised and
    requiring grad. It computes more than K5: the full (N, N) bias
    gradient, where K5 sums it into drel_h / drel_w."""
    b, n, _ = qkv.shape
    x = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
    q, k, v = (x[i].detach().clone().requires_grad_(True) for i in range(3))
    bias = (rel_h.reshape(b, heads, n, hw[0], 1)
            + rel_w.reshape(b, heads, n, 1, hw[1])).reshape(b, heads, n, n)
    bias.requires_grad_(True)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=bias)
    go = g.view(b, n, heads, 64).transpose(1, 2)
    ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, bias), go,
                                             retain_graph=True), 3)
    del q, k, v, bias, out
    return ms


def ft_launches(cfg, compute_dtype="bfloat16"):
    """Launches of one full fine-tune step: K1 / K2 once in the forward and
    once more in the checkpointed layers' recompute, K5's two kernels once
    per layer, and in bf16 the decoder's K3 x1 and K4 x2 forward and
    backward (in f32 the decoder takes its plain route, as in JAX)."""
    v = cfg.vision
    n_glob = len(v.global_attn_indexes)
    decoder = (STEP_LAUNCHES if compute_dtype == "bfloat16" else
               dict.fromkeys(STEP_LAUNCHES, 0))
    return {**decoder, "attn_global": 2 * n_glob,
            "attn_windowed": 2 * (v.num_layers - n_glob),
            "attn_bwd_dq": v.num_layers, "attn_bwd_dkv": v.num_layers}


def _full_params(torch, tr, config, sd_host, device):
    # copies, also on the host: the step updates its tensors in place
    sd = {k: v.to(device, copy=True) for k, v in sd_host.items()}
    params, frozen = tr._split_params(sd, "all")
    for v in params.values():
        v.requires_grad_(True)
    return params, frozen, tr.make_optimizer(config, params.values())


def full_finetune_run(torch, tr, cfg, sd_host, items, bs, n_steps, label,
                      compute_dtype="bfloat16"):
    """``n_steps`` full fine-tune steps (trainable='all', encoder inside) on
    one batch of ``bs`` images in ``compute_dtype``; checks every step's
    launch deltas, a finite loss and a moved patch embedding. Returns
    (launch counts of the run, losses)."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)

    dev = torch.device("cuda")
    config = tr.TrainConfig(evaluate=False, batch_size=bs, trainable="all",
                            cache_embeddings=False,
                            compute_dtype=compute_dtype)  # lr 1e-3
    tname = "bf16" if compute_dtype == "bfloat16" else "f32"
    batch = list(batches(PromptedDataset(items, seed=0), bs, with_images=True,
                         num_workers=2))[0]
    check(batch["channel_mask"].shape == (bs, 8)
          and batch["channel_mask"].min() == 1, f"the batch is not {bs} x "
                                                "bucket 8")
    db = _device_batch(torch, batch, dev)
    params, frozen, opt = _full_params(torch, tr, config, sd_host, dev)
    step = tr.make_train_step(cfg, config, opt, (496, 512), False)
    want = ft_launches(cfg, compute_dtype)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # --- main path starts
    for i in range(n_steps):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, frozen, db)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        d = _delta(_counts(), before)
        check(d == want, f"{label} step {i} launched {d}, want {want}")
        losses.append(float(loss))
    launches = _counts()  # --- main path ends
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    k = "vision_encoder.patch_embed.projection.weight"
    moved = float((params[k].detach().cpu() - sd_host[k]).abs().max())
    check(moved > 0, f"{label}: the patch embedding did not move")
    med = statistics.median(times[1:])
    print(f"full fine-tune {label} {tname}, {bs} images x bucket 8: losses "
          f"{[round(x, 4) for x in losses]}; patch embedding moved by up to "
          f"{moved:.3g}; launches per step {want}")
    print(f"full fine-tune {label} {tname} step ms: first {times[0]:.1f}, "
          f"median of "
          f"steps 2-{n_steps} {med:.2f} ({bs * 1e3 / med:.2f} img/s), all "
          f"{[round(t, 1) for t in times]}; max_memory_allocated "
          f"{peak / 2**20:.1f} MiB")
    del params, frozen, opt, db
    torch.cuda.empty_cache()
    return launches, losses


def finetune_phase(torch):
    """The full fine-tune main path (BASELINE config 5 geometry): ViT-B at
    bs 4 for 10 steps, then ViT-L at bs 2 for 3 steps, the card against the
    CPU, and the epoch loop. Returns the ViT-B run's launch counts."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import (sam_vit_base,
                                                            sam_vit_large)
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    items = synthetic.oct_training_items(4, seed=3)
    launches, losses = full_finetune_run(torch, tr, cfg, sd_host, items, 4,
                                         10, "ViT-B")
    check(losses[-1] < losses[0], f"ViT-B: the loss did not fall: {losses}")
    cfg_l = sam_vit_large()
    full_finetune_run(torch, tr, cfg_l, synthetic.random_params(cfg_l, seed=0),
                      items[:2], 2, 3, "ViT-L")
    finetune_card_vs_cpu(torch, tr, cfg)
    finetune_epoch_loop(torch, tr, sd_host)
    return launches


def finetune_f32_phase(torch):
    """The f32 full fine-tune (``compute_dtype='float32'``, a training
    configuration of the JAX package): ViT-B at bs 4 for 5 steps on one
    batch, each step K1 x8, K2 x16 and K5's two kernels x12 in f32 (split
    TF32 on the tensor cores) and no K3 / K4; then the card
    against the CPU at the 2-layer cut. Returns the run's launch counts."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    items = synthetic.oct_training_items(4, seed=3)
    launches, losses = full_finetune_run(torch, tr, cfg, sd_host, items, 4, 5,
                                         "ViT-B", "float32")
    check(losses[-1] < losses[0], f"ViT-B f32: the loss did not fall: "
                                  f"{losses}")
    finetune_card_vs_cpu(torch, tr, cfg, "float32")
    return launches


def finetune_card_vs_cpu(torch, tr, cfg, compute_dtype="bfloat16"):
    """The first full fine-tune step on 1 image, at ViT-B width with the
    depth cut to 2 layers (one windowed, one global) so that the host can
    run it, on the card and on the CPU from the same weights, in
    ``compute_dtype``."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic

    cfg2 = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, num_layers=2, global_attn_indexes=(1,)))
    sd_host = synthetic.random_params(cfg2, seed=1)
    config = tr.TrainConfig(evaluate=False, batch_size=1, trainable="all",
                            cache_embeddings=False,
                            compute_dtype=compute_dtype)
    tname = "bf16" if compute_dtype == "bfloat16" else "f32"
    rtol = STEP_LOSS_RTOL if compute_dtype == "bfloat16" else F32_STEP_LOSS_RTOL
    b1 = list(batches(PromptedDataset(synthetic.oct_training_items(1, seed=5),
                                      seed=0), 1, with_images=True,
                      num_workers=1))[0]
    out = {}
    for name, device in (("card", torch.device("cuda")),
                         ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        params, frozen, opt = _full_params(torch, tr, config, sd_host, device)
        step = tr.make_train_step(cfg2, config, opt, (496, 512), False)
        params, opt, loss = step(params, opt, frozen,
                                 _device_batch(torch, b1, device))
        out[name] = (float(loss), {k: (v.detach().cpu() - sd_host[k])
                                   for k, v in params.items()})
        print(f"full fine-tune first step on the {name}: "
              f"{time.perf_counter() - t0:.1f} s")
    (l_card, d_card), (l_cpu, d_cpu) = out["card"], out["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    agree = total = 0
    for k, dc in d_cpu.items():
        moved = dc.abs() > 1e-3 * config.learning_rate
        agree += int((torch.sign(dc) == torch.sign(d_card[k]))[moved].sum())
        total += int(moved.sum())
    share = agree / max(total, 1)
    print(f"card vs cpu, first full fine-tune {tname} step on 1 image x "
          f"bucket 8, ViT-B width, depth cut to 2 layers (layer 0 windowed, "
          f"layer 1 global) of 12: loss {l_card:.8f} vs {l_cpu:.8f} (rel "
          f"{rel:.3g}, rtol {rtol}); update signs agree on {share:.4f} of "
          f"{total} moved weights over all parameters (min {SIGN_AGREE_MIN})")
    check(rel <= rtol, f"card and CPU full fine-tune {tname} losses differ")
    check(share >= SIGN_AGREE_MIN, "card and CPU full fine-tune updates "
                                   "disagree in sign")


def finetune_epoch_loop(torch, tr, sd_host):
    """training(trainable='all') at ViT-B for 1 epoch of 2 steps."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(sd_host, ckpt)
        config = tr.TrainConfig(
            evaluate=False, trainable="all", cache_embeddings=False,
            batch_size=2, epochs=1, ckpt_keep=1, pretrained_checkpoint=ckpt,
            checkpoint=os.path.join(tmp, "ck"), display_name="smoke_all",
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        t0 = time.perf_counter()
        r = tr.training(config, splits=(synthetic.oct_training_items(4, 6),
                                        synthetic.oct_training_items(2, 7)))
        hist = r["history"]
        check([h["epoch"] for h in hist] == [0], f"epochs run: {hist}")
        losses = [hist[0]["train_loss"], hist[0]["valid_loss"]]
        check(np.isfinite(losses).all(),
              "non-finite full fine-tune epoch losses")
        steps = sorted(d for d in os.listdir(r["checkpoint_dir"])
                       if d.startswith("step_"))
        check(steps == ["step_0"], f"checkpoints left: {steps}")
        print(f"full fine-tune epoch loop: train {hist[0]['train_loss']:.4f}, "
              f"valid {hist[0]['valid_loss']:.4f} in "
              f"{time.perf_counter() - t0:.1f} s; checkpoints {steps}")


def k6_kernel_phase(torch, attn):
    """K6 against its plain version at ViT-H shapes, at the test-size
    model's and at head dims whose rows the kernels pad (20: padded to 24
    in f32, to 32 in bf16 with 8-byte copies; 48), f32 and bf16, and the
    same bits on a second run, timed beside its bound, the plain version
    and SDPA; returns the result-line rows of the ViT-H global and windowed
    layers: f32 (serving's type) and bf16 (the precompute's)."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [("ViT-H global", 1, (64, 64), 16, 80),
             ("ViT-H windowed", 25, (14, 14), 16, 80),
             ("tiny global", 2, (8, 8), 4, 16),
             ("tiny windowed", 8, (4, 4), 4, 16),
             ("d=20 global", 1, (64, 64), 8, 20),
             ("d=48 windowed", 25, (14, 14), 8, 48)]
    rows = {}
    for label, b, hw, heads, d in cases:
        n = hw[0] * hw[1]
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            tname = "f32" if f32 else "bf16"
            qkv = (0.5 * torch.randn((b, n, 3 * heads * d), generator=gen,
                                     device=dev)).to(dtype)
            rel_h = (0.3 * torch.randn((b, heads, n, hw[0]), generator=gen,
                                       device=dev)).to(dtype)
            rel_w = (0.3 * torch.randn((b, heads, n, hw[1]), generator=gen,
                                       device=dev)).to(dtype)
            args, kw = (qkv, rel_h, rel_w), dict(hw=hw, num_heads=heads)
            with full_fp32():
                before = dict(attn.LAUNCHES)
                out = attn.flash_attention_packed(*args, **kw)
                torch.cuda.synchronize()
                check(_delta(attn.LAUNCHES, before)
                      == {**dict.fromkeys(before, 0), "attn_relpos": 1},
                      f"attn_relpos {label}: launched "
                      f"{_delta(attn.LAUNCHES, before)}")
                ref = attn.relpos_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = kernel_tol(ref)
                check(out.dtype == dtype and out.shape == (b, n, heads * d)
                      and bool(torch.isfinite(out).all()),
                      f"attn_relpos {label} {tname}: bad output")
                check(err <= tol, f"attn_relpos {label} {tname}: max |kernel "
                                  f"- plain| {err:.3g} > {tol:.3g}")
                check(torch.equal(out, attn.flash_attention_packed(*args, **kw)),
                      f"attn_relpos {label} {tname}: a second run gave other "
                      "bits")
                iters = 20 if n > 1000 else 50
                ms = cuda_ms(lambda: attn.flash_attention_packed(*args, **kw),
                             iters)
                plain_ms = cuda_ms(
                    lambda: attn.relpos_attention_plain(*args, **kw), 5)
                lib_ms = _sdpa_ms(torch, qkv, rel_h, rel_w, hw, heads)
            # the f32 kernel runs on the tensor cores in split TF32
            bound, bound_by = attention_bound_ms(
                b, n, heads, hw, qkv.element_size(),
                PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS, d=d)
            # the result line's rows: the ViT-H global and windowed layers
            key = ("attn_relpos" + ("_windowed" if b > 1 else "")
                   + ("" if f32 else "_bf16")) if label.startswith("ViT-H") \
                else None
            row = {"name": key, "route": "cuda",
                   "source": "dilabhelmholtzoct_tpu_torch/csrc/"
                             "attention_relpos.cu",
                   "replaces": "dilabhelmholtzoct_tpu/ops/attention.py:132",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": lib_ms}
            print(f"kernel attn_relpos {label} {tname} B={b} N={n} "
                  f"heads={heads} d={d}: max_abs_err={err:.3g} (limit "
                  f"{tol:.3g}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.4f} ({bound_by}"
                  f"{', split TF32' if f32 else ''}) "
                  f"share_of_bound={bound / ms:.3f}"
                  + _cuda_core_bound(row, ms, f32, attention_bound_ms(
                      b, n, heads, hw, qkv.element_size(), PEAK_F32_FLOPS,
                      d=d)))
            if key is not None:
                rows[key] = row
            del qkv, rel_h, rel_w, out, ref, args
        torch.cuda.empty_cache()
    return rows


def k7_kernel_phase(torch, attn):
    """K7 against its plain version and against K2 on the partitioned
    windows (bit for bit) at ViT-B and on a ragged grid, f32 and bf16,
    timed beside K2's bound; then one ViT-B layer's windowed attention
    through both routes. Returns the result-line row (ViT-B, f32)."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models import sam
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    heads, ws, c = 12, 14, 768
    row = None
    for label, b, hw in (("ViT-B", 1, (64, 64)), ("ragged", 2, (28, 20))):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            tname = "f32" if f32 else "bf16"
            qkv = (0.5 * torch.randn((b, *hw, 3 * c), generator=gen,
                                     device=dev)).to(dtype)
            rel = (0.3 * torch.randn((b, heads, *hw, 2 * ws), generator=gen,
                                     device=dev)).to(dtype)
            bias = (0.5 * torch.randn((3 * c,), generator=gen,
                                      device=dev)).to(dtype)
            kw = dict(ws=ws, num_heads=heads)
            with full_fp32():
                before = dict(attn.LAUNCHES)
                out = attn.flash_attention_windowed_image(qkv, rel, bias, **kw)
                torch.cuda.synchronize()
                check(_delta(attn.LAUNCHES, before)
                      == {**dict.fromkeys(before, 0), "attn_windowed_image": 1},
                      f"attn_windowed_image {label}: launched "
                      f"{_delta(attn.LAUNCHES, before)}")
                ref = attn.windowed_image_attention_plain(qkv, rel, bias, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                tol = kernel_tol(ref)
                check(out.dtype == dtype and out.shape == (b, *hw, c)
                      and bool(torch.isfinite(out).all()),
                      f"attn_windowed_image {label} {tname}: bad output")
                check(err <= tol, f"attn_windowed_image {label} {tname}: max "
                                  f"|kernel - plain| {err:.3g} > {tol:.3g}")
                win, r_h, r_w, padded = attn.partition_image_operands(
                    qkv, rel, bias, ws)
                k2 = attn.window_unpartition(
                    attn.attention_fwd_cuda(win, r_h, r_w, hw=(ws, ws),
                                            num_heads=heads).reshape(
                                                -1, ws, ws, c), ws, padded, hw)
                check(bool(torch.equal(out, k2)),
                      f"attn_windowed_image {label} {tname} is not bit-equal "
                      f"to K2 on the partitioned windows")
                ms = cuda_ms(lambda: attn.flash_attention_windowed_image(
                    qkv, rel, bias, **kw), 50)
                plain_ms = cuda_ms(
                    lambda: attn.windowed_image_attention_plain(
                        qkv, rel, bias, **kw), 5)
                k2_ms = cuda_ms(lambda: attn.attention_fwd_cuda(
                    win, r_h, r_w, hw=(ws, ws), num_heads=heads), 50)
                lib_ms = _sdpa_ms(torch, win, r_h, r_w, (ws, ws), heads)
            # both types on the tensor cores, f32 in split TF32
            bound, bound_by = attention_bound_ms(
                win.shape[0], ws * ws, heads, (ws, ws), qkv.element_size(),
                PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS)
            k7_row = {"name": "attn_windowed_image", "route": "cuda",
                      "source": "dilabhelmholtzoct_tpu_torch/csrc/"
                                "attention_winimg.cu",
                      "replaces": "dilabhelmholtzoct_tpu/ops/attention.py:633",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib_ms}
            print(f"kernel attn_windowed_image {label} {tname} B={b} "
                  f"grid={hw} heads={heads} ({win.shape[0]} windows): "
                  f"max_abs_err={err:.3g} (limit {tol:.3g}) bit-equal to K2; "
                  f"ms={ms:.4f} "
                  f"K2_on_partitioned_windows_ms={k2_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms (SDPA on the "
                  f"partitioned windows, partition not counted)="
                  f"{lib_ms:.4f} bound_ms={bound:.4f} ({bound_by}"
                  f"{', split TF32' if f32 else ''}) "
                  f"share_of_bound={bound / ms:.3f}"
                  + _cuda_core_bound(k7_row, ms, f32, attention_bound_ms(
                      win.shape[0], ws * ws, heads, (ws, ws),
                      qkv.element_size(), PEAK_F32_FLOPS)))
            if label == "ViT-B" and f32:
                row = k7_row
            del qkv, rel, bias, out, ref, win, r_h, r_w, k2
        torch.cuda.empty_cache()

    # one ViT-B layer's windowed attention, both routes on the same input
    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    pf = "vision_encoder.layers.0.attn"
    for dtype in (torch.float32, torch.bfloat16):
        tname = "f32" if dtype == torch.float32 else "bf16"
        sd = {k: v.to(dev) for k, v in sd_host.items() if k.startswith(pf)}
        x = torch.randn((1, 64, 64, c), generator=gen, device=dev).to(dtype)

        def fused():
            return sam._windowed_attention_image(x, sd, pf, cfg.vision, ws)

        def partitioned():
            win, padded = sam.window_partition(x, ws)
            return sam.window_unpartition(
                sam.vision_attention(win, sd, pf, cfg.vision), ws, padded,
                (64, 64))

        with torch.inference_mode(), full_fp32():
            before = dict(attn.LAUNCHES)
            a, p_ = fused(), partitioned()
            check(_delta(attn.LAUNCHES, before)
                  == {**dict.fromkeys(before, 0), "attn_windowed_image": 1,
                      "attn_windowed": 1}, "layer routes: wrong launches")
            err = (a.float() - p_.float()).abs().max().item()
            tol = kernel_tol(p_)
            check(err <= tol, f"layer routes {tname} differ by {err:.3g} "
                              f"(limit {tol:.3g})")
            t = {"image": [], "partitioned": []}
            for name, fn in (("partitioned", partitioned), ("image", fused),
                             ("image", fused), ("partitioned", partitioned)):
                t[name].append(cuda_ms(fn, 20))
        print(f"ViT-B windowed layer attention {tname} B=1 (LN output to "
              f"projected output): image-layout route (K7) "
              f"{min(t['image']):.4f} ms (both rounds "
              f"{[round(v, 4) for v in t['image']]}), partitioned route "
              f"(pad + partition + qkv + K2 + proj + un-partition) "
              f"{min(t['partitioned']):.4f} ms "
              f"({[round(v, 4) for v in t['partitioned']]}); max "
              f"|difference| {err:.3g} (limit {tol:.3g})")
        del sd, x
    torch.cuda.empty_cache()
    return {"attn_windowed_image": row}


def vith_serving_phase(torch, attn, sd):
    """Serving at full ViT-H; returns the launch counts of its three
    requests (K6 only)."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.inference.engine import SegmentationEngine
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_huge

    cfg = sam_vit_huge()
    engine = SegmentationEngine(sd, cfg)
    check(engine.device.type == "cuda", "engine is not on the card")
    img = synthetic.oct_image(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # --- main path starts
    t0 = time.perf_counter()
    bin_box, p_box = engine.segment(img, synthetic.BOX, "bbox")
    cold_ms = 1e3 * (time.perf_counter() - t0)
    after_encode = _counts()
    bin_pt, p_pt = engine.segment(img, synthetic.POINT, "points")
    bin_3, p_3 = engine.segment(img, synthetic.BOXES3, "bbox")
    launches = _counts()  # --- main path ends
    peak_bytes = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(launches, 0),
            "attn_relpos": cfg.vision.num_layers}
    check(after_encode == want, f"one ViT-H encode must launch K6 x32 and "
                                f"nothing else, got {after_encode}")
    check(launches == after_encode,
          f"a cached prompt launched kernels: {launches}")
    for b_, p_, n in ((bin_box, p_box, 1), (bin_pt, p_pt, 1), (bin_3, p_3, 3)):
        check(b_.shape == p_.shape == (n, 496, 512), f"shape {b_.shape}")
        check(b_.dtype == np.uint8 and set(np.unique(b_)) <= {0, 1},
              "masks are not 0/1 uint8")
        check(bool(np.isfinite(p_).all()) and p_.min() >= 0 and p_.max() <= 1,
              "probabilities are not finite in [0, 1]")
    cached = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.segment(img, synthetic.BOX, "bbox")
        cached.append(1e3 * (time.perf_counter() - t0))
    warm = []
    for seed in (1, 2, 3):  # new images: encode + decode past first use
        other = synthetic.oct_image(seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.segment(other, synthetic.BOX, "bbox")
        warm.append(1e3 * (time.perf_counter() - t0))
    print(f"serving ViT-H f32 (32 layers, 1280 wide, 16 heads of 80): "
          f"launches {launches}; cold encode+decode {cold_ms:.2f} ms, new "
          f"images after it {[round(w, 2) for w in warm]} ms, cached "
          f"prompt-to-mask median of 10 {statistics.median(cached):.2f} ms "
          f"(all {[round(c, 2) for c in cached]}), max_memory_allocated "
          f"{peak_bytes / 2**20:.1f} MiB")
    del engine
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cbin, cprob = SegmentationEngine(sd, cfg, device="cpu").segment(
        img, synthetic.BOX, "bbox")
    cpu_s = time.perf_counter() - t0
    diff = float(np.abs(cprob - p_box).max())
    near = np.abs(cprob - 0.5) <= PROB_ATOL
    mism = int((cbin != bin_box)[~near].sum())
    print(f"serving ViT-H vs cpu engine (box) at full depth (32 layers; the "
          f"CPU request took {cpu_s:.1f} s): max |p_card - p_cpu| = "
          f"{diff:.3g} (atol {PROB_ATOL}), mask pixels that differ away "
          f"from 0.5: {mism}, foreground share {bin_box.mean():.4f}")
    check(diff <= PROB_ATOL, f"ViT-H card probabilities differ from the CPU "
                             f"engine by {diff:.3g}")
    check(mism == 0, f"{mism} ViT-H mask pixels differ from the CPU engine")
    return launches


def fused_windowed_phase(torch, attn):
    """ViT-B serving under ``set_fused_windowed('on')`` against the default
    route; returns the launch counts of the ``'on'`` encode."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.inference.engine import SegmentationEngine
    from dilabhelmholtzoct_tpu_torch.models import sam
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.ops.preprocess import preprocess_image

    cfg = sam_vit_base()
    sd = synthetic.random_params(cfg, seed=0)
    img = synthetic.oct_image(seed=0)
    _, p_default = SegmentationEngine(sd, cfg).segment(img, synthetic.BOX)
    try:
        sam.set_fused_windowed("on")
        engine = SegmentationEngine(sd, cfg)
        _reset_counts()  # --- main path starts
        bin_on, p_on = engine.segment(img, synthetic.BOX, "bbox")
        launches = _counts()  # --- main path ends
        want = {**dict.fromkeys(launches, 0), "attn_global": 4,
                "attn_windowed_image": 8}
        check(launches == want, f"a ViT-B encode under 'on' must launch K1 "
                                f"x4, K7 x8 and K2 x0, got {launches}")
        diff = float(np.abs(p_on - p_default).max())
        check(p_on.shape == (1, 496, 512) and bool(np.isfinite(p_on).all()),
              "bad probabilities under 'on'")
        check(diff <= PROB_ATOL, f"probabilities under 'on' differ from the "
                                 f"default route's by {diff:.3g}")

        # both routes in f32 (serving) and in bf16 (the precompute's
        # encode, K2 / K7 on the tensor cores), timed in interleaved rounds
        x = torch.from_numpy(img[None]).to(engine.device)
        times = {(m, t): [] for m in ("auto", "on") for t in ("f32", "bf16")}
        with torch.inference_mode(), full_fp32():
            pix = {t: preprocess_image(x, target_size=cfg.vision.image_size,
                                       dtype=dt)[0]
                   for t, dt in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16))}
            emb = {}
            for mode, k2, k7 in (("auto", 8, 0), ("on", 0, 8)):
                sam.set_fused_windowed(mode)
                before = _counts()
                emb[mode] = sam.encode_image(engine.params, pix["bf16"], cfg)
                torch.cuda.synchronize()
                d = {k: v for k, v in _delta(_counts(), before).items() if v}
                want_bf = {"attn_global": 4, "attn_windowed": k2,
                           "attn_windowed_image": k7}
                check(d == {k: v for k, v in want_bf.items() if v},
                      f"a bf16 ViT-B encode under {mode!r} launched {d}")
            ref = emb["auto"].float()
            bf_rel = ((emb["on"].float() - ref).abs().max()
                      / ref.abs().max()).item()
            check(emb["on"].dtype == torch.bfloat16
                  and bool(torch.isfinite(emb["on"].float()).all())
                  and bf_rel <= K34_TOL["bf16"],
                  f"bf16 embeddings under 'on' differ from the default "
                  f"route's by {bf_rel:.3g} of their max")
            for mode in ("auto", "on", "on", "auto", "auto", "on"):
                sam.set_fused_windowed(mode)
                for t in ("f32", "bf16"):
                    times[(mode, t)].append(cuda_ms(
                        lambda: sam.encode_image(engine.params, pix[t], cfg),
                        10))
    finally:
        sam.set_fused_windowed("auto")
    print(f"serving ViT-B f32 under set_fused_windowed('on'): launches "
          f"{launches}; max |p_on - p_default| = {diff:.3g} (atol "
          f"{PROB_ATOL}); bf16 encode under 'on' vs default: max |difference| "
          f"/ max |default| = {bf_rel:.3g} (limit {K34_TOL['bf16']}: bf16 "
          f"roundings flip between two GEMM shapes and carry through 12 "
          f"layers)")
    for t in ("f32", "bf16"):
        print(f"ViT-B encode ms {t} (CUDA events, mean of 10, three rounds "
              f"each, interleaved): default route "
              f"{[round(v, 3) for v in times[('auto', t)]]}, 'on' route "
              f"{[round(v, 3) for v in times[('on', t)]]}")
    del engine
    torch.cuda.empty_cache()
    return launches


def _report_numbers(report):
    """Every number of an evaluation report, flattened to {path: value}."""
    out = {}
    for key, val in report.items():
        if key == "_global":
            for k, row in val.items():
                out.update({f"_global/{k}/{i}": x for i, x in enumerate(row)})
        elif key.startswith("_"):
            out.update({f"{key}/{k}": x for k, x in val.items()})
        else:
            for metric, d in val.items():
                out.update({f"{key}/{metric}/{k}": x for k, x in d.items()})
    return out


def _quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its printing kept off the output (the
    evaluation prints the reference's whole per-class report)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def evaluation_phase(torch, attn, sd_h):
    """The evaluation harness at full ViT-H on the card, at a depth cut on
    the card against the CPU, and as the tail of a short ViT-B training
    run."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import PromptedDataset
    from dilabhelmholtzoct_tpu_torch.eval.harness import evaluate_metrics
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_huge
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_huge()
    config = tr.TrainConfig(base_model="facebook/sam-vit-huge")
    items = synthetic.oct_training_items(8, seed=11)
    ds = PromptedDataset(items, seed=0)
    _reset_counts()  # --- main path starts
    t0 = time.perf_counter()
    report = _quiet(evaluate_metrics, sd_h, cfg, config, ds,
                    orig_hw=(496, 512))
    eval_s = time.perf_counter() - t0
    launches = _counts()  # --- main path ends
    want = {**dict.fromkeys(launches, 0),
            "attn_relpos": cfg.vision.num_layers * len(ds)}
    check(launches == want, f"evaluating {len(ds)} images at ViT-H must "
                            f"launch K6 x32 per image, got {launches}")
    nums = _report_numbers(report)
    check(all(np.isfinite(v) for v in nums.values()), "report not finite")
    check({str(c) for c in range(8)} <= set(report),
          f"classes in the report: {sorted(report)}")
    print(f"evaluation ViT-H f32, 8 images x 8 components on the card: "
          f"{eval_s:.1f} s, launches {launches}; mean IoU "
          f"{report['_means']['iou']:.4f}, mean Dice "
          f"{report['_means']['dice']:.4f}, mean AP "
          f"{report['_means']['ap']:.4f} (random weights)")

    # the card against the CPU at a depth cut that keeps both layer kinds
    cfg2 = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, num_layers=2, global_attn_indexes=(1,)))
    sd2 = synthetic.random_params(cfg2, seed=2)
    ds2 = PromptedDataset(items[:4], seed=0)
    reports = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reports[device] = _report_numbers(_quiet(
            evaluate_metrics, sd2, cfg2, config, ds2, orig_hw=(496, 512),
            batch_encode=4, device=device))
        print(f"evaluation at the depth cut on {device}: "
              f"{time.perf_counter() - t0:.1f} s")
    check(set(reports["cuda"]) == set(reports["cpu"]), "report keys differ")
    worst = max(reports["cpu"], key=lambda k: abs(reports["cpu"][k]
                                                  - reports["cuda"][k]))
    diff = abs(reports["cpu"][worst] - reports["cuda"][worst])
    print(f"evaluation card vs cpu, ViT-H width, depth cut to 2 layers "
          f"(layer 0 windowed, layer 1 global) of 32, 4 images: "
          f"{len(reports['cpu'])} numbers, max |difference| {diff:.3g} at "
          f"{worst} (atol {EVAL_ATOL})")
    check(diff <= EVAL_ATOL, f"evaluation reports differ by {diff:.3g}")

    # training(evaluate=True): one short ViT-B epoch, then the report
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(synthetic.random_params(sam_vit_base(), seed=0), ckpt)
        cfg_loop = tr.TrainConfig(
            evaluate=True, batch_size=4, epochs=1, ckpt_keep=1,
            pretrained_checkpoint=ckpt, checkpoint=os.path.join(tmp, "ck"),
            display_name="smoke_eval",
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        _reset_counts()
        t0 = time.perf_counter()
        r = _quiet(tr.training, cfg_loop, splits=(items[:4], items[4:]))
        c = _counts()
        check("metrics" in r and all(
            np.isfinite(v) for v in _report_numbers(r["metrics"]).values()),
            "training(evaluate=True) returned no finite metrics")
        # 8 images precomputed in bf16 + 4 evaluated in f32, K1 x4, K2 x8 each
        check(c["attn_global"] == 4 * 12 and c["attn_windowed"] == 8 * 12
              and c["attn_relpos"] == 0, f"training + evaluation at ViT-B "
                                         f"launched {c}")
        print(f"training(evaluate=True) ViT-B, 1 epoch of 1 step + the "
              f"report on 4 validation images: "
              f"{time.perf_counter() - t0:.1f} s, train loss "
              f"{r['history'][0]['train_loss']:.4f}, mean IoU "
              f"{r['metrics']['_means']['iou']:.4f}; launches {c}")
    return launches


EMB_ULPS = 4  # bf16 embeddings, card vs CPU (2-layer cut): bf16 ulps of
#               their scale, 2^-8 * max |cpu|; the mean within half of one


def vith_decoder_phase(torch):
    """MedSAM-style decoder fine-tuning at full ViT-H (32 layers, 1280 wide,
    16 heads of 80) in bf16 from ``prepare_model``'s seeded random weights:
    the precompute of the 16 training images (K6 x32 per image, nothing
    else) and one epoch of 2 cached-embedding steps (K3 x1, K4 x2, forward
    and backward, each); ``training()`` itself for 1 epoch of 2 steps; the
    card against the CPU on the embeddings of 2 images at a 2-layer cut.
    Returns the launch counts of the precompute and the steps."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    config = tr.TrainConfig(base_model="facebook/sam-vit-huge",
                            trainable="decoder", evaluate=False, batch_size=8,
                            epochs=1)  # bf16, lr 1e-3
    t0 = time.perf_counter()
    cfg, sd_host = tr.prepare_model(config)
    init_s = time.perf_counter() - t0
    v = cfg.vision
    check((v.num_layers, v.hidden_size, v.num_heads) == (32, 1280, 16),
          f"not ViT-H: {v}")
    train_items = synthetic.oct_training_items(16, seed=1)
    valid_items = synthetic.oct_training_items(8, seed=2)
    ds = PromptedDataset(train_items, seed=0)
    sd = {k: x.to(dev) for k, x in sd_host.items()}
    decoder, frozen = tr._split_params(sd)
    for x in decoder.values():
        x.requires_grad_(True)
    opt = tr.make_optimizer(config, decoder.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # --- main path starts
    t0 = time.perf_counter()
    emb = tr.precompute_embeddings(sd, cfg, ds, dtype=torch.bfloat16,
                                   verbose=False)
    pre_s = time.perf_counter() - t0
    c = _counts()
    check(c == {**dict.fromkeys(c, 0), "attn_relpos": v.num_layers * len(ds)},
          f"the ViT-H bf16 precompute of {len(ds)} images must launch K6 x32 "
          f"per image and nothing else, got {c}")
    check(emb.shape == (16, 64, 64, 256) and emb.dtype == torch.bfloat16
          and bool(torch.isfinite(emb.float()).all()), "bad ViT-H embeddings")
    step = tr.make_train_step(cfg, config, opt, (496, 512), True)
    losses, times = [], []
    for batch in batches(ds, 8, with_images=False, num_workers=2):
        db = _device_batch(torch, batch, dev, emb)
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoder, opt, loss = step(decoder, opt, frozen, db)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        d = _delta(_counts(), before)
        check(d == STEP_LAUNCHES, f"ViT-H step launched {d}, want "
                                  f"{STEP_LAUNCHES}")
        losses.append(float(loss))
    launches = _counts()  # --- main path ends
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"ViT-H steps: losses {losses}")
    print(f"training ViT-H bf16 (32 layers, 1280 wide, 16 heads of 80; "
          f"prepare_model {init_s:.1f} s): precompute {pre_s * 1e3:.1f} ms "
          f"for {len(ds)} images ({pre_s / len(ds) * 1e3:.2f} ms/image incl. "
          f"first use); 1 epoch of 2 steps, ms {[round(t, 2) for t in times]}"
          f", losses {[round(x, 4) for x in losses]}; max_memory_allocated "
          f"{peak / 2**20:.1f} MiB; launches {launches}")
    t0 = time.perf_counter()  # a second precompute pass, past first use
    tr.precompute_embeddings(sd, cfg, ds, dtype=torch.bfloat16, verbose=False)
    warm_s = time.perf_counter() - t0
    print(f"ViT-H bf16 precompute, second pass: {warm_s * 1e3:.1f} ms for "
          f"{len(ds)} images ({warm_s / len(ds) * 1e3:.2f} ms/image)")
    del sd, decoder, frozen, opt, emb
    torch.cuda.empty_cache()

    # training() itself: 16 + 8 images precomputed, 2 steps, 1 validation
    with tempfile.TemporaryDirectory() as tmp:
        loop = dataclasses.replace(
            config, checkpoint=os.path.join(tmp, "ck"), ckpt_keep=1,
            display_name="smoke_vith",
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        _reset_counts()
        t0 = time.perf_counter()
        r = _quiet(tr.training, loop, splits=(train_items, valid_items))
        c = _counts()
        want = {**dict.fromkeys(c, 0), "attn_relpos": v.num_layers * 24,
                "upscale_fwd": 3, "upscale_bwd": 2, "upscale_bwd_dw": 2,
                "i2t_fwd": 6, "i2t_bwd": 4, "i2t_bwd_dw": 4}
        check(c == want, f"training() at ViT-H launched {c}, want {want}")
        hist = r["history"]
        check([h["epoch"] for h in hist] == [0]
              and np.isfinite([hist[0]["train_loss"],
                               hist[0]["valid_loss"]]).all(),
              f"training() at ViT-H: {hist}")
        print(f"training() ViT-H bf16, 1 epoch of 2 steps + 1 validation "
              f"batch: {time.perf_counter() - t0:.1f} s (prepare_model "
              f"included), train {hist[0]['train_loss']:.4f}, valid "
              f"{hist[0]['valid_loss']:.4f}; launches {c}")
    del r
    torch.cuda.empty_cache()

    # the card against the CPU at a depth cut that keeps both layer kinds
    cfg2 = dataclasses.replace(cfg, vision=dataclasses.replace(
        v, num_layers=2, global_attn_indexes=(1,)))
    sd2 = synthetic.random_params(cfg2, seed=3)
    ds2 = PromptedDataset(train_items[:2], seed=0)
    embs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        before = _counts()
        embs[device] = tr.precompute_embeddings(
            {k: x.to(device) for k, x in sd2.items()}, cfg2, ds2,
            dtype=torch.bfloat16, verbose=False).float().cpu()
        d = {k: x for k, x in _delta(_counts(), before).items() if x}
        check(d == ({"attn_relpos": 4} if device == "cuda" else {}),
              f"2-layer precompute on {device} launched {d}")
        print(f"ViT-H bf16 precompute at the depth cut on {device}: "
              f"{time.perf_counter() - t0:.1f} s")
    ulp = 2.0 ** -8 * embs["cpu"].abs().max().item()
    diff = (embs["cuda"] - embs["cpu"]).abs()
    print(f"ViT-H bf16 embeddings card vs cpu, full width, depth cut to 2 "
          f"layers (layer 0 windowed, layer 1 global) of 32, 2 images: max "
          f"|difference| {diff.max().item():.3g} = "
          f"{diff.max().item() / ulp:.3f} ulps of the scale (limit "
          f"{EMB_ULPS}), mean {diff.mean().item() / ulp:.3f} ulps (limit 0.5)"
          f", bit-equal share {(diff == 0).float().mean().item():.4f}")
    check(diff.max().item() <= EMB_ULPS * ulp
          and diff.mean().item() <= 0.5 * ulp,
          "ViT-H bf16 embeddings differ between the card and the CPU")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from dilabhelmholtzoct_tpu_torch import kernels
    from dilabhelmholtzoct_tpu_torch.ops import attention as attn

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)  # name, power limit

    build_s = kernels.build()
    print(f"kernel build: {build_s:.1f} s")
    for src, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"  {src}: {line.strip()}")
    tensor_core_check(kernels)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, attn)
    launches = serving_phase(torch, attn)
    print(f"[phases] K1/K2 + serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_rows = k34_kernel_phase(torch)
    print(f"[phases] K3/K4 kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(training_phase(torch))
    print(f"[phases] training {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update({f"{k}_f32": v
                     for k, v in decoder_f32_fused_phase(torch).items()})
    print(f"[phases] f32 fused decoder fine-tune "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k5_rows = k5_kernel_phase(torch, attn)
    print(f"[phases] K5 kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ft = finetune_phase(torch)
    launches.update({k: ft[k] for k in ("attn_bwd_dq", "attn_bwd_dkv")})
    launches["attn_global_bf16"] = ft["attn_global"]
    launches["attn_windowed_bf16"] = ft["attn_windowed"]
    print(f"[phases] full fine-tune {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ft32 = finetune_f32_phase(torch)
    launches.update({f"{k}_f32": ft32[k] for k in ("attn_bwd_dq",
                                                    "attn_bwd_dkv")})
    launches["attn_global_b4"] = ft32["attn_global"]
    print(f"[phases] f32 full fine-tune {time.perf_counter() - t0:.1f} s")
    rows.update(train_rows)
    rows.update(k5_rows)
    t0 = time.perf_counter()
    rows.update(k6_kernel_phase(torch, attn))
    rows.update(k7_kernel_phase(torch, attn))
    print(f"[phases] K6/K7 kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_huge

    sd_h = synthetic.random_params(sam_vit_huge(), seed=0)
    print(f"[phases] ViT-H random weights {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vith = vith_serving_phase(torch, attn, sd_h)
    # one kernel (one count) serves the global and the windowed layers
    launches["attn_relpos"] = vith["attn_relpos"]
    launches["attn_relpos_windowed"] = vith["attn_relpos"]
    print(f"[phases] ViT-H serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on = fused_windowed_phase(torch, attn)
    launches["attn_windowed_image"] = on["attn_windowed_image"]
    print(f"[phases] ViT-B serving under 'on' {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    evaluation_phase(torch, attn, sd_h)
    print(f"[phases] evaluation {time.perf_counter() - t0:.1f} s")
    del sd_h
    t0 = time.perf_counter()
    launches["attn_relpos_bf16"] = vith_decoder_phase(torch)["attn_relpos"]
    launches["attn_relpos_windowed_bf16"] = launches["attn_relpos_bf16"]
    print(f"[phases] ViT-H bf16 decoder fine-tune "
          f"{time.perf_counter() - t0:.1f} s")
    for k, row in rows.items():
        check(launches[k] > 0, f"{k} was not launched on the main path")
        row["launches"] = launches[k]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
