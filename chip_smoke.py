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
   K1-K7 kernels' (split TF32) TF32 ones (HMMA.1688.F32.TF32), the
   kernels on wgmma and TMA (``WGMMA_KERNELS``: the bf16 K6, K1 and K2
   ``attn_relpos_wgmma_kernel``, the f32 K6, K1 and K2
   ``attn_relpos_wgmma_tf32_kernel``, K5's bf16 ``attn_bwd_dq_wgmma_kernel``
   and ``attn_bwd_dkv_wgmma_kernel`` and f32
   ``attn_bwd_dq_wgmma_tf32_kernel`` and ``attn_bwd_dkv_wgmma_tf32_kernel``,
   the bf16 K4 row pass ``i2t_bwd_rows_wgmma_kernel``, both K4 weight
   passes, the f32 K3 weight pass, the bf16 K3 forward
   ``upscale_fwd_wgmma_kernel`` and row pass) HGMMA (TF32 in the f32 ones; no HMMA
   where ``NO_HMMA_KERNELS`` names them) and TMA
   loads (UTMALDG), ptxas serializes no wgmma of a main-path instance
   (``PIPELINED``), and their ptxas reports no spills,
   printed per kernel beside its registers and its counts of HMMA, HGMMA
   and UTMALDG.
2b. The component engine of prompt extraction (``components_phase``; the
   host library's ``csrc/components_host.cc``): built, and bit-equal to its
   scipy twins on the 24 label maps of the training phases and on one map
   above the 256-component cap (component map, values, boxes, sizes,
   total, and the boxes and points drawn from one seed); the host ms per
   map of each.
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
   either fused chain, so their library_ms is null; the weight passes' is
   their cuBLAS products alone (``x^T @ y`` on the kernel's own operands,
   under ``full_fp32``).
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
6c. Decoder fine-tuning with the topological loss (``topological=True``,
   bf16, ViT-B, cached embeddings of 8 images x bucket 8 = 64 pairs, interp
   50, lambda 0.1, H1): T1 (``cubical_pairs``) and T2
   (``wasserstein_match``, ``csrc/topology.cu``) on the step's own grids
   (H1) and on 64 pred and 64 true grids of 50x50 sigmoid noise (H0 and
   H1; hundreds of bars on both sides of each matching), against their
   plain twins (``ops/topology_ref.py``), the host library
   (``ops/native.py``) and their own phases run on the host
   (``native.*_parallel``, which also count the merge pixels each T1 walk
   visits and the Dijkstra steps of each T2 row, printed): bars exactly
   equal, matching cost within ``TOPO_COST_RTOL`` of the twin and equal to
   the host's, the same bits on a second run; each timed beside the twin
   and the host library. Then 8 steps of each mode from the same
   weights: ``topo_device`` (K3 x1, K4 x2, T1 x1, T2 x1 per step), host
   sync and host pipelined (with ``flush``), and without the term; falling
   losses, the median step of each; the device and sync first-step losses
   within ``TOPO_LOSS_RTOL``, the pipelined first step equal to the sync
   one; ``T1_LARGE_STEPS`` device-mode steps at ``topo_interp=
   T1_LARGE_INTERP``, past one block's shared memory (each T1 launch on
   its global route); one device-mode step on the card against the CPU.
6c'. T1's global route (``t1_large_phase``): at 100x100, 128x128 and
   255x255, in H0 and H1, 8 grids of sigmoid noise and 8 of blobs; the
   route taken (a 50x50 grid keeps the shared one), bars, counts and cap
   equal to the host library's and, on 2 grids, the twin's, the same bits
   on a second run, the time beside the bytes bound; one T2 launch on the
   255x255 noise grids' H1 bars (512 a side) held by its cost against the
   twin and equal to the host library's matching.
6d. The training run from raw items with every data option
   (``data_path_phase``): ``training()`` at full ViT-B width and depth,
   bf16, seeded weights, 16 train + 8 valid synthetic items, batch 4, 2
   epochs, ``cache_embeddings=False`` (the frozen encoder in every step),
   all six augmentations, ``pseudocolor='Jet'``, ``display_mode=
   'predefined'`` (items 0 and 1 of each split, before the first epoch and
   after each) and ``profile_dir``: exact K1 / K2 / K3 / K4 launch counts
   derived from the step count, the batch, ``encoder_microbatch`` and the
   display's f32 encodes; finite losses; the epoch-0 trace names a port
   kernel; the display panels (496 x 1536) when PIL imports; the median
   uncached step ms and images/s with the card's name and power limit.
   Then every host batch the run's loader built byte-equal to a second
   ``PromptedDataset`` with the same options on the CPU; the augmented
   step on the card against the CPU at a 2-layer cut (``STEP_LOSS_RTOL``,
   ``SIGN_AGREE_MIN``); ``sam_forward`` with a box and a (1, 256, 256, 1)
   mask input at ViT-B, f32, from a cached embedding, on the card against
   the CPU (``PROB_ATOL``), its dense embedding unlike the no-mask row, and
   the bf16 forward finite. The prompt extraction runs on the component
   engine.
6d'. BASELINE config 3 in training (``points_bone_phase``): ``training()``
   at ViT-B, bf16, cached embeddings, ``prompt_type='points'``,
   ``pseudocolor='Bone'``, 1 epoch of 2 steps of batch 8: exact launches
   (the precompute's K1 / K2, K3 x1 and K4 x2 a step), finite losses, the
   component engine's extraction and point picks on its host path.
6e. Data parallelism (``dp_phase``; ``parallel/``, ``multihost``):
   ``training()`` with ``multihost=True`` in an NCCL group of one (ViT-B,
   bf16, cached, 8 + 8 images: 64 pairs, one epoch), its history bit-equal
   to the same run in one process and its launches exact (K1 x64, K2
   x128, K3 / K4 of one train and one valid step); then two ranks sharing
   ``cuda:0`` over gloo (NCCL takes one rank per card), each a process,
   ``DP_STEPS`` Adam decoder steps on its half of 7 images padded to 8
   (32 and 9 channels), K3 x1 / K4 x2 forward and backward per step and
   rank: the ranks bit-equal, the first step's loss, gradients and the
   signs of its Adam updates against the single-process full-batch step
   (``DP_LOSS_RTOL``, ``DP_GRAD_RTOL``, ``DP_SIGN_AGREE_MIN``), and the
   gradient against the exact per-rank oracle (``dp_rank_oracle``: each
   rank's rows in this process with the global denominators, summed in
   f32; within ``DP_ORACLE_ULPS`` f32 ulps, the largest difference
   printed), step ms per rank beside one process's; over NCCL with one
   rank per card where the machine has two cards, else one line saying it
   did not run.
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
   against its plain version and against K2 on the partitioned windows of
   the same qkv (K2 on the wgmma bodies, K7 on mma.sync: within the limit
   against plain, ``kernel_tol``, in both types); timed beside K2's
   bound. Then one ViT-B layer's
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
19. ViT-H encoder fine-tuning (``vith_finetune_phase``): ``trainable=
   'all'``, bf16, batch 2, ``VITH_FT_STEPS`` steps under
   ``set_flash_attention('off')`` (the materialized attention route in
   every encoder layer): no attention kernel launched, K3 x1 / K4 x2
   forward and backward per step, finite losses, the median step and the
   peak memory; the first step card vs CPU at a 2-layer cut (ViT-H width);
   the 'auto' route with a gradient raises, naming the switch (K6 is
   forward-only); a ViT-B f32 encode under 'off' against 'auto' (K1 x4,
   K2 x8) within ``F32_ATOL`` of the embeddings' scale, both timed.

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
launches counted on the ``set_fused_windowed('on')`` encode; T1 / T2 on the
topological step's grids, their launches counted on its device mode's 8
steps, with the host library's time beside them); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
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
F32_REL = 1e-4     # the f32 K1 / K6 (split TF32 on wgmma) vs plain, of max
#                    |plain|: summation order, and 2^-20 of each product
#                    that the split drops
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
# the bf16 K4 forward against i2t_fwd_plain: the share of y bit-equal (its
# products' f32 sums run in another order than the plain version's; an
# output a bf16 rounding boundary apart differs by one ulp)
K4_FWD_SAME = 0.995


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


def f32_rel_tol(ref):
    """The limit of the f32 K1 / K6 kernel (split TF32 on wgmma) against its
    plain twin: ``F32_REL`` of max |plain|, its LSE rows included."""
    return F32_REL * ref.float().abs().max().item()


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
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


def device_ms_by_kernel(fn, names, reps=20):
    """Device ms a call of ``fn`` spends in each kernel whose name holds one
    of ``names``, from ``torch.profiler`` over ``reps`` calls; None where
    the profiler saw no device time for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    # a first session, discarded: after another phase's trace the first
    # one has come back without device time
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {n: 0.0 for n in names}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        for n in names:
            if n in e.key:
                us[n] += t
    return {n: us[n] / 1e3 / reps if us[n] > 0 else None for n in names}


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


# the kernels on the tensor cores: library -> kernel names, bf16 (HMMA or
# HGMMA on bf16) and f32 in split TF32 (HMMA.1688.F32.TF32, or HGMMA on
# TF32)
MMA_KERNELS = {"attention_bwd": ("attn_bwd_dq_wgmma_kernel",
                                 "attn_bwd_dkv_wgmma_kernel"),
               "attention_relpos_wgmma": ("attn_relpos_wgmma_kernel",),
               "attention_winimg": ("attn_winimg_mma_kernel",),
               "upscaler": ("upscale_fwd_wgmma_kernel",
                            "upscale_bwd_rows_wgmma_kernel",
                            "upscale_bwd_dw_kernel"),
               "decoder_attn": ("i2t_fwd_wgmma_kernel",
                                "i2t_bwd_rows_wgmma_kernel",
                                "i2t_bwd_dw_wgmma_kernel")}
TF32_KERNELS = {"attention_bwd_wgmma_tf32": ("attn_bwd_dq_wgmma_tf32_kernel",
                                             "attn_bwd_dkv_wgmma_tf32_kernel"),
                "attention_relpos_wgmma_tf32": (
                    "attn_relpos_wgmma_tf32_kernel",),
                "attention_winimg": ("attn_winimg_tf32_kernel",),
                "upscaler": ("upscale_fwd_tf32_kernel",
                             "upscale_bwd_rows_tf32_kernel",
                             "upscale_bwd_dw_tf32_kernel"),
                "decoder_attn": ("i2t_fwd_tf32_kernel",
                                 "i2t_bwd_rows_tf32_kernel",
                                 "i2t_bwd_dw_tf32_kernel")}
# the kernels on wgmma with TMA loads: HGMMA and UTMALDG in their SASS (the
# bf16 K1 and K2 are instances of attn_relpos_wgmma_kernel, the f32 K1 and
# K2 of attn_relpos_wgmma_tf32_kernel)
WGMMA_KERNELS = {"attention_relpos_wgmma": ("attn_relpos_wgmma_kernel",),
                 "attention_relpos_wgmma_tf32": (
                     "attn_relpos_wgmma_tf32_kernel",),
                 "attention_bwd": ("attn_bwd_dq_wgmma_kernel",
                                   "attn_bwd_dkv_wgmma_kernel"),
                 "attention_bwd_wgmma_tf32": (
                     "attn_bwd_dq_wgmma_tf32_kernel",
                     "attn_bwd_dkv_wgmma_tf32_kernel"),
                 "decoder_attn": ("i2t_bwd_dw_tf32_kernel",
                                  "i2t_fwd_wgmma_kernel",
                                  "i2t_bwd_rows_wgmma_kernel",
                                  "i2t_bwd_dw_wgmma_kernel"),
                 "upscaler": ("upscale_bwd_dw_tf32_kernel",
                              "upscale_bwd_rows_wgmma_kernel",
                              "upscale_fwd_wgmma_kernel")}
# the kernels whose every product is on wgmma: no HMMA (mma.sync) in their
# SASS
NO_HMMA_KERNELS = ("attn_relpos_wgmma_tf32_kernel",
                   "attn_bwd_dq_wgmma_tf32_kernel",
                   "attn_bwd_dkv_wgmma_tf32_kernel",
                   "i2t_bwd_rows_wgmma_kernel",
                   "upscale_bwd_rows_wgmma_kernel")
# instances whose wgmma ptxas must not serialize (C7511 / C7512: they then
# run at half their speed or less): the f32 K6 / K1 / K2 of the main path,
# ViT-H's global (DP 80, ROW_TILE) and windowed (GRID) layers, ViT-B / L's
# K1 (DP 64, ROW_TILE) and K2 (DP 64, GRID), by their mangled template
# arguments; K5's f32 kernels at ViT-B / L's global layer (dq ROW, two
# tiles a grid row: <2>; dk/dv ROW_TILE: <true>) and windows (dq GRID: <0>;
# dk/dv <false>); K4's bf16 row pass and forward, K3's bf16 row pass and
# forward
PIPELINED = {"attention_relpos_wgmma_tf32": ("ILi80ELNS0_4ModeE1E",
                                             "ILi80ELNS0_4ModeE2E",
                                             "ILi64ELNS0_4ModeE1E",
                                             "ILi64ELNS0_4ModeE2E"),
             "decoder_attn": ("i2t_bwd_rows_wgmma_kernel",
                              "i2t_fwd_wgmma_kernel"),
             "upscaler": ("upscale_bwd_rows_wgmma_kernel",
                          "upscale_fwd_wgmma_kernel"),
             "attention_bwd_wgmma_tf32": (
                 "attn_bwd_dq_wgmma_tf32_kernelILi2E",
                 "attn_bwd_dq_wgmma_tf32_kernelILi0E",
                 "attn_bwd_dkv_wgmma_tf32_kernelILb1E",
                 "attn_bwd_dkv_wgmma_tf32_kernelILb0E")}


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
    f32 kernels), the wgmma kernels (``WGMMA_KERNELS``) HGMMA and TMA loads
    (UTMALDG), those of ``NO_HMMA_KERNELS`` no HMMA, and its ptxas report
    shows no spills; print the counts of each instance beside its
    registers and spills, every ptxas warning and every wgmma ptxas
    serialized (its C7511 / C7512 notes), and fail where it serialized an
    instance of ``PIPELINED``."""
    cuobjdump = kernels.cuda_tool("cuobjdump")
    for lib in sorted(set(MMA_KERNELS) | set(TF32_KERNELS)):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(kernels.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = dict.fromkeys(("HMMA", "HGMMA", "TF32",
                                            "UTMALDG"), 0)
            elif fn:
                c = counts[fn]
                for op in ("HMMA", "HGMMA", "UTMALDG"):
                    c[op] += op in line
                c["TF32"] += ("MMA" in line) and ("TF32" in line)
        serialized = set()
        for line in kernels.BUILD_LOG.get(lib, "").splitlines():
            if "warning" in line.lower():
                print(f"ptxas {lib}: {line.strip()}")
            if "(C751" in line and "function '" in line:
                serialized.add(line.split("function '")[1].split("'")[0])
        for f in sorted(serialized):
            print(f"ptxas {lib}: wgmma serialized in {f}")
        for pat in PIPELINED.get(lib, ()):
            check(not any(pat in f for f in serialized),
                  f"{lib}: ptxas serialized the wgmma of the main path's "
                  f"instance {pat}")
        report = _ptxas_by_function(kernels.BUILD_LOG.get(lib, ""))
        for name in MMA_KERNELS.get(lib, ()) + TF32_KERNELS.get(lib, ()):
            tf32 = name in TF32_KERNELS.get(lib, ())
            wgmma = name in WGMMA_KERNELS.get(lib, ())
            found = [f for f in counts if name in f]
            check(found, f"{name} is not in the SASS of {lib}")
            for f in found:
                c = counts[f]
                check(c["HMMA"] + c["HGMMA"] > 0
                      and (c["TF32"] > 0 if tf32 else True),
                      f"{f}: no {'TF32 ' if tf32 else ''}tensor-core "
                      "instruction in its SASS")
                check(not wgmma or (c["HGMMA"] > 0 and c["UTMALDG"] > 0),
                      f"{f}: no HGMMA (wgmma) or no UTMALDG (TMA load) in "
                      "its SASS")
                check(name not in NO_HMMA_KERNELS or c["HMMA"] == 0,
                      f"{f}: {c['HMMA']} HMMA (mma.sync) in its SASS")
                rep = report.get(f, "not rebuilt in this run")
                # (a count that merely ends in 0, "960 bytes", is a spill)
                check(f not in report or (
                    re.search(r"(^|\D)0 bytes spill stores", rep)
                    and re.search(r"(^|\D)0 bytes spill loads", rep)),
                      f"{f} spills: {rep}")
                on_tf32 = f" ({c['TF32']} on TF32)" if tf32 else ""
                print(f"sass {f}: HMMA {c['HMMA']}, HGMMA {c['HGMMA']}"
                      f"{on_tf32}, UTMALDG {c['UTMALDG']}; ptxas {rep}")


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
    a second run (the f32 K1 and K2 are the f32 K6's kernel on wgmma: K1
    within ``F32_REL`` of max |plain|, K2 within ``F32_ATOL``, their LSE
    rows too); returns the numbers of
    each kernel for the result line: f32 (the serving path's type) under
    its name, bf16 (the tensor-core kernels of the precompute and full
    fine-tune paths) as ``<name>_bf16``, and the f32 K1 at B = 4 (the f32
    full fine-tune's shape) as ``attn_global_b4``."""
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
                # the f32 K1 and K2 on the split-TF32 wgmma kernel: K1 (4096
                # keys) within F32_REL of max |plain|, K2 within F32_ATOL
                wgmma_f32 = dtype == torch.float32
                tol = (f32_rel_tol(ref) if wgmma_f32 and name == "attn_global"
                       else kernel_tol(ref))
                check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                      f"{name} {dtype}: bad output")
                check(err <= tol, f"{name} {dtype}: max |kernel - plain| "
                                  f"{err:.3g} > {tol:.3g}")
                check(torch.equal(out, attn.flash_attention_packed(*args, **kw)),
                      f"{name} {dtype}: a second run gave other bits")
                lse_note = ""
                if wgmma_f32:  # the LSE rows K5 reads, and the same output
                    out_l, lse = attn.attention_fwd_cuda(
                        *args, return_lse=True, **kw)
                    _, want_lse = attn.packed_attention_plain(
                        *args, return_lse=True, **kw)
                    lse_err = (lse - want_lse).abs().max().item()
                    lse_tol = (f32_rel_tol(want_lse) if name == "attn_global"
                               else F32_ATOL)
                    check(lse_err <= lse_tol and torch.equal(out_l, out),
                          f"{name} f32 B={b}: LSE max |kernel - plain| "
                          f"{lse_err:.3g} > {lse_tol:.3g}, or another output")
                    lse_note = f" lse_err={lse_err:.3g} (limit {lse_tol:.3g})"
                    del out_l, lse, want_lse
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
            # the K1s and K2s are the K6 kernels of their type
            src = ("attention_relpos_wgmma.cu" if not split else
                   "attention_relpos_wgmma_tf32.cu")
            rows[key] = {
                "name": key, "route": "cuda",
                "source": f"dilabhelmholtzoct_tpu_torch/csrc/{src}",
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms,
            }
            print(f"kernel {name} {tname} B={b} N={n} heads={heads}: "
                  f"max_abs_err={err:.3g} (limit {tol:.3g}){lse_note} "
                  f"ms={ms:.4f} "
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
    share of outputs bit-equal to ``i2t_fwd_plain`` at least
    ``K4_FWD_SAME``, printed); each backward
    is two launches, the row pass and the weight pass: each is held against
    its plain twin (the weight pass on the row pass's own scratch rows), the
    composed backward against ``*_bwd_plain`` and against itself on a second
    run (the same bits), and each launch is timed beside its bound (f32:
    split TF32's rate, the CUDA cores' bound beside it). The bf16 forward
    runs at n_out 4 too (tag ``_n4``, printed only).
    Returns the numbers per launch for the result line: bf16 rows under the
    launch names, f32 rows under the names with ``_f32``."""
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
            tag="", row=None, bits=False, cores=None, library=None):
        """``name`` is the launch count the kernel call adds one to; ``row``
        the result line's entry it fills (pb = 1; ``_f32`` added in f32);
        ``replaces`` the kernel's source file, its name and the TPU kernel's
        call site; ``bits`` prints the share of outputs bit-equal to the
        plain version; ``cores`` the f32 bound over the CUDA cores;
        ``library`` the PyTorch call timed as the yardstick, where one
        computes the same function (the weight passes: their cuBLAS
        products alone). Every launch must give the same bits on a second
        run."""
        before = counter[name]
        out = kernel()
        torch.cuda.synchronize()
        check(counter[name] == before + 1,
              f"{name}{tag} did not launch its kernel")
        ref = plain()
        torch.cuda.synchronize()
        err, rel = _check_outputs(torch, name + tag, tname, out, ref)
        same = ""
        if bits:  # the bf16 K4 forward: >= K4_FWD_SAME of y bit-equal
            share = float((out == ref).float().mean())
            check(share >= K4_FWD_SAME, f"{name}{tag} {tname}: {share:.5f} "
                                        "of the outputs bit-equal to plain")
            same = f" bit-equal to plain {share:.5f};"
        del ref
        again = kernel()
        pairs = zip(out, again) if isinstance(out, tuple) else [(out, again)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{row or name}{tag} {tname}: a second run gave other bits")
        same, again = same + " same bits on a second run;", None
        del out
        ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, 2)
        lib_ms = None if library is None else cuda_ms(library, iters)
        b_ms, b_by = bound
        key = None if row is None or tag else row + (
            "" if tname == "bf16" else "_f32")
        entry = {}
        core_txt = _cuda_core_bound(entry, ms, cores is not None, cores)
        lib_txt = "null" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"kernel {row or name}{tag} {tname}: max_abs_err={err:.3g} "
              f"max_rel_err={rel:.3g};{same} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_txt} "
              f"bound_ms={b_ms:.4f} "
              f"({b_by}{'; split TF32' if cores else ''}) "
              f"share_of_bound={b_ms / ms:.3f}{core_txt}")
        if key:
            entry.update({
                "name": key, "route": "cuda",
                "source": f"dilabhelmholtzoct_tpu_torch/csrc/{replaces[0]}",
                "kernel": replaces[1][tname], "replaces": replaces[2],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
            })
            rows[key] = entry
        return ms

    k3 = "upscaler.cu", "dilabhelmholtzoct_tpu/ops/upscaler.py"
    k4 = "decoder_attn.cu", "dilabhelmholtzoct_tpu/ops/decoder_attn.py"
    names = lambda bf, f: {"bf16": bf, "f32": f}
    k3_fwd = k3[0], names("upscale_fwd_wgmma_kernel",
                          "upscale_fwd_tf32_kernel"), f"{k3[1]}:295"
    k3_bwd = k3[0], names("upscale_bwd_rows_wgmma_kernel",
                          "upscale_bwd_rows_tf32_kernel"), f"{k3[1]}:329"
    k3_dw = k3[0], names("upscale_bwd_dw_kernel",
                         "upscale_bwd_dw_tf32_kernel"), f"{k3[1]}:329"
    k4_fwd = k4[0], names("i2t_fwd_wgmma_kernel",
                          "i2t_fwd_tf32_kernel"), f"{k4[1]}:264"
    k4_bwd = k4[0], names("i2t_bwd_rows_wgmma_kernel",
                          "i2t_bwd_rows_tf32_kernel"), f"{k4[1]}:287"
    k4_dw = k4[0], names("i2t_bwd_dw_wgmma_kernel",
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

            def k3b(backward, part=None, n=n_out):
                return bounds(lambda pk: k3_bound_ms(bp, m, n, isz, pk,
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
            # the yardstick: dW1 = up^T d_u1pre and the four dW2 blocks as
            # cuBLAS products of the kernel's own operands
            n_r = bp * m
            x1, y1 = scratch[0].reshape(n_r, -1), scratch[3].reshape(n_r, -1)
            x2 = scratch[1].reshape(n_r, 4, -1).permute(1, 2, 0).contiguous()
            y2 = scratch[2].reshape(n_r, 4, -1).permute(1, 0, 2).contiguous()
            t_dw = run("upscale_bwd_dw", tname,
                       lambda: up_op.upscale_bwd_dw_cuda(*scratch),
                       lambda: up_op.upscale_bwd_dw_plain(*scratch),
                       up_op.LAUNCHES, b, k3_dw, 5, row="upscale_bwd_dw",
                       cores=c, library=lambda: (x1.T @ y1,
                                                 torch.bmm(x2, y2)))
            del x1, y1, x2, y2
            print(f"K3 {tname} backward: {total:.4f} ms composed (row pass "
                  f"{t_rows:.4f} + weight pass {t_dw:.4f} timed alone)")
            del up_args, dm, bwd_args, scratch
            if bf:  # the bf16 forward (on wgmma) at 4 mask tokens too
                up_args = (rnd(bp, m, 256, dt=dt),
                           rnd(256, 2, 2, 64, k=0.06, dt=dt), rnd(64, k=0.1),
                           1 + rnd(64, k=0.1), rnd(64, k=0.1),
                           rnd(64, 2, 2, 32, k=0.12, dt=dt), rnd(32, k=0.1),
                           rnd(bp, 4, 32, dt=dt))
                b, c = k3b(False, n=4)
                run("upscale_fwd", tname,
                    lambda: up_op.upscale_fwd_cuda(*up_args),
                    lambda: up_op.upscale_fwd_plain(*up_args),
                    up_op.LAUNCHES, b, k3_fwd, 10, "_n4", row="upscale_fwd",
                    cores=c)
                del up_args
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
                # the yardstick: dWq^T = d_qpre^T (keys + pe) and dWo =
                # rnd(out)^T rnd(d_res) as two cuBLAS products, the sum and
                # repeat of keys + pe made beforehand
                flat = lambda t: t.reshape(bp * m, -1)
                qin = flat((args[0] + args[1]).repeat_interleave(pb, 0))
                dq, orow, dres = (flat(t) for t in scratch[2:])
                t_dw = run(
                    "i2t_bwd_dw", tname,
                    lambda: i2t.i2t_bwd_dw_cuda(*scratch, pb=pb),
                    lambda: i2t.i2t_bwd_dw_plain(*scratch, pb=pb),
                    i2t.LAUNCHES, b, k4_dw, 5, tag, row="i2t_bwd_dw",
                    cores=c, library=lambda: (dq.T @ qin, orow.T @ dres))
                del qin, dq, orow, dres
                print(f"K4{tag} {tname} backward: {total:.4f} ms composed "
                      f"(row pass {t_rows:.4f} + weight pass {t_dw:.4f} "
                      "timed alone)")
                if bf:  # the bf16 weight pass: its two kernels apart
                    split = device_ms_by_kernel(
                        lambda: i2t.i2t_bwd_dw_cuda(*scratch, pb=pb),
                        ("i2t_bwd_dw_wgmma_kernel", "i2t_dw_sum_kernel"))
                    txt = ", ".join(
                        f"{k} " + ("not measured" if v is None
                                   else f"{v:.4f} ms")
                        for k, v in split.items())
                    print(f"K4{tag} {tname} weight pass, device time a call "
                          f"(torch.profiler, 20 calls): {txt}")
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
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as topo
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    return {**attn.LAUNCHES, **up_op.LAUNCHES, **i2t.LAUNCHES,
            **topo.LAUNCHES}


def _reset_counts():
    from dilabhelmholtzoct_tpu_torch.ops import attention as attn
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as topo
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    for mod in (attn, up_op, i2t, topo):
        mod.reset_launch_counts()


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


STEP_LAUNCHES = {"attn_global": 0, "attn_windowed": 0, "attn_bwd_dq": 0,
                 "attn_bwd_dkv": 0, "attn_relpos": 0, "attn_windowed_image": 0,
                 "upscale_fwd": 1, "upscale_bwd": 1, "upscale_bwd_dw": 1,
                 "i2t_fwd": 2, "i2t_bwd": 2, "i2t_bwd_dw": 2,
                 "cubical_pairs": 0, "wasserstein_match": 0}


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


TOPO_STEPS = 8  # steps of each mode in the topological phase
# device mode against host sync mode, first step: one algorithm gives the
# same pairing and matching, so only f32 sums of the loss may differ
TOPO_LOSS_RTOL = 2e-5
# T2 against its plain twin: each row's matching cost (scipy may pick
# another matching of equal cost; the f32 cost entries are the same)
TOPO_COST_RTOL = 1e-6
TOPO_STEP_LAUNCHES = {**STEP_LAUNCHES, "cubical_pairs": 1,
                      "wasserstein_match": 1}


def _match_cost(torch, flat, pb, pd, matched, target, const_term, q=2.0):
    """Each row's matching cost (what the loss takes the q-th root of), in
    f64 on the host."""
    flat, pb, pd = flat.double().cpu(), pb.long().cpu(), pd.long().cpu()
    valid = pb >= 0
    b = flat.gather(1, pb.clamp(min=0))
    d = flat.gather(1, pd.clamp(min=0))
    t = target.double().cpu()
    c_match = torch.maximum((b - t[..., 0]).abs(), (d - t[..., 1]).abs()) ** q
    c_diag = ((d - b).abs() / 2) ** q
    cost = torch.where(matched.cpu().bool() & valid, c_match,
                       torch.where(valid, c_diag, 0.0))
    return cost.sum(1) + const_term.double().cpu()


def _host_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _spread(a):
    a = np.asarray(a)
    return f"{int(a.min())}/{int(np.median(a))}/{int(a.max())}"


def topo_kernel_checks(torch, sp, st, label, feat_ds=(1,), t2_runs=10,
                       t2_warmup=3):
    """T1 and T2 on (N, h, w) pred grids ``sp`` and true grids ``st`` on the
    card, as ``device_pairing`` launches them (T1 once over both, T2 once):
    T1 on each pass of ``feat_ds`` (H1, the loss's, feeds T2), its bars
    (indices, order and counts) exactly equal to its plain twin's, to the
    host library's and to its own phases run on the host
    (``native.cubical_pairs_parallel``, which also gives the merge pixels
    its walk visits per grid); T2's matching cost per row within
    ``TOPO_COST_RTOL`` of its twin's and equal to the host library's
    matching and to its phases on the host (``native.
    wasserstein_match_parallel``: the Dijkstra steps per row); both the same
    bits on a second run; each timed with CUDA events beside the twin and
    the host library on the same batch (T2 over ``t2_runs`` launches after
    ``t2_warmup``). Returns the result line's rows (T1: the H1 pass)."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    n, h, w = sp.shape
    k = 512
    grids = torch.cat([sp, st]).float().contiguous()
    g_host = grids.cpu()
    g_np = g_host.numpy()
    host = native.cubical_pairs_batch(g_np, k)
    t1 = {}
    for fd in feat_ds:
        before = ptd.LAUNCHES["cubical_pairs"]
        got = ptd.cubical_pairs_cuda(grids, fd, k)
        torch.cuda.synchronize()
        check(ptd.LAUNCHES["cubical_pairs"] == before + 1, "T1 did not launch")
        again = ptd.cubical_pairs_cuda(grids, fd, k)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"T1 H{fd} on {label}: a second run gave other bits")
        t0 = time.perf_counter()
        twin = ptd.cubical_pairs_plain(g_host, fd, k)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got_np = [x.cpu().numpy() for x in got]
        check(all(np.array_equal(x, y.numpy()) for x, y in zip(got_np, twin)),
              f"T1 H{fd} on {label}: bars differ from the plain twin's")
        check(np.array_equal(host[f"h{fd}_birth"], got_np[0])
              and np.array_equal(host[f"h{fd}_death"], got_np[1])
              and np.array_equal(host["counts"][:, fd], got_np[2]),
              f"T1 H{fd} on {label}: bars differ from the host library's")
        *phases, merges = native.cubical_pairs_parallel(g_np, fd, k, 512)
        check(all(np.array_equal(x, y) for x, y in zip(got_np, phases)),
              f"T1 H{fd} on {label}: bars differ from its phases on the host")
        ms = cuda_ms(lambda: ptd.cubical_pairs_cuda(grids, fd, k), 10)
        t1[fd] = (got, ms, plain_ms)
        print(f"T1 H{fd} on {label}: merge pixels per grid (min/median/max) "
              f"pred {_spread(merges[:n])}, true {_spread(merges[n:])}; bars "
              f"pred {_spread(got_np[2][:n])}, true {_spread(got_np[2][n:])};"
              f" card ms {ms:.4f}, plain ms {plain_ms:.1f}")
    (b, d, c), t1_ms, t1_plain = t1[1]
    t1_host = _host_ms(lambda: native.cubical_pairs_batch(g_np, k))

    t_flat = st.reshape(n, -1).float()
    tb = t_flat.gather(1, b[n:].clamp(min=0).long())
    td = t_flat.gather(1, d[n:].clamp(min=0).long())
    true_bars = torch.stack([tb, td], -1).contiguous()
    flat = sp.reshape(n, -1).float().contiguous()
    args = (flat, b[:n], d[:n], c[:n], true_bars, c[n:].clone())
    before = ptd.LAUNCHES["wasserstein_match"]
    m, tg, ct = ptd.wasserstein_match_cuda(*args, 2.0)
    torch.cuda.synchronize()
    check(ptd.LAUNCHES["wasserstein_match"] == before + 1,
          "T2 did not launch")
    again = ptd.wasserstein_match_cuda(*args, 2.0)
    check(all(torch.equal(x, y) for x, y in zip((m, tg, ct), again)),
          f"T2 on {label}: a second run gave other bits")
    args_h = tuple(a.cpu() for a in args)
    t0 = time.perf_counter()
    tw = ptd.wasserstein_match_plain(*args_h, 2.0)
    t2_plain = 1e3 * (time.perf_counter() - t0)
    cost = _match_cost(torch, flat, b[:n], d[:n], m, tg, ct)
    cost_twin = _match_cost(torch, flat, b[:n], d[:n], *tw)
    rel = float(((cost - cost_twin).abs()
                 / cost_twin.abs().clamp(min=1e-30)).max())
    check(rel <= TOPO_COST_RTOL, f"T2 on {label}: matching cost differs from "
                                 f"the twin's by {rel:.3g} (rtol "
                                 f"{TOPO_COST_RTOL})")
    nt = c[n:].cpu().numpy()
    diagrams = [true_bars[i, :nt[i]].cpu().numpy() for i in range(n)]
    host_in = (flat.cpu().numpy(), b[:n].cpu().numpy(), d[:n].cpu().numpy(),
               c[:n].cpu().numpy(), diagrams, 2.0, k)
    hm = native.wasserstein_match_batch(*host_in)
    got_np = [x.cpu().numpy() for x in (m, tg, ct)]
    check(all(np.array_equal(x, y) for x, y in zip(got_np, hm)),
          f"T2 on {label}: the matching differs from the host library's")
    *phases, steps = native.wasserstein_match_parallel(
        *(a.numpy() for a in args_h), 2.0, 256)
    check(all(np.array_equal(x, y) for x, y in zip(got_np, phases)),
          f"T2 on {label}: the matching differs from its phases on the host")
    t2_host = _host_ms(lambda: native.wasserstein_match_batch(*host_in))

    t2_ms = cuda_ms(lambda: ptd.wasserstein_match_cuda(*args, 2.0), t2_runs,
                    t2_warmup)
    # bytes: each input read once, each output written once. T1 reads every
    # grid and writes its fixed-shape bars. T2 needs, of its padded inputs,
    # only this run's bars: each pred bar's two indices and two pixel values,
    # each true bar's two values, and the counts; it writes its fixed-shape
    # outputs. Its operations: each pred / true pair's cost once (two
    # differences, their larger, its square, less the diagonal cost: 5
    # f32 operations), the least an optimal matching must look at.
    t1_bytes = 4 * grids.numel() + 4 * (2 * 2 * n * k + 2 * n)
    pc, tc = c[:n].long().cpu(), c[n:].long().cpu()
    t2_bytes = 16 * int(pc.sum()) + 8 * int(tc.sum()) + 4 * 2 * n \
        + n * k + 4 * (2 * n * k + n)
    t2_ops = 5 * int((pc * tc).sum())
    bounds = {"cubical_pairs": _bound(0, t1_bytes, PEAK_F32_FLOPS),
              "wasserstein_match": _bound(t2_ops, t2_bytes, PEAK_F32_FLOPS)}
    print(f"topology kernels on {label} ({n} pred + {n} true grids of {h}x"
          f"{w}; H1 bars pred {_spread(pc)}, true {_spread(tc)}): T1 bars "
          f"equal to the twin's, the host library's and its phases' on the "
          f"host, same bits on a second run; T2 cost within {rel:.3g} of "
          f"the twin's (rtol {TOPO_COST_RTOL}), equal to the host library's "
          f"matching and its phases' on the host; Dijkstra steps per row "
          f"(min/median/max) {_spread(steps)}, all rows {int(steps.sum())}")
    rows = {}
    for name, kern, ms, plain_ms, host_ms, line in (
            ("cubical_pairs", "cubical_pairs_kernel", t1_ms, t1_plain,
             t1_host, 305),
            ("wasserstein_match", "wasserstein_match_kernel", t2_ms, t2_plain,
             t2_host, 333)):
        bound, bound_by = bounds[name]
        print(f"kernel {name} ({label}): max_abs_err=0 ms={ms:.4f} "
              f"plain_ms={plain_ms:.1f} host_library_ms={host_ms:.3f} "
              f"library_ms=null bound_ms={bound:.6f} ({bound_by}) "
              f"share_of_bound={bound / ms:.6f}")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "dilabhelmholtzoct_tpu_torch/csrc/topology.cu",
            "kernel": kern,
            "replaces": f"dilabhelmholtzoct_tpu/ops/topology_device.py:{line}"
                        " (XLA, no Pallas kernel)",
            "max_abs_err": 0.0 if name == "cubical_pairs" else rel,
            "ms": ms, "plain_ms": plain_ms, "host_library_ms": host_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    return rows


def _blob_grids(rng, n, size):
    """Near-binary (n, size, size) grids: plateaus of 0 and 1 (three
    rectangles each, every other grid's with a hole) with a little noise on
    5% of the pixels, as trained predictions."""
    out = np.zeros((n, size, size), np.float32)
    scale = size / 50
    for i in range(n):
        for _ in range(3):
            dy, dx = (rng.integers(6, 12, 2) * scale).astype(int)
            y, x = rng.integers(0, size - dy), rng.integers(0, size - dx)
            out[i, y:y + dy, x:x + dx] = 1.0
            if i % 2:
                out[i, y + 2:y + dy - 2, x + 2:x + dx - 2] = 0.0
        few = rng.random((size, size)) < 0.05
        out[i][few] = np.clip(out[i][few] + rng.normal(size=few.sum()) * 0.1,
                              0.0, 1.0)
    return out


T1_LARGE_SIZES = (100, 128, 255)  # every one past one block's shared memory
T1_LARGE_INTERP = 128  # topo_interp of the topological phase's global-route
T1_LARGE_STEPS = 2     # steps


def t1_large_phase(torch):
    """T1 on grids past one block's shared memory (its global route): at
    each of ``T1_LARGE_SIZES`` in H0 and H1, 8 grids of sigmoid noise and 8
    of blobs; the route (a 50x50 grid keeps the shared one), the bars,
    counts and cap equal to the host library's, to the plain twin's on 2 of
    the grids, and the same bits on a second run; timed with CUDA events
    beside the bytes bound. Then one T2 launch on the 255x255 noise grids'
    H1 bars, 512 a side: its matching cost against the twin's
    (``TOPO_COST_RTOL``) and its matching equal to the host library's."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    dev = torch.device("cuda")
    k = 512
    for fd in (0, 1):
        check(ptd.t1_scratch_bytes(50, 50, fd) == 0,
              f"a 50x50 grid in H{fd} does not take T1's shared route")
    rng = np.random.default_rng(17)
    for size in T1_LARGE_SIZES:
        noise = 1 / (1 + np.exp(-rng.normal(size=(8, size, size))))
        grids = np.concatenate([noise.astype(np.float32),
                                _blob_grids(rng, 8, size)])
        n = len(grids)
        g = torch.tensor(grids, device=dev)
        host = native.cubical_pairs_batch(grids, k)
        for fd in (0, 1):
            stride = ptd.t1_scratch_bytes(size, size, fd)
            check(stride > 0, f"a {size}x{size} grid in H{fd} does not take "
                              f"T1's global route")
            before = dict(ptd.T1_ROUTES)
            got = ptd.cubical_pairs_cuda(g, fd, k)
            torch.cuda.synchronize()
            check(ptd.T1_ROUTES == {"shared": before["shared"],
                                    "global": before["global"] + 1},
                  f"T1 at {size}x{size}: routes {ptd.T1_ROUTES}, before "
                  f"{before}")
            got_np = [x.cpu().numpy() for x in got]
            check(np.array_equal(host[f"h{fd}_birth"], got_np[0])
                  and np.array_equal(host[f"h{fd}_death"], got_np[1])
                  and np.array_equal(host["counts"][:, fd], got_np[2]),
                  f"T1 H{fd} at {size}x{size}: bars differ from the host "
                  f"library's")
            again = ptd.cubical_pairs_cuda(g, fd, k)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"T1 H{fd} at {size}x{size}: a second run gave other bits")
            pick = [0, 8]  # one noise grid, one blob grid
            t0 = time.perf_counter()
            twin = ptd.cubical_pairs_plain(torch.from_numpy(grids[pick]), fd,
                                           k)
            plain_ms = 1e3 * (time.perf_counter() - t0) / len(pick)
            check(all(np.array_equal(x[pick], y.numpy())
                      for x, y in zip(got_np, twin)),
                  f"T1 H{fd} at {size}x{size}: bars differ from the twin's")
            ms = cuda_ms(lambda: ptd.cubical_pairs_cuda(g, fd, k), 5, 1)
            bound, bound_by = _bound(0, 4 * grids.size + 4 * (2 * n * k + n),
                                     PEAK_F32_FLOPS)
            print(f"T1 global route H{fd}, {n} grids of {size}x{size} (8 "
                  f"noise, 8 blobs; scratch {stride / 2**20:.2f} MiB a grid):"
                  f" bars equal to the host library's and, on 2 grids, the "
                  f"twin's; bars noise {_spread(got_np[2][:8])}, blobs "
                  f"{_spread(got_np[2][8:])}; ms={ms:.4f} "
                  f"plain_ms_per_grid={plain_ms:.1f} bound_ms={bound:.6f} "
                  f"({bound_by}) share_of_bound={bound / ms:.6f}")
        if size != 255:
            continue
        b, d, c = got  # the H1 pass: noise grids 0-3 against noise 4-7
        flat_t = g[4:8].reshape(4, -1)
        true_bars = torch.stack(
            [flat_t.gather(1, b[4:8].clamp(min=0).long()),
             flat_t.gather(1, d[4:8].clamp(min=0).long())], -1).contiguous()
        args = (g[:4].reshape(4, -1).contiguous(), b[:4].contiguous(),
                d[:4].contiguous(), c[:4].clone(), true_bars, c[4:8].clone())
        check(int(c[:8].min()) == k, "the 255x255 noise grids hold fewer "
                                     f"than {k} H1 bars")
        before = ptd.LAUNCHES["wasserstein_match"]
        m, tg, ct = ptd.wasserstein_match_cuda(*args, 2.0)
        torch.cuda.synchronize()
        check(ptd.LAUNCHES["wasserstein_match"] == before + 1,
              "T2 did not launch")
        args_h = tuple(a.cpu() for a in args)
        tw = ptd.wasserstein_match_plain(*args_h, 2.0)
        cost = _match_cost(torch, args[0], args[1], args[2], m, tg, ct)
        cost_twin = _match_cost(torch, args[0], args[1], args[2], *tw)
        rel = float(((cost - cost_twin).abs()
                     / cost_twin.abs().clamp(min=1e-30)).max())
        check(rel <= TOPO_COST_RTOL, f"T2 on 255x255 bars: cost differs "
                                     f"from the twin's by {rel:.3g}")
        hm = native.wasserstein_match_batch(
            *(a.numpy() for a in args_h[:4]),
            [x.numpy() for x in args_h[4]], 2.0, k)
        check(all(np.array_equal(x.cpu().numpy(), y)
                  for x, y in zip((m, tg, ct), hm)),
              "T2 on 255x255 bars: the matching differs from the host "
              "library's")
        print(f"T2 on the H1 bars of 4 + 4 noise grids of 255x255 ({k} a "
              f"side): cost within {rel:.3g} of the twin's (rtol "
              f"{TOPO_COST_RTOL}), matching equal to the host library's")


def components_phase():
    """The component engine of prompt extraction (``csrc/components_host.cc``
    in the host library) against its scipy twins on the 24 label maps of the
    data phases and on one map of ~500 components, above the 256 cap: the
    component map, values, boxes, sizes and total, and the boxes and points
    drawn from one seed, bit for bit; each one's host ms per map (median of
    5, extraction and a point draw)."""
    from dilabhelmholtzoct_tpu_torch.data import sampling
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    maps = [it["label"] for it in (synthetic.oct_training_items(16, seed=1)
                                   + synthetic.oct_training_items(8, seed=2))]
    rng = np.random.default_rng(11)
    above = np.zeros((496, 512), np.uint8)
    for _ in range(600):
        y, x = rng.integers(0, 493), rng.integers(0, 509)
        above[y:y + 3, x:x + 3] = rng.integers(1, 4)
    for lab in maps + [above]:
        got = sampling.extract_components(lab)
        want = sampling.extract_components_plain(lab)
        check(all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(got[:4], want[:4])) and got[4] == want[4],
              "the component engine's extraction differs from the twin's")
        for kind in ("bboxes", "points"):
            a = sampling.prompts_from_extraction(
                got, lab.shape, kind, np.random.default_rng(7))
            b = sampling.prompts_from_extraction_plain(
                want, lab.shape, kind, np.random.default_rng(7))
            check(np.array_equal(a.bboxes, b.bboxes),
                  f"the component engine's {kind} differ from the twin's")
    total = sampling.extract_components(above)[4]
    check(total > sampling.MAX_COMPONENTS, f"the map above the cap holds "
                                           f"{total} components")

    def draw(extract, prompts, lab):
        return lambda: prompts(extract(lab), lab.shape, "points",
                               np.random.default_rng(7))

    times = {}
    for name, ex, pr in (
            ("engine", sampling.extract_components,
             sampling.prompts_from_extraction),
            ("twin", sampling.extract_components_plain,
             sampling.prompts_from_extraction_plain)):
        per_map = [_host_ms(draw(ex, pr, lab)) for lab in maps]
        times[name] = (statistics.median(per_map),
                       _host_ms(draw(ex, pr, above)))
    print(f"component engine (host library built or loaded in {build_s:.1f} "
          f"s): extraction and point draws bit-equal to the scipy twins on "
          f"{len(maps)} maps of 496x512 and one of {total} components (cap "
          f"{sampling.MAX_COMPONENTS}); host ms per map (median of 5; median "
          f"over the {len(maps)} maps / the map above the cap): engine "
          f"{times['engine'][0]:.3f} / {times['engine'][1]:.3f}, twin "
          f"{times['twin'][0]:.3f} / {times['twin'][1]:.3f}")


def topo_phase(torch):
    """Decoder fine-tuning with the topological loss: bf16, ViT-B (full
    width), cached embeddings of 8 images x bucket 8 (64 pairs), topo_interp
    50, lambda 0.1, H1 (the JAX defaults). T1 / T2 against their twins and
    the host library on the step's own grids and on 64 pred and 64 true
    grids of 50x50 sigmoid noise; ``TOPO_STEPS`` steps of each mode from the same weights:
    ``topo_device`` (each step K3 x1, K4 x2, T1 x1 and T2 x1, exactly), the
    host modes, synchronous and pipelined (with ``flush``; no T1 / T2), and
    the same steps without the term; the first-step losses of the device
    and the sync host mode within ``TOPO_LOSS_RTOL``; one device-mode step
    on the card against the CPU (``card_vs_cpu``). Returns (the result
    line's rows, the device mode's launch counts)."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.data.sampling import (
        gt_masks_from_comp_map)
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.ops.topology import downsample_grid
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    config = tr.TrainConfig(evaluate=False, batch_size=8, topological=True,
                            topo_interp=50, topo_lamda=0.1, topo_feat_d=1)
    orig_hw = (496, 512)
    ds = PromptedDataset(synthetic.oct_training_items(8, seed=1), seed=0)
    sd = {k: v.to(dev) for k, v in sd_host.items()}
    emb = tr.precompute_embeddings(sd, cfg, ds, dtype=bf16, verbose=False)
    batch = list(batches(ds, 8, with_images=False, num_workers=2))[0]
    check(batch["channel_mask"].shape == (8, 8)
          and batch["channel_mask"].min() == 1, "the batch is not 8 x bucket 8")
    db = _device_batch(torch, batch, dev, emb)

    # the grids the first step pairs (its forward, at the initial weights)
    decoder, frozen = tr._split_params(sd)
    with torch.no_grad(), full_fp32():
        masks = tr._forward_from_embeddings(
            tr._cast_floats(decoder, bf16),
            tr._cast_floats(tr._prompt_entries(frozen), bf16), cfg,
            db["embeddings"], db, orig_hw, config.prompt_type)
        gt = gt_masks_from_comp_map(db["comp_map"], masks.shape[1])
        sp = downsample_grid(torch.sigmoid(masks.float()), 50).reshape(
            -1, 50, 50)
        st = downsample_grid(gt, 50).reshape(-1, 50, 50)
    del sd, decoder, frozen, masks
    rows = topo_kernel_checks(torch, sp, st, "the step's grids")
    # both diagrams large (hundreds of bars a side): T2's loaded matching
    gen = torch.Generator(device=dev).manual_seed(5)
    noise = torch.sigmoid(torch.randn((2, 64, 50, 50), generator=gen,
                                      device=dev))
    topo_kernel_checks(torch, noise[0], noise[1],
                       "64 pred and 64 true grids of 50x50 sigmoid noise",
                       feat_ds=(0, 1), t2_runs=5, t2_warmup=1)

    def fresh(device, conf=config):
        sd_m = {k: v.to(device, copy=True) for k, v in sd_host.items()}
        decoder, frozen = tr._split_params(sd_m)
        for v in decoder.values():
            v.requires_grad_(True)
        return sd_m, decoder, frozen, tr.make_optimizer(conf, decoder.values())

    modes = (("device", dict(topo_device=True)),
             ("host sync", dict(topo_device=False, topo_pipeline=False)),
             ("host pipelined", dict(topo_device=False, topo_pipeline=True)),
             ("no topological term", dict(topological=False)))
    out = {}
    for mode, kw in modes:
        conf = dataclasses.replace(config, **kw)
        _, decoder, frozen, opt = fresh(dev, conf)
        step = tr.make_train_step(cfg, conf, opt, orig_hw, True)
        want = TOPO_STEP_LAUNCHES if mode == "device" else STEP_LAUNCHES
        if mode == "host pipelined":  # each call also runs the next
            # batch's forward for its grids (K3 x1, K4 x2); the first call
            # only that
            grids_fwd = {**dict.fromkeys(want, 0), "upscale_fwd": 1,
                         "i2t_fwd": 2}
            want = {k: v + grids_fwd[k] for k, v in want.items()}
        losses, times = [], []
        torch.cuda.synchronize()
        _reset_counts()  # --- main path starts
        for i in range(TOPO_STEPS):
            if hasattr(step, "set_host_batch"):
                step.set_host_batch(batch)
            before = _counts()
            t0 = time.perf_counter()
            decoder, opt, loss = step(decoder, opt, frozen, db)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            d = _delta(_counts(), before)
            first_deferred = mode == "host pipelined" and i == 0
            check(d == (grids_fwd if first_deferred else want),
                  f"{mode} step {i} launched {d}")
            check((loss is None) == first_deferred,
                  f"{mode} step {i} returned loss {loss}")
            if loss is not None:
                losses.append(float(loss))
        if hasattr(step, "flush"):
            before = _counts()
            decoder, opt, loss = step.flush(decoder, opt, frozen)
            d = _delta(_counts(), before)
            check(d == STEP_LAUNCHES, f"flush launched {d}")
            losses.append(float(loss))
        launches = _counts()  # --- main path ends
        check(len(losses) == TOPO_STEPS and all(np.isfinite(losses)),
              f"{mode}: losses {losses}")
        check(losses[-1] < losses[0], f"{mode}: the loss did not fall: "
                                      f"{losses}")
        med = statistics.median(times[1:])
        out[mode] = (losses, med, launches)
        print(f"topological decoder fine-tune ViT-B bf16, 8 images x bucket "
              f"8 (64 pairs), interp 50, lambda 0.1, H1, mode {mode}: losses "
              f"{[round(x, 6) for x in losses]}; step ms first "
              f"{times[0]:.1f}, median of steps 2-{TOPO_STEPS} {med:.2f} "
              f"({8e3 / med:.1f} img/s), all {[round(t, 1) for t in times]}")
        del decoder, frozen, opt, step
        torch.cuda.empty_cache()
    l_dev, l_sync = out["device"][0][0], out["host sync"][0][0]
    rel = abs(l_dev - l_sync) / abs(l_sync)
    print(f"topological step, device mode against host sync mode: first-step "
          f"loss {l_dev:.8f} vs {l_sync:.8f} (rel {rel:.3g}, rtol "
          f"{TOPO_LOSS_RTOL}); median step ms: device {out['device'][1]:.2f}, "
          f"host sync {out['host sync'][1]:.2f}, host pipelined "
          f"{out['host pipelined'][1]:.2f}, without the term "
          f"{out['no topological term'][1]:.2f}")
    check(rel <= TOPO_LOSS_RTOL,
          "the device and host sync modes' first-step losses differ")
    launches = out["device"][2]
    check(launches["cubical_pairs"] == launches["wasserstein_match"]
          == TOPO_STEPS, f"device mode launches {launches}")
    check(out["host pipelined"][0][0] == l_sync,
          "the pipelined first step differs from the sync first step")

    # topo_interp past one block's shared memory: T1's global route on the
    # step's 64 + 64 grids of T1_LARGE_INTERP^2
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    conf = dataclasses.replace(config, topo_interp=T1_LARGE_INTERP)
    _, decoder, frozen, opt = fresh(dev, conf)
    step = tr.make_train_step(cfg, conf, opt, orig_hw, True)
    routes = dict(ptd.T1_ROUTES)
    losses, times = [], []
    for i in range(T1_LARGE_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        decoder, opt, loss = step(decoder, opt, frozen, db)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        d = _delta(_counts(), before)
        check(d == TOPO_STEP_LAUNCHES, f"interp {T1_LARGE_INTERP} step {i} "
                                       f"launched {d}")
        losses.append(float(loss))
    check(ptd.T1_ROUTES == {"shared": routes["shared"],
                            "global": routes["global"] + T1_LARGE_STEPS},
          f"interp {T1_LARGE_INTERP}: T1 routes {ptd.T1_ROUTES}, before "
          f"{routes}")
    check(all(np.isfinite(losses)), f"interp {T1_LARGE_INTERP}: losses "
                                    f"{losses}")
    print(f"topological decoder fine-tune, device mode at interp "
          f"{T1_LARGE_INTERP} (T1's global route on 128 grids of "
          f"{T1_LARGE_INTERP}x{T1_LARGE_INTERP} a step): losses "
          f"{[round(x, 6) for x in losses]}, step ms "
          f"{[round(t, 1) for t in times]}, T1 launches "
          f"{T1_LARGE_STEPS} on the global route")
    del decoder, frozen, opt, step
    card_vs_cpu(torch, tr, cfg, config, sd_host, fresh, ds, emb, orig_hw)
    del emb, db
    torch.cuda.empty_cache()
    return rows, launches


def sign_agreement(torch, d_cpu, d_card, lr):
    """(share, count) of the weights the CPU step moved (by more than 1e-3
    of the learning rate: Adam's first step moves each by ~lr) that the
    card's step moved the same way."""
    agree = total = 0
    for k, dc in d_cpu.items():
        moved = dc.abs() > 1e-3 * lr
        agree += int((torch.sign(dc) == torch.sign(d_card[k]))[moved].sum())
        total += int(moved.sum())
    return agree / max(total, 1), total


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
    share, total = sign_agreement(torch, d_cpu, d_card, config.learning_rate)
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


DATA_OPS = ("hflip", "vflip", "brightness", "contrast", "gaussian_noise",
            "shift")
# the port's bf16 kernels on the uncached step: one of them must appear in
# the epoch-0 trace for it to be the card's
TRACE_KERNELS = ("attn_relpos_wgmma_kernel", "i2t_fwd_wgmma_kernel",
                 "upscale_fwd_wgmma_kernel")


def _same_batches(built, ref, what):
    check(len(built) == len(ref), f"{what}: {len(built)} batches, want "
                                  f"{len(ref)}")
    for i, (b, r) in enumerate(zip(built, ref)):
        check(set(b) == set(r), f"{what} batch {i}: keys {sorted(b)}")
        for k in r:
            check(b[k].dtype == r[k].dtype and b[k].shape == r[k].shape
                  and np.array_equal(b[k], r[k]),
                  f"{what} batch {i}: {k} differs from the CPU dataset's")


def _trace_kernels(trace_dir):
    """(file, size in bytes, {port kernel name: events}) of the one trace
    under trace_dir."""
    files = os.listdir(trace_dir)
    check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
          f"profile_dir holds {files}, want one trace of epoch 0")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = dict.fromkeys(TRACE_KERNELS, 0)
    for e in events:
        if e.get("cat") == "kernel":
            for k in TRACE_KERNELS:
                found[k] += k in e.get("name", "")
    return files[0], os.path.getsize(path), found


def data_path_phase(torch):
    """The training run from raw items at full ViT-B width and depth, bf16,
    the encoder inside the step (``cache_embeddings=False``), with every
    data option: augmentation, the 'Jet' colormap, sample display and the
    epoch-0 trace; then the host batches against a CPU dataset, the
    augmented step on the card against the CPU (2-layer cut), and prompt
    mask inputs on the card against the CPU. Returns the run's launches."""
    from dilabhelmholtzoct_tpu_torch.data.augment import make_augmenter
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    train_items = synthetic.oct_training_items(16, seed=1)
    valid_items = synthetic.oct_training_items(8, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(sd_host, ckpt)
        config = tr.TrainConfig(
            checkpoint=os.path.join(tmp, "ck"), display_name="data",
            pretrained_checkpoint=ckpt, epochs=2, batch_size=4,
            evaluate=False, ckpt_keep=1, cache_embeddings=False,
            data_transforms=DATA_OPS, pseudocolor="Jet",
            display_mode="predefined", display_idx=(0, 1),
            profile_dir=os.path.join(tmp, "trace"),
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        built = []  # (dataset, batches() keywords, batch) the run's loader made

        def recording(ds, batch_size, **kw):
            for b in batches(ds, batch_size, **kw):
                built.append((ds, kw, b))
                yield b

        tr.batches = recording
        torch.cuda.synchronize()
        _reset_counts()  # --- data path starts
        t0 = time.perf_counter()
        try:
            result = tr.training(config, splits=(train_items, valid_items))
        finally:
            tr.batches = batches
        torch.cuda.synchronize()
        got = _counts()  # --- data path ends
        run_s = time.perf_counter() - t0

        bs = config.batch_size
        steps = config.epochs * -(-len(train_items) // bs)
        vsteps = config.epochs * -(-len(valid_items) // bs)
        chunks = -(-bs // config.encoder_microbatch)  # encodes per batch
        shown = (config.epochs + 1) * 2 * len(config.display_idx)
        encodes = (steps + vsteps) * chunks + shown
        want = {**dict.fromkeys(got, 0),
                "attn_global": 4 * encodes, "attn_windowed": 8 * encodes,
                "upscale_fwd": steps + vsteps, "upscale_bwd": steps,
                "upscale_bwd_dw": steps, "i2t_fwd": 2 * (steps + vsteps),
                "i2t_bwd": 2 * steps, "i2t_bwd_dw": 2 * steps}
        print(f"data path (ViT-B bf16, uncached, {len(DATA_OPS)} "
              f"augmentations, 'Jet', display, trace): {steps} train steps + "
              f"{vsteps} valid batches of {bs}, {shown} f32 display encodes, "
              f"launches {got} in {run_s:.1f} s")
        check(got == want, f"the data path launched {got}, want {want}")
        hist = result["history"]
        check([h["epoch"] for h in hist] == [0, 1]
              and all(np.isfinite([h["train_loss"] for h in hist]))
              and all(np.isfinite([h["valid_loss"] for h in hist])),
              f"data path epochs {hist}")

        name, size, found = _trace_kernels(config.profile_dir)
        print(f"epoch-0 trace {name}: {size / 2**20:.1f} MiB, port kernel "
              f"events {found}")
        check(any(found.values()), "the trace names none of the port's "
                                   "kernels: it is not the card's")

        disp = os.path.join(result["checkpoint_dir"], "display")
        try:
            from PIL import Image
        except ImportError:
            Image = None
            print(f"PIL absent: no display panels written ({shown} display "
                  f"inferences ran on the card, counted above)")
        if Image is not None:
            names = sorted(f"{s}_e{e}_i{i}.png" for s in ("train", "test")
                           for e in range(-1, config.epochs)
                           for i in config.display_idx)
            check(sorted(os.listdir(disp)) == names,
                  f"display panels {sorted(os.listdir(disp))}")
            for n in names:
                shape = np.asarray(Image.open(os.path.join(disp, n))).shape
                check(shape == (496, 1536, 3), f"{n} has shape {shape}")
            print(f"display panels {len(names)} of (496, 1536, 3)")

        perf = []
        with open(config.log_jsonl) as f:
            for line in f:
                rec = json.loads(line)
                if "perf/train/step_ms_p50" in rec:
                    perf.append(rec["perf/train/step_ms_p50"])
        check(len(perf) == config.epochs, f"step timings {perf}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(f"uncached augmented bf16 step, ViT-B, batch {bs} (4 encodes + "
              f"{bs} x bucket 8 decoder pairs): median {perf[-1]:.2f} ms "
              f"({bs * 1e3 / perf[-1]:.1f} img/s) over epoch {config.epochs - 1}"
              f"'s steps 2-{steps // config.epochs} (epoch 0 under the trace "
              f"{perf[0]:.2f} ms); {smi}")

    # the host batches against a second dataset with the same options
    train_ref = PromptedDataset(train_items, prompt_type=config.prompt_type,
                                pseudocolor="Jet", seed=config.seed,
                                augment=make_augmenter(DATA_OPS))
    valid_ref = PromptedDataset(valid_items, prompt_type=config.prompt_type,
                                pseudocolor="Jet", seed=config.seed + 1)
    runs = {}
    for ds, kw, b in built:
        runs.setdefault((ds.augment is not None, kw["epoch"]),
                        (kw, []))[1].append(b)
    check(sorted(runs) == [(a, e) for a in (False, True)
                           for e in range(config.epochs)],
          f"loader runs {sorted(runs)}")
    for (aug, epoch), (kw, got_b) in sorted(runs.items()):
        ref = list(batches(train_ref if aug else valid_ref, bs, **kw))
        _same_batches(got_b, ref, f"{'train' if aug else 'valid'} epoch "
                                  f"{epoch}")
    n_b = sum(len(v[1]) for v in runs.values())
    print(f"host batches: {n_b} batches of the run byte-equal to a CPU "
          f"PromptedDataset's (images, prompts, component maps, masks, "
          f"indices)")

    # the augmented step, card against CPU, at a 2-layer cut
    cfg2 = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, num_layers=2, global_attn_indexes=(1,)))
    sd2 = synthetic.random_params(cfg2, seed=1)
    b0 = runs[(True, 0)][1][0]
    b2 = {k: b0[k][:2] for k in ("image", "prompts", "comp_map",
                                 "channel_mask")}
    out = {}
    for name, device in (("card", torch.device("cuda")),
                         ("cpu", torch.device("cpu"))):
        decoder, frozen = tr._split_params({k: v.to(device, copy=True)
                                            for k, v in sd2.items()})
        for v in decoder.values():
            v.requires_grad_(True)
        opt = tr.make_optimizer(config, decoder.values())
        step = tr.make_train_step(cfg2, config, opt, (496, 512), False)
        t0 = time.perf_counter()
        decoder, opt, loss = step(decoder, opt, frozen,
                                  _device_batch(torch, b2, device))
        out[name] = (float(loss), {k: (v.detach().cpu() - sd2[k])
                                   for k, v in decoder.items()})
        print(f"augmented step on the {name}: "
              f"{time.perf_counter() - t0:.1f} s")
    (l_card, d_card), (l_cpu, d_cpu) = out["card"], out["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    share, total = sign_agreement(torch, d_cpu, d_card, config.learning_rate)
    print(f"card vs cpu, augmented uncached bf16 step on 2 images x bucket "
          f"8, ViT-B width, depth cut to 2 layers: loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (rel {rel:.3g}, rtol {STEP_LOSS_RTOL}); update signs "
          f"agree on {share:.4f} of {total} moved weights (min "
          f"{SIGN_AGREE_MIN})")
    check(rel <= STEP_LOSS_RTOL, "card and CPU augmented step losses differ")
    check(share >= SIGN_AGREE_MIN, "card and CPU augmented updates disagree "
                                   "in sign")
    mask_inputs_check(torch, cfg, sd_host)
    return got


def points_bone_phase(torch):
    """BASELINE config 3 in training: ``training()`` at full ViT-B width and
    depth, bf16, cached embeddings, ``prompt_type='points'`` and
    ``pseudocolor='Bone'``, 16 train + 8 valid synthetic items, batch 8, 1
    epoch of 2 steps. The launches exactly: the precompute's K1 x4 and K2 x8
    per image of both splits, K3 x1 and K4 x2 forward and backward a train
    step, their forwards on the valid batch; finite losses; the component
    engine's extraction (once per item) and point picks (once per item and
    epoch) on the run's host path. Returns the run's launches."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    splits = (synthetic.oct_training_items(16, seed=1),
              synthetic.oct_training_items(8, seed=2))
    calls = {"extract_components": 0, "component_pixel_at": 0}
    wrapped = {}

    def counting(name):
        fn = getattr(native, name)

        def call(*a, **kw):
            calls[name] += 1  # under the GIL: the loader's threads
            return fn(*a, **kw)
        return fn, call

    for name in calls:
        wrapped[name], call = counting(name)
        setattr(native, name, call)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "weights.pt")
            torch.save(sd_host, ckpt)
            config = tr.TrainConfig(
                checkpoint=os.path.join(tmp, "ck"), display_name="points",
                pretrained_checkpoint=ckpt, epochs=1, batch_size=8,
                evaluate=False, ckpt_keep=1, prompt_type="points",
                pseudocolor="Bone", log_jsonl=os.path.join(tmp, "m.jsonl"))
            torch.cuda.synchronize()
            _reset_counts()  # --- config 3 starts
            t0 = time.perf_counter()
            result = tr.training(config, splits=splits)
            torch.cuda.synchronize()
            got = _counts()  # --- config 3 ends
            run_s = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(native, name, fn)
    images = len(splits[0]) + len(splits[1])
    steps = len(splits[0]) // config.batch_size
    vsteps = -(-len(splits[1]) // config.batch_size)
    want = {**dict.fromkeys(got, 0),
            "attn_global": 4 * images, "attn_windowed": 8 * images,
            "upscale_fwd": steps + vsteps, "upscale_bwd": steps,
            "upscale_bwd_dw": steps, "i2t_fwd": 2 * (steps + vsteps),
            "i2t_bwd": 2 * steps, "i2t_bwd_dw": 2 * steps}
    hist = result["history"]
    print(f"config 3 (ViT-B bf16, cached, points, 'Bone'): training() "
          f"{steps} train steps + {vsteps} valid batch of "
          f"{config.batch_size}, history {hist}, launches {got} in "
          f"{run_s:.1f} s; component engine calls {calls}")
    check(got == want, f"config 3 launched {got}, want {want}")
    check(len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
          and np.isfinite(hist[0]["valid_loss"]), f"config 3 epochs {hist}")
    check(calls["extract_components"] == images
          and calls["component_pixel_at"] >= images,
          f"config 3's host path made engine calls {calls}")
    return got


def mask_inputs_check(torch, cfg, sd_host):
    """``sam_forward`` at ViT-B, f32, from a cached embedding with a box and
    a (1, 256, 256, 1) mask input, on the card against the CPU (the
    probabilities within ``PROB_ATOL``); the dense embedding differs from the
    no-mask row; the same forward in bf16 is finite."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models import sam as psam

    rng = np.random.default_rng(7)
    g = cfg.prompt.image_embedding_size
    emb = rng.normal(size=(1, g, g, cfg.prompt.hidden_size)).astype(np.float32)
    masks = (rng.normal(size=(1, 4 * g, 4 * g, 1)) * 3).astype(np.float32)
    boxes = np.asarray([[synthetic.BOX]], np.float32) * 2  # 1024 frame
    out = {}
    for name, device in (("card", torch.device("cuda")),
                         ("cpu", torch.device("cpu"))):
        sd = {k: v.to(device) for k, v in sd_host.items()
              if not k.startswith("vision_encoder.")}
        args = dict(image_embeddings=torch.tensor(emb, device=device),
                    boxes=torch.tensor(boxes, device=device),
                    mask_inputs=torch.tensor(masks, device=device))
        with torch.no_grad(), full_fp32():
            fwd = psam.sam_forward(sd, cfg, **args)
            _, dense = psam.encode_prompts(sd, cfg, 1,
                                           mask_inputs=args["mask_inputs"])
        out[name] = (torch.sigmoid(fwd["pred_masks"]).cpu().numpy(),
                     (dense - sd["prompt_encoder.no_mask_embed.weight"][0])
                     .abs().max().item())
        if name == "card":
            sd16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
            with torch.no_grad():
                fwd16 = psam.sam_forward(sd16, cfg, **{
                    k: v.to(torch.bfloat16) if k != "boxes" else v
                    for k, v in args.items()})
            finite16 = bool(torch.isfinite(fwd16["pred_masks"].float()).all())
    diff = float(np.abs(out["card"][0] - out["cpu"][0]).max())
    print(f"mask inputs, ViT-B f32 from a cached embedding: max |p_card - "
          f"p_cpu| {diff:.3g} (atol {PROB_ATOL}); max |dense - no-mask row| "
          f"{out['card'][1]:.3g}; bf16 forward finite {finite16}")
    check(out["card"][0].shape == (1, 1, 1, 4 * g, 4 * g),
          f"mask-input masks of shape {out['card'][0].shape}")
    check(diff <= PROB_ATOL, "mask-input probabilities differ from the CPU")
    check(out["card"][1] > 1e-2 and out["cpu"][1] > 1e-2,
          "the dense embedding is the no-mask row: the mask branch did not "
          "run")
    check(finite16, "the bf16 mask-input forward is not finite")


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
    that requires grad (the f32 kernels' time includes their pre-pass,
    whose device time and the kernel's the profiler gives beside it).
    Returns the result-line rows of the global layer: bf16 under the
    kernels' names (the full fine-tune path), f32 (split TF32 on wgmma) as
    ``attn_bwd_dq_f32`` / ``attn_bwd_dkv_f32``."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(3)
    heads, rows = 12, {}
    src = {"bf16": "dilabhelmholtzoct_tpu_torch/csrc/attention_bwd.cu",
           "f32": "dilabhelmholtzoct_tpu_torch/csrc/"
                  "attention_bwd_wgmma_tf32.cu"}
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
                if f32:  # device time: each kernel and its pre-pass
                    for k, fn in (("dq", attn.attention_bwd_dq_cuda),
                                  ("dkv", attn.attention_bwd_dkv_cuda)):
                        dev = device_ms_by_kernel(
                            lambda: fn(*args, **kw),
                            (f"attn_bwd_{k}_wgmma_tf32_kernel",
                             f"{k}_images_kernel"), reps=iters)
                        print(f"kernel attn_bwd_{k} {kind} f32 B={b_time}: "
                              "device ms " + ", ".join(
                                  f"{n} {v:.4f}" if v is not None else
                                  f"{n} not measured"
                                  for n, v in dev.items()))
                plain_ms = cuda_ms(lambda: attn.packed_attention_bwd_plain(
                    *args[:6], **kw), 2)
                lib_ms = _sdpa_bwd_ms(torch, qkv, rel_h, rel_w, g, hw, heads)
            for k in ("dq", "dkv"):
                bound, bound_by = k5_bound_ms(k, b_time, hw[0] * hw[1], heads,
                                              hw, qkv.element_size(), peak)
                row = {"name": f"attn_bwd_{k}" + ("_f32" if f32 else ""),
                       "route": "cuda", "source": src[tname],
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
                      compute_dtype="bfloat16", want=None):
    """``n_steps`` full fine-tune steps (trainable='all', encoder inside) on
    one batch of ``bs`` images in ``compute_dtype``; checks every step's
    launch deltas (``want``, by default ``ft_launches``), a finite loss and
    a moved patch embedding. Returns (launch counts of the run, losses,
    median step ms of steps 2 on, peak memory bytes)."""
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
    want = ft_launches(cfg, compute_dtype) if want is None else want
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
    return launches, losses, med, peak


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
    launches, losses, _, _ = full_finetune_run(torch, tr, cfg, sd_host,
                                               items, 4, 10, "ViT-B")
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
    launches, losses, _, _ = full_finetune_run(torch, tr, cfg, sd_host,
                                               items, 4, 5, "ViT-B",
                                               "float32")
    check(losses[-1] < losses[0], f"ViT-B f32: the loss did not fall: "
                                  f"{losses}")
    finetune_card_vs_cpu(torch, tr, cfg, "float32")
    return launches


def finetune_card_vs_cpu(torch, tr, cfg, compute_dtype="bfloat16"):
    """The first full fine-tune step on 1 image, at the width of ``cfg``
    (ViT-B, or ViT-H under ``set_flash_attention('off')``) with the depth
    cut to 2 layers (one windowed, one global) so that the host can
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
    share, total = sign_agreement(torch, d_cpu, d_card, config.learning_rate)
    print(f"card vs cpu, first full fine-tune {tname} step on 1 image x "
          f"bucket 8, width {cfg.vision.hidden_size}, depth cut to 2 layers "
          f"(layer 0 windowed, layer 1 global) of {cfg.vision.num_layers}: "
          f"loss {l_card:.8f} vs {l_cpu:.8f} (rel "
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
    model's and at head dims whose rows the kernels pad (20: padded to 32
    with zeros by the wrapper; 48), f32 (within ``F32_REL`` of max |plain|)
    and bf16, and the same bits on a second run, timed beside its bound,
    the plain version and SDPA; returns the result-line rows of the ViT-H
    global and windowed layers: f32 (serving's type) and bf16 (the
    precompute's)."""
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
                tol = f32_rel_tol(ref) if f32 else kernel_tol(ref)
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
                             + ("attention_relpos_wgmma_tf32.cu" if f32 else
                                "attention_relpos_wgmma.cu"),
                   "kernel": ("attn_relpos_wgmma_tf32_kernel" if f32 else
                              "attn_relpos_wgmma_kernel"),
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
    windows (K2 runs on the wgmma bodies and K7 on mma.sync: within the
    kernels' tolerance, ``kernel_tol``, in both types) at ViT-B and on
    a ragged grid, f32 and bf16, timed beside K2's bound; then one ViT-B
    layer's windowed attention through both routes. Returns the
    result-line row (ViT-B, f32)."""
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
                k2_err = (out.float() - k2.float()).abs().max().item()
                check(k2_err <= tol,
                      f"attn_windowed_image {label} {tname} is not close to "
                      f"K2 on the partitioned windows (max |K7 - K2| "
                      f"{k2_err:.3g} > {tol:.3g})")
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
                  f"max_abs_err={err:.3g} (limit {tol:.3g}) max |K7 - K2| "
                  f"{k2_err:.3g}; "
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


DP_STEPS = 5  # steps of each rank and of the single process in dp_phase
DP_LOSS_RTOL = 1e-3  # two ranks vs one process, bf16 decoder step: each
#                      rank's GEMMs see half the rows, so f32 sums run in
#                      another order and a few bf16 roundings flip
DP_GRAD_RTOL = 1e-2  # the same, the whole decoder gradient: L2 error over
#                      its norm. The gradient of a weight's bf16 copy is
#                      rounded to bf16 on each rank's partial sum, and on
#                      the whole batch's in one process (2^-8 relative
#                      each); partials that cancel move single elements
#                      more, and the gradients that are zero but for
#                      rounding (the key projections' biases: softmax
#                      ignores a constant per row) are noise, so no
#                      per-element bound holds
DP_SIGN_AGREE_MIN = 0.99  # the same, share of the weights Adam's first
#                           step moved that move the same way


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def dp_step_run(torch, data, batch, dev):
    """``DP_STEPS`` bf16 decoder steps (the trainer's Adam, lr 1e-3) at ViT-B
    from
    ``data``'s weights and embeddings on ``batch`` (host arrays, pad rows
    with the -1 sentinel), on ``dev``: in a process group each on this
    rank's rows. Each step must launch ``STEP_LAUNCHES``. Returns the first
    step's loss, gradients (summed over the ranks) and updated decoder, and
    the median of steps 2 on (ms)."""
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    config = tr.TrainConfig(evaluate=False)  # bf16, Adam, lr 1e-3
    sd = {k: v.to(dev, copy=True) for k, v in data["sd"].items()}
    decoder, frozen = tr._split_params(sd)
    for v in decoder.values():
        v.requires_grad_(True)
    opt = tr.make_optimizer(config, decoder.values())
    idx = torch.as_tensor(np.maximum(batch["indices"], 0),
                          dtype=torch.long).to(dev)
    db = {k: torch.as_tensor(batch[k]).to(dev)
          for k in ("prompts", "comp_map", "channel_mask")}
    db["embeddings"] = data["emb"].to(dev).index_select(0, idx)
    step = tr.make_train_step(cfg, config, opt, (496, 512), True)
    times, first = [], None
    for i in range(DP_STEPS):
        before = _counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        decoder, opt, loss = step(decoder, opt, frozen, db)
        torch.cuda.synchronize(dev)
        times.append(1e3 * (time.perf_counter() - t0))
        d = _delta(_counts(), before)
        check(d == STEP_LAUNCHES, f"DP step {i} on {dev} launched {d}, "
                                  f"want {STEP_LAUNCHES}")
        if i == 0:
            first = (float(loss), {k: v.grad.cpu() for k, v in decoder.items()},
                     {k: v.detach().cpu() for k, v in decoder.items()})
    return {"loss": first[0], "grads": first[1], "params": first[2],
            "ms": statistics.median(times[1:]), "launches": _counts()}


def dp_worker(argv):
    """One rank of ``dp_phase``'s two-rank step (``chip_smoke.py --dp-worker
    <rank> <port> <backend> <dir>``): joins the group, takes its rows of the
    padded batch in ``<dir>/inputs.pt`` and writes ``<dir>/rank<r>.pt``."""
    import torch

    from dilabhelmholtzoct_tpu_torch.parallel import distributed as dist
    from dilabhelmholtzoct_tpu_torch.parallel import mesh

    rank, port, backend, tmp = int(argv[0]), argv[1], argv[2], argv[3]
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    os.environ["LOCAL_RANK"] = str(dev.index)
    check(dist.initialize(f"localhost:{port}", 2, rank, backend=backend),
          "no group of two")
    try:
        data = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        padded, _ = mesh.pad_to_multiple(data["batch"], 2)
        _reset_counts()
        out = dp_step_run(torch, data, mesh.shard_batch(padded), dev)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def _dp_pair(torch, tmp, backend):
    """Run the two ranks of ``backend`` as processes; their results."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         port, backend, tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{backend} rank {r} failed (rc "
                                 f"{p.returncode}):\n{out[-4000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in (0, 1)]


DP_ORACLE_ULPS = 4  # the two ranks' all-reduced gradient against each
#                    rank's gradient computed in one process and summed in
#                    f32 in rank order: the same bf16 arithmetic on the same
#                    rows, so equal but for the sum's order (none for two)


def dp_rank_oracle(torch, data, padded, dev):
    """The two-rank step's first gradient computed in this process: each
    rank's rows of the padded batch through ``dp_step_run`` with no group,
    its loss over the global batch's denominators (every ``global_count``
    answers the sum of the two ranks' values, in rank order, each recorded
    from a first pass over that rank's rows) and no all-reduce; the two
    gradients summed in f32, rank 0's first. Returns {name: gradient}."""
    from dilabhelmholtzoct_tpu_torch.ops import losses
    from dilabhelmholtzoct_tpu_torch.parallel import distributed as dist

    half = next(iter(padded.values())).shape[0] // 2
    rows = [{k: v[r * half:(r + 1) * half] for k, v in padded.items()}
            for r in (0, 1)]
    seen = [[], []]
    state = {"rank": 0, "replay": False, "i": 0}

    def global_count(x):
        if not state["replay"]:
            seen[state["rank"]].append(x.detach().clone())
            return x
        i = state["i"]
        state["i"] += 1
        return seen[0][i] + seen[1][i]

    saved = (dist.is_initialized, dist.global_count, dist.all_reduce_sum_,
             losses.global_count)
    dist.is_initialized = lambda: True
    dist.global_count = losses.global_count = global_count
    dist.all_reduce_sum_ = lambda tensors: None
    grads = []
    try:
        for replay in (False, True):
            for r in (0, 1):
                state.update(rank=r, replay=replay, i=0)
                out = dp_step_run(torch, data, rows[r], dev)
                if replay:
                    grads.append(out["grads"])
    finally:
        (dist.is_initialized, dist.global_count, dist.all_reduce_sum_,
         losses.global_count) = saved
    check(len(seen[0]) == len(seen[1]) > 0,
          f"the ranks' denominators differ in number: {len(seen[0])} / "
          f"{len(seen[1])}")
    return {k: grads[0][k] + grads[1][k] for k in grads[0]}


def _dp_compare(torch, ranks, single, before, label, oracle):
    """Both ranks against each other (bit for bit), against the
    single-process full-batch step from the weights ``before``, and their
    gradient against ``oracle`` (``dp_rank_oracle``) within
    ``DP_ORACLE_ULPS`` f32 ulps per element."""
    r0, r1 = ranks
    check(r0["loss"] == r1["loss"] and all(
        torch.equal(r0[part][k], r1[part][k]) for part in ("grads", "params")
        for k in r0["params"]), f"{label}: the ranks disagree")
    rel = abs(r0["loss"] - single["loss"]) / abs(single["loss"])
    keys = list(single["grads"])
    g1 = torch.cat([single["grads"][k].flatten() for k in keys])
    g2 = torch.cat([r0["grads"][k].flatten() for k in keys])
    g_rel = ((g2 - g1).norm() / g1.norm()).item()
    share, total = sign_agreement(
        torch, {k: single["params"][k] - before[k] for k in keys},
        {k: r0["params"][k] - before[k] for k in keys}, 1e-3)
    print(f"DP {label}: loss {r0['loss']:.6f} vs one process "
          f"{single['loss']:.6f} (rel {rel:.3g}, rtol {DP_LOSS_RTOL}); "
          f"gradient L2 error {g_rel:.3g} of its norm (limit {DP_GRAD_RTOL});"
          f" update signs agree on {share:.5f} of {total} moved weights (min "
          f"{DP_SIGN_AGREE_MIN}); step ms per rank {r0['ms']:.2f} / "
          f"{r1['ms']:.2f} (median of steps 2-{DP_STEPS}) vs one process "
          f"{single['ms']:.2f}; launches per rank {r0['launches']}")
    check(rel <= DP_LOSS_RTOL, f"{label}: loss differs from one process")
    check(g_rel <= DP_GRAD_RTOL, f"{label}: gradients differ from one process")
    check(share >= DP_SIGN_AGREE_MIN,
          f"{label}: updates differ in sign from one process")
    o = torch.cat([oracle[k].flatten() for k in keys])
    mag = o.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    diff = (g2 - o).abs()
    worst = float((diff / ulp).max())
    print(f"DP {label}: gradient against the per-rank oracle (each rank's "
          f"rows in one process, global denominators, summed in f32): max "
          f"|difference| {float(diff.max()):.3g}, {worst:.3g} f32 ulps of the "
          f"element (limit {DP_ORACLE_ULPS}); {int((diff > 0).sum())} of "
          f"{o.numel()} elements differ")
    check(worst <= DP_ORACLE_ULPS,
          f"{label}: gradient differs from the per-rank oracle by {worst:.3g}"
          f" ulps")
    for r in ranks:
        check(r["launches"] == {k: DP_STEPS * v
                                for k, v in STEP_LAUNCHES.items()},
              f"{label}: a rank launched {r['launches']}")


def dp_phase(torch):
    """Data parallelism (``parallel/``, ``multihost``): (1) ``training()``
    with ``multihost=True`` in an NCCL group of one (ViT-B, bf16, cached,
    8 + 8 images of 8 components: 64 pairs, one epoch) against the same run
    in one process, history bit for bit; (2) two ranks sharing ``cuda:0``
    over gloo (NCCL takes one rank per card) on a batch of 7 images padded
    to 8 whose halves hold 32 and 9 channels: ``DP_STEPS`` bf16 decoder
    steps per rank, each K3 x1 / K4 x2 forward and backward, against the
    single-process full-batch step; (3) the same over NCCL, one rank per
    card, where the machine has two cards. Returns the per-rank launch
    counts of (1)."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_vit_base
    from dilabhelmholtzoct_tpu_torch.parallel import distributed as dist
    from dilabhelmholtzoct_tpu_torch.parallel import mesh
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_base()
    sd_host = synthetic.random_params(cfg, seed=0)
    splits = (synthetic.oct_training_items(8, seed=1),
              synthetic.oct_training_items(8, seed=2))
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": _free_port(),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        torch.save(sd_host, ckpt)
        base = tr.TrainConfig(
            evaluate=False, batch_size=8, epochs=1, ckpt_keep=1,
            pretrained_checkpoint=ckpt, checkpoint=os.path.join(tmp, "ck"),
            log_jsonl=os.path.join(tmp, "metrics.jsonl"))
        t0 = time.perf_counter()
        single = tr.training(dataclasses.replace(base, display_name="one"),
                             splits=splits)
        t_one = time.perf_counter() - t0
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            _reset_counts()  # --- DP main path starts
            t0 = time.perf_counter()
            dp = tr.training(dataclasses.replace(
                base, multihost=True, display_name="dp"), splits=splits)
            t_dp = time.perf_counter() - t0
            launches = _counts()  # --- DP main path ends
            check(dist.is_initialized() and dist.process_count() == 1,
                  "multihost=True did not join the group of one")
            backend = torch.distributed.get_backend()
        finally:
            dist.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    key = [(h["epoch"], h["train_loss"], h["valid_loss"])
           for h in single["history"]]
    got = [(h["epoch"], h["train_loss"], h["valid_loss"])
           for h in dp["history"]]
    print(f"DP group of one ({backend}) through training(multihost=True): "
          f"history {got} vs one process {key} in {t_dp:.1f} s (one process "
          f"{t_one:.1f} s); launches {launches}")
    check(backend == "nccl", f"the group of one runs {backend}, not NCCL")
    check(got == key, "the NCCL group of one is not bit-equal to one process")
    want = {"attn_global": 4 * 16, "attn_windowed": 8 * 16,
            "upscale_fwd": 2, "upscale_bwd": 1, "upscale_bwd_dw": 1,
            "i2t_fwd": 4, "i2t_bwd": 2, "i2t_bwd_dw": 2}
    check(all(launches[k] == v for k, v in want.items()),
          f"DP run of one launched {launches}, want {want}")

    # (2) two ranks on one card over gloo, against one process
    ds = PromptedDataset(synthetic.oct_training_items(7, seed=4), seed=0)
    batch = list(batches(ds, 7, with_images=False, num_workers=2))[0]
    batch = {k: batch[k] for k in ("prompts", "comp_map", "channel_mask",
                                   "indices")}
    batch["channel_mask"][4:, 3:] = 0.0  # rank 1's rows: 9 of 32 channels
    gen = torch.Generator().manual_seed(11)
    emb = torch.randn((7, 64, 64, 256), generator=gen).to(torch.bfloat16)
    data = {"sd": {k: v for k, v in sd_host.items()
                   if not k.startswith("vision_encoder.")},
            "emb": emb, "batch": batch}
    padded, _ = mesh.pad_to_multiple(batch, 2)
    single = dp_step_run(torch, data, padded, torch.device("cuda", 0))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(data, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ranks = _dp_pair(torch, tmp, "gloo")
        print(f"DP two ranks on one card (gloo): "
              f"{time.perf_counter() - t0:.1f} s with the processes' start")
        before = {k: v for k, v in data["sd"].items()
                  if k.startswith(tr.DECODER_PREFIX)}
        oracle = dp_rank_oracle(torch, data, padded, torch.device("cuda", 0))
        _dp_compare(torch, ranks, single, before, "gloo, 2 ranks on cuda:0",
                    oracle)
        if torch.cuda.device_count() >= 2:
            _dp_compare(torch, _dp_pair(torch, tmp, "nccl"), single, before,
                        "NCCL, one rank per card", oracle)
        else:
            print(f"DP over NCCL with one rank per card: not run "
                  f"({torch.cuda.device_count()} card)")
    return launches


VITH_FT_STEPS = 3


def vith_finetune_phase(torch, sd_h):
    """ViT-H encoder fine-tuning (``trainable='all'``, bf16, batch 2) under
    ``set_flash_attention('off')``: the materialized attention route in
    every encoder layer, no attention kernel, the decoder's K3 x1 / K4 x2
    forward and backward per step; finite losses, the step time and the
    peak memory; the first step card vs CPU at a 2-layer cut; the 'auto'
    route with a gradient raises (K6 is forward-only); and a ViT-B f32
    encode under 'off' against 'auto' (K1 / K2)."""
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models import sam as psam
    from dilabhelmholtzoct_tpu_torch.models.configs import (sam_vit_base,
                                                            sam_vit_huge)
    from dilabhelmholtzoct_tpu_torch.ops.preprocess import preprocess_image
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = sam_vit_huge()
    items = synthetic.oct_training_items(2, seed=3)
    want = {**STEP_LAUNCHES}  # the encoder launches no attention kernel
    psam.set_flash_attention("off")
    try:
        launches, losses, med, peak = full_finetune_run(
            torch, tr, cfg, sd_h, items, 2, VITH_FT_STEPS, "ViT-H 'off'",
            want=want)
        finetune_card_vs_cpu(torch, tr, cfg)
    finally:
        psam.set_flash_attention("auto")
    print(f"ViT-H trainable='all' bf16 bs 2 under 'off': median step "
          f"{med:.2f} ms ({2e3 / med:.2f} img/s), peak {peak / 2**30:.2f} "
          f"GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")

    # 'auto' sends ViT-H to K6, which has no backward
    config = tr.TrainConfig(evaluate=False, batch_size=1, trainable="all",
                            cache_embeddings=False)
    cut = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, num_layers=2, global_attn_indexes=(1,)))
    sd_cut = {k: v for k, v in sd_h.items()
              if not k.startswith("vision_encoder.layers.")
              or int(k.split(".")[2]) < 2}
    params, frozen, opt = _full_params(torch, tr, config, sd_cut,
                                       torch.device("cuda"))
    step = tr.make_train_step(cut, config, opt, (496, 512), False)
    b1 = list(batches(PromptedDataset(items[:1], seed=0), 1,
                      with_images=True, num_workers=1))[0]
    try:
        step(params, opt, frozen, _device_batch(torch, b1,
                                                torch.device("cuda")))
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    check(raised is not None and "set_flash_attention('off')" in raised,
          f"the 'auto' route with a gradient at head dim 80 did not raise "
          f"with the switch named: {raised!r}")
    print(f"'auto' with a gradient at ViT-H raises: {raised.splitlines()[0]}")
    del params, frozen, opt
    torch.cuda.empty_cache()

    # a ViT-B f32 encode: the materialized route against K1 / K2
    cfg_b = sam_vit_base()
    sd_b = {k: v.cuda() for k, v in
            synthetic.random_params(cfg_b, seed=0).items()}
    img = torch.as_tensor(synthetic.oct_training_items(1, seed=9)[0]["image"])
    pix, _ = preprocess_image(img[None].cuda(), target_size=1024)
    out, times = {}, {}
    for mode in ("auto", "off"):
        psam.set_flash_attention(mode)
        try:
            with torch.no_grad(), full_fp32():
                before = _counts()
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out[mode] = psam.encode_image(sd_b, pix, cfg_b)
                    torch.cuda.synchronize()
                    times[mode] = 1e3 * (time.perf_counter() - t0)
                d = _delta(_counts(), before)
        finally:
            psam.set_flash_attention("auto")
        n_attn = d["attn_global"] + d["attn_windowed"]
        check(n_attn == (24 if mode == "auto" else 0),
              f"ViT-B encode under {mode!r} launched {d}")
    diff = (out["off"] - out["auto"]).abs().max().item()
    scale = out["auto"].abs().max().item()
    print(f"ViT-B f32 encode, 'off' (materialized) vs 'auto' (K1 x4, K2 x8): "
          f"max |difference| {diff:.3g} of max |value| {scale:.3g} (limit "
          f"{F32_ATOL} relative); encode ms 'auto' {times['auto']:.2f}, "
          f"'off' {times['off']:.2f}")
    check(diff <= F32_ATOL * scale, "ViT-B encode differs between routes")
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
    components_phase()
    print(f"[phases] component engine {time.perf_counter() - t0:.1f} s")
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
    data_path_phase(torch)
    print(f"[phases] data path {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    points_bone_phase(torch)
    print(f"[phases] config 3, points and 'Bone' "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update({f"{k}_f32": v
                     for k, v in decoder_f32_fused_phase(torch).items()})
    print(f"[phases] f32 fused decoder fine-tune "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    topo_rows, topo_launches = topo_phase(torch)
    launches.update({k: topo_launches[k] for k in topo_rows})
    print(f"[phases] topological decoder fine-tune "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    t1_large_phase(torch)
    print(f"[phases] T1's global route {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dp_phase(torch)
    print(f"[phases] data parallelism {time.perf_counter() - t0:.1f} s")
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
    rows.update(topo_rows)
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
    t0 = time.perf_counter()
    vith_finetune_phase(torch, sd_h)
    print(f"[phases] ViT-H encoder fine-tune under 'off' "
          f"{time.perf_counter() - t0:.1f} s")
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


def redesign_times(torch):
    """The kernels redesigned on wgmma and TMA, timed at their main-path
    shapes through the public wrappers alone, so that the same function
    times an older tree's kernels: the bf16 K6 at a ViT-H global layer
    (N = 4096) and windowed layer (25 windows of 196), 16 heads of 80; the
    K4 weight pass at 64 pairs x 4096 rows, pb 1 and 8, in f32 and in
    bf16; K5's bf16 dk/dv and dq kernels at a ViT-B global layer (B = 4)
    and windowed layer (100 windows of 196), 12 heads; the bf16 K1 with its
    logsumexp rows at the global layer, B = 1 and 4; the bf16 K2 with its
    logsumexp rows at the windowed layer, B = 1 and 4 (25 and 100 windows
    of 196), by CUDA events and, as ``*_device``, by the profiler's device
    time of its kernel (the mma.sync ``attn_windowed_mma_kernel`` of older
    trees or ``attn_relpos_wgmma_kernel``; None where the profiler saw
    neither); the f32 K3 weight pass at 64 pairs x 4096 rows; the f32 K1
    with its logsumexp rows at ViT-B's global layer, B = 1 and 4, and the
    f32 K6 at ViT-H's global and windowed layers, each also as the
    profiler's device time of its kernel (``*_device``: the ``mma.sync``
    kernels of older trees, ``attn_global_tf32_kernel`` /
    ``attn_relpos_tf32_kernel``, or ``attn_relpos_wgmma_tf32_kernel``).
    K5's f32 dq and dk/dv kernels at ViT-B's global layer (B = 4) and 100
    windows, each also as the profiler's device time of the mma.sync
    kernels of older trees (``attn_bwd_dq_tf32_kernel``, ...) or of the
    split-TF32 wgmma kernel with its pre-pass (``*_device``; the pre-pass
    alone ``*_prepass_device``). The f32 K2 with its logsumexp rows at
    ViT-B's windowed layer, B = 1 and 4 (25 and 100 windows of 196, 12
    heads), also as the device time of ``attn_windowed_tf32_kernel`` (older
    trees) or ``attn_relpos_wgmma_tf32_kernel``; the bf16 K4 row pass at 64
    pairs x 4096 rows, pb 1 and 8, also as the device time of
    ``i2t_bwd_rows_kernel`` (older trees) or ``i2t_bwd_rows_wgmma_kernel``;
    the bf16 K3 row pass at 64 pairs x 4096 rows, n_out 1 and 4, and the
    bf16 K4 forward at pb 1 and 8, each also as the device time of the
    mma.sync kernel of older trees (``upscale_bwd_rows_kernel``,
    ``i2t_fwd_mma_kernel``) or of the wgmma one (``*_wgmma_kernel``); the
    bf16 K3 forward at 64 pairs x 4096 rows, n_out 1 and 4, also as the
    device time of ``upscale_fwd_mma_kernel`` (older trees) or
    ``upscale_fwd_wgmma_kernel`` (``k3_fwd_bf16_n1[_device]``, ...).
    Returns {"ms": {case: ms}, "bits": {case: a digest of its outputs}}:
    the bf16 K6 and K1's outputs (K1's with its logsumexp rows), the f32
    K1's, K2's and K6's, K5's (dqkv, drel_h, drel_w) in bf16 and in f32,
    the bf16 K4 row pass's, K3 row pass's and K4 forward's, and the bf16
    K3 forward's, on
    inputs drawn in the same order from one seed in every tree, so that two
    trees' digests say whether the kernels give the same bits."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.ops import attention as attn
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    rnd = lambda *s, k=1.0: k * torch.randn(s, generator=gen, device=dev)
    out, bits = {}, {}

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()[:16]

    for case, b, hw in (("k6_bf16_global", 1, (64, 64)),
                        ("k6_bf16_windowed", 25, (14, 14))):
        n, heads = hw[0] * hw[1], 16
        qkv = rnd(b, n, 3 * heads * 80, k=0.5).bfloat16()
        rel_h = rnd(b, heads, n, hw[0], k=0.3).bfloat16()
        rel_w = rnd(b, heads, n, hw[1], k=0.3).bfloat16()
        fn = lambda: attn.attention_relpos_cuda(qkv, rel_h, rel_w, hw=hw,
                                                num_heads=heads)
        out[case] = cuda_ms(fn, 50)
        bits[case] = digest(fn())
    bp, m = TRAIN_SHAPES["bp"], TRAIN_SHAPES["m"]
    with full_fp32():
        for pb in (1, 8):
            args = (rnd(bp // pb, m, 256), rnd(1, m, 256), rnd(bp, m, 128),
                    rnd(bp, m, 128), rnd(bp, m, 256))
            out[f"k4_dw_f32_pb{pb}"] = cuda_ms(
                lambda: i2t.i2t_bwd_dw_cuda(*args, pb=pb), 20)
            del args
    for pb in (1, 8):
        args = tuple(x.bfloat16() for x in (
            rnd(bp // pb, m, 256), rnd(1, m, 256), rnd(bp, m, 128),
            rnd(bp, m, 128), rnd(bp, m, 256)))
        out[f"k4_dw_bf16_pb{pb}"] = cuda_ms(
            lambda: i2t.i2t_bwd_dw_cuda(*args, pb=pb), 20)
        del args
    for case, b, hw, iters in (("bf16_global", 4, (64, 64), 5),
                               ("bf16_windowed", 100, (14, 14), 20)):
        n, heads = hw[0] * hw[1], 12
        kw = dict(hw=hw, num_heads=heads)
        qkv = rnd(b, n, 3 * heads * 64, k=0.5).bfloat16()
        rel_h = rnd(b, heads, n, hw[0], k=0.3).bfloat16()
        rel_w = rnd(b, heads, n, hw[1], k=0.3).bfloat16()
        g = rnd(b, n, heads * 64).bfloat16()
        o, lse = attn.attention_fwd_cuda(qkv, rel_h, rel_w, return_lse=True,
                                         **kw)
        args = (qkv, rel_h, rel_w, g, lse, attn.bwd_dvec(g, o, heads),
                torch.empty_like(qkv))
        out[f"k5_dkv_{case}"] = cuda_ms(
            lambda: attn.attention_bwd_dkv_cuda(*args, **kw), iters)
        out[f"k5_dq_{case}"] = cuda_ms(
            lambda: attn.attention_bwd_dq_cuda(*args, **kw), iters)
        drel = attn.attention_bwd_dq_cuda(*args, **kw)
        attn.attention_bwd_dkv_cuda(*args, **kw)
        bits[f"k5_{case}"] = digest(args[6], *drel)
        if case == "bf16_global":  # the bf16 K1 with its LSE rows, B = 4
            out["k1_bf16_global_b4"] = cuda_ms(
                lambda: attn.attention_fwd_cuda(
                    qkv, rel_h, rel_w, return_lse=True, **kw), 20)
            bits["k1_bf16_global_b4"] = digest(*attn.attention_fwd_cuda(
                qkv, rel_h, rel_w, return_lse=True, **kw))
            one = (qkv[:1], rel_h[:1], rel_w[:1])
            out["k1_bf16_global_b1"] = cuda_ms(
                lambda: attn.attention_fwd_cuda(*one, return_lse=True, **kw),
                50)
            del one
        del qkv, rel_h, rel_w, g, o, lse, args
    names = ("attn_windowed_mma_kernel", "attn_relpos_wgmma_kernel")
    for case, b in (("k2_bf16_windowed_b1", 25), ("k2_bf16_windowed_b4", 100)):
        hw, heads = (14, 14), 12
        n = hw[0] * hw[1]
        qkv = rnd(b, n, 3 * heads * 64, k=0.5).bfloat16()
        rel_h = rnd(b, heads, n, hw[0], k=0.3).bfloat16()
        rel_w = rnd(b, heads, n, hw[1], k=0.3).bfloat16()
        fn = lambda: attn.attention_fwd_cuda(qkv, rel_h, rel_w, hw=hw,
                                             num_heads=heads, return_lse=True)
        out[case] = cuda_ms(fn, 50)
        dev_ms = [v for v in device_ms_by_kernel(fn, names).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        del qkv, rel_h, rel_w
    with full_fp32():
        args = (rnd(bp, m, 256), rnd(bp, m, 256), rnd(bp, m, 512),
                rnd(bp, m, 256))
        out["k3_dw_f32"] = cuda_ms(lambda: up_op.upscale_bwd_dw_cuda(*args),
                                   20)
        del args
    # the f32 K1 (with its LSE rows) and K6: events and device time
    f32_names = ("attn_global_tf32_kernel", "attn_relpos_tf32_kernel",
                 "attn_relpos_wgmma_tf32_kernel")
    for case, b, hw, heads, d in (("k1_f32_global_b1", 1, (64, 64), 12, 64),
                                  ("k1_f32_global_b4", 4, (64, 64), 12, 64),
                                  ("k6_f32_global", 1, (64, 64), 16, 80),
                                  ("k6_f32_windowed", 25, (14, 14), 16, 80)):
        n = hw[0] * hw[1]
        qkv = rnd(b, n, 3 * heads * d, k=0.5)
        rel_h = rnd(b, heads, n, hw[0], k=0.3)
        rel_w = rnd(b, heads, n, hw[1], k=0.3)
        kw = dict(hw=hw, num_heads=heads)
        if case.startswith("k1"):
            fn = lambda: attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                                 return_lse=True, **kw)
        else:
            fn = lambda: attn.attention_relpos_cuda(qkv, rel_h, rel_w, **kw)
        out[case] = cuda_ms(fn, 20 if n > 1000 else 50)
        dev_ms = [v for v in device_ms_by_kernel(fn, f32_names).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        got = fn()
        bits[case] = digest(*(got if isinstance(got, tuple) else (got,)))
        del qkv, rel_h, rel_w, got
    # the f32 K2 with its LSE rows: events and device time
    k2_names = ("attn_windowed_tf32_kernel", "attn_relpos_wgmma_tf32_kernel")
    with full_fp32():
        for case, b in (("k2_f32_windowed_b1", 25),
                        ("k2_f32_windowed_b4", 100)):
            hw, heads = (14, 14), 12
            n = hw[0] * hw[1]
            qkv = rnd(b, n, 3 * heads * 64, k=0.5)
            rel_h = rnd(b, heads, n, hw[0], k=0.3)
            rel_w = rnd(b, heads, n, hw[1], k=0.3)
            fn = lambda: attn.attention_fwd_cuda(
                qkv, rel_h, rel_w, hw=hw, num_heads=heads, return_lse=True)
            out[case] = cuda_ms(fn, 50)
            dev_ms = [v for v in device_ms_by_kernel(fn, k2_names).values()
                      if v is not None]
            out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
            bits[case] = digest(*fn())
            del qkv, rel_h, rel_w
    # the bf16 K4 row pass at the training shape: events and device time
    rows_names = ("i2t_bwd_rows_kernel", "i2t_bwd_rows_wgmma_kernel")
    for pb in (1, 8):
        bf = torch.bfloat16
        args = (rnd(bp // pb, m, 256).to(bf), rnd(1, m, 256).to(bf),
                rnd(bp, 7, 128).to(bf), rnd(bp, 7, 128).to(bf),
                rnd(256, 128, k=0.06).to(bf), rnd(128, k=0.1),
                rnd(128, 256, k=0.09).to(bf), rnd(256, k=0.1),
                1 + rnd(256, k=0.1), rnd(256, k=0.1))
        dy = rnd(bp, m, 256).to(bf)
        fn = lambda: i2t.i2t_bwd_rows_cuda(*args, dy, nh=8, pb=pb, eps=1e-6)
        case = f"k4_rows_bf16_pb{pb}"
        out[case] = cuda_ms(fn, 10)
        dev_ms = [v for v in device_ms_by_kernel(fn, rows_names,
                                                 reps=10).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        bits[case] = digest(*fn())
        del args, dy
    # the bf16 K3 row pass at the training shape, n_out 1 and 4, and the
    # bf16 K4 forward at pb 1 and 8: events and device time of the mma.sync
    # kernel of older trees or of the wgmma one
    k3_names = ("upscale_bwd_rows_kernel", "upscale_bwd_rows_wgmma_kernel")
    for n_out in (1, 4):
        bf = torch.bfloat16
        args = (rnd(bp, m, 256).to(bf), rnd(bp, m, n_out * 16),
                rnd(256, 2, 2, 64, k=0.06).to(bf), rnd(64, k=0.1),
                1 + rnd(64, k=0.1), rnd(64, k=0.1),
                rnd(64, 2, 2, 32, k=0.12).to(bf), rnd(32, k=0.1),
                rnd(bp, n_out, 32).to(bf))
        fn = lambda: up_op.upscale_bwd_rows_cuda(*args)
        case = f"k3_rows_bf16_n{n_out}"
        out[case] = cuda_ms(fn, 10)
        dev_ms = [v for v in device_ms_by_kernel(fn, k3_names,
                                                 reps=10).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        bits[case] = digest(*fn())
        del args
    # the bf16 K3 forward at the training shape, n_out 1 and 4: events and
    # the device time of the mma.sync kernel of older trees or of the wgmma
    # one
    k3f_names = ("upscale_fwd_mma_kernel", "upscale_fwd_wgmma_kernel")
    for n_out in (1, 4):
        bf = torch.bfloat16
        args = (rnd(bp, m, 256).to(bf), rnd(256, 2, 2, 64, k=0.06).to(bf),
                rnd(64, k=0.1), 1 + rnd(64, k=0.1), rnd(64, k=0.1),
                rnd(64, 2, 2, 32, k=0.12).to(bf), rnd(32, k=0.1),
                rnd(bp, n_out, 32).to(bf))
        fn = lambda: up_op.upscale_fwd_cuda(*args)
        case = f"k3_fwd_bf16_n{n_out}"
        out[case] = cuda_ms(fn, 20)
        dev_ms = [v for v in device_ms_by_kernel(fn, k3f_names).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        bits[case] = digest(fn())
        del args
    fwd_names = ("i2t_fwd_mma_kernel", "i2t_fwd_wgmma_kernel")
    for pb in (1, 8):
        bf = torch.bfloat16
        args = (rnd(bp // pb, m, 256).to(bf), rnd(1, m, 256).to(bf),
                rnd(bp, 7, 128).to(bf), rnd(bp, 7, 128).to(bf),
                rnd(256, 128, k=0.06).to(bf), rnd(128, k=0.1),
                rnd(128, 256, k=0.09).to(bf), rnd(256, k=0.1),
                1 + rnd(256, k=0.1), rnd(256, k=0.1))
        fn = lambda: i2t.i2t_fwd_cuda(*args, nh=8, pb=pb, eps=1e-6)
        case = f"k4_fwd_bf16_pb{pb}"
        out[case] = cuda_ms(fn, 20)
        dev_ms = [v for v in device_ms_by_kernel(fn, fwd_names).values()
                  if v is not None]
        out[f"{case}_device"] = sum(dev_ms) if dev_ms else None
        bits[case] = digest(fn())
        del args
    # K5's f32 kernels at ViT-B's global layer (B = 4) and 100 windows, from
    # the f32 forward's LSE rows: events, and the device time of the
    # mma.sync kernels of older trees or of the split-TF32 wgmma kernel and
    # its pre-pass (also alone, ``*_prepass_device``)
    k5_names = {k: (f"attn_bwd_{k}_tf32_kernel",
                    f"attn_bwd_{k}_wgmma_tf32_kernel", f"{k}_images_kernel")
                for k in ("dq", "dkv")}
    with full_fp32():
        for case, b, hw, iters in (("global", 4, (64, 64), 5),
                                   ("windowed", 100, (14, 14), 20)):
            n, heads = hw[0] * hw[1], 12
            kw = dict(hw=hw, num_heads=heads)
            qkv = rnd(b, n, 3 * heads * 64, k=0.5)
            rel_h = rnd(b, heads, n, hw[0], k=0.3)
            rel_w = rnd(b, heads, n, hw[1], k=0.3)
            g = rnd(b, n, heads * 64)
            o, lse = attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                             return_lse=True, **kw)
            args = (qkv, rel_h, rel_w, g, lse, attn.bwd_dvec(g, o, heads),
                    torch.empty_like(qkv))
            for k, f in (("dq", attn.attention_bwd_dq_cuda),
                         ("dkv", attn.attention_bwd_dkv_cuda)):
                fn = lambda: f(*args, **kw)
                c = f"k5_{k}_f32_{case}"
                out[c] = cuda_ms(fn, iters)
                by_name = device_ms_by_kernel(fn, k5_names[k], reps=iters)
                ran = [v for v in by_name.values() if v is not None]
                out[f"{c}_device"] = sum(ran) if ran else None
                out[f"{c}_prepass_device"] = by_name[k5_names[k][2]]
            drel = attn.attention_bwd_dq_cuda(*args, **kw)
            attn.attention_bwd_dkv_cuda(*args, **kw)
            bits[f"k5_f32_{case}"] = digest(args[6], *drel)
            del qkv, rel_h, rel_w, g, o, lse, args, drel
    return {"ms": out, "bits": bits}


def redesign_ab(other_root):
    """The redesigned kernels of another tree (A: an older checkout, e.g.
    the parent commit's ``git archive``) against this tree's (B) on one
    card, in turns A B B A, each turn a fresh process that imports the
    package from its tree (``--redesign-times ROOT``) and builds its
    kernels there. Prints each turn's times and each side's mean, and
    whether the two sides' bf16 K6, K1, K5, K4 row pass and forward and K3
    row pass and f32 K1, K2, K6 and K5 gave the same bits."""
    here = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    runs, bits = {"A": [], "B": []}, {}
    for side in "ABBA":
        root = os.path.abspath(other_root) if side == "A" else here
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--redesign-times",
             root], capture_output=True, text=True, timeout=1500)
        check(proc.returncode == 0, f"turn {side} ({root}) failed:\n"
                                    f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        ms = got["ms"]
        runs[side].append(ms)
        bits.setdefault(side, got["bits"])
        print(f"turn {side} ({root}): " + ", ".join(
            f"{k} " + ("not measured" if v is None else f"{v:.4f} ms")
            for k, v in ms.items()))
    for side, turns in runs.items():
        means = {k: [t[k] for t in turns if t[k] is not None]
                 for k in turns[0]}
        print(f"mean {side}: " + ", ".join(
            f"{k} " + (f"{statistics.mean(v):.4f} ms" if v else "not measured")
            for k, v in means.items()))
    print("bits A vs B: " + ", ".join(
        f"{k} {'same' if bits['A'].get(k) == v else 'different'}"
        for k, v in bits["B"].items()))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--redesign-times"]:
        sys.path.insert(0, sys.argv[2])
        import torch as _torch

        print(json.dumps(redesign_times(_torch)))
        sys.exit(0)
    if sys.argv[1:2] == ["--redesign-ab"]:
        redesign_ab(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
