#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):

1. Device facts: the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. Build: every CUDA kernel of the serving path from
   ``dilabhelmholtzoct_tpu_torch/csrc`` with nvcc for sm_90a (build seconds
   and the ptxas report).
3. Kernels at SAM ViT-B shapes — K1 global attention (B=1, N=4096, 12 heads)
   and K2 windowed attention (25 windows of 196 tokens, 12 heads) — in f32
   and bf16: each held against its plain PyTorch version on the same card
   tensors, then timed with CUDA events (kernel, plain version, and one
   ``scaled_dot_product_attention`` call with the materialised bias as the
   library yardstick), beside the bound computed from the shapes.
4. Serving at full ViT-B width: random weights from a seeded
   torch.Generator (non-zero rel-pos tables), a synthetic 496x512 OCT-shaped
   uint8 image (the exact-2x preprocess), a box, a point and a 3-box request
   through ``SegmentationEngine.segment``. Launch counts are zeroed just
   before and read just after: 4 K1 and 8 K2 launches for the one encode,
   none for the cached prompts. The box request's probabilities and masks
   are held against the same engine on ``device="cpu"``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
F32_ATOL = 1e-4    # kernel vs plain, f32: summation order over <= 4096 keys
BF16_ATOL = 2e-2   # kernel vs plain, bf16: one bf16 rounding of |out| <~ 2
PROB_ATOL = 1e-3   # card engine vs CPU engine, probabilities (ViT-B, f32)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def attention_bound_ms(b, n, heads, hw, itemsize, peak_flops):
    """Least time for one call: the larger of its operations (q.k and p.v,
    2 * 2 * N^2 * 64 per head) over the type's peak and its bytes (qkv and
    both bias factors read once, the output written once) over 3.35 TB/s."""
    c = heads * 64
    flops = 4.0 * b * heads * n * n * 64
    nbytes = itemsize * b * n * (3 * c + heads * (hw[0] + hw[1]) + c)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(torch, attn):
    """K1 / K2 vs their plain versions at ViT-B shapes; returns the f32
    numbers per kernel (the serving path's type) for the result line."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [
        ("attn_global", 1, (64, 64),
         "dilabhelmholtzoct_tpu/ops/attention.py:819"),
        ("attn_windowed", 25, (14, 14),
         "dilabhelmholtzoct_tpu/ops/attention.py:770"),
    ]
    heads = 12
    rows = {}
    for name, b, hw, replaces in cases:
        n = hw[0] * hw[1]
        for dtype in (torch.float32, torch.bfloat16):
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
                tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
                check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                      f"{name} {dtype}: bad output")
                check(err <= tol, f"{name} {dtype}: max |kernel - plain| "
                                  f"{err:.3g} > {tol}")
                iters = 20 if name == "attn_global" else 50
                ms = cuda_ms(lambda: attn.flash_attention_packed(*args, **kw),
                             iters)
                plain_ms = cuda_ms(
                    lambda: attn.packed_attention_plain(*args, **kw), 5)
                x = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
                mask = (rel_h.reshape(b, heads, n, hw[0], 1)
                        + rel_w.reshape(b, heads, n, 1, hw[1])).reshape(
                            b, heads, n, n)
                lib_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        x[0], x[1], x[2], attn_mask=mask), 5)
                del mask
            peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
            bound, bound_by = attention_bound_ms(b, n, heads, hw,
                                                 qkv.element_size(), peak)
            tname = "f32" if dtype == torch.float32 else "bf16"
            print(f"kernel {name} {tname} B={b} N={n} heads={heads}: "
                  f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                  f"({bound_by}) share_of_bound={bound / ms:.3f}")
            if dtype == torch.float32:
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "dilabhelmholtzoct_tpu_torch/csrc/attention.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": lib_ms,
                }
            del qkv, rel_h, rel_w, out, ref, x
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
    attn.reset_launch_counts()  # --- main path starts
    t0 = time.perf_counter()
    bin_box, p_box = engine.segment(img, box, "bbox")
    cold_ms = 1e3 * (time.perf_counter() - t0)
    after_encode = dict(attn.LAUNCHES)
    bin_pt, p_pt = engine.segment(img, point, "points")
    bin_3, p_3 = engine.segment(img, boxes3, "bbox")
    launches = dict(attn.LAUNCHES)  # --- main path ends
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"serving launches after the first request {after_encode}, "
          f"after all three {launches}")
    check(after_encode == {"attn_global": 4, "attn_windowed": 8},
          f"one ViT-B encode must launch K1 x4 and K2 x8, got {after_encode}")
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

    rows = kernel_phase(torch, attn)
    launches = serving_phase(torch, attn)
    for k, row in rows.items():
        check(launches[k] > 0, f"{k} was not launched on the main path")
        row["launches"] = launches[k]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
