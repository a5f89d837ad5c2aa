"""Where the serving time goes on the card, at SAM ViT-B (f32) or another
preset (``--base_model facebook/sam-vit-huge``: every encoder layer on K6).

    python -m dilabhelmholtzoct_tpu_torch.inference.profile_serving \
        [--base_model facebook/sam-vit-base] [--fused_windowed on] [--top 12]

Runs the seeded serving workload (``inference/synthetic.py``) through
``SegmentationEngine`` under ``torch.profiler``: one request on a new image
(preprocess + encode + decode; the process has already served another image,
so one-time start-up costs stay outside the window) and ten cached
prompt-to-mask requests. For each window it prints the host wall time, the
device time summed over kernels and copies, the busy share (device time /
wall), the time by kind (K1, K2, K6, K7, matrix products, convolutions,
copies, other kernels) and the top kernels by device time. Needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models.configs import config_for
from ..models.sam import set_fused_windowed
from . import synthetic
from .engine import SegmentationEngine


def _kind(name: str) -> str:
    low = name.lower()
    if "attn_global" in low:
        return "K1 attn_global"
    if "attn_winimg" in low:
        return "K7 attn_windowed_image"
    if "attn_windowed" in low:
        return "K2 attn_windowed"
    if "attn_relpos" in low:
        return "K6 attn_relpos"
    if "attn_bwd" in low:
        return "K5 attn_bwd"
    if "upscale_" in low:
        return "K3 upscaler"
    if "i2t_" in low:
        return "K4 i2t attention"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "matrix products"
    if "conv" in low:
        return "convolutions"
    return "other kernels"


def _device_events(prof):
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, e.count, us / 1e3))
    return out


def profile_window(label, fn, reps, top):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    busy_ms = sum(ms for _, _, ms in events)
    print(f"== {label}: wall {wall_ms:.3f} ms, device {busy_ms:.3f} ms, "
          f"busy share {busy_ms / wall_ms:.3f}")
    if not events:
        print("   the profiler recorded no device time (not measured)")
        return
    kinds: dict[str, float] = {}
    for name, _, ms in events:
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"   {kind:<18} {ms:10.3f} ms  {ms / busy_ms:6.3f} of device")
    for name, count, ms in sorted(events, key=lambda e: -e[2])[:top]:
        print(f"   {ms:10.3f} ms  x{count:<5} {name[:100]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top", type=int, default=12,
                        help="kernels listed per window")
    parser.add_argument("--base_model", type=str,
                        default="facebook/sam-vit-base")
    parser.add_argument("--fused_windowed", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="the windowed layers' route "
                             "(models/sam.py::set_fused_windowed)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {args.base_model}, fused_windowed="
          f"{args.fused_windowed}")
    set_fused_windowed(args.fused_windowed)
    cfg = config_for(args.base_model)
    engine = SegmentationEngine(synthetic.random_params(cfg, seed=0), cfg)
    engine.segment(synthetic.oct_image(seed=1), synthetic.BOX)  # start-up
    img = synthetic.oct_image(seed=0)
    profile_window("new image: preprocess + encode + decode (box)",
                   lambda: engine.segment(img, synthetic.BOX), 1, args.top)
    profile_window("cached prompt-to-mask (box) x10",
                   lambda: engine.segment(img, synthetic.BOX), 10, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
