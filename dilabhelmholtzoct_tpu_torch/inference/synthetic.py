"""Seeded workloads for smoke runs and profiles on the card: random SAM
weights with non-zero rel-pos tables, synthetic OCT B-scans, the prompts a
user sends (a box, a point, three boxes), and labelled training items."""

from __future__ import annotations

import numpy as np
import torch

from ..models.configs import SamConfig
from ..models.sam import init_params

BOX = [120, 150, 380, 330]
POINT = [256, 240]
BOXES3 = [[40, 120, 200, 300], [200, 150, 330, 320], [300, 160, 480, 360]]


def random_params(cfg: SamConfig, seed: int = 0) -> dict:
    """``init_params`` from a seeded torch.Generator, with N(0, 0.2) rel-pos
    tables (init zeroes them, which would leave the bias path idle)."""
    gen = torch.Generator().manual_seed(seed)
    sd = init_params(cfg, gen)
    for i in range(cfg.vision.num_layers):
        for k in ("rel_pos_h", "rel_pos_w"):
            key = f"vision_encoder.layers.{i}.attn.{k}"
            sd[key] = 0.2 * torch.randn(sd[key].shape, generator=gen)
    return sd


def oct_image(seed: int = 0) -> np.ndarray:
    """Synthetic 496x512x3 uint8 OCT B-scan (the dataset's geometry, which
    takes the exact-2x preprocess): curved retinal layers plus speckle."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:496, 0:512].astype(np.float32)
    surface = 180 + 25 * np.sin(xx / 70.0)
    img = np.zeros((496, 512), np.float32)
    for depth, level in ((0, 200), (20, 120), (45, 170), (80, 90), (110, 220),
                         (130, 60)):
        img = np.where(yy > surface + depth, level, img)
    img = img * rng.gamma(4.0, 0.25, img.shape)
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3,
                     axis=2)


def oct_training_items(n: int, seed: int) -> list[dict]:
    """n synthetic training items {"image", "label"}: the 496x512 B-scan
    geometry and a label map of background plus 7 non-touching rectangular
    blobs, one class each, on a 2x4 grid of cells — 8 components per image,
    so a batch fills prompt bucket 8."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        label = np.zeros((496, 512), np.uint8)
        for cls, cell in enumerate(rng.permutation(8)[:7], start=1):
            y0, x0 = (cell // 4) * 248, (cell % 4) * 128
            h, w = int(rng.integers(30, 200)), int(rng.integers(30, 100))
            y = y0 + int(rng.integers(8, 240 - h))
            x = x0 + int(rng.integers(8, 120 - w))
            label[y:y + h, x:x + w] = cls
        items.append({"image": oct_image(seed * 1000 + i), "label": label})
    return items
