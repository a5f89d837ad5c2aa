"""Joint image + label-map augmentation on the host.

Port of ``dilabhelmholtzoct_tpu/data/augment.py``: named numpy ops applied
jointly to an (H, W, 3) uint8 image and its (H, W) label map before prompt
sampling, configured by ``TrainConfig.data_transforms`` /
``--data_transforms``. Each op draws from the caller's
``np.random.Generator`` in the JAX package's order, so the same generator
state gives the same bytes.

Geometric ops move image and labels alike (index permutations, so the
labels keep nearest semantics); photometric ops touch the image alone.
"""

from __future__ import annotations

import numpy as np


def hflip(image, mask, rng):
    return image[:, ::-1], mask[:, ::-1]


def vflip(image, mask, rng):
    return image[::-1], mask[::-1]


def brightness(image, mask, rng, limit=0.2):
    f = 1.0 + rng.uniform(-limit, limit)
    return np.clip(image.astype(np.float32) * f, 0, 255).astype(image.dtype), mask


def contrast(image, mask, rng, limit=0.2):
    f = 1.0 + rng.uniform(-limit, limit)
    mean = image.mean()
    out = np.clip((image.astype(np.float32) - mean) * f + mean, 0, 255)
    return out.astype(image.dtype), mask


def gaussian_noise(image, mask, rng, sigma=5.0):
    noise = rng.normal(0.0, sigma, image.shape)
    return (np.clip(image.astype(np.float32) + noise, 0, 255)
            .astype(image.dtype), mask)


def shift(image, mask, rng, max_frac=0.05):
    """Translate by up to ``max_frac`` of each side, zero-filled."""
    h, w = mask.shape[:2]
    dy = int(rng.uniform(-max_frac, max_frac) * h)
    dx = int(rng.uniform(-max_frac, max_frac) * w)
    out_i = np.zeros_like(image)
    out_m = np.zeros_like(mask)
    ys, yd = (dy, 0) if dy >= 0 else (0, -dy)
    xs, xd = (dx, 0) if dx >= 0 else (0, -dx)
    hh, ww = h - abs(dy), w - abs(dx)
    out_i[ys:ys + hh, xs:xs + ww] = image[yd:yd + hh, xd:xd + ww]
    out_m[ys:ys + hh, xs:xs + ww] = mask[yd:yd + hh, xd:xd + ww]
    return out_i, out_m


_OPS = {
    "hflip": hflip,
    "vflip": vflip,
    "brightness": brightness,
    "contrast": contrast,
    "gaussian_noise": gaussian_noise,
    "shift": shift,
}


class Augmenter:
    """Compose named ops, each applied with probability p (one
    ``rng.random()`` per op, then the op's own draws)."""

    def __init__(self, operations: list[str], p: float = 0.5):
        unknown = [o for o in operations if o not in _OPS]
        if unknown:
            raise ValueError(f"unknown augmentations {unknown}; "
                             f"known: {sorted(_OPS)}")
        self.operations = list(operations)
        self.p = p

    def __call__(self, image, mask, rng: np.random.Generator):
        for name in self.operations:
            if rng.random() < self.p:
                image, mask = _OPS[name](image, mask, rng)
        return image, mask


def make_augmenter(operations) -> Augmenter | None:
    return Augmenter(list(operations)) if operations else None
