"""SAM image and prompt preprocessing in PyTorch.

Port of ``dilabhelmholtzoct_tpu/ops/preprocess.py`` (``transformers.SamProcessor``
semantics): resize the longest side to 1024 (bilinear, half-pixel centres),
rescale 1/255, normalise with the ImageNet mean and std, zero-pad
bottom/right to a square, and rescale prompt coordinates into the resized
frame. Activations stay NHWC, as in the JAX package.

The general resize is a separable linear map: ``resize_matrix`` builds the
1-D operator in numpy with the exact weights of ``jax.image.resize``
(triangle kernel, edge renormalisation and, when downscaling with
``antialias=True``, the widened kernel), and the image is resized by two
full-f32 products.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_shape(orig_h: int, orig_w: int, longest_edge: int = 1024):
    """Target (h, w) after the longest-side resize (scale, then round half
    up — HF ``SamImageProcessor._get_preprocess_shape``)."""
    scale = longest_edge / max(orig_h, orig_w)
    return int(orig_h * scale + 0.5), int(orig_w * scale + 0.5)


def resize_matrix(n_in: int, n_out: int, *, antialias: bool) -> np.ndarray:
    """(n_out, n_in) f32 matrix M with bilinear-resize(v) == M @ v.

    Reproduces ``jax.image.resize(..., 'bilinear', antialias=...)`` weight
    by weight: sample positions at half-pixel centres, triangle kernel
    (widened by the downscale factor when antialiasing), weights
    renormalised to sum 1 per output sample (the edge rule)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
        weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32).T.copy()


def _upsample2_bilinear(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 2x bilinear upsampling along ``dim`` (half-pixel centres, edge
    clamp): out[2j] = 0.25 x[j-1] + 0.75 x[j], out[2j+1] = 0.75 x[j] +
    0.25 x[j+1]."""
    n = x.shape[dim]
    lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * lo + 0.75 * x
    odd = 0.75 * x + 0.25 * hi
    y = torch.stack([even, odd], dim=dim + 1)
    return y.reshape(x.shape[:dim] + (2 * n,) + x.shape[dim + 1:])


def preprocess_image(image: torch.Tensor, *, target_size: int = 1024,
                     dtype=torch.float32):
    """uint8/float (B, H, W, 3) → normalised, padded (B, T, T, 3).

    Returns (pixel_values, reshaped_input_size): the static (h, w) the image
    occupies inside the padded square. Runs on ``image``'s device."""
    b, h, w, c = image.shape
    new_h, new_w = preprocess_shape(h, w, target_size)
    x = image.to(torch.float32)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    if (new_h, new_w) == (2 * h, 2 * w):
        # normalise BEFORE the upsample (affine maps commute exactly with
        # convex bilinear weights), then the closed-form 2x path — the OCT
        # geometry (496x512 → 992x1024) takes it
        x = (x / 255.0 - mean) / std
        x = _upsample2_bilinear(_upsample2_bilinear(x, 1), 2)
    else:
        # jax.image.resize's default antialias=True: it widens the kernel
        # when the image is downscaled (longest side > target)
        r_h = torch.as_tensor(resize_matrix(h, new_h, antialias=True),
                              device=x.device)
        r_w = torch.as_tensor(resize_matrix(w, new_w, antialias=True),
                              device=x.device)
        x = torch.einsum("bhwc,Hh->bHwc", x, r_h)
        x = torch.einsum("bHwc,Ww->bHWc", x, r_w)
        x = x / 255.0
        x = (x - mean) / std
    x = torch.nn.functional.pad(
        x, (0, 0, 0, target_size - new_w, 0, target_size - new_h))
    return x.to(dtype), (new_h, new_w)


def rescale_coords(coords: torch.Tensor, orig_hw, target_size: int = 1024):
    """xy prompt coordinates (..., 2) from original-image space to the
    resized frame (``SamProcessor._normalize_coordinates``)."""
    old_h, old_w = orig_hw
    new_h, new_w = preprocess_shape(old_h, old_w, target_size)
    scale = torch.tensor([new_w / old_w, new_h / old_h], dtype=torch.float32,
                         device=coords.device)
    return coords.to(torch.float32) * scale


def rescale_boxes(boxes: torch.Tensor, orig_hw, target_size: int = 1024):
    """(..., 4) xyxy boxes → resized space."""
    shape = boxes.shape
    return rescale_coords(boxes.reshape(*shape[:-1], 2, 2), orig_hw,
                          target_size).reshape(shape)
