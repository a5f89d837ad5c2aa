"""Mask postprocessing: the reference's 3-step upsample → crop → resize.

Port of ``dilabhelmholtzoct_tpu/ops/postprocess.py``. Bilinear resize is a
separable linear map, so the chain

    F.interpolate(low, (1024, 1024)) → [:new_h, :new_w] → F.interpolate(orig)

collapses into one row operator R_h (H, Gl) and one column operator
R_w (W, Gl), composed in numpy from the 1-D ``jax.image.resize`` weights
(half-pixel centres, no antialias, edge renormalisation). The products run
in full f32 (``device.full_fp32``): at TF32 precision boundary pixels flip at
the 0.5 threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from .preprocess import preprocess_shape, resize_matrix

_OPERATOR_CACHE: dict = {}


def resize_operators(gl: int, orig_hw: tuple[int, int],
                     model_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Composed (R_h (H, Gl), R_w (W, Gl)) for the upsample→crop→resize
    chain, cached per geometry."""
    key = (gl, tuple(orig_hw), model_size)
    if key not in _OPERATOR_CACHE:
        new_h, new_w = preprocess_shape(orig_hw[0], orig_hw[1], model_size)
        a1 = resize_matrix(gl, model_size, antialias=False)
        r_h = resize_matrix(new_h, orig_hw[0], antialias=False) @ a1[:new_h]
        r_w = resize_matrix(new_w, orig_hw[1], antialias=False) @ a1[:new_w]
        _OPERATOR_CACHE[key] = (r_h, r_w)
    return _OPERATOR_CACHE[key]


def postprocess_masks(low_res_masks: torch.Tensor, orig_hw: tuple[int, int],
                      *, model_size: int = 1024) -> torch.Tensor:
    """(B, C, Gl, Gl) low-res logits → (B, C, orig_h, orig_w) f32 logits:
    the natural-layout form, which the evaluation harness uses."""
    gl = low_res_masks.shape[-1]
    r_h, r_w = resize_operators(gl, orig_hw, model_size)
    dev = low_res_masks.device
    x = low_res_masks.to(torch.float32)
    x = torch.einsum("bcgw,Hg->bcHw", x, torch.as_tensor(r_h, device=dev))
    return torch.einsum("bcHw,Ww->bcHW", x, torch.as_tensor(r_w, device=dev))


def postprocess_masks_blocked(blocked_masks: torch.Tensor,
                              orig_hw: tuple[int, int], *,
                              model_size: int = 1024) -> torch.Tensor:
    """(B, C, G, G, 2, 2, 2, 2) blocked logits → (B, C, H, W) logits.

    Pixel (4h+2d+f, 4w+2e+g) lives at [h, w, d, e, f, g] (the decoder's
    ``blocked=True`` layout); the operators' input axis factors the same
    way, so regroup and resize are one product per axis."""
    g = blocked_masks.shape[2]
    r_h, r_w = resize_operators(4 * g, orig_hw, model_size)
    dev = blocked_masks.device
    rh_f = torch.as_tensor(r_h.reshape(orig_hw[0], g, 2, 2), device=dev)
    rw_f = torch.as_tensor(r_w.reshape(orig_hw[1], g, 2, 2), device=dev)
    x = blocked_masks.to(torch.float32)
    x = torch.einsum("bchwdefg,Hhdf->bcwegH", x, rh_f)
    return torch.einsum("bcwegH,Wweg->bcHW", x, rw_f)
