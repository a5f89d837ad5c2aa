"""Mask -> prompt sampling: connected components, jittered boxes, points.

Port of ``dilabhelmholtzoct_tpu/data/sampling.py`` (the port imports nothing
of the JAX package). Per class value present in the label map (background 0
included), connected components under the 3x3 all-ones structure; per
component a box from its min/max x/y with +-10 px jitter clamped to the
image, or one uniformly drawn pixel; the components as one slot map
(``comp_map``, slots 1..n in prompt order).

The components come from the host library's component engine
(``ops/native.py`` on ``csrc/components_host.cc``: one union-find pass over
the class map, and one pass for the point picks), as the JAX package's come
from its C++ library. A library that cannot be built raises; nothing falls
back. ``label_components_plain``, ``extract_components_plain`` and
``prompts_from_extraction_plain`` are the scipy / numpy twins the tests
hold the engine to.

The labelling is split from the random draws so the input pipeline can
cache it across epochs (it is a pure function of the label map): the
``extract_components`` / ``prompts_from_extraction`` pair gives exactly what
``sample_prompts`` gives, draw for draw. The draw order is the reference's:
per component, for boxes ``x_min, x_max, y_min, y_max``, each
``rng.integers(-10, 10)``; for points ``rng.integers(0, size)`` picking the
pixel of that rank in row-major order (all ranks drawn first, in slot
order, then picked in one pass).

Batches are padded to static bucket sizes, with ``channel_mask`` marking the
channels a ragged batch would hold.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
from scipy import ndimage

from ..ops import native

_STRUCTURE = np.ones((3, 3), dtype=np.int32)

# static bucket sizes for per-image component counts; components beyond the
# largest are dropped with a warning, never silently
DEFAULT_BUCKETS = (8, 16, 32, 64)
MAX_COMPONENTS = 256  # host-side extraction cap (far above any real image)


@dataclass
class PromptedSample:
    """Prompts for one image (ragged, on the host): ``bboxes`` (n, 4) f32
    xyxy or points (n, 1, 2), ``comp_map`` (H, W) int32 slots 1..n,
    ``mask_values`` (n,) int32 class value per component."""

    bboxes: np.ndarray
    comp_map: np.ndarray
    mask_values: np.ndarray

    @property
    def n(self) -> int:
        return len(self.mask_values)

    @property
    def gt_masks(self) -> np.ndarray:
        """(n, H, W) f32 binary masks, materialised on demand."""
        n = self.n
        if n == 0:
            return np.zeros((0, *self.comp_map.shape), np.float32)
        return (self.comp_map[None] == np.arange(1, n + 1)[:, None, None]
                ).astype(np.float32)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket holding ``n``; the largest bucket when none does."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def label_components(binary_mask: np.ndarray):
    """8-connected components of a (H, W) mask (3x3 ones structure) on the
    component engine: (labels (H, W) int32, 1..n in raster order of each
    component's first pixel, as ``scipy.ndimage.label`` numbers them; n)."""
    return native.label_components_8(binary_mask)


def label_components_plain(binary_mask: np.ndarray):
    """Plain twin of ``label_components``: ``scipy.ndimage.label``."""
    labels, n = ndimage.label(np.ascontiguousarray(binary_mask),
                              structure=_STRUCTURE)
    return labels.astype(np.int32), int(n)


def _class_map(label: np.ndarray) -> np.ndarray:
    """The label map as the engine takes it: uint8, C order; raises for
    class values outside 0..255."""
    if label.dtype != np.uint8 and label.size and (
            label.min() < 0 or label.max() > 255):
        raise ValueError("class values must lie in 0..255, got "
                         f"{label.min()}..{label.max()}")
    return np.ascontiguousarray(label, np.uint8)


def extract_components(label: np.ndarray, max_comps: int = MAX_COMPONENTS):
    """The RNG-free half of prompt sampling, from a (H, W) integer label map
    (class values 0..255), on the component engine.

    Returns (comp_map (H, W) int32 slots 1..n, values (n,) int32, boxes
    (n, 4) int32 as (x0, y0, x1, y1) inclusive, sizes (n,) int32, total
    found). Slots follow the ascending class values, then scipy's label
    order (raster order of each component's first pixel); components past
    ``max_comps`` are counted in ``total`` only."""
    return native.extract_components(_class_map(label), max_comps)


def extract_components_plain(label: np.ndarray,
                             max_comps: int = MAX_COMPONENTS):
    """Plain twin of ``extract_components``: ``scipy.ndimage.label`` per
    class value and one full-image mask per component."""
    h, w = label.shape
    comp_map = np.zeros((h, w), np.int32)
    values, boxes, sizes = [], [], []
    total = 0
    for v in np.unique(label):
        labeled, ncomp = ndimage.label(label == v, structure=_STRUCTURE)
        counts = np.bincount(labeled.reshape(-1), minlength=ncomp + 1)
        for c, sl in enumerate(ndimage.find_objects(labeled), start=1):
            total += 1
            if len(values) >= max_comps:
                continue
            values.append(int(v))
            comp_map[labeled == c] = len(values)
            boxes.append((sl[1].start, sl[0].start, sl[1].stop - 1,
                          sl[0].stop - 1))
            sizes.append(int(counts[c]))
    n = len(values)
    return (comp_map, np.asarray(values, np.int32),
            np.asarray(boxes, np.int32).reshape(n, 4),
            np.asarray(sizes, np.int32), total)


def component_pixel_at_plain(comp_map: np.ndarray, ranks) -> np.ndarray:
    """Plain twin of ``native.component_pixel_at``: per slot, its pixels in
    raster order (``np.flatnonzero``) and the one of the given rank."""
    w = comp_map.shape[1]
    flat = comp_map.reshape(-1)
    out = np.zeros((len(ranks), 2), np.int32)
    for s, rank in enumerate(ranks):
        idx = np.flatnonzero(flat == s + 1)[int(rank)]
        out[s] = (idx % w, idx // w)
    return out


def _prompts(extraction, shape, prompt_type, rng, pixel_at) -> PromptedSample:
    h, w = shape
    comp_map, values, boxes, sizes, _ = extraction
    n = len(values)
    if prompt_type == "points":
        ranks = np.asarray([int(rng.integers(0, int(sz))) for sz in sizes],
                           np.int64)
        prompts = pixel_at(comp_map, ranks).astype(np.float32).reshape(
            n, 1, 2)
    else:
        prompts = np.zeros((n, 4), np.float32)
        for s in range(n):
            x0, y0, x1, y1 = (int(q) for q in boxes[s])
            jx0 = max(0, x0 + int(rng.integers(-10, 10)))
            jx1 = min(w, x1 + int(rng.integers(-10, 10)))
            jy0 = max(0, y0 + int(rng.integers(-10, 10)))
            jy1 = min(h, y1 + int(rng.integers(-10, 10)))
            prompts[s] = (jx0, jy0, jx1, jy1)
    return PromptedSample(bboxes=prompts, comp_map=comp_map,
                          mask_values=values.astype(np.int32))


def prompts_from_extraction(extraction, shape, prompt_type: str,
                            rng: np.random.Generator) -> PromptedSample:
    """The random half: jittered boxes or uniform points from a (possibly
    cached) ``extract_components`` result, in the reference's draw order;
    the points picked by the component engine."""
    return _prompts(extraction, shape, prompt_type, rng,
                    native.component_pixel_at)


def prompts_from_extraction_plain(extraction, shape, prompt_type: str,
                                  rng: np.random.Generator) -> PromptedSample:
    """Plain twin of ``prompts_from_extraction``: the same draws, the points
    picked by ``component_pixel_at_plain``."""
    return _prompts(extraction, shape, prompt_type, rng,
                    component_pixel_at_plain)


def sample_prompts(ground_truth_mask: np.ndarray, prompt_type: str,
                   rng: np.random.Generator) -> PromptedSample:
    """Per-component prompts from a (H, W) integer label map."""
    return prompts_from_extraction(extract_components(ground_truth_mask),
                                   ground_truth_mask.shape, prompt_type, rng)


def collate(samples: list[PromptedSample], images: np.ndarray | None = None,
            *, prompt_type: str = "bboxes", buckets=DEFAULT_BUCKETS) -> dict:
    """Pad ragged samples into one static-shape batch (numpy):

    prompts (B, C, 4) f32 boxes or (B, C, 1, 2) f32 points; point_labels
    (B, C, 1) i32 for points — 1 where the ragged batch has a channel (its
    zero-padded slots are (0, 0) foreground points, as HF reads them), -10
    on bucket-only padding; comp_map (B, H, W) i32; mask_values (B, C) i32;
    channel_mask (B, C) f32, 1 for channels c < the batch's largest
    component count; n_components (B,) i32; image (B, H, W, 3) when given."""
    bsz = len(samples)
    if images is not None:
        h, w = images.shape[1:3]
    else:
        h, w = samples[0].comp_map.shape
    max_n = max(s.n for s in samples)
    cap = buckets[-1]
    if max_n > cap:
        warnings.warn(f"batch has {max_n} components; capping at {cap} "
                      "(excess components dropped)")
        max_n = cap
    c = bucket_for(max_n, buckets)

    comp_map = np.zeros((bsz, h, w), np.int32)
    values = np.zeros((bsz, c), np.int32)
    n_comp = np.zeros((bsz,), np.int32)
    if prompt_type == "points":
        prompts = np.zeros((bsz, c, 1, 2), np.float32)
        labels = np.full((bsz, c, 1), -10, np.int32)
    else:
        prompts = np.zeros((bsz, c, 4), np.float32)
        labels = None
    for i, s in enumerate(samples):
        n = min(s.n, c)
        n_comp[i] = n
        comp_map[i] = s.comp_map  # slots > c fall outside the one-hot range
        if n:
            prompts[i, :n] = s.bboxes[:n]
            values[i, :n] = s.mask_values[:n]
            if labels is not None:
                labels[i, :n] = 1

    channel_mask = np.zeros((bsz, c), np.float32)
    channel_mask[:, :max_n] = 1.0
    if labels is not None:
        labels[:, :max_n] = np.where(labels[:, :max_n] == -10, 1,
                                     labels[:, :max_n])
    out = {"prompts": prompts, "comp_map": comp_map, "mask_values": values,
           "channel_mask": channel_mask, "n_components": n_comp}
    if images is not None:
        out["image"] = images
    if labels is not None:
        out["point_labels"] = labels
    return out


def gt_masks_from_comp_map(comp_map, n_channels: int):
    """(B, H, W) integer slot map -> (B, C, H, W) f32 one-hot masks, numpy
    in numpy out, tensor in tensor out (on its device); slots beyond
    ``n_channels`` vanish."""
    if isinstance(comp_map, np.ndarray):
        rng_ = np.arange(1, n_channels + 1, dtype=comp_map.dtype)
        return (comp_map[:, None] == rng_[None, :, None, None]).astype(
            np.float32)
    rng_ = torch.arange(1, n_channels + 1, device=comp_map.device).to(
        comp_map.dtype)
    return (comp_map[:, None] == rng_[None, :, None, None]).float()
