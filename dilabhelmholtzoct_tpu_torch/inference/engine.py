"""Interactive segmentation engine: SAM serving with an encoder cache.

Port of ``dilabhelmholtzoct_tpu/inference/engine.py``, the serving core of
the reference's Gradio app: ``segment(image, prompt, prompt_type)`` returns
the sigmoid > 0.5 uint8 masks after the 3-step postprocess.

  * The image encoder runs once per image; repeated prompts on the same
    image reuse the cached embeddings (hash-keyed LRU).
  * A prompt costs only prompt encode → decode (blocked upscaler layout) →
    postprocess → sigmoid → threshold.
  * Prompt counts are padded to a bucket (1, 2, 4, ..., 64), as in the JAX
    engine; zero-pad rows decode independently and are sliced off.

The engine runs on ``cuda`` unless constructed with ``device="cpu"``, in
f32, with TF32 off (``device.full_fp32``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..data.sampling import bucket_for
from ..device import full_fp32, resolve_device
from ..models.configs import SamConfig, config_for
from ..models.sam import (
    decode_masks,
    encode_image,
    encode_prompts,
    image_wide_pe,
)
from ..ops.postprocess import postprocess_masks_blocked
from ..ops.preprocess import preprocess_image, rescale_boxes, rescale_coords

PROMPT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class SegmentationEngine:
    def __init__(self, params: dict, cfg: SamConfig, *, cache_size: int = 8,
                 device=None):
        """params: HF-named state_dict (``models/convert.py``)."""
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in params.items()}
        self.cfg = cfg
        self.cache_size = cache_size
        self._cache: dict[str, torch.Tensor] = {}

    @classmethod
    def from_checkpoint(cls, base_model: str, checkpoint_path: str | None,
                        allow_pickled_module: bool = False, **kw):
        """Base config + (optionally fine-tuned) weights from a local
        HF-format checkpoint (.pt/.pth/.safetensors); random weights (seed 0)
        without one. ``allow_pickled_module=True`` also accepts
        whole-pickled-module files, opt-in because unpickling can run code."""
        from ..models.convert import load_state_dict
        from ..models.sam import init_params

        cfg = config_for(base_model)
        if checkpoint_path:
            params = load_state_dict(checkpoint_path,
                                     allow_pickled_module=allow_pickled_module)
        else:
            params = init_params(cfg, torch.Generator().manual_seed(0))
        return cls(params, cfg, **kw)

    # -- encoder cache -----------------------------------------------------

    def _embeddings(self, image: np.ndarray) -> torch.Tensor:
        # shape/dtype are part of the key (identical bytes reshaped are a
        # different image); hits re-insert, so eviction is LRU, not FIFO
        h = hashlib.sha1(str((image.shape, image.dtype.str)).encode())
        h.update(np.ascontiguousarray(image))
        key = h.hexdigest()
        if key in self._cache:
            self._cache[key] = self._cache.pop(key)
            return self._cache[key]
        if len(self._cache) >= self.cache_size:
            self._cache.pop(next(iter(self._cache)))
        x = torch.from_numpy(np.ascontiguousarray(image[None])).to(self.device)
        pix, _ = preprocess_image(x, target_size=self.cfg.vision.image_size)
        self._cache[key] = encode_image(self.params, pix, self.cfg)
        return self._cache[key]

    # -- decode ------------------------------------------------------------

    def _decode(self, emb, prompt_type: str, prompts, labels, orig_hw):
        cfg, p = self.cfg, self.params
        size = cfg.vision.image_size
        if prompt_type == "points":
            sparse, dense = encode_prompts(
                p, cfg, 1, points=rescale_coords(prompts, orig_hw, size)[None],
                labels=labels[None], dtype=emb.dtype)
        else:
            sparse, dense = encode_prompts(
                p, cfg, 1, boxes=rescale_boxes(prompts, orig_hw, size)[None],
                dtype=emb.dtype)
        low, _ = decode_masks(p, cfg, emb, image_wide_pe(p, cfg), sparse,
                              dense, multimask_output=False, blocked=True)
        masks = postprocess_masks_blocked(low[:, :, 0], orig_hw,
                                          model_size=size)
        probs = torch.sigmoid(masks[0])
        return (probs > 0.5).to(torch.uint8), probs

    # -- public API --------------------------------------------------------

    def segment(self, image: np.ndarray, prompt, prompt_type: str = "bbox",
                with_probs: bool = True):
        """image (H, W, 3) uint8; prompt an [x, y] point or [x0, y0, x1, y1]
        box, or a list of them. Returns (masks (n, H, W) uint8, probs
        (n, H, W) f32, or None when ``with_probs=False``)."""
        orig_hw = tuple(image.shape[:2])
        prompt = np.asarray(prompt, np.float32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        n = len(prompt)
        nb = bucket_for(n, buckets=PROMPT_BUCKETS)
        if prompt_type == "points":
            prompts = np.zeros((nb, 1, 2), np.float32)
            prompts[:n] = prompt.reshape(n, 1, 2)
            labels = np.zeros((nb, 1), np.int32)
            labels[:n] = 1
        else:
            prompts = np.zeros((nb, 4), np.float32)
            prompts[:n] = prompt.reshape(n, 4)
            labels = np.zeros((0,), np.int32)
        with torch.inference_mode(), full_fp32():
            emb = self._embeddings(image)
            binary, probs = self._decode(
                emb, "points" if prompt_type == "points" else "bbox",
                torch.from_numpy(prompts).to(self.device),
                torch.from_numpy(labels).to(self.device), orig_hw)
        binary = binary[:n].cpu().numpy()
        if not with_probs:
            return binary, None
        return binary, probs[:n].cpu().numpy()


def parse_image_prompter_points(points):
    """Parse gradio-image-prompter events: each entry is [x, y, ., x2, y2, .];
    a point iff entries 3 and 4 are 0, else a box. Returns a list of
    ("points" | "bbox", prompt) tuples."""
    out = []
    for entry in points:
        pixel = list(map(int, entry))
        prompt = [pixel[0], pixel[1], pixel[3], pixel[4]]
        if pixel[3] == 0 and pixel[4] == 0:
            out.append(("points", [prompt[0], prompt[1]]))
        else:
            out.append(("bbox", prompt))
    return out


def point_marker(shape_hw, x: int, y: int) -> np.ndarray:
    """3x3 point marker overlay."""
    point = np.zeros(shape_hw, np.uint8)
    point[max(0, y - 1): y + 2, max(0, x - 1): x + 2] = 1
    return point
