"""Sample display: class-coloured prediction and ground-truth overlays.

Port of ``dilabhelmholtzoct_tpu/train/display.py`` (the reference's
``display_samples``): the indices come from ``display_mode`` —
'predefined' (``display_idx``), 'random_equal' (seeded 17, the same indices
every epoch), 'random_changing' (seeded by the clock) or 'none' — and each
sample runs through the evaluation harness's inference on the run's device;
the channel argmax, remapped from components to classes, is overlaid on the
image. Each panel (image | prediction | ground truth) is written to
``<run_dir>/display/{split}_e{epoch}_i{i}.png`` when PIL imports, and logged
as a wandb image with both masks when wandb imports; the entries go to
``logger.log_images`` under ``{split}_samples``.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np

# distinct RGB colours for up to 14 classes (0 = background stays dark)
_PALETTE = np.array([
    [0, 0, 0], [230, 25, 75], [60, 180, 75], [255, 225, 25],
    [0, 130, 200], [245, 130, 48], [145, 30, 180], [70, 240, 240],
    [240, 50, 230], [210, 245, 60], [250, 190, 190], [0, 128, 128],
    [170, 110, 40], [128, 128, 0],
], np.uint8)


def _select_indices(config, split, n):
    mode = config.display_mode
    if mode == "none":
        return []
    if mode == "predefined":
        return [i for i in config.display_idx if i < n]
    if mode == "random_equal":
        rng = random.Random(17)  # the reference's seed
    elif mode == "random_changing":
        rng = random.Random(time.time())
    else:
        raise ValueError(
            f"unknown display_mode {mode!r}; expected one of "
            "predefined/random_equal/random_changing/none")
    count = config.display_train_nr if split == "train" else config.display_val_nr
    return [rng.randint(0, n - 1) for _ in range(count)]


def _class_map(masks_logits, mask_values):
    """(C, H, W) logits + per-channel class values -> (H, W) class map: the
    channel argmax, then the component -> class remap."""
    comp = np.argmax(masks_logits, axis=0)
    return np.asarray(mask_values, np.int32)[comp]


def _overlay(image, class_map, alpha=0.5):
    color = _PALETTE[np.clip(class_map, 0, len(_PALETTE) - 1)]
    return (image.astype(np.float32) * (1 - alpha)
            + color.astype(np.float32) * alpha).astype(np.uint8)


def display_samples(params, cfg, config, dataset, split, logger, run_dir, *,
                    epoch, orig_hw, device=None):
    """Overlays of the selected samples of ``dataset`` under the weights
    ``params`` (an HF-named state_dict), inferred on ``device`` (the card
    unless the caller names another)."""
    indices = _select_indices(config, split, len(dataset))
    if not indices:
        return
    from ..eval.harness import make_infer_fn

    out_dir = os.path.join(run_dir, "display")
    os.makedirs(out_dir, exist_ok=True)
    # argmax over sigmoid probabilities == argmax over logits
    infer = make_infer_fn(params, cfg, config, orig_hw, device=device)
    entries = []
    for i in indices:
        image, sample = dataset[i]
        if sample.n == 0:
            continue
        pred_map = _class_map(infer(image, sample), sample.mask_values)
        gt_map = _class_map(sample.gt_masks, sample.mask_values)
        entry = None
        try:
            from PIL import Image

            panel = np.concatenate(
                [image, _overlay(image, pred_map), _overlay(image, gt_map)],
                axis=1)
            entry = os.path.join(out_dir, f"{split}_e{epoch}_i{i}.png")
            Image.fromarray(panel).save(entry)
        except ImportError:
            pass
        try:
            import wandb

            entry = wandb.Image(image, masks={
                "pred": {"mask_data": pred_map,
                         "class_labels": config.mask_dict},
                "gt": {"mask_data": gt_map,
                       "class_labels": config.mask_dict},
            })
        except ImportError:
            pass
        if entry is not None:
            entries.append(entry)
    logger.log_images(f"{split}_samples", entries)
