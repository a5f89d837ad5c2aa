"""Segmentation losses: ``monai.losses.DiceCELoss(sigmoid=True)`` semantics.

Port of ``dilabhelmholtzoct_tpu/ops/losses.py``: soft Dice (sigmoid, smooth
1e-5 on numerator and denominator, one term per (sample, channel), mean
reduction) plus cross-entropy — ``CrossEntropyLoss`` with probabilistic
targets when the channel dim is > 1, ``BCEWithLogitsLoss`` when it is 1.

``channel_mask`` (B, C) marks the channels a ragged batch would really hold
(the rest are bucket padding): masked channels leave the Dice mean, the
softmax and the target sum, and a row with no channel at all (a padding
row of the last batch) leaves the CE denominator.

Under data parallelism (``parallel/distributed.py``) each rank's loss is its
local numerator over the global batch's denominator (``global_count``,
``mean_share``), as the JAX package's sharded step computes the loss of the
whole padded batch; with no process group the helpers are the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.distributed import global_count, mean_share

SMOOTH_NR = 1e-5
SMOOTH_DR = 1e-5


def dice_loss(logits, targets, channel_mask=None):
    """Soft Dice with sigmoid; logits/targets (B, C, *spatial), channel_mask
    (B, C) {0, 1} or None. The mean of the per-(b, c) terms over the masked
    entries."""
    probs = torch.sigmoid(logits.float())
    t = targets.float()
    axes = tuple(range(2, logits.dim()))
    intersection = (t * probs).sum(axes)
    denominator = t.sum(axes) + probs.sum(axes)
    f = 1.0 - (2.0 * intersection + SMOOTH_NR) / (denominator + SMOOTH_DR)
    if channel_mask is None:
        return mean_share(f)
    m = channel_mask.float()
    return (f * m).sum() / torch.clamp(global_count(m.sum()), min=1.0)


def softmax_ce_prob_targets(logits, targets, channel_mask=None):
    """``CrossEntropyLoss`` with probabilistic targets over axis 1: the mean
    over (B, *spatial) of -sum_c targets_c * log_softmax(logits)_c."""
    x = logits.float()
    t = targets.float()
    if channel_mask is None:
        return mean_share(-(t * F.log_softmax(x, dim=1)).sum(1))
    m = channel_mask.bool()
    mb = m.reshape(m.shape + (1,) * (logits.dim() - 2))
    x = torch.where(mb, x, -math.inf)
    t = torch.where(mb, t, 0.0)
    logp = F.log_softmax(x, dim=1)
    logp = torch.where(torch.isfinite(logp), logp, 0.0)
    per_pixel = -(t * logp).sum(1)  # (B, *spatial)
    # rows with no channel are padding and stay out of the denominator
    row_valid = m.any(1).float()
    n_pix = float(math.prod(per_pixel.shape[1:]))
    denom = torch.clamp(global_count(row_valid.sum()) * n_pix, min=1.0)
    rshape = (-1,) + (1,) * (per_pixel.dim() - 1)
    return (per_pixel * row_valid.reshape(rshape)).sum() / denom


def bce_with_logits(logits, targets):
    x = logits.float()
    t = targets.float()
    loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return mean_share(loss)


def dice_ce_loss(logits, targets, channel_mask=None):
    """DiceCE (lambda_dice = lambda_ce = 1); with C == 1 the CE term is
    BCE-with-logits, as monai dispatches."""
    d = dice_loss(logits, targets, channel_mask)
    if logits.shape[1] == 1:
        ce = bce_with_logits(logits, targets)
    else:
        ce = softmax_ce_prob_targets(logits, targets, channel_mask)
    return d + ce


def segmentation_loss(name: str):
    """The ``--loss`` flag -> a loss function: 'diceCE', or one of its two
    parts ('dice', 'ce' / 'crossentropy')."""
    name = name.lower()
    if name == "dicece":
        return dice_ce_loss
    if name == "dice":
        return dice_loss
    if name in ("ce", "crossentropy"):
        return softmax_ce_prob_targets
    raise ValueError(f"unknown loss {name!r}; known: diceCE, dice, ce")
