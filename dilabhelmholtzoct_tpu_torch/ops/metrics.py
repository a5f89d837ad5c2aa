"""Segmentation metrics owned natively (no sklearn / HF-evaluate dependency).

A copy of ``dilabhelmholtzoct_tpu/ops/metrics.py`` (the port imports nothing
of the JAX package): HF ``mean_iou`` per-category IoU / accuracy and sklearn
F1, average precision and the confusion-matrix metrics (sensitivity,
specificity, Dice) of the reference's evaluation report, as vectorized numpy
on the host, plus the batched confusion counts as a torch function for
tensors on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def binary_confusion(pred, gt):
    """pred/gt: binary arrays (any shape) → (tn, fp, fn, tp) as ints."""
    pred = np.asarray(pred).astype(bool).reshape(-1)
    gt = np.asarray(gt).astype(bool).reshape(-1)
    tp = int(np.sum(pred & gt))
    fp = int(np.sum(pred & ~gt))
    fn = int(np.sum(~pred & gt))
    tn = pred.size - tp - fp - fn
    return tn, fp, fn, tp


def iou(tn, fp, fn, tp):
    """Per-category IoU of the foreground label — HF mean_iou's
    per_category_iou[1]."""
    d = tp + fp + fn
    return tp / d if d else float("nan")


def category_accuracy(tn, fp, fn, tp):
    """HF mean_iou per_category_accuracy[1] = intersect / total_label."""
    d = tp + fn
    return tp / d if d else float("nan")


def f1(tn, fp, fn, tp):
    d = 2 * tp + fp + fn
    return 2 * tp / d if d else 0.0


dice = f1  # Dice coefficient == F1 for binary masks (training_utils.py:156)


def sensitivity(tn, fp, fn, tp):
    return tp / (tp + fn) if (tp + fn) else 0.0


def specificity(tn, fp, fn, tp):
    return tn / (tn + fp) if (tn + fp) else 0.0


def average_precision(scores, labels):
    """sklearn ``average_precision_score`` for binary labels.

    AP = sum_k (R_k - R_{k-1}) * P_k over descending unique score thresholds.
    """
    # sort in the input precision (f32 upstream): ties and order are
    # identical to an f64 sort of the same values, and the argsort is the
    # dominant cost on full-split pixel counts
    scores = np.ascontiguousarray(np.reshape(scores, -1))
    labels = np.asarray(labels).astype(bool).reshape(-1)
    n_pos = int(labels.sum())
    if n_pos == 0:
        return 0.0
    # stability is irrelevant to AP: cumulative tps are only read at the
    # END of each tie group, so any order within ties gives the same value
    # (quicksort is ~2x faster than sklearn's mergesort on these sizes)
    order = np.argsort(-scores)
    scores = scores[order]
    labels = labels[order]
    # indices of last occurrence of each distinct score
    distinct = np.where(np.diff(scores))[0]
    thresh_idx = np.concatenate([distinct, [scores.size - 1]])
    tps = np.cumsum(labels)[thresh_idx].astype(np.float64)
    fps = (thresh_idx + 1) - tps
    precision = tps / (tps + fps)
    recall = tps / n_pos
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_recall) * precision))


def average_precision_batched(scores, labels, row_chunk: int = 16):
    """Row-wise sklearn ``average_precision_score``: (N, ...) → (N,) f64.

    Exactly ``[average_precision(s, l) for s, l in zip(scores, labels)]``
    (verified in tests/test_torch_eval.py against the loop) but one vectorized argsort/cumsum pass
    per chunk of rows instead of a Python loop per sample — the per-sample
    AP loop was the dominant host cost of the eval report
    (reference's per-sample AP: training_utils.py:177-184).

    Derivation: with rows sorted by descending score, AP over distinct-score
    thresholds telescopes to (1/n_pos) * Σ_j l_j · P(end(j)) where end(j)
    is the last index of j's tie group — so each positive contributes the
    precision at its tie-group end, computed with a reverse fill.
    """
    scores = np.asarray(scores)
    scores = scores.reshape(scores.shape[0], -1)
    labels = np.asarray(labels).astype(bool).reshape(scores.shape[0], -1)
    n, p = scores.shape
    out = np.zeros(n, np.float64)
    if p == 0:
        return out
    for r0 in range(0, n, row_chunk):
        s = scores[r0:r0 + row_chunk]
        l = labels[r0:r0 + row_chunk]
        n_pos = l.sum(axis=1)
        order = np.argsort(-s, axis=1)
        s_sorted = np.take_along_axis(s, order, axis=1)
        l_sorted = np.take_along_axis(l, order, axis=1)
        tps = np.cumsum(l_sorted, axis=1, dtype=np.float64)
        prec = tps / np.arange(1, p + 1, dtype=np.float64)
        # group-end mask: position k is the last of its score-tie group
        is_end = np.empty_like(l_sorted)
        is_end[:, :-1] = s_sorted[:, :-1] != s_sorted[:, 1:]
        is_end[:, -1] = True
        # backward-fill precision from each group end onto its group:
        # index of the nearest group end >= k, via reversed cummax of
        # masked indices
        idx = np.where(is_end, np.arange(p), p - 1)
        end_idx = np.minimum.accumulate(idx[:, ::-1], axis=1)[:, ::-1]
        prec_at_end = np.take_along_axis(prec, end_idx, axis=1)
        ap = np.sum(l_sorted * prec_at_end, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            out[r0:r0 + row_chunk] = np.where(n_pos > 0, ap / n_pos, 0.0)
    return out


def binary_report(pred, gt, scores=None):
    """All reference per-class metrics in one pass.

    Returns dict with keys iou, accuracy, f1, dice, sensitivity,
    specificity, and (if scores given) ap.
    """
    c = binary_confusion(pred, gt)
    out = {
        "iou": iou(*c),
        "accuracy": category_accuracy(*c),
        "f1": f1(*c),
        "dice": dice(*c),
        "sensitivity": sensitivity(*c),
        "specificity": specificity(*c),
    }
    if scores is not None:
        out["ap"] = average_precision(scores, gt)
    return out


def batched_confusion(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Confusion counts on the tensors' device; pred/gt: (B, ...) binary →
    (B, 4) int32 rows (tn, fp, fn, tp)."""
    p = pred.reshape(pred.shape[0], -1).to(torch.bool)
    g = gt.reshape(gt.shape[0], -1).to(torch.bool)
    tp = (p & g).sum(dim=1)
    fp = (p & ~g).sum(dim=1)
    fn = (~p & g).sum(dim=1)
    tn = p.shape[1] - tp - fp - fn
    return torch.stack([tn, fp, fn, tp], dim=1).to(torch.int32)
