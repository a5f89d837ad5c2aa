"""Per-class evaluation harness.

Port of ``dilabhelmholtzoct_tpu/eval/harness.py``, which replicates the
reference's ``evaluate_metrics`` report (octsam/models/training_utils.py:
82-270): inference with sigmoid and a 0.5 threshold, component → class
bucketing with the stop-at-second-zero scan (training_utils.py:128-134),
then for each of the 14 classes IoU, accuracy (HF mean_iou semantics), F1,
Dice, sensitivity, specificity and average precision, both globally (all
pixels of the class pooled) and per sample (mean over samples), with the
best / average / worst-3 sample printouts per metric.

The forward runs in f32 on an explicit device — the card unless the caller
asks for the host (``eval_device="cpu"``, the reference's placement, or
``device="cpu"``) — with the encoder run once per image up front
(``precompute_embeddings``; at a head dim other than 64, as ViT-H's, its
attention is K6) and one batched decode per group of images. The metric
reductions run vectorized on the host.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from ..data.sampling import DEFAULT_BUCKETS, bucket_for
from ..device import full_fp32, resolve_device
from ..models.sam import encode_image, sam_forward
from ..ops.metrics import (
    average_precision,
    average_precision_batched,
    binary_confusion,
    category_accuracy,
    dice,
    f1,
    iou,
    sensitivity,
    specificity,
)
from ..ops.postprocess import postprocess_masks
from ..ops.preprocess import preprocess_image, rescale_boxes, rescale_coords

NO_BEST_WORST_SAMPLES = 3
MAX_BUCKET = 64


def _bucket(n):
    # one source of truth with training collation, plus a small eval-only
    # first bucket (single-digit prompt counts are common per sample here)
    return bucket_for(n, buckets=(4,) + DEFAULT_BUCKETS)


def make_batch_infer_fns(cfg, orig_hw):
    """Batched decode: (params, B-row embeddings, prompts) → (B, C, H, W)
    sigmoid probabilities, every tensor on the parameters' device. The one
    implementation of the evaluation's inference math: the per-sample path
    wraps these on a size-1 batch, so the two cannot drift apart."""
    size = cfg.vision.image_size

    def _probs(p, emb, **prompts):
        with torch.inference_mode(), full_fp32():
            out = sam_forward(p, cfg, image_embeddings=emb,
                              multimask_output=False, **prompts)
            masks = postprocess_masks(out["pred_masks"][:, :, 0], orig_hw,
                                      model_size=size)
            return torch.sigmoid(masks)

    def batch_boxes(p, emb, boxes):
        return _probs(p, emb, boxes=rescale_boxes(boxes, orig_hw, size))

    def batch_points(p, emb, points, labels):
        return _probs(p, emb, points=rescale_coords(points, orig_hw, size),
                      labels=labels)

    return batch_boxes, batch_points


def _on_device(params: dict, device) -> dict:
    return {k: v.detach().to(device, torch.float32) if v.is_floating_point()
            else v.detach().to(device) for k, v in params.items()}


def make_infer_fn(params, cfg, config, orig_hw, device=None):
    """Per-sample inference ``infer(image, sample)``: an (H, W, 3) uint8
    image, or a precomputed (G, G, C) embedding row (the encoder is then
    skipped), plus the sample's prompts → (n, H, W) f32 sigmoid
    probabilities on the host. Samples with more than 64 components are
    evaluated in chunks of the largest bucket, never truncated."""
    dev = resolve_device(device)
    params = _on_device(params, dev)
    size = cfg.vision.image_size
    g = cfg.prompt.image_embedding_size
    batch_boxes, batch_points = make_batch_infer_fns(cfg, tuple(orig_hw))

    def embed(image):
        with torch.inference_mode(), full_fp32():
            pix, _ = preprocess_image(torch.as_tensor(image).to(dev)[None],
                                      target_size=size)
            return encode_image(params, pix, cfg)[0]

    def infer(image, sample):
        if tuple(image.shape) == (g, g, cfg.vision.output_channels):
            emb = torch.as_tensor(image).to(dev, torch.float32)
        else:
            emb = embed(image)
        n = sample.n
        if n == 0:
            return np.zeros((0, *orig_hw), np.float32)
        chunks = []
        for s in range(0, n, MAX_BUCKET):
            m = min(MAX_BUCKET, n - s)
            c = _bucket(m)
            if config.prompt_type == "points":
                pts = np.zeros((c, 1, 2), np.float32)
                lbl = np.full((c, 1), -10, np.int32)
                pts[:m] = sample.bboxes[s:s + m]
                lbl[:m] = 1
                probs = batch_points(params, emb[None],
                                     torch.as_tensor(pts).to(dev)[None],
                                     torch.as_tensor(lbl).to(dev)[None])[0]
            else:
                boxes = np.zeros((c, 4), np.float32)
                boxes[:m] = sample.bboxes[s:s + m]
                probs = batch_boxes(params, emb[None],
                                    torch.as_tensor(boxes).to(dev)[None])[0]
            chunks.append(probs[:m].cpu().numpy())
        return np.concatenate(chunks, axis=0)

    return infer


def _metric_block(name, global_val, sample_vals, idx, out):
    order = np.argsort(sample_vals)
    k = NO_BEST_WORST_SAMPLES
    mid0 = len(sample_vals) // 2 - k // 2
    mid1 = len(sample_vals) // 2 + k // 2
    print(f"----{name}----:")
    print(f"{global_val} \\ {np.mean(sample_vals)}")
    print(f"Best samples: {idx[order[-k:]]}")
    print(f"Average samples: {idx[order[mid0:mid1]]}")
    print(f"Worst samples: {idx[order[:k]]}")
    out[name.lower()] = {"global": float(global_val),
                         "sample_mean": float(np.mean(sample_vals))}


def evaluate_metrics(params, cfg, config, dataset, *, orig_hw, num_classes=14,
                     batch_encode: int = 8, eval_device: str | None = None,
                     device=None):
    """Full per-class report; returns the nested dict of all metrics.

    eval_device: None → ``config.eval_device``. "cpu" runs the whole
    evaluation on the host, the reference's placement (its evaluate_metrics
    re-instantiates the model and never moves it, training_utils.py:83-85);
    "default" runs it on ``device``: the card unless the caller names
    another.

    Classes absent from the split contribute zeros to the ``_means``
    averages (the denominator is always ``num_classes``) and print
    ``(no samples)``, as in the JAX package."""
    where = eval_device if eval_device is not None else getattr(
        config, "eval_device", "default")
    dev = resolve_device("cpu" if where == "cpu" else device)
    params = _on_device(params, dev)
    infer = make_infer_fn(params, cfg, config, orig_hw, dev)

    embeddings = None
    if batch_encode:
        from ..train.trainer import precompute_embeddings

        embeddings = precompute_embeddings(
            params, cfg, dataset, batch_size=batch_encode,
            dtype=torch.float32, verbose=False)

    seg = defaultdict(list)        # class → [binary mask]
    seg_probs = defaultdict(list)  # class → [prob mask]
    gts = defaultdict(list)
    indexes = defaultdict(list)

    batch_boxes, batch_points = make_batch_infer_fns(cfg, tuple(orig_hw))

    def batched_probs():
        """One decode and one device → host copy per group of
        ``batch_encode`` samples, sliced on the device to the real component
        count first."""
        bsz = max(int(batch_encode), 1)
        n_ds = len(dataset)
        samples = [dataset.sample(i) if hasattr(dataset, "sample")
                   else dataset[i][1] for i in range(n_ds)]
        for i0 in range(0, n_ds, bsz):
            group = list(range(i0, min(i0 + bsz, n_ds)))
            ns = [samples[i].n for i in group]
            if max(ns, default=0) > MAX_BUCKET:
                # rare giant sample: the per-sample chunked path handles it
                for i in group:
                    yield i, samples[i], infer(embeddings[i], samples[i])
                continue
            c = _bucket(max(ns, default=1))
            pad = bsz - len(group)
            emb_rows = embeddings[i0:i0 + bsz]
            if pad:
                emb_rows = torch.cat([emb_rows, emb_rows.new_zeros(
                    (pad, *emb_rows.shape[1:]))])
            if config.prompt_type == "points":
                pts = np.zeros((bsz, c, 1, 2), np.float32)
                lbl = np.full((bsz, c, 1), -10, np.int32)
                for j, i in enumerate(group):
                    pts[j, :ns[j]] = samples[i].bboxes
                    lbl[j, :ns[j]] = 1
                probs_b = batch_points(params, emb_rows,
                                       torch.as_tensor(pts).to(dev),
                                       torch.as_tensor(lbl).to(dev))
            else:
                boxes = np.zeros((bsz, c, 4), np.float32)
                for j, i in enumerate(group):
                    boxes[j, :ns[j]] = samples[i].bboxes
                probs_b = batch_boxes(params, emb_rows,
                                      torch.as_tensor(boxes).to(dev))
            maxn = max(ns, default=1)
            probs_np = probs_b[:len(group), :maxn].cpu().numpy()
            for j, i in enumerate(group):
                yield i, samples[i], probs_np[j, :ns[j]]

    def per_sample_probs():
        for i in range(len(dataset)):
            image, sample = dataset[i]
            yield i, sample, infer(image, sample)

    t_infer0 = time.time()
    stream = batched_probs() if embeddings is not None else per_sample_probs()
    for i, sample, probs in stream:
        binary = (probs > 0.5).astype(np.uint8)
        for c in range(sample.n):
            v = int(sample.mask_values[c])
            # The reference's scan break (training_utils.py:128-131):
            # `mask_values[c] == 0 and c > 0`. Not only a padding guard: a
            # sample whose background class 0 splits into several
            # 8-connected components puts a second value-0 entry at c = 1,
            # and the reference drops every later component of that sample
            # from its metrics; replicated exactly.
            if v == 0 and c > 0:
                break
            seg[v].append(binary[c])
            seg_probs[v].append(probs[c])
            # one (H, W) slice from the compact comp_map, not the full
            # (n, H, W) one-hot stack per component
            gts[v].append((sample.comp_map == c + 1).astype(np.float32))
            indexes[v].append(i)

    print(f"[eval] inference over {len(dataset)} samples on {dev.type}: "
          f"{time.time() - t_infer0:.1f}s")
    t_cls0 = time.time()

    report = {}
    agg = {k: np.zeros(num_classes) for k in (
        "iou", "accuracy", "f1", "dice", "sensitivity", "specificity", "ap")}
    agg_s = {k: np.zeros(num_classes) for k in agg}

    class_names = config.mask_dict or {i: str(i) for i in range(num_classes)}
    for cls in range(num_classes):
        name = class_names.get(cls, str(cls))
        print(f"------------------CLASS: {name}----------------------")
        if not seg[cls]:
            print("(no samples)")
            continue
        flat_gt = np.stack(gts[cls])
        flat_seg = np.stack(seg[cls])
        flat_probs = np.stack(seg_probs[cls])
        conf = binary_confusion(flat_seg, flat_gt)
        g = {
            "IoU": iou(*conf),
            "Accuracy": category_accuracy(*conf),
            "Specificity": specificity(*conf),
            "Sensitivity": sensitivity(*conf),
            "F1": f1(*conf),
            "Dice": dice(*conf),
            "AP": average_precision(flat_probs, flat_gt),
        }
        # per-sample confusion metrics, one vectorized pass over the stack
        ps = flat_seg.reshape(len(seg[cls]), -1).astype(bool)
        gs = flat_gt.reshape(len(seg[cls]), -1).astype(bool)
        tp_v = np.sum(ps & gs, axis=1).astype(np.float64)
        fp_v = np.sum(ps & ~gs, axis=1).astype(np.float64)
        fn_v = np.sum(~ps & gs, axis=1).astype(np.float64)
        tn_v = ps.shape[1] - tp_v - fp_v - fn_v
        with np.errstate(divide="ignore", invalid="ignore"):
            per_sample = {
                "IoU": tp_v / (tp_v + fp_v + fn_v),
                "Accuracy": tp_v / (tp_v + fn_v),
                "Specificity": np.where(
                    tn_v + fp_v > 0, tn_v / (tn_v + fp_v), 0.0),
                "Sensitivity": np.where(
                    tp_v + fn_v > 0, tp_v / (tp_v + fn_v), 0.0),
                "F1": np.where(2 * tp_v + fp_v + fn_v > 0,
                               2 * tp_v / (2 * tp_v + fp_v + fn_v), 0.0),
            }
        per_sample["Dice"] = per_sample["F1"]
        per_sample["AP"] = average_precision_batched(flat_probs, flat_gt)
        idx = np.asarray(indexes[cls])
        cls_report = {}
        for metric in g:
            vals = np.nan_to_num(np.asarray(per_sample[metric], np.float64))
            _metric_block(metric, np.nan_to_num(g[metric]), vals, idx,
                          cls_report)
        report[name] = cls_report
        key_map = {"IoU": "iou", "Accuracy": "accuracy", "F1": "f1",
                   "Dice": "dice", "Sensitivity": "sensitivity",
                   "Specificity": "specificity", "AP": "ap"}
        for mk, ak in key_map.items():
            agg[ak][cls] = np.nan_to_num(g[mk])
            agg_s[ak][cls] = np.nan_to_num(
                np.mean(np.nan_to_num(per_sample[mk])))

    print("----------GLOBAL----------")
    for k in ("accuracy", "iou", "specificity", "sensitivity", "dice", "ap"):
        print(f"Category_{k}: {list(agg[k])}")
    means = {k: float(np.mean(v)) for k, v in agg.items()}
    for k, v in means.items():
        print(f"Mean {k}: {v}")
    print("----------SAMPLE----------")
    sample_means = {k: float(np.mean(v)) for k, v in agg_s.items()}
    for k, v in sample_means.items():
        print(f"Mean {k}: {v}")

    report["_global"] = {k: list(map(float, v)) for k, v in agg.items()}
    report["_means"] = means
    report["_sample_means"] = sample_means
    print(f"[eval] metric computation: {time.time() - t_cls0:.1f}s")
    return report
