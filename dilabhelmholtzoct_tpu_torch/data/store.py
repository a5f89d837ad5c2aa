"""Dataset store: the reference's on-disk contract, read side.

Port of the loaders of ``dilabhelmholtzoct_tpu/data/store.py``: a HF
``DatasetDict{train, test}`` of ``{image, label}`` saved with
``save_to_disk``. ``datasets`` is imported only inside ``load_split``; hosts
without it pass the splits in memory (``train.trainer.training(splits=...)``)
as any indexable sequence of ``{"image", "label"}`` items.
"""

from __future__ import annotations

import datetime

import numpy as np


def timestamp() -> str:
    """The reference's run timestamp format."""
    return datetime.datetime.now().strftime("%y-%m-%d_%H.%M.%S")


def load_split(dataset_path: str, split: str):
    """Load one split of a saved DatasetDict; returns a sequence of
    {'image', 'label'} items."""
    try:
        import datasets
    except ImportError as e:
        raise ImportError(
            "reading a saved dataset needs the 'datasets' package, which is "
            "not installed; pass the splits in memory instead "
            "(training(config, splits=(train_items, valid_items)))") from e
    return datasets.load_from_disk(dataset_path)[split]


def item_arrays(item) -> tuple[np.ndarray, np.ndarray]:
    """A dataset item -> (image (H, W, 3) uint8, label (H, W) uint8).

    Takes both storage forms: Image features (PIL) and raw arrow tensors
    (nested lists, int64 without the cast); a grey image gets three
    channels, a three-channel label keeps its first."""
    image = np.asarray(item["image"], dtype=None)
    label = np.asarray(item["label"], dtype=None)
    if image.dtype != np.uint8:
        image = image.astype(np.uint8)
    if label.dtype != np.uint8:
        label = label.astype(np.uint8)
    if label.ndim == 3:
        label = label[..., 0]
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    return image, label
