"""Dataset store: the reference's on-disk contract.

Port of ``dilabhelmholtzoct_tpu/data/store.py``: a HF ``DatasetDict{train,
test}`` of ``{image, label}`` saved with ``save_to_disk`` under the name
``{description}preprocessed_at_{time}``, so a dataset written by either
package is read by both. ``datasets`` is imported only inside the functions
that need it; hosts without it pass the splits in memory
(``train.trainer.training(splits=...)``) as any indexable sequence of
``{"image", "label"}`` items.
"""

from __future__ import annotations

import datetime
import os

import numpy as np


def timestamp() -> str:
    """The reference's run timestamp format."""
    return datetime.datetime.now().strftime("%y-%m-%d_%H.%M.%S")


def _datasets(what: str):
    try:
        import datasets
    except ImportError as e:
        raise ImportError(
            f"{what} needs the 'datasets' package, which is not installed; "
            "pass the splits in memory instead (training(config, "
            "splits=(train_items, valid_items)))") from e
    return datasets


def create_dataset(images: np.ndarray, labels: np.ndarray,
                   storage: str = "png"):
    """(N, H, W, 3) images + (N, H, W) labels -> HF Dataset{image, label}.

    storage='png': the reference's interchange format (HF Image features);
    'raw': uint8 arrow tensors, faster to build and read, larger on disk.
    ``item_arrays`` reads both."""
    ds_mod = _datasets("writing a dataset")
    if storage == "raw":
        n, h, w, c = images.shape
        features = ds_mod.Features({
            "image": ds_mod.Array3D(shape=(h, w, c), dtype="uint8"),
            "label": ds_mod.Array2D(shape=(h, w), dtype="uint8"),
        })
        return ds_mod.Dataset.from_dict({"image": images, "label": labels},
                                        features=features)
    ds = ds_mod.Dataset.from_dict({"image": list(images),
                                   "label": list(labels)})
    ds = ds.cast_column("image", ds_mod.Image())
    return ds.cast_column("label", ds_mod.Image())


def split_and_save(images, labels, processed_data_path: str, *,
                   test_size: float = 0.2, shuffle: bool = True,
                   file_description: str = "default_",
                   time: str | None = None, seed: int | None = None,
                   storage: str = "png"):
    """Train/test split and save; returns (dataset_name, save_directory),
    the name ``{file_description}preprocessed_at_{time}``."""
    ds = create_dataset(images, labels, storage=storage)
    split = ds.train_test_split(test_size=test_size, shuffle=shuffle,
                                seed=seed)
    name = f"{file_description}preprocessed_at_{time or timestamp()}"
    save_dir = os.path.join(processed_data_path, name)
    split.save_to_disk(save_dir)
    return name, save_dir


def load_split(dataset_path: str, split: str):
    """Load one split of a saved DatasetDict; returns a sequence of
    {'image', 'label'} items."""
    return _datasets("reading a saved dataset").load_from_disk(
        dataset_path)[split]


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
