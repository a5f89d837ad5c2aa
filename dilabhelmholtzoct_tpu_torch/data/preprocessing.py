"""Preprocessing CLI: raw images -> on-disk train/test dataset.

Port of ``dilabhelmholtzoct_tpu/data/preprocessing.py``, with the same flags
and defaults (``--dataset {custom,dme,amd} --data_directory --test_size
--shuffle --dme_masks --seed --storage``): it reads
``<data_directory>/raw/<dataset>`` and writes the split DatasetDict under
``<data_directory>/processed/<dataset>`` (``data/store.split_and_save``),
which the training CLI reads. ``amd`` raises NotImplementedError, as in the
JAX package and the reference.

The loaders need packages the card machine lacks: ``cv2`` (custom PNGs),
``scipy.io`` (DME .mat files) and ``datasets`` (the writer). Each is
imported where it is used; run the CLI on a host that has them:

    python -m dilabhelmholtzoct_tpu_torch.data.preprocessing \
        --dataset custom --data_directory /vol/data/datasets
"""

from __future__ import annotations

import argparse
import importlib
import os

import numpy as np

from ..utils.flags import str2bool as _str2bool  # shared strict parser
from .store import split_and_save, timestamp

CUSTOM_SHAPE = (496, 512, 3)  # the custom dataset's shape gate


def _need(module: str, package: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"this loader needs the '{package}' package ({module}), which is "
            "not installed") from e


def preprocess_custom(raw_data_path: str, config: dict):
    """``imagesgreyscale/`` + ``masks14/`` PNG pairs of one name: channel 0
    of the mask is the label map; a pair not exactly 496x512x3 is skipped."""
    cv2 = _need("cv2", "opencv-python")
    img_dir = os.path.join(raw_data_path, "imagesgreyscale")
    mask_dir = os.path.join(raw_data_path, "masks14")
    images, masks = [], []
    for filename in sorted(os.listdir(img_dir)):
        image = cv2.imread(os.path.join(img_dir, filename))
        mask = cv2.imread(os.path.join(mask_dir, filename))
        if image is None or mask is None:
            continue
        if mask.shape != CUSTOM_SHAPE or image.shape != CUSTOM_SHAPE:
            if config.get("print_status"):
                print(f"Skipped image of different size! {filename} "
                      f"{mask.shape} {image.shape}")
            continue
        images.append(image)
        masks.append(mask[:, :, 0])
    if not images:
        raise FileNotFoundError(
            f"no valid image/mask pairs under {raw_data_path}")
    return np.stack(images), np.stack(masks)


def preprocess_dme(raw_data_path: str, config: dict):
    """Chiu-2015 DME: 10 subjects x 61 B-scans from ``Subject_NN.mat``;
    B-scans with an empty mask are dropped. ``use_masks`` must name a
    per-pixel mask array (such as 'manualFluid1'): the default
    'manualLayers1' holds layer-boundary row indices, which raise."""
    loadmat = _need("scipy.io", "scipy").loadmat
    use_masks = config.get("use_masks", "manualLayers1")
    images, masks = [], []
    for i in range(10):
        number = str(i + 1).zfill(2)
        if config.get("print_status"):
            print("subject" + number)
        subject = loadmat(os.path.join(raw_data_path, f"Subject_{number}.mat"))
        s_images = subject["images"]
        s_masks = np.nan_to_num(np.asarray(subject[use_masks], np.float32))
        if s_masks.shape[:2] != s_images.shape[:2]:
            raise ValueError(
                f"--dme_masks={use_masks!r} has shape {s_masks.shape}, "
                f"which is not a per-pixel mask for images of shape "
                f"{s_images.shape}; use a per-pixel key such as "
                f"'manualFluid1'")
        if s_masks.max() > 255:
            raise ValueError(
                f"--dme_masks={use_masks!r} holds values up to "
                f"{s_masks.max():.0f}, which do not fit uint8 class labels")
        for j in range(s_masks.shape[2]):
            mask = s_masks[:, :, j]
            if np.sum(mask) == 0:
                continue
            image = s_images[:, :, j]
            images.append(np.repeat(image[:, :, None], 3, axis=2))
            masks.append(mask.astype(np.uint8))
    return np.stack(images), np.stack(masks)


def preprocess_amd(raw_data_path: str, config: dict):
    raise NotImplementedError()  # as the JAX package and the reference


_LOADERS = {
    "custom": preprocess_custom,
    "dme": preprocess_dme,
    "amd": preprocess_amd,
}


def preprocess(dataset, raw_data_path, processed_data_path, config):
    """Load one raw dataset and write its split; returns (name, save_dir)."""
    if dataset not in _LOADERS:
        raise ValueError("dataset is not implemented")
    verbose = config.get("print_status")
    if verbose:
        print("Start preprocessing")
    images, masks = _LOADERS[dataset](raw_data_path, config)
    if verbose:
        print("Preprocessed images and masks. Now creating dataset")
    name, save_dir = split_and_save(
        images, masks, processed_data_path,
        test_size=config["test_size"], shuffle=config["shuffle"],
        file_description=config.get("additional_file_description",
                                    "default_"),
        time=config.get("time"), seed=config.get("seed"),
        storage=config.get("storage", "png"))
    if verbose:
        print(f"Finished. Dataset name is {name}")
    return name, save_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="custom")
    parser.add_argument("--data_directory", type=str,
                        default="/vol/data/datasets")
    parser.add_argument("--test_size", type=float, default=0.2)
    parser.add_argument("--shuffle", type=_str2bool, default=True)
    parser.add_argument("--dme_masks", type=str, default="manualLayers1")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--storage", type=str, default="png",
                        choices=["png", "raw"],
                        help="'raw' stores arrow tensors (faster to build "
                             "and read, larger on disk)")
    args = parser.parse_args(argv)

    raw_data_path = os.path.join(args.data_directory, "raw", args.dataset)
    processed_data_path = os.path.join(args.data_directory, "processed",
                                       args.dataset)
    config = {
        "test_size": args.test_size,
        "shuffle": args.shuffle,
        "time": timestamp(),
        "print_status": True,
        "additional_file_description": "default_",
        "seed": args.seed,
        "storage": args.storage,
    }
    if args.dataset == "dme":
        config["use_masks"] = args.dme_masks
        config["additional_file_description"] = args.dme_masks + "_"
    return preprocess(args.dataset, raw_data_path, processed_data_path,
                      config)


if __name__ == "__main__":
    main()
