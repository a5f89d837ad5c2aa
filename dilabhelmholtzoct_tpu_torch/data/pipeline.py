"""Host input pipeline: prompted dataset + prefetching batch iterator.

Port of ``dilabhelmholtzoct_tpu/data/pipeline.py``: prompt sampling runs in
a thread pool while the card computes, and batches come out in static
bucketed shapes (``data/sampling.collate``). Each item's randomness comes
from ``SeedSequence([seed, epoch, idx])``, so a run is reproducible and the
same seeds give the JAX package's prompts draw for draw.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator

import numpy as np

from .sampling import (
    DEFAULT_BUCKETS,
    PromptedSample,
    collate,
    extract_components,
    prompts_from_extraction,
)
from .store import item_arrays


class PromptedDataset:
    """Per-item prompt sampling over a stored split (any indexable sequence
    of {'image', 'label'} items).

    The component labelling of each label map is cached across epochs (it
    is a pure function of the map); only the jitter / point draws are fresh
    per epoch. Colormap pseudocolouring is not ported yet: ``pseudocolor``
    other than None / 'grayscale' raises."""

    def __init__(self, dataset, *, prompt_type: str = "bboxes",
                 pseudocolor: str | None = None, seed: int = 0):
        if pseudocolor not in (None, "grayscale"):
            raise NotImplementedError(
                f"pseudocolor {pseudocolor!r}: the colormap LUTs are not "
                "ported yet (None or 'grayscale' only)")
        self.dataset = dataset
        self.prompt_type = prompt_type
        self._seed = seed
        self._epoch = 0
        self._comp_cache: dict[int, tuple] = {}
        # label-only view: HF datasets decode every column on row access,
        # and prompt sampling needs only the label map
        self._labels_only = None
        if hasattr(dataset, "remove_columns"):
            try:
                self._labels_only = dataset.remove_columns(["image"])
            except (ValueError, KeyError):
                pass

    def __len__(self):
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def image(self, idx: int) -> np.ndarray:
        return item_arrays(self.dataset[int(idx)])[0]

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, int(idx)]))

    def _label(self, idx: int) -> np.ndarray:
        if self._labels_only is not None:
            label = np.array(self._labels_only[int(idx)]["label"])
            return label[..., 0] if label.ndim == 3 else label
        return item_arrays(self.dataset[int(idx)])[1]

    def _sample_cached(self, idx: int, rng, label=None) -> PromptedSample:
        hit = self._comp_cache.get(idx)
        if hit is None:
            if label is None:
                label = self._label(idx)
            hit = (extract_components(label), label.shape)
            self._comp_cache[idx] = hit
        return prompts_from_extraction(hit[0], hit[1], self.prompt_type, rng)

    def sample(self, idx: int) -> PromptedSample:
        """Prompts only, no image decode (the embedding-cache path)."""
        return self._sample_cached(int(idx), self._rng(idx))

    def comp_map(self, idx: int) -> np.ndarray:
        """(H, W) int32 component-slot map of one item (RNG-free), so the
        trainer can stage every map on the card once."""
        return self._sample_cached(int(idx), np.random.default_rng(0)).comp_map

    def __getitem__(self, idx: int) -> tuple[np.ndarray, PromptedSample]:
        image, label = item_arrays(self.dataset[int(idx)])
        return image, self._sample_cached(int(idx), self._rng(idx),
                                          label=label)


def batches(dataset: PromptedDataset, batch_size: int, *,
            shuffle: bool = False, seed: int = 0, epoch: int = 0,
            buckets=DEFAULT_BUCKETS, num_workers: int = 8, prefetch: int = 4,
            drop_last: bool = False, with_images: bool = True,
            pad_last: bool = True) -> Iterator[dict]:
    """Prefetching batch iterator with static bucketed shapes.

    pad_last=True pads the final partial batch to ``batch_size`` with zero
    rows whose ``channel_mask`` is all zero (out of every masked loss term)
    and whose ``indices`` are -1, so a consumer that forgets the mask fails
    loudly instead of counting sample 0 twice."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    dataset.set_epoch(epoch)
    chunks = [order[i:i + batch_size] for i in range(0, n, batch_size)]
    if drop_last:
        chunks = [c for c in chunks if len(c) == batch_size]

    def build(idx_chunk):
        if with_images:
            items = [dataset[i] for i in idx_chunk]
            images = np.stack([im for im, _ in items])
            samples = [s for _, s in items]
        else:
            images = None
            samples = [dataset.sample(i) for i in idx_chunk]
        batch = collate(samples, images, prompt_type=dataset.prompt_type,
                        buckets=buckets)
        batch["indices"] = np.asarray(idx_chunk, np.int32)
        pad = batch_size - len(idx_chunk)
        if pad_last and pad > 0:
            for k, v in batch.items():
                batch[k] = np.concatenate(
                    [v, np.zeros((pad, *v.shape[1:]), v.dtype)])
            batch["indices"][len(idx_chunk):] = -1
        return batch

    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        pending = []
        it = iter(chunks)
        for _ in range(prefetch):
            try:
                pending.append(pool.submit(build, next(it)))
            except StopIteration:
                break
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(pool.submit(build, next(it)))
            except StopIteration:
                pass
            yield fut.result()
