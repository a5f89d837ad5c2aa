"""Port's data path (prompt sampling, collate, the prefetching batch
iterator, one-hot masks, item decoding) against the JAX package's on the
same label maps and seeds: identical arrays, bit for bit."""

import numpy as np
import pytest
import torch

from dilabhelmholtzoct_tpu.data import pipeline as jpipe
from dilabhelmholtzoct_tpu.data import sampling as jsamp
from dilabhelmholtzoct_tpu.data import store as jstore
from dilabhelmholtzoct_tpu.ops import native as jnative
from dilabhelmholtzoct_tpu_torch.data import pipeline as ppipe
from dilabhelmholtzoct_tpu_torch.data import sampling as psamp
from dilabhelmholtzoct_tpu_torch.data import store as pstore


def _label_map(seed, hw=(60, 80), classes=5):
    """Several classes, several components each; some blobs touch only at a
    corner (one component under 8-connectivity)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(hw, np.uint8)
    for c in range(1, classes):
        for _ in range(int(rng.integers(1, 4))):
            y, x = int(rng.integers(0, hw[0] - 8)), int(rng.integers(0, hw[1] - 8))
            h, w = int(rng.integers(2, 9)), int(rng.integers(2, 9))
            lab[y:y + h, x:x + w] = c
    lab[10, 10] = lab[11, 11] = 7  # diagonal neighbours: one component
    return lab


def _items(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (60, 80, 3), dtype=np.uint8),
             "label": _label_map(seed * 100 + i)} for i in range(n)]


def _same(a, b, what=""):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_prompts_matches_jax(prompt_type, seed):
    lab = _label_map(seed)
    want = jsamp.sample_prompts(lab, prompt_type, np.random.default_rng(seed))
    got = psamp.sample_prompts(lab, prompt_type, np.random.default_rng(seed))
    _same(got.bboxes, want.bboxes, "prompts")
    _same(got.comp_map, want.comp_map, "comp_map")
    _same(got.mask_values, want.mask_values, "mask_values")
    _same(got.gt_masks, want.gt_masks, "gt_masks")


@pytest.mark.parametrize("seed", [0, 3])
def test_components_match_the_native_engine(seed):
    """The JAX package's C++ union-find (when its library is built) and the
    port's scipy labelling give the same components, slots and boxes."""
    lab = _label_map(seed)
    got = psamp.extract_components(lab)
    want = jnative.extract_components(lab, psamp.MAX_COMPONENTS)
    if want is None:  # no native library here: JAX's scipy branch
        s = jsamp.sample_prompts(lab, "bboxes", np.random.default_rng(0))
        _same(got[0], s.comp_map, "comp_map")
        _same(got[1], s.mask_values, "values")
        return
    for a, b, what in zip(got[:4], want[:4], ("comp_map", "values", "boxes",
                                              "sizes")):
        _same(a, b, what)
    assert got[4] == want[4]


@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
def test_collate_matches_jax(prompt_type):
    rng = np.random.default_rng(4)
    samples = [jsamp.sample_prompts(_label_map(s), prompt_type, rng)
               for s in range(3)]
    rng = np.random.default_rng(4)
    psamples = [psamp.sample_prompts(_label_map(s), prompt_type, rng)
                for s in range(3)]
    images = np.zeros((3, 60, 80, 3), np.uint8)
    want = jsamp.collate(samples, images,
                         prompt_type=prompt_type, buckets=(4, 8, 16))
    got = psamp.collate(psamples, images, prompt_type=prompt_type,
                        buckets=(4, 8, 16))
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
@pytest.mark.parametrize("with_images", [False, True])
def test_batches_match_jax(prompt_type, with_images):
    """Shuffled epochs of 7 items in batches of 3 (the last padded, index
    -1): identical batches, epoch after epoch."""
    items = _items(7)
    jds = jpipe.PromptedDataset(items, prompt_type=prompt_type, seed=5)
    pds = ppipe.PromptedDataset(items, prompt_type=prompt_type, seed=5)
    for epoch in (0, 1):
        kw = dict(shuffle=True, seed=5, epoch=epoch, buckets=(4, 8, 16),
                  with_images=with_images, num_workers=2)
        want = list(jpipe.batches(jds, 3, **kw))
        got = list(ppipe.batches(pds, 3, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                _same(g[k], w[k], k)
        assert (got[-1]["indices"][1:] == -1).all()
        assert (got[-1]["channel_mask"][1:] == 0).all()
    for i in range(7):
        _same(pds.comp_map(i), jds.comp_map(i), "comp_map")
        _same(pds.image(i), jds.image(i), "image")


def test_pseudocolor_luts_not_ported():
    """The LUTs are ported now: 'Bone' colours the image as the JAX
    package's dataset does, and a name outside COLORMAP_NAMES raises."""
    items = _items(1)
    got = ppipe.PromptedDataset(items, pseudocolor="Bone").image(0)
    _same(got, jpipe.PromptedDataset(items, pseudocolor="Bone").image(0),
          "image")
    with pytest.raises(ValueError, match="colormap"):
        ppipe.PromptedDataset(items, pseudocolor="NoSuchMap")


def test_gt_masks_from_comp_map_matches_jax():
    cm = np.stack([_label_map(s).astype(np.int32) for s in range(2)])
    want = jsamp.gt_masks_from_comp_map(cm, 6)
    _same(psamp.gt_masks_from_comp_map(cm, 6), want, "numpy")
    got = psamp.gt_masks_from_comp_map(torch.tensor(cm).to(torch.uint8), 6)
    assert got.dtype == torch.float32
    _same(got.numpy(), want, "tensor")


def test_item_arrays_on_both_storage_forms():
    from PIL import Image

    rng = np.random.default_rng(6)
    grey = rng.integers(0, 255, (12, 10), dtype=np.uint8)
    lab = rng.integers(0, 4, (12, 10), dtype=np.uint8)
    pil_item = {"image": Image.fromarray(grey),
                "label": Image.fromarray(np.stack([lab] * 3, -1))}
    raw_item = {"image": np.stack([grey] * 3, -1).astype(np.int64).tolist(),
                "label": lab.astype(np.int64).tolist()}
    for item in (pil_item, raw_item):
        got, want = pstore.item_arrays(item), jstore.item_arrays(item)
        for a, b in zip(got, want):
            _same(a, b)
        assert got[0].shape == (12, 10, 3) and got[1].shape == (12, 10)


def test_load_split_needs_datasets_or_says_so(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_datasets(name, *a, **kw):
        if name == "datasets":
            raise ImportError("no datasets")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="splits="):
        pstore.load_split(str(tmp_path), "train")
