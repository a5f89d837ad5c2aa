"""The port's host augmentation and pseudocolor maps against the JAX
package's: each augmentation op and their composition from equal
``np.random.Generator`` states, the 23 colormap tables, and the prompted
dataset under augmentation and a colormap over several epochs. The host
path is numpy on both sides, so every comparison is bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dilabhelmholtzoct_tpu.data import augment as jaug
from dilabhelmholtzoct_tpu.data import pipeline as jpipe
from dilabhelmholtzoct_tpu.ops import preprocess as jpre
from dilabhelmholtzoct_tpu_torch.data import augment as paug
from dilabhelmholtzoct_tpu_torch.data import pipeline as ppipe
from dilabhelmholtzoct_tpu_torch.ops import preprocess as ppre

OPS = ("hflip", "vflip", "brightness", "contrast", "gaussian_noise", "shift")


def _image_and_label(seed, hw=(40, 56)):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    label = np.zeros(hw, np.uint8)
    for c in range(1, 5):
        y, x = int(rng.integers(0, hw[0] - 10)), int(rng.integers(0, hw[1] - 10))
        label[y:y + int(rng.integers(3, 10)), x:x + int(rng.integers(3, 10))] = c
    return image, label


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_op_matches_jax(op, seed):
    image, label = _image_and_label(seed)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(jaug, op)(image, label, rj)
    got = getattr(paug, op)(image, label, rp)
    _same(got[0], want[0], "image")
    _same(got[1], want[1], "label")
    # the same draws: both generators end in the same state
    assert rp.random() == rj.random()


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_augmenter_composition_matches_jax(p):
    for seed in range(6):
        image, label = _image_and_label(10 + seed)
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jaug.Augmenter(list(OPS), p=p)(image, label, rj)
        got = paug.Augmenter(list(OPS), p=p)(image, label, rp)
        _same(got[0], want[0], f"image, seed {seed}")
        _same(got[1], want[1], f"label, seed {seed}")


def test_unknown_augmentation_raises_and_empty_list_is_none():
    with pytest.raises(ValueError, match="unknown augmentations"):
        paug.Augmenter(["hflip", "rotate"])
    with pytest.raises(ValueError, match="unknown augmentations"):
        paug.make_augmenter(("blur",))
    assert paug.make_augmenter(()) is None
    assert paug.make_augmenter(["hflip"]).operations == ["hflip"]


def test_colormap_names_match_jax():
    assert ppre.COLORMAP_NAMES == jpre.COLORMAP_NAMES
    assert len(ppre.COLORMAP_NAMES) == 23


@pytest.mark.parametrize("name", jpre.COLORMAP_NAMES)
def test_colormap_lut_matches_jax(name):
    """Every table equal to the JAX package's (cv2's at run time), and the
    dataset takes every name, colouring as JAX's does."""
    got = ppre.colormap_lut(name)
    _same(got, jpre.colormap_lut(name), name)
    assert not got.flags.writeable  # the cached table cannot be changed
    items = _items(1, seed=7)
    _same(ppipe.PromptedDataset(items, pseudocolor=name).image(0),
          jpipe.PromptedDataset(items, pseudocolor=name).image(0), name)


def test_apply_pseudocolor_matches_jax():
    gray = np.random.default_rng(3).integers(0, 256, (2, 9, 7), dtype=np.uint8)
    lut = ppre.colormap_lut("Turbo")
    want = np.asarray(jpre.apply_pseudocolor(jnp.asarray(gray), lut))
    _same(ppre.apply_pseudocolor(gray, lut), want, "numpy")
    got = ppre.apply_pseudocolor(torch.tensor(gray), lut)
    assert isinstance(got, torch.Tensor)
    _same(got.numpy(), want, "tensor")
    with pytest.raises(ValueError, match="unknown colormap"):
        ppre.colormap_lut("NoSuchMap")


def _items(n, seed=0):
    out = []
    for i in range(n):
        image, label = _image_and_label(seed * 100 + i)
        out.append({"image": image, "label": label})
    return out


@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
def test_augmented_pseudocolor_dataset_matches_jax(prompt_type):
    """Epochs 0-2 of 5 items under every op and 'Jet': each item's image,
    prompts, component map and class values, and the collated batches."""
    items = _items(5)
    kw = dict(prompt_type=prompt_type, pseudocolor="Jet", seed=4)
    jds = jpipe.PromptedDataset(items, augment=jaug.make_augmenter(OPS), **kw)
    pds = ppipe.PromptedDataset(items, augment=paug.make_augmenter(OPS), **kw)
    for epoch in range(3):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(items)):
            (jimg, js), (pimg, ps) = jds[i], pds[i]
            what = f"epoch {epoch} item {i}"
            _same(pimg, jimg, f"image, {what}")
            _same(ps.bboxes, js.bboxes, f"prompts, {what}")
            _same(ps.comp_map, js.comp_map, f"comp_map, {what}")
            _same(ps.mask_values, js.mask_values, f"mask_values, {what}")
        bkw = dict(shuffle=True, seed=4, epoch=epoch, buckets=(4, 8),
                   num_workers=2)
        for g, w in zip(ppipe.batches(pds, 2, **bkw),
                        jpipe.batches(jds, 2, **bkw), strict=True):
            assert set(g) == set(w)
            for k in w:
                _same(g[k], w[k], f"batch {k}, epoch {epoch}")
    # augmentation changes each epoch: epoch 0 and 2 differ somewhere
    pds.set_epoch(0)
    first = [pds[i][0] for i in range(5)]
    pds.set_epoch(2)
    assert any(not np.array_equal(a, pds[i][0]) for i, a in enumerate(first))


def test_image_under_pseudocolor_matches_jax():
    items = _items(3, seed=1)
    for name in ("Jet", "Twilight shifted", "grayscale"):
        jds = jpipe.PromptedDataset(items, pseudocolor=name)
        pds = ppipe.PromptedDataset(items, pseudocolor=name)
        for i in range(3):
            _same(pds.image(i), jds.image(i), f"{name} item {i}")
    _same(ppipe.PromptedDataset(items, pseudocolor="grayscale").image(0),
          items[0]["image"], "grayscale is the stored image")


def test_sample_and_comp_map_refuse_under_augmentation():
    pds = ppipe.PromptedDataset(_items(2), augment=paug.make_augmenter(OPS))
    assert pds._comp_cache is None  # the labels change every access
    with pytest.raises(ValueError, match="cache_embeddings=False"):
        pds.sample(0)
    with pytest.raises(ValueError, match="cache_embeddings=False"):
        pds.comp_map(0)
    # without augmentation both work and the cache fills
    plain = ppipe.PromptedDataset(_items(2))
    plain.sample(0)
    plain.comp_map(1)
    assert sorted(plain._comp_cache) == [0, 1]
