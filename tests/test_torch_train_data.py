"""The training run's data options against the JAX package: uncached f32
train steps on augmented, pseudocolored host batches; the sample display
(``display_mode``) on the same weights; the epoch-0 trace (``profile_dir``);
and the refusal of augmentation with cached embeddings.

Inputs are made with numpy from a seed; the parameters are the JAX
package's init perturbed by N(0, 0.05) on every leaf and bridged with
``params_from_jax``. The host batches are numpy on both sides and equal bit
for bit; the losses are held to tests/test_torch_train.py's f32 tolerance
(2e-4 * (1 + step) relative)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.data import augment as jaug
from dilabhelmholtzoct_tpu.data import pipeline as jpipe
from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.train import display as jdisplay
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch.data import augment as paug
from dilabhelmholtzoct_tpu_torch.data import pipeline as ppipe
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.train import display as pdisplay
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr

ORIG_HW = (48, 64)
OPS = ("hflip", "vflip", "brightness", "contrast", "gaussian_noise", "shift")
pconfigs.register_preset("tiny-test", lambda: pconfigs.sam_tiny(128))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), cfg))


def _items(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = np.zeros(ORIG_HW, np.uint8)
        for c in range(1, 4):
            y, x = int(rng.integers(2, 30)), int(rng.integers(2, 44))
            lab[y:y + 14, x:x + 18] = c
        out.append({"image": rng.integers(0, 255, (*ORIG_HW, 3),
                                          dtype=np.uint8), "label": lab})
    return out


def test_uncached_f32_steps_on_augmented_batches_match_jax():
    """Three f32 steps with the encoder inside, one per epoch's first batch
    of an augmented 'Jet' dataset: the host batches equal, each loss within
    2e-4 * (1 + step) relative of JAX's."""
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=3)
    items = _items(4, 8)
    kw = dict(pseudocolor="Jet", seed=2)
    jds = jpipe.PromptedDataset(items, augment=jaug.make_augmenter(OPS), **kw)
    pds = ppipe.PromptedDataset(items, augment=paug.make_augmenter(OPS), **kw)

    conf = dict(compute_dtype="float32", learning_rate=1e-2,
                cache_embeddings=False, data_transforms=OPS,
                pseudocolor="Jet")
    jconf = jtr.TrainConfig(**conf)
    pconf = ptr.TrainConfig(evaluate=False, **conf)
    dec_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree))
    opt_j = jtr.make_optimizer(jconf)
    state_j = opt_j.init(dec_j)
    step_j = jtr.make_train_step(cfg_j, jconf, opt_j, ORIG_HW, False)
    dec_p, frozen_p = ptr._split_params(params_from_jax(tree))
    for v in dec_p.values():
        v.requires_grad_(True)
    opt_p = ptr.make_optimizer(pconf, dec_p.values())
    step_p = ptr.make_train_step(cfg_p, pconf, opt_p, ORIG_HW, False)

    keys = ("image", "prompts", "comp_map", "channel_mask")
    lj, lp = [], []
    for epoch in range(3):
        bkw = dict(shuffle=True, seed=2, epoch=epoch, buckets=(4, 8),
                   num_workers=1)
        jb = next(iter(jpipe.batches(jds, 2, **bkw)))
        pb = next(iter(ppipe.batches(pds, 2, **bkw)))
        for k in keys:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        dec_j, state_j, loss = step_j(
            dec_j, state_j, frozen_j, {k: jnp.asarray(jb[k]) for k in keys})
        lj.append(float(loss))
        dec_p, opt_p, loss = step_p(dec_p, opt_p, frozen_p,
                                    {k: torch.tensor(pb[k]) for k in keys})
        lp.append(float(loss))
    for i, (a, b) in enumerate(zip(lp, lj)):
        tol = 2e-4 * (1 + i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"step {i}: port {lp} jax {lj}")


class _Images:
    def __init__(self):
        self.logged = {}

    def log_images(self, key, images):
        self.logged[key] = images


def _loop_config(tmp_path, **kw):
    base = dict(base_model="tiny-test", checkpoint=str(tmp_path / "ck"),
                learning_rate=3e-2, epochs=1, batch_size=2, evaluate=False,
                compute_dtype="float32", buckets=(4, 8), display_name="run",
                ckpt_keep=1, cache_embeddings=False)
    base.update(kw)
    return ptr.TrainConfig(**base)


def test_training_display_matches_jax_display_samples(tmp_path):
    """training(device='cpu') with display_mode='predefined' on augmented,
    pseudocolored splits: the panels written before the first epoch carry
    the names JAX's display_samples gives them on the same weights and
    datasets, the image and ground-truth thirds equal bit for bit, the
    prediction overlay equal on at least 99.9% of the pixels; the panels
    after the epoch are written too."""
    from PIL import Image

    cfg_j = jconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=4)
    ckpt = str(tmp_path / "weights.pt")
    torch.save(params_from_jax(tree), ckpt)
    splits = (_items(4, 0), _items(3, 1))
    config = _loop_config(tmp_path, pretrained_checkpoint=ckpt, seed=5,
                          display_mode="predefined", display_idx=(0, 2),
                          data_transforms=("hflip", "shift"),
                          pseudocolor="Jet")
    result = ptr.training(config, splits=splits, device="cpu")
    port_dir = os.path.join(result["checkpoint_dir"], "display")

    jconf = jtr.TrainConfig(display_mode="predefined", display_idx=(0, 2),
                            compute_dtype="float32", buckets=(4, 8))
    jdir = str(tmp_path / "jax")
    logger = _Images()
    for split, items, seed, augment in (
            ("train", splits[0], 5, jaug.make_augmenter(("hflip", "shift"))),
            ("test", splits[1], 6, None)):
        ds = jpipe.PromptedDataset(items, pseudocolor="Jet", seed=seed,
                                   augment=augment)
        jdisplay.display_samples(jax.tree.map(jnp.asarray, tree), cfg_j,
                                 jconf, ds, split, logger, jdir, epoch=-1,
                                 orig_hw=ORIG_HW)
    want = sorted(os.listdir(os.path.join(jdir, "display")))
    assert want == ["test_e-1_i0.png", "test_e-1_i2.png", "train_e-1_i0.png",
                    "train_e-1_i2.png"]
    got = sorted(os.listdir(port_dir))
    assert got == sorted(want + [n.replace("e-1", "e0") for n in want])
    w = ORIG_HW[1]
    for name in want:
        p = np.asarray(Image.open(os.path.join(port_dir, name)))
        j = np.asarray(Image.open(os.path.join(jdir, "display", name)))
        assert p.shape == j.shape == (ORIG_HW[0], 3 * w, 3)
        np.testing.assert_array_equal(p[:, :w], j[:, :w], err_msg=name)
        np.testing.assert_array_equal(p[:, 2 * w:], j[:, 2 * w:],
                                      err_msg=name)
        same = (p[:, w:2 * w] == j[:, w:2 * w]).all(axis=-1).mean()
        assert same >= 0.999, (name, same)


def test_display_selects_as_jax_and_refuses_unknown_modes():
    for mode, n in (("predefined", 3), ("random_equal", 50), ("none", 9)):
        conf = ptr.TrainConfig(display_mode=mode, display_idx=(0, 1, 3),
                               display_train_nr=4, display_val_nr=2)
        jconf = jtr.TrainConfig(display_mode=mode, display_idx=(0, 1, 3),
                                display_train_nr=4, display_val_nr=2)
        for split in ("train", "test"):
            assert pdisplay._select_indices(conf, split, n) == \
                jdisplay._select_indices(jconf, split, n)
    bad = ptr.TrainConfig(display_mode="sometimes")
    with pytest.raises(ValueError, match="unknown display_mode"):
        pdisplay._select_indices(bad, "train", 4)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 6, 5))
    values = np.array([0, 3, 7, 20], np.int32)
    np.testing.assert_array_equal(pdisplay._class_map(logits, values),
                                  jdisplay._class_map(logits, values))
    image = rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        pdisplay._overlay(image, pdisplay._class_map(logits, values)),
        jdisplay._overlay(image, jdisplay._class_map(logits, values)))
    np.testing.assert_array_equal(pdisplay._PALETTE, jdisplay._PALETTE)


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    trace_dir = tmp_path / "traces"
    ptr.training(_loop_config(tmp_path, profile_dir=str(trace_dir),
                              epochs=2),
                 splits=(_items(2, 0), _items(2, 1)), device="cpu")
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")  # epoch 0
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_data_transforms_with_cached_embeddings_raise(tmp_path):
    config = _loop_config(tmp_path, data_transforms=("hflip",),
                          cache_embeddings=True)
    with pytest.raises(ValueError, match="requires cache_embeddings=False"):
        ptr.training(config, splits=(_items(2, 0), _items(2, 1)),
                     device="cpu")
    with pytest.raises(ValueError, match="unknown augmentations"):
        ptr.training(dataclasses.replace(config, data_transforms=("blur",),
                                         cache_embeddings=False),
                     splits=(_items(2, 0), _items(2, 1)), device="cpu")
