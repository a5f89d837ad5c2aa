"""The port's preprocessing CLI and dataset writer against the JAX
package's: the custom PNG loader (its shape gate and its error when no pair
is left), the DME .mat loader (its two refusals), ``amd``, the split written
in both storage forms, and the paths ``main`` builds. Raw data are written
here with cv2 and scipy.io from a seed; the splits must be equal item for
item and the directory names equal."""

import os

import numpy as np
import pytest

from dilabhelmholtzoct_tpu.data import preprocessing as jprep
from dilabhelmholtzoct_tpu.data import store as jstore
from dilabhelmholtzoct_tpu_torch.data import preprocessing as pprep
from dilabhelmholtzoct_tpu_torch.data import store as pstore

SHAPE = (496, 512)


def _write_custom(root, n=6, seed=0, odd_sizes=()):
    """n PNG pairs of the custom layout under root; the names in odd_sizes
    get a 100x120 pair (skipped by the shape gate)."""
    import cv2

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imagesgreyscale")
    mask_dir = os.path.join(root, "masks14")
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    for i in range(n):
        name = f"scan_{i:02d}.png"
        hw = (100, 120) if name in odd_sizes else SHAPE
        grey = rng.integers(0, 256, hw, dtype=np.uint8)
        label = np.zeros(hw, np.uint8)
        label[hw[0] // 4:hw[0] // 2, 10:60] = 1 + i % 13
        label[hw[0] // 2:, 70:110] = 2
        cv2.imwrite(os.path.join(img_dir, name), np.stack([grey] * 3, -1))
        cv2.imwrite(os.path.join(mask_dir, name), np.stack([label] * 3, -1))


def _config(**kw):
    base = {"test_size": 0.25, "shuffle": True, "time": "26-01-02_03.04.05",
            "seed": 7, "print_status": False,
            "additional_file_description": "default_"}
    base.update(kw)
    return base


def _assert_splits_equal(dir_a, dir_b):
    import datasets

    a, b = datasets.load_from_disk(dir_a), datasets.load_from_disk(dir_b)
    assert set(a) == set(b) == {"train", "test"}
    for split in ("train", "test"):
        assert len(a[split]) == len(b[split]) > 0
        for ia, ib in zip(a[split], b[split]):
            for x, y in zip(pstore.item_arrays(ia), jstore.item_arrays(ib)):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


# png encoding goes through Python lists (~1.5 s per 496x512 item): fewer
@pytest.mark.parametrize("storage,n,sizes", [("png", 3, (1, 1)),
                                             ("raw", 6, (3, 2))])
def test_custom_preprocess_matches_jax(tmp_path, storage, n, sizes):
    raw = tmp_path / "raw" / "custom"
    _write_custom(str(raw), n=n, odd_sizes=("scan_01.png",))
    config = _config(storage=storage)
    want = jprep.preprocess("custom", str(raw), str(tmp_path / "jax"), config)
    got = pprep.preprocess("custom", str(raw), str(tmp_path / "port"), config)
    assert os.path.basename(got[1]) == os.path.basename(want[1]) == got[0]
    assert got[0] == want[0] == "default_preprocessed_at_26-01-02_03.04.05"
    _assert_splits_equal(got[1], want[1])
    import datasets

    split = datasets.load_from_disk(got[1])
    # all pairs but one pass the 496x512x3 gate, split at test_size 0.25
    assert (len(split["train"]), len(split["test"])) == sizes
    image, label = pstore.item_arrays(split["train"][0])
    assert image.shape == (*SHAPE, 3) and label.shape == SHAPE


def test_custom_loader_skips_odd_sizes_and_refuses_no_pairs(tmp_path, capsys):
    raw = str(tmp_path / "raw")
    _write_custom(raw, n=3, odd_sizes=("scan_01.png",))
    images, masks = pprep.preprocess_custom(raw, {"print_status": True})
    want_i, want_m = jprep.preprocess_custom(raw, {})
    np.testing.assert_array_equal(images, want_i)
    np.testing.assert_array_equal(masks, want_m)
    assert images.shape == (2, *SHAPE, 3) and masks.shape == (2, *SHAPE)
    assert "Skipped image of different size! scan_01.png" in capsys.readouterr().out

    empty = str(tmp_path / "empty")
    _write_custom(empty, n=2, odd_sizes=("scan_00.png", "scan_01.png"))
    for mod in (pprep, jprep):
        with pytest.raises(FileNotFoundError, match="no valid image/mask"):
            mod.preprocess_custom(empty, {})


def _write_dme(root, masks_key="manualFluid1", seed=0, bad=None):
    """10 tiny subjects (8 x 10 B-scans, 4 each) in the Chiu-2015 layout;
    some masks empty, some NaN. bad='shape' writes layer-boundary rows of
    another shape under the key, bad='range' values above 255."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(10):
        images = rng.integers(0, 256, (8, 10, 4), dtype=np.uint8)
        masks = np.zeros((8, 10, 4), np.float64)
        masks[2:5, 3:7, 1] = 1 + s % 3
        masks[1:3, 0:4, 3] = 2
        masks[0, 0, 2] = np.nan  # NaN only: an empty mask after nan_to_num
        if bad == "shape":
            masks = rng.integers(0, 8, (2, 10, 4)).astype(np.float64)
        elif bad == "range" and s == 4:
            masks[0, 0, 1] = 300
        savemat(os.path.join(root, f"Subject_{s + 1:02d}.mat"),
                {"images": images, masks_key: masks})


def test_dme_loader_matches_jax_and_refuses_bad_masks(tmp_path):
    root = str(tmp_path / "dme")
    _write_dme(root)
    config = {"use_masks": "manualFluid1"}
    images, masks = pprep.preprocess_dme(root, config)
    want_i, want_m = jprep.preprocess_dme(root, config)
    for got, want in ((images, want_i), (masks, want_m)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # two non-empty B-scans per subject, grey repeated into 3 channels
    assert images.shape == (20, 8, 10, 3) and masks.dtype == np.uint8

    for bad, match in (("shape", "not a per-pixel mask"),
                       ("range", "do not fit uint8")):
        root_bad = str(tmp_path / f"dme_{bad}")
        _write_dme(root_bad, masks_key="manualLayers1", bad=bad)
        for mod in (pprep, jprep):
            with pytest.raises(ValueError, match=match):
                mod.preprocess_dme(root_bad, {})


def test_dme_preprocess_writes_the_jax_split(tmp_path):
    root = str(tmp_path / "dme")
    _write_dme(root, seed=3)
    config = _config(use_masks="manualFluid1", storage="png",
                     additional_file_description="manualFluid1_")
    want = jprep.preprocess("dme", root, str(tmp_path / "jax"), config)
    got = pprep.preprocess("dme", root, str(tmp_path / "port"), config)
    assert got[0] == want[0] == \
        "manualFluid1_preprocessed_at_26-01-02_03.04.05"
    _assert_splits_equal(got[1], want[1])


def test_amd_and_unknown_datasets_raise(tmp_path):
    with pytest.raises(NotImplementedError):
        pprep.preprocess("amd", str(tmp_path), str(tmp_path), _config())
    with pytest.raises(ValueError, match="not implemented"):
        pprep.preprocess("oct5k", str(tmp_path), str(tmp_path), _config())


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "dme", "--dme_masks", "manualFluid1", "--test_size", "0.3",
     "--shuffle", "false", "--seed", "3", "--storage", "raw"],
    ["--dataset", "custom", "--data_directory", "/data/oct", "--seed", "1"],
])
def test_main_builds_the_jax_paths_and_config(monkeypatch, argv):
    calls = {}
    for name, mod in (("jax", jprep), ("port", pprep)):
        monkeypatch.setattr(
            mod, "preprocess",
            lambda *args, _name=name: calls.setdefault(_name, args))
        mod.main(argv)
    (jd, jraw, jproc, jconf), (pd, praw, pproc, pconf) = (calls["jax"],
                                                          calls["port"])
    assert (pd, praw, pproc) == (jd, jraw, jproc)
    assert praw.endswith(os.path.join("raw", pd))
    assert pproc.endswith(os.path.join("processed", pd))
    jconf, pconf = dict(jconf), dict(pconf)
    assert len(pconf.pop("time")) == len(jconf.pop("time"))  # taken apart
    assert pconf == jconf


def test_missing_package_is_named(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    with pytest.raises(ImportError, match="opencv-python"):
        pprep.preprocess_custom(str(tmp_path), {})
    monkeypatch.setitem(sys.modules, "scipy.io", None)
    with pytest.raises(ImportError, match="'scipy'"):
        pprep.preprocess_dme(str(tmp_path), {})
