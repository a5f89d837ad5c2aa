"""The port's component engine (``csrc/components_host.cc`` through
``ops/native.py`` and ``data/sampling.py``) against the JAX package's
(``ops/native.py``: ``label_components_8``, ``extract_components``,
``component_pixel_at``; ``data/sampling.py``: ``extract_for_sampling``,
``prompts_from_extraction``) and against the port's own scipy twins, on the
same label maps and seeds.

Tolerance: none. Component maps, class values, boxes, sizes, totals, the
drawn boxes and points are equal bit for bit. Where the JAX package's
library is not built, its functions take their scipy branches, which the
comparisons then hold the engine to (below the 256-component cap, where
that branch has no cap)."""

import concurrent.futures
import functools
import threading

import numpy as np
import pytest

from dilabhelmholtzoct_tpu.data import sampling as jsamp
from dilabhelmholtzoct_tpu.ops import native as jnative
from dilabhelmholtzoct_tpu_torch.data import sampling as psamp
from dilabhelmholtzoct_tpu_torch.inference import synthetic
from dilabhelmholtzoct_tpu_torch.ops import native


@functools.lru_cache(maxsize=None)
def _oct_maps():
    """The 24 label maps of the card's data phases: background and 7 blobs
    on 496x512."""
    items = (synthetic.oct_training_items(16, seed=1)
             + synthetic.oct_training_items(8, seed=2))
    return tuple(it["label"] for it in items)


def _above_cap():
    """Three classes of sparse noise on 96x96: over a thousand components,
    far above the 256 cap."""
    rng = np.random.default_rng(11)
    return ((rng.random((96, 96)) < 0.35)
            * rng.integers(1, 4, (96, 96))).astype(np.uint8)


def _non_square():
    """37x53 rectangles of 5 classes, some overlapping."""
    rng = np.random.default_rng(12)
    lab = np.zeros((37, 53), np.uint8)
    for c in range(1, 6):
        for _ in range(3):
            y, x = rng.integers(0, 33), rng.integers(0, 49)
            lab[y:y + rng.integers(1, 9), x:x + rng.integers(1, 11)] = c
    return lab


def _diagonal():
    """Pixels that touch only at corners: one component each diagonal under
    8-connectivity, single pixels under 4, and a background that the
    diagonals cut apart."""
    lab = np.zeros((24, 24), np.uint8)
    i = np.arange(24)
    lab[i, i] = 1
    lab[i, 23 - i] = 2
    lab[i[::3], (i[::3] + 5) % 24] = 3
    return lab


MAPS = {
    "oct_items": lambda: _oct_maps(),
    "above_cap": lambda: (_above_cap(),),
    "single_class": lambda: (np.full((40, 50), 3, np.uint8),),
    "all_zero": lambda: (np.zeros((30, 30), np.uint8),),
    "non_square_37x53": lambda: (_non_square(),),
    "diagonal_only": lambda: (_diagonal(),),
}


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_extraction(got, want):
    for a, b, what in zip(got[:4], want[:4], ("comp_map", "values", "boxes",
                                              "sizes")):
        _same(a, b, what)
    assert got[4] == want[4]


@pytest.mark.parametrize("case", sorted(MAPS))
def test_label_components_match_jax_and_scipy(case):
    """Every class's mask and the foreground mask: the engine's labels and
    count equal JAX's ``label_components_8`` and ``scipy.ndimage.label``."""
    for lab in MAPS[case]():
        for mask in [lab > 0] + [lab == v for v in np.unique(lab)]:
            got = psamp.label_components(mask)
            for want in (jnative.label_components_8(mask),
                         psamp.label_components_plain(mask)):
                _same(got[0], want[0], "labels")
                assert got[1] == want[1]


@pytest.mark.parametrize("case", sorted(MAPS))
def test_extract_components_matches_jax(case):
    """comp_map, values, boxes, sizes and total: the engine against JAX's
    ``extract_for_sampling`` (its C++ pass) and the port's scipy twin."""
    for lab in MAPS[case]():
        got = psamp.extract_components(lab)
        _same_extraction(got, psamp.extract_components_plain(lab))
        want = jsamp.extract_for_sampling(lab)
        if want is None:  # no JAX library: its scipy branch, uncapped
            assert got[4] <= psamp.MAX_COMPONENTS
            s = jsamp.sample_prompts(lab, "bboxes", np.random.default_rng(0))
            _same(got[0], s.comp_map, "comp_map")
            _same(got[1], s.mask_values, "values")
            continue
        _same_extraction(got, want)


def test_cap_counts_every_component():
    """Above the cap: 256 slots emitted in order, the rest counted in total
    and absent from comp_map."""
    lab = _above_cap()
    comp_map, values, boxes, sizes, total = psamp.extract_components(lab)
    assert total > 4 * psamp.MAX_COMPONENTS
    assert len(values) == len(boxes) == len(sizes) == psamp.MAX_COMPONENTS
    assert comp_map.max() == psamp.MAX_COMPONENTS
    np.testing.assert_array_equal(
        np.bincount(comp_map.reshape(-1), minlength=257)[1:], sizes)
    assert (np.diff(values) >= 0).all()  # ascending class values
    small = psamp.extract_components(lab, max_comps=5)
    assert small[4] == total
    _same(small[0], np.where(comp_map <= 5, comp_map, 0), "capped comp_map")


@pytest.mark.parametrize("case", sorted(MAPS))
def test_component_pixel_at_matches_jax(case):
    """Ranks drawn from a seed: the engine's pick of each slot's pixel
    equals JAX's ``component_pixel_at`` and the ``flatnonzero`` twin."""
    rng = np.random.default_rng(sorted(MAPS).index(case))
    for lab in MAPS[case]():
        comp_map, _, _, sizes, _ = psamp.extract_components(lab)
        ranks = np.asarray([rng.integers(0, s) for s in sizes], np.int64)
        got = native.component_pixel_at(comp_map, ranks)
        _same(got, jnative.component_pixel_at(comp_map, ranks), "jax")
        _same(got, psamp.component_pixel_at_plain(comp_map, ranks), "plain")
        if len(ranks):  # the last pixel of each slot too
            last = sizes.astype(np.int64) - 1
            _same(native.component_pixel_at(comp_map, last),
                  psamp.component_pixel_at_plain(comp_map, last), "last")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
@pytest.mark.parametrize("case", sorted(MAPS))
def test_prompts_match_jax(case, prompt_type, seed):
    """The drawn boxes or points, comp_map and values: the engine's
    ``prompts_from_extraction`` and ``sample_prompts`` against JAX's
    ``prompts_from_extraction`` on its ``extract_for_sampling`` and against
    the port's plain twins, from one seed."""
    for lab in MAPS[case]()[:4]:
        got = psamp.prompts_from_extraction(
            psamp.extract_components(lab), lab.shape, prompt_type,
            np.random.default_rng(seed))
        twin = psamp.prompts_from_extraction_plain(
            psamp.extract_components_plain(lab), lab.shape, prompt_type,
            np.random.default_rng(seed))
        sampled = psamp.sample_prompts(lab, prompt_type,
                                       np.random.default_rng(seed))
        native_j = jsamp.extract_for_sampling(lab)
        if native_j is None:
            want = jsamp.sample_prompts(lab, prompt_type,
                                        np.random.default_rng(seed))
        else:
            want = jsamp.prompts_from_extraction(
                native_j, lab.shape, prompt_type, np.random.default_rng(seed))
        for other in (twin, sampled, want):
            _same(got.bboxes, other.bboxes, "prompts")
            _same(got.comp_map, other.comp_map, "comp_map")
            _same(got.mask_values, other.mask_values, "mask_values")


def test_class_values_outside_a_byte_raise():
    lab = np.zeros((8, 8), np.int32)
    lab[2, 2] = 300
    with pytest.raises(ValueError, match="0..255"):
        psamp.extract_components(lab)
    lab[2, 2] = 200  # wider integer maps within a byte are taken
    _same_extraction(psamp.extract_components(lab),
                     psamp.extract_components_plain(lab))


def test_engine_raises_when_the_library_cannot_be_built(tmp_path,
                                                        monkeypatch):
    """No quiet fallback to scipy: prompt sampling raises with the
    compiler's output when the host library cannot be built."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'compiler says no' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)failed.*compiler says no"):
        psamp.sample_prompts(_non_square(), "points",
                             np.random.default_rng(0))


def test_first_build_from_many_threads(tmp_path, monkeypatch):
    """The data loader's threads reach the engine together on a fresh
    checkout: one of them builds the library, the others wait for it, and
    every thread gets the engine's prompts. The compiler here copies the
    library built by the real one after a pause, and logs each run."""
    built = native.build()
    log = tmp_path / "runs"
    cxx = tmp_path / "cxx"
    cxx.write_text(
        "#!/bin/sh\n"
        f"echo run >> '{log}'\n"
        "while [ \"$1\" != -o ]; do shift; done\n"
        f"sleep 0.3; cp '{built}' \"$2\"\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", str(cxx))
    lab = _non_square()
    want = psamp.prompts_from_extraction_plain(
        psamp.extract_components_plain(lab), lab.shape, "points",
        np.random.default_rng(0))
    start = threading.Barrier(6)

    def one(_):
        start.wait()
        return psamp.sample_prompts(lab, "points", np.random.default_rng(0))

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        got = list(pool.map(one, range(6)))
    assert log.read_text().count("run") == 1
    assert [p.name for p in (tmp_path / "out").iterdir()] == [
        native.library_path().name]
    for g in got:
        _same(g.bboxes, want.bboxes, "prompts")
        _same(g.comp_map, want.comp_map, "comp_map")
