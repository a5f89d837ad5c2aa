"""The block-parallel algorithm of the card's T1 and T2 (``csrc/topology.cu``
on the phases of ``csrc/persistence_parallel.h``) on the CPU: the host
library's ``cubical_pairs_parallel`` / ``wasserstein_match_parallel`` run
those phases over 1, 32 and 256 virtual threads, and must equal the host
library's sequential algorithm (``native.cubical_pairs_batch`` on
``sublevel_pairs``, ``native.wasserstein_match_batch`` on
``min_cost_assign``) and the plain twin ``cubical_pairs_plain``. Grids of
100x100 to 255x255 (the card's global route; int32 slots from 182x182, the
first of 2^15 pixels or more) run at 32 and 256 virtual threads against the
host library only: the twin's pure-Python union-find takes seconds there.

Inputs are made with numpy from a seed. Tolerance: none. The bars must be
equal index for index and in emission order, with the same counts and the
same cap. The matchings must be equal match for match, and the constant
term to the bit: the phases compute the same f32 and f64 values in the same
order."""

import numpy as np
import pytest
import torch

from dilabhelmholtzoct_tpu_torch.ops import native
from dilabhelmholtzoct_tpu_torch.ops import topology as pt
from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

THREADS = (1, 32, 256)


def _sigmoid_noise(rng, shape):
    return (1 / (1 + np.exp(-rng.normal(size=shape)))).astype(np.float32)


def _blobs(rng, n, h=50, w=50):
    """Near-binary grids: plateaus of 0 and 1 (rectangles, some with a
    hole) with a little noise on a few pixels, as trained predictions."""
    out = np.zeros((n, h, w), np.float32)
    for i in range(n):
        for _ in range(3):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
            dy, dx = rng.integers(6, 12, 2)
            out[i, y:y + dy, x:x + dx] = 1.0
            if i % 2:
                out[i, y + 2:y + dy - 2, x + 2:x + dx - 2] = 0.0
        few = rng.random((h, w)) < 0.05
        out[i][few] = np.clip(out[i][few] + rng.normal(size=few.sum()) * 0.1,
                              0.0, 1.0)
    return out


def _downsampled_mask(rng, n):
    """Binary masks at 200x200 (discs) through the loss's align-corners
    downsample to 50x50, as the step's true grids."""
    yy, xx = np.mgrid[:200, :200]
    masks = np.zeros((n, 200, 200), bool)
    for i in range(n):
        for _ in range(4):
            cy, cx = rng.integers(20, 180, 2)
            r = rng.integers(8, 30)
            masks[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return pt.downsample_grid(torch.from_numpy(masks.astype(np.float32)),
                              50).numpy()


T1_CASES = {
    # case: (grids from a seeded rng, max_bars)
    "noise_50x50": (lambda rng: _sigmoid_noise(rng, (3, 50, 50)), 512),
    "blobs_plateaus": (lambda rng: _blobs(rng, 4), 512),
    "downsampled_mask": (lambda rng: _downsampled_mask(rng, 3), 512),
    "quantized_plateaus": (lambda rng: (np.round(rng.random((3, 30, 20)) * 3)
                                        / 3).astype(np.float32), 512),
    "constant": (lambda rng: np.full((2, 12, 12), 0.5, np.float32), 512),
    "row_1x50": (lambda rng: rng.random((3, 1, 50)).astype(np.float32), 512),
    "col_50x1": (lambda rng: rng.random((3, 50, 1)).astype(np.float32), 512),
    # more than 512 bars a pass: the cap keeps the 512 most persistent
    "above_cap_72x72": (lambda rng: _sigmoid_noise(rng, (2, 72, 72)), 512),
    # equal persistences at the cap, in emission order
    "above_cap_ties": (lambda rng: (np.round(rng.random((2, 40, 40)) * 6)
                                    / 6).astype(np.float32), 16),
}


def _noise_and_blobs(size):
    """One grid of sigmoid noise and one of blobs, size x size."""
    return lambda rng: np.concatenate([_sigmoid_noise(rng, (1, size, size)),
                                       _blobs(rng, 1, size, size)])


# past one block's shared memory (the card's global route)
LARGE = (100, 128, 182, 215, 255)
T1_CASES.update({f"large_{s}x{s}": (_noise_and_blobs(s), 512) for s in LARGE})
T1_PARAMS = [(case, feat_d, threads) for case in sorted(T1_CASES)
             for feat_d in (0, 1)
             for threads in (THREADS if not case.startswith("large")
                             else (32, 256))]


@pytest.mark.parametrize("case,feat_d,threads", T1_PARAMS)
def test_t1_phases_equal_sublevel_pairs(case, feat_d, threads):
    make, k = T1_CASES[case]
    grids = make(np.random.default_rng(sorted(T1_CASES).index(case)))
    birth, death, count, merges = native.cubical_pairs_parallel(
        grids, feat_d, k, threads)
    host = native.cubical_pairs_batch(grids, k)
    np.testing.assert_array_equal(birth, host[f"h{feat_d}_birth"])
    np.testing.assert_array_equal(death, host[f"h{feat_d}_death"])
    np.testing.assert_array_equal(count, host["counts"][:, feat_d])
    if not case.startswith("large"):
        twin = ptd.cubical_pairs_plain(torch.from_numpy(grids), feat_d, k)
        for got, want in zip((birth, death, count), twin):
            np.testing.assert_array_equal(got, want.numpy())
    if case.startswith("above_cap"):
        assert (count == k).all()  # the cap did act
    if case == "constant":
        assert (merges == 0).all() and (count == 0).all()
    # a merge pixel emits at most its slots less one bars
    assert (count <= merges * (8 if feat_d == 0 else 4)).all()


def test_t1_phases_refuse_grids_beyond_16_bit_indices():
    """JAX's capacity, 65534 cells (two of the 2^16 ids reserved): a
    256x256 grid raises ValueError in the phases and in
    ``device_cubical_pairs`` on the CPU, where 255x255 and 65534 cells
    run."""
    for fn in (lambda g: native.cubical_pairs_parallel(g, 1),
               lambda g: ptd.device_cubical_pairs(torch.from_numpy(g), 0)):
        with pytest.raises(ValueError, match="65534 cells"):
            fn(np.zeros((1, 256, 256), np.float32))
    got = native.cubical_pairs_parallel(np.zeros((1, 2, 32767), np.float32),
                                        0)
    assert got[2][0] == 0


def _bars(rng, n, nb, nt, hw, quantum=None):
    """T2's operands in its layout: n rows of nb pred bars (pixel indices
    into (n, hw) grids) and nt true bars (values; (n, nt_max, 2) padded)."""
    grids = rng.random((n, hw)).astype(np.float32)
    if quantum:  # few distinct values: many equal costs
        grids = (np.round(grids / quantum) * quantum).astype(np.float32)
    k = max(nb, 1)
    p_birth = np.full((n, k), -1, np.int32)
    p_death = np.full((n, k), -1, np.int32)
    for i in range(n):
        p_birth[i, :nb] = rng.integers(0, hw, nb)
        p_death[i, :nb] = rng.integers(0, hw, nb)
    true_bars = rng.random((n, max(nt, 1), 2)).astype(np.float32)
    if quantum:
        true_bars = (np.round(true_bars / quantum) * quantum).astype(
            np.float32)
    p_count = np.full((n,), nb, np.int32)
    t_count = np.full((n,), nt, np.int32)
    return grids, p_birth, p_death, p_count, true_bars, t_count


T2_CASES = {
    # case: (nb, nt, quantum of the values, q)
    "no_true_bar": (40, 0, None, 2.0),
    "one_true_bar": (40, 1, None, 2.0),
    "one_true_bar_q1": (40, 1, None, 1.0),
    "more_true_than_pred": (12, 30, None, 2.0),  # rows: the pred bars
    "no_pred_bar": (0, 5, None, 2.0),
    "cost_ties": (24, 20, 0.25, 2.0),
    "cost_ties_rows_pred": (20, 24, 0.25, 1.0),
    "200_a_side": (200, 200, None, 2.0),
    "200_a_side_rows_pred": (199, 200, None, 2.0),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(T2_CASES))
def test_t2_phases_equal_min_cost_assign(case, threads):
    nb, nt, quantum, q = T2_CASES[case]
    rng = np.random.default_rng(100 + sorted(T2_CASES).index(case))
    grids, pb, pd, pc, tb, tc = _bars(rng, 3, nb, nt, 64, quantum)
    matched, target, const_term, steps = native.wasserstein_match_parallel(
        grids, pb, pd, pc, tb, tc, q, threads)
    want = native.wasserstein_match_batch(
        grids, pb, pd, pc, [tb[i, :tc[i]] for i in range(len(tc))], q,
        pb.shape[1])
    for got, w in zip((matched, target, const_term), want):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    # one Dijkstra step at least per row of the smaller diagram
    assert (steps >= min(nb, nt)).all()
    if nt == 0:
        assert not matched.any() and (const_term == 0).all()
