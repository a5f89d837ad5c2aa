"""``training()`` under data parallelism on the CPU: two ranks over gloo
(``tests/torch_dp_worker.py``; ``multihost=True`` with the group named by
the env ``torchrun`` sets) for 2 epochs on tiny splits whose batches of 3
pad to 4, then resumed to 3 epochs, against the same runs in one process
with ``data_parallel=False`` (rtol 1e-4, the JAX package's DP tests'
tolerance, ``tests/test_training.py``); rank 0 alone writes; and the JAX
package's refusal of the host topological pairing under ``multihost``."""

import json
import os

import numpy as np
import pytest

from dilabhelmholtzoct_tpu_torch.train import trainer as ptr
from torch_dp_worker import run_pair, train_config, train_items, \
    training_results

RTOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results (sharing one checkpoint root) and the
    single-process run's (its own root)."""
    root = tmp_path_factory.mktemp("dp")
    run_pair("training", str(root / "ck"), str(root / "rank{rank}.json"))
    ranks = [json.loads((root / f"rank{r}.json").read_text())
             for r in (0, 1)]
    single = training_results(str(root / "single"), data_parallel=False)
    return root, ranks, single


def _losses(history):
    return [(h["epoch"], h["train_loss"], h["valid_loss"]) for h in history]


@pytest.mark.parametrize("which", ["history", "resumed"])
def test_two_rank_history_matches_single_process(runs, which):
    """Every epoch's train and valid loss: the ranks agree exactly (the
    logged losses are the all-reduced global ones), and match the
    single-process run within rtol 1e-4; the resumed run starts at epoch
    2 on every rank."""
    _, ranks, single = runs
    assert _losses(ranks[0][which]) == _losses(ranks[1][which])
    got, want = _losses(ranks[0][which]), _losses(single[which])
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == (
        [0, 1] if which == "history" else [2])
    np.testing.assert_allclose(np.array(got)[:, 1:], np.array(want)[:, 1:],
                               rtol=RTOL)
    assert np.isfinite(np.array(got)).all()


def test_only_rank_zero_writes_the_run(runs):
    """Rank 0 saves every epoch's checkpoint and the export; rank 1 none.
    The run directory holds what one writer leaves: the kept steps, one
    metrics line per logged value (as the single-process run's), and the
    export beside it."""
    root, ranks, single = runs
    assert (ranks[0]["save"], ranks[0]["export"]) == (3, 1)
    assert (ranks[1]["save"], ranks[1]["export"]) == (0, 0)
    run_dir = root / "ck" / "run"
    assert sorted(d for d in os.listdir(run_dir) if d.startswith("step_")) \
        == ["step_1", "step_2"]
    assert (root / "ck" / "run_t0.pt").is_file()
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    want = (root / "single" / "run" / "metrics.jsonl").read_text()
    assert len(lines) == len(want.splitlines())


def test_multihost_with_host_topology_raises(tmp_path):
    """As the JAX package: the host pairing does not compose with
    ``multihost``; ``topo_device`` does."""
    config = train_config(str(tmp_path), multihost=True, topological=True,
                          topo_device=False)
    with pytest.raises(ValueError, match="incompatible with multihost"):
        ptr.training(config, splits=(train_items(2, 0), train_items(2, 1)),
                     device="cpu")
    ptr._check_supported(train_config(str(tmp_path), multihost=True,
                                      topological=True, topo_device=True))
