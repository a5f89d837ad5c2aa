"""The port's evaluation slice vs the JAX package on the same inputs: the
natural-layout mask postprocess, every function of the metrics copy, the
per-class report of ``evaluate_metrics`` on a small model (the test-size
model, head_dim 16: its encoder attention is K6's plain version here), the
trainer's ``evaluate=True`` tail and the evaluation CLI's flags.

Tolerances: postprocess 1e-5; metrics exact on the integer counts and 1e-12
on the ratios; probabilities 1e-4 (a whole encoder + decoder + postprocess in
another f32 summation order); the report's confusion metrics equal to 1e-12
wherever no pixel of the class lies within 1e-4 of the 0.5 threshold, its
average precisions (which rank every pixel's probability) to 1e-3."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.data.pipeline import PromptedDataset as JaxDataset
from dilabhelmholtzoct_tpu.eval import cli as jcli
from dilabhelmholtzoct_tpu.eval import harness as jharness
from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.ops import metrics as jmetrics
from dilabhelmholtzoct_tpu.ops import postprocess as jpost
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch.data.pipeline import PromptedDataset
from dilabhelmholtzoct_tpu_torch.eval import cli as pcli
from dilabhelmholtzoct_tpu_torch.eval import harness as pharness
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import metrics as pmetrics
from dilabhelmholtzoct_tpu_torch.ops import postprocess as ppost
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr

ORIG_HW = (48, 64)
PROB_TOL = 1e-4


@pytest.mark.parametrize("orig_hw", [(48, 64), (120, 100), (128, 128)])
def test_postprocess_masks_matches_jax(rng, orig_hw):
    low = rng.normal(size=(2, 3, 32, 32)).astype(np.float32) * 4
    want = jpost.postprocess_masks(jnp.asarray(low), orig_hw, model_size=128)
    got = ppost.postprocess_masks(torch.tensor(low), orig_hw, model_size=128)
    assert got.shape == (2, 3, *orig_hw) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _masks(rng, n=5, hw=(24, 32), empty=False):
    gt = (rng.random((n, *hw)) > 0.6)
    scores = np.clip(gt * 0.4 + rng.random((n, *hw)) * 0.6, 0, 1).astype(
        np.float32)
    scores = np.round(scores, 2)  # ties between scores
    if empty:
        gt[0] = False        # a sample without positives
        scores[1] = 0.0      # ... and one without predictions
    return (scores > 0.5).astype(np.uint8), gt.astype(np.float32), scores


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("name", ["iou", "category_accuracy", "f1", "dice",
                                  "sensitivity", "specificity"])
def test_confusion_metrics_match_jax(rng, name, empty):
    pred, gt, _ = _masks(rng, empty=empty)
    for p, g in ((pred, gt), (pred[0], gt[0]), (pred[1], gt[1])):
        conf = pmetrics.binary_confusion(p, g)
        assert conf == jmetrics.binary_confusion(p, g)
        want = getattr(jmetrics, name)(*conf)
        np.testing.assert_allclose(getattr(pmetrics, name)(*conf), want,
                                   rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("empty", [False, True])
def test_average_precision_matches_jax(rng, empty):
    _, gt, scores = _masks(rng, empty=empty)
    np.testing.assert_allclose(pmetrics.average_precision(scores, gt),
                               jmetrics.average_precision(scores, gt),
                               rtol=1e-12)
    got = pmetrics.average_precision_batched(scores, gt, row_chunk=2)
    np.testing.assert_allclose(
        got, jmetrics.average_precision_batched(scores, gt), rtol=1e-12)
    np.testing.assert_allclose(
        got, [pmetrics.average_precision(s, g) for s, g in zip(scores, gt)],
        rtol=1e-12)


def test_binary_report_and_batched_confusion_match_jax(rng):
    pred, gt, scores = _masks(rng)
    want = jmetrics.binary_report(pred, gt, scores)
    got = pmetrics.binary_report(pred, gt, scores)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    counts = pmetrics.batched_confusion(torch.tensor(pred), torch.tensor(gt))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jmetrics.batched_confusion_jnp(
            jnp.asarray(pred), jnp.asarray(gt))))
    np.testing.assert_array_equal(
        counts.numpy(), [pmetrics.binary_confusion(p, g)
                         for p, g in zip(pred, gt)])


def _items(n, seed):
    """Label maps of background + 3 blobs of classes 1..3 (4 components per
    image: prompt bucket 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = np.zeros(ORIG_HW, np.uint8)
        for c, x0 in zip((1, 2, 3), (2, 22, 44)):
            y = int(rng.integers(2, 28))
            lab[y:y + int(rng.integers(8, 16)),
                x0:x0 + int(rng.integers(8, 16))] = c
        out.append({"image": rng.integers(0, 255, (*ORIG_HW, 3),
                                          dtype=np.uint8), "label": lab})
    return out


def _params(cfg, seed=0):
    """JAX init + N(0, 0.05) on every leaf, N(0, 0.2) rel-pos tables."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), cfg))
    for lp in tree["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (rng.normal(size=lp["attn"][key].shape)
                               * 0.2).astype(np.float32)
    return tree


@pytest.mark.parametrize("prompt_type", ["bboxes", "points"])
def test_evaluate_metrics_matches_jax(prompt_type):
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=3)
    items = _items(4, seed=5)
    jconf = jtr.TrainConfig(prompt_type=prompt_type)
    pconf = ptr.TrainConfig(prompt_type=prompt_type)
    jds = JaxDataset(items, prompt_type=prompt_type, seed=7)
    pds = PromptedDataset(items, prompt_type=prompt_type, seed=7)
    params_j = jax.tree.map(jnp.asarray, tree)
    sd = params_from_jax(tree)

    # per-sample probabilities, the encoder inside
    jinfer = jharness.make_infer_fn(params_j, cfg_j, jconf, ORIG_HW)
    pinfer = pharness.make_infer_fn(sd, cfg_p, pconf, ORIG_HW, device="cpu")
    near = {}
    for i in range(len(items)):
        image, sample = pds[i]
        want = np.asarray(jinfer(*jds[i]))
        got = pinfer(image, sample)
        assert got.shape == want.shape == (sample.n, *ORIG_HW)
        np.testing.assert_allclose(got, want, atol=PROB_TOL)
        for c in range(sample.n):
            v = int(sample.mask_values[c])
            close = bool((np.abs(want[c] - 0.5) <= PROB_TOL).any())
            near[v] = near.get(v, False) or close

    want = jharness.evaluate_metrics(params_j, cfg_j, jconf, jds,
                                     orig_hw=ORIG_HW, batch_encode=3)
    got = pharness.evaluate_metrics(sd, cfg_p, pconf, pds, orig_hw=ORIG_HW,
                                    batch_encode=3, device="cpu")
    assert set(got) == set(want)
    assert {"0", "1", "2", "3"} <= set(got)  # classes 4..13: absent, zeros
    for key in want:
        if key.startswith("_"):
            continue
        assert set(got[key]) == set(want[key])
        for metric, vals in want[key].items():
            tol = 1e-3 if metric == "ap" else (
                1e-12 if not near[int(key)] else 1e-3)
            for k, v in vals.items():
                np.testing.assert_allclose(got[key][metric][k], v, atol=tol,
                                           err_msg=f"{key} {metric} {k}")
    exact = not any(near.values())
    for block in ("_means", "_sample_means"):
        for k, v in want[block].items():
            tol = 1e-12 if exact and k != "ap" else 1e-3
            np.testing.assert_allclose(got[block][k], v, atol=tol)
    for k, v in want["_global"].items():
        assert len(got["_global"][k]) == 14
        assert all(x == 0 for x in got["_global"][k][4:])
        np.testing.assert_allclose(got["_global"][k], v, atol=1e-3)


class _Sample:
    def __init__(self, values, comp_map, bboxes):
        self.mask_values, self.comp_map, self.bboxes = values, comp_map, bboxes
        self.n = len(values)


class _ScanDataset:
    """Two hand-made samples: one whose second component has value 0 (the
    scan stops there, dropping its class-2 component), one with 70
    components (more than the largest bucket: evaluated in chunks)."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.images = rng.integers(0, 255, (2, *ORIG_HW, 3), dtype=np.uint8)
        cm0 = np.zeros(ORIG_HW, np.int32)
        cm0[:24], cm0[24:40, :32], cm0[40:, 32:] = 1, 2, 3
        boxes0 = np.array([[0, 0, 63, 23], [0, 24, 31, 39], [32, 40, 63, 47]],
                          np.float32)
        cm1 = (np.arange(ORIG_HW[0] * ORIG_HW[1]).reshape(ORIG_HW) % 70
               + 1).astype(np.int32)
        boxes1 = np.tile(np.array([[4, 4, 40, 40]], np.float32), (70, 1))
        self.samples = [
            _Sample(np.array([1, 0, 2], np.int32), cm0, boxes0),
            _Sample(np.array([3] * 70, np.int32), cm1, boxes1)]

    def __len__(self):
        return 2

    def image(self, i):
        return self.images[i]

    def sample(self, i):
        return self.samples[i]

    def __getitem__(self, i):
        return self.images[i], self.samples[i]


@pytest.mark.parametrize("batch_encode", [2, 0])
def test_scan_stop_and_chunking_match_jax(batch_encode):
    """The stop-at-second-zero scan and the > 64-component chunking, on the
    batched path and on the per-sample path (``batch_encode=0``)."""
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=4)
    ds = _ScanDataset()
    want = jharness.evaluate_metrics(
        jax.tree.map(jnp.asarray, tree), cfg_j, jtr.TrainConfig(), ds,
        orig_hw=ORIG_HW, batch_encode=batch_encode)
    got = pharness.evaluate_metrics(
        params_from_jax(tree), cfg_p, ptr.TrainConfig(), ds, orig_hw=ORIG_HW,
        batch_encode=batch_encode, device="cpu")
    assert set(got) == set(want) == {"1", "3", "_global", "_means",
                                     "_sample_means"}
    for key in ("1", "3"):
        for metric, vals in want[key].items():
            for k, v in vals.items():
                np.testing.assert_allclose(got[key][metric][k], v, atol=1e-3,
                                           err_msg=f"{key} {metric} {k}")


pconfigs.register_preset("tiny-eval", lambda: pconfigs.sam_tiny(128))


def test_training_with_evaluate_returns_metrics(tmp_path):
    """``training(evaluate=True)`` ends with the report on the validation
    set, from the final parameters; ``eval_device='cpu'`` gives the same."""
    config = ptr.TrainConfig(
        base_model="tiny-eval", checkpoint=str(tmp_path / "ck"), epochs=1,
        batch_size=2, compute_dtype="float32", buckets=(4, 8),
        display_name="run", evaluate=True)
    splits = (_items(2, 0), _items(3, 1))
    result = ptr.training(config, splits=splits, device="cpu")
    metrics = result["metrics"]
    assert {"0", "1", "2", "3", "_global", "_means", "_sample_means"} \
        <= set(metrics)
    assert all(np.isfinite(v) for v in metrics["_means"].values())
    want = pharness.evaluate_metrics(
        result["params"], result["cfg"], config,
        PromptedDataset(splits[1], seed=config.seed + 1), orig_hw=ORIG_HW,
        eval_device="cpu")
    assert metrics == want
    off = ptr.training(dataclasses.replace(config, evaluate=False),
                       splits=splits, device="cpu")
    assert "metrics" not in off


JAX_CLI_ARGV = ["--base_model", "facebook/sam-vit-huge", "--checkpoint",
                "w.pt", "--dataset", "other", "--data_directory", "/data",
                "--dataset_name", "x", "--split", "train", "--prompt",
                "points", "--pseudocolor", "grayscale", "--eval_device", "cpu",
                "--seed", "3", "--report_json", "r.json"]


@pytest.mark.parametrize("argv", [[], JAX_CLI_ARGV])
def test_eval_cli_takes_the_jax_flags(monkeypatch, argv):
    """The same argv builds the same TrainConfig in both CLIs (the JAX one's
    is caught as its ``main`` hands it to ``prepare_model``)."""

    class Caught(Exception):
        pass

    def catch(config):
        raise Caught(config)

    monkeypatch.setattr(jcli, "prepare_model", catch)
    with pytest.raises(Caught) as info:
        jcli.main(argv)
    want = dataclasses.asdict(info.value.args[0])
    args = pcli.build_parser().parse_args(argv)
    assert dataclasses.asdict(pcli.config_from_args(args)) == want
    assert args.device == "cuda"  # the card unless asked for the host


def test_eval_cli_runs_on_the_host(tmp_path, monkeypatch):
    items = _items(3, 2)
    monkeypatch.setattr(pcli, "load_split", lambda path, split: items)
    out = tmp_path / "report.json"
    report = pcli.main(["--base_model", "tiny-eval", "--device", "cpu",
                        "--data_directory", str(tmp_path), "--report_json",
                        str(out)])
    assert json.loads(out.read_text()) == report
    assert "background" in report and "_means" in report
    monkeypatch.setattr(pcli, "load_split", lambda path, split: [])
    with pytest.raises(SystemExit, match="empty"):
        pcli.main(["--base_model", "tiny-eval", "--device", "cpu"])
