"""The port's training slice as a whole against the JAX package: the train
step (f32 and bf16), the epoch loop with resume, retention and export, and
the CLI.

Inputs are made with numpy from a seed and handed to both packages; the
parameters are the JAX package's init perturbed by N(0, 0.05) on every
leaf (so no bias or table is zero) and bridged with ``params_from_jax``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models.convert import (
    load_state_dict,
    params_from_jax,
)
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr

LR = 1e-2
ORIG_HW = (48, 64)


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), cfg))


def _batch(rng, b, n_comp, hw=ORIG_HW):
    img = rng.integers(0, 255, (b, *hw, 3)).astype(np.uint8)
    comp_map = np.zeros((b, *hw), np.int32)
    boxes = np.zeros((b, n_comp, 4), np.float32)
    for i in range(b):
        for c in range(n_comp):
            y, x = int(rng.integers(2, hw[0] // 2)), int(rng.integers(2, hw[1] // 2))
            h, w = int(rng.integers(6, hw[0] // 2)), int(rng.integers(6, hw[1] // 2))
            comp_map[i, y:y + h, x:x + w] = c + 1
            boxes[i, c] = (x, y, x + w, y + h)
    mask = np.ones((b, n_comp), np.float32)
    mask[-1, -1] = 0  # one bucket-padding channel
    return {"image": img, "prompts": boxes, "comp_map": comp_map,
            "channel_mask": mask}


def _jax_hf(tree, cfg):
    """The JAX tree's decoder as the port's HF-named tensors."""
    return {k: v for k, v in params_from_jax(jax.tree.map(np.asarray, tree))
            .items() if k.startswith("mask_decoder.")}


def _run_both(cfg_j, cfg_p, tree, batch, dtype, from_embeddings, n_steps,
              **conf):
    """n_steps of each package's train step from the same parameters on the
    same batch (``conf``: more TrainConfig fields for both); returns (jax
    losses, port losses, jax and port decoder after step 1, decoder
    before)."""
    jconf = jtr.TrainConfig(compute_dtype=dtype, learning_rate=LR,
                            cache_embeddings=from_embeddings, **conf)
    pconf = ptr.TrainConfig(compute_dtype=dtype, learning_rate=LR,
                            cache_embeddings=from_embeddings, evaluate=False,
                            **conf)
    dec_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree))
    opt_j = jtr.make_optimizer(jconf)
    state_j = opt_j.init(dec_j)
    step_j = jtr.make_train_step(cfg_j, jconf, opt_j, ORIG_HW, from_embeddings)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    sd = params_from_jax(tree)
    before = {k: v.clone() for k, v in sd.items()
              if k.startswith("mask_decoder.")}
    dec_p, frozen_p = ptr._split_params(sd)
    for v in dec_p.values():
        v.requires_grad_(True)
    opt_p = ptr.make_optimizer(pconf, dec_p.values())
    step_p = ptr.make_train_step(cfg_p, pconf, opt_p, ORIG_HW,
                                 from_embeddings)
    pb = {k: torch.tensor(v) for k, v in batch.items()}

    lj, lp, first = [], [], None
    for i in range(n_steps):
        dec_j, state_j, loss = step_j(dec_j, state_j, frozen_j, jb)
        lj.append(float(loss))
        dec_p, opt_p, loss = step_p(dec_p, opt_p, frozen_p, pb)
        lp.append(float(loss))
        if i == 0:
            first = (_jax_hf({**tree, "decoder": dec_j}, cfg_j),
                     {k: v.detach().clone() for k, v in dec_p.items()})
    return lj, lp, first, before


def _sign_agreement(jax_after, port_after, before):
    agree = total = 0
    for k, b in before.items():
        dj = jax_after[k] - b
        dp = port_after[k] - b
        moved = dj.abs() > 1e-3 * LR  # Adam's first step moves ~lr
        agree += int((torch.sign(dj) == torch.sign(dp))[moved].sum())
        total += int(moved.sum())
    return agree / max(total, 1)


@pytest.mark.parametrize("from_embeddings", [True, False])
def test_f32_train_steps_match_jax(from_embeddings):
    """Five f32 steps: each loss within 2e-4 * (1 + step) relative (f32
    drift compounds through the Adam moments, tests/test_train_step_parity.py
    :153-158); after step 1, at least 99% of the decoder updates that moved
    agree in sign."""
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j)
    rng = np.random.default_rng(11)
    batch = _batch(rng, 2, 3)
    if from_embeddings:
        pix, _ = jtr.preprocess_image(jnp.asarray(batch["image"]),
                                      target_size=128)
        batch["embeddings"] = np.asarray(
            jsam.encode_image(jax.tree.map(jnp.asarray, tree), pix, cfg_j))
    lj, lp, (j1, p1), before = _run_both(cfg_j, cfg_p, tree, batch,
                                         "float32", from_embeddings, 5)
    for i, (a, b) in enumerate(zip(lp, lj)):
        tol = 2e-4 * (1 + i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"step {i}: port {lp} jax {lj}")
    assert lp[-1] < lp[0]
    assert _sign_agreement(j1, p1, before) >= 0.99


def _assert_updates_match(jax_after, port_after, before, atol=1e-5):
    """Every tensor's first-step update, port vs JAX, within atol."""
    for k, b in before.items():
        np.testing.assert_allclose((port_after[k] - b).numpy(),
                                   (jax_after[k] - b).numpy(), atol=atol,
                                   err_msg=k)


def test_weight_decay_updates_match_jax():
    """One f32 step with weight_decay=0.1: every decoder tensor moves as in
    JAX, the iou-prediction head included. The loss does not reach that
    head, so torch's Adam would skip its None gradient, while optax decays
    it through a dense zero gradient; the step gives every such tensor a
    zero gradient."""
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=5)
    batch = _batch(np.random.default_rng(13), 2, 3)
    pix, _ = jtr.preprocess_image(jnp.asarray(batch["image"]), target_size=128)
    batch["embeddings"] = np.asarray(
        jsam.encode_image(jax.tree.map(jnp.asarray, tree), pix, cfg_j))
    _, _, (j1, p1), before = _run_both(cfg_j, cfg_p, tree, batch, "float32",
                                       True, 1, weight_decay=0.1)
    iou = [k for k in before if "iou_prediction_head" in k]
    assert len(iou) == 6
    for k in iou:  # decayed, so moved by ~lr
        assert float((p1[k] - before[k]).abs().min()) > 0.5 * LR, k
    _assert_updates_match(j1, p1, before)


def _cfg_grid32(m):
    """A decoder on a 32x32 grid, so that the bf16 step engages both fused
    ops (K3 needs >= 1024 cells)."""
    return m.SamConfig(
        vision=m.VisionConfig(hidden_size=64, num_layers=1, num_heads=1,
                              image_size=512, patch_size=16, window_size=4,
                              global_attn_indexes=(0,), mlp_dim=64,
                              output_channels=32),
        prompt=m.PromptConfig(hidden_size=32, image_embedding_size=32,
                              input_image_size=512),
        decoder=m.DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16)


def test_bf16_step_matches_jax_fused():
    """One bf16 step from cached embeddings, JAX with both fused ops under
    "interpret", the port through its fused ops (plain versions on the CPU):
    the first and second step's losses within 1e-3 relative (bf16 roundings
    of a two-layer decoder in another summation order; the second loss also
    checks that the update went the same way)."""
    cfg_j, cfg_p = _cfg_grid32(jconfigs), _cfg_grid32(pconfigs)
    tree = _params(cfg_j, seed=1)
    rng = np.random.default_rng(12)
    batch = _batch(rng, 2, 3)
    batch["embeddings"] = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    jsam.set_fused_i2t("interpret")
    jsam.set_fused_upscaler("interpret")
    try:
        lj, lp, _, _ = _run_both(cfg_j, cfg_p, tree, batch, "bfloat16", True,
                                 2)
    finally:
        jsam.set_fused_i2t("auto")
        jsam.set_fused_upscaler("auto")
    np.testing.assert_allclose(lp, lj, rtol=1e-3)


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


pconfigs.register_preset("tiny-test", lambda: pconfigs.sam_tiny(128))


def _loop_config(tmp_path, **kw):
    base = dict(base_model="tiny-test", checkpoint=str(tmp_path / "ck"),
                learning_rate=3e-2, epochs=3, batch_size=2, evaluate=False,
                compute_dtype="float32", buckets=(4, 8), display_name="run",
                time="t0", ckpt_keep=2, shuffle=True)
    base.update(kw)
    return ptr.TrainConfig(**base)


def test_training_loop_resume_retention_export(tmp_path):
    splits = (_items(6, 0), _items(2, 1))
    config = _loop_config(tmp_path, export_pt=True)
    result = ptr.training(config, splits=splits, device="cpu")
    hist = result["history"]
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite([h["valid_loss"] for h in hist]).all()
    run_dir = result["checkpoint_dir"]
    assert sorted(d for d in os.listdir(run_dir) if d.startswith("step_")) \
        == ["step_1", "step_2"]
    # the export is the merged HF-named state_dict, readable by the loader
    sd = load_state_dict(str(tmp_path / "ck" / "run_t0.pt"))
    assert set(sd) == set(result["params"])
    for k in ("mask_decoder.iou_token.weight",
              "vision_encoder.pos_embed"):
        np.testing.assert_array_equal(sd[k].numpy(),
                                      result["params"][k].numpy())

    resumed = ptr.training(dataclasses.replace(config, epochs=5, resume=True,
                                               export_pt=False),
                           splits=splits, device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    assert sorted(d for d in os.listdir(run_dir) if d.startswith("step_")) \
        == ["step_3", "step_4"]


def test_training_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptr.training(_loop_config(tmp_path),
                     splits=(_items(2, 0), _items(2, 1)))


@pytest.mark.parametrize("field,value", [("topological", True),
                                         ("multihost", True),
                                         ("data_transforms", ("hflip",)),
                                         ("display_mode", "predefined")])
def test_later_slices_raise(tmp_path, field, value):
    config = _loop_config(tmp_path, **{field: value})
    with pytest.raises(NotImplementedError, match="later slice"):
        ptr.training(config, splits=(_items(2, 0), _items(2, 1)),
                     device="cpu")


@pytest.mark.parametrize("argv", [
    ["--lr", "5e-5", "--weight_decay", "1e-4", "--bs", "2",
     "--pseudocolor", "Bone", "--prompt", "points", "--top",
     "--shuffle", "True", "--evaluate", "False"],
    ["--compute_dtype", "float32", "--cache_embeddings", "false",
     "--epochs", "3", "--seed", "4", "--resume", "true",
     "--display_name", "named", "--optimizer", "adamw"],
])
def test_cli_builds_the_jax_config(tmp_path, argv):
    from dilabhelmholtzoct_tpu.train import cli as jcli
    from dilabhelmholtzoct_tpu_torch.train import cli as pcli

    argv = argv + ["--data_directory", str(tmp_path), "--dataset_name", "x"]
    want = dataclasses.asdict(jcli.config_from_args(
        jcli.build_parser().parse_args(argv)))
    got = dataclasses.asdict(pcli.config_from_args(
        pcli.build_parser().parse_args(argv)))
    for cfg in (want, got):  # run timestamps, taken a moment apart
        cfg.pop("time")
        if "--display_name" not in argv:
            cfg["display_name"] = cfg["display_name"].rsplit(",", 1)[0]
    assert got == want


def test_train_config_fields_and_defaults_match_jax():
    want = {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(jtr.TrainConfig)}
    got = {f.name: (f.default if f.default is not dataclasses.MISSING
                    else f.default_factory())
           for f in dataclasses.fields(ptr.TrainConfig)}
    assert got == want


def test_eval_step_and_precompute_match_jax():
    """f32: the embedding precompute (atol 5e-5 / rtol 1e-4, the encoder
    lock of tests/test_torch_sam.py) and the eval-step loss on its output
    (rtol 1e-4) against the JAX package's, on the same items and seeds."""
    from dilabhelmholtzoct_tpu.data.pipeline import PromptedDataset as JDS
    from dilabhelmholtzoct_tpu.data.pipeline import batches as jbatches
    from dilabhelmholtzoct_tpu_torch.data.pipeline import PromptedDataset
    from dilabhelmholtzoct_tpu_torch.data.pipeline import batches

    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=2)
    items = _items(3, 4)
    jemb = np.asarray(jtr.precompute_embeddings(
        jax.tree.map(jnp.asarray, tree), cfg_j, JDS(items, seed=3),
        batch_size=2, dtype=jnp.float32, verbose=False))
    sd = params_from_jax(tree)
    pemb = ptr.precompute_embeddings(sd, cfg_p, PromptedDataset(items, seed=3),
                                     batch_size=2, dtype=torch.float32,
                                     verbose=False)
    np.testing.assert_allclose(pemb.numpy(), jemb, atol=5e-5, rtol=1e-4)

    jconf = jtr.TrainConfig(compute_dtype="float32", buckets=(4, 8))
    pconf = ptr.TrainConfig(compute_dtype="float32", buckets=(4, 8),
                            evaluate=False)
    jb = list(jbatches(JDS(items, seed=3), 3, with_images=False,
                       buckets=(4, 8), num_workers=1))[0]
    pb = list(batches(PromptedDataset(items, seed=3), 3, with_images=False,
                      buckets=(4, 8), num_workers=1))[0]
    jb["embeddings"], pb["embeddings"] = jemb, pemb.numpy()
    dec_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree))
    want = float(jtr.make_eval_step(cfg_j, jconf, ORIG_HW, True)(
        dec_j, frozen_j, {k: jnp.asarray(v) for k, v in jb.items()
                          if k != "indices"}))
    dec_p, frozen_p = ptr._split_params(sd)
    got = float(ptr.make_eval_step(cfg_p, pconf, ORIG_HW, True)(
        dec_p, frozen_p, {k: torch.tensor(v) for k, v in pb.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-4)
