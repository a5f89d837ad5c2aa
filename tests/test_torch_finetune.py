"""Full fine-tuning (``trainable='all'``: image encoder, prompt encoder and
decoder) of the port against the JAX package: the train step in f32 and
bf16, weight decay, and the epoch loop.

The model is tests/test_attention.py's small encoder (two layers, windowed
and global, two heads of 64, 64 px images) under the small decoder; JAX runs
its Pallas attention in interpret mode (``set_flash_attention('interpret')``,
the packed custom VJP), the port its plain versions on the CPU. Inputs are
made with numpy from a seed; the parameters are the JAX init perturbed by
N(0, 0.05) on every leaf and bridged with ``params_from_jax``."""

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
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr
from dilabhelmholtzoct_tpu_torch.utils import checkpoint as ckpt_utils
from test_torch_train import (
    LR,
    ORIG_HW,
    _assert_updates_match,
    _batch,
    _items,
    _params,
    _sign_agreement,
)


def _cfg(m):
    return m.SamConfig(
        vision=m.VisionConfig(hidden_size=128, num_layers=2, num_heads=2,
                              image_size=64, patch_size=16, window_size=2,
                              global_attn_indexes=(1,), mlp_dim=128,
                              output_channels=32),
        prompt=m.PromptConfig(hidden_size=32, image_embedding_size=4,
                              input_image_size=64),
        decoder=m.DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16)


def _run_all(tree, batch, dtype, n_steps, **conf):
    """n_steps of each package's trainable='all' step (encoder inside) from
    the same parameters on the same batch; returns (jax losses, port
    losses, (jax, port) parameters after step 1, parameters before)."""
    cfg_j, cfg_p = _cfg(jconfigs), _cfg(pconfigs)
    kw = dict(compute_dtype=dtype, learning_rate=LR, cache_embeddings=False,
              trainable="all", **conf)
    jconf = jtr.TrainConfig(**kw)
    pconf = ptr.TrainConfig(evaluate=False, **kw)
    p_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree), "all")
    opt_j = jtr.make_optimizer(jconf)
    state_j = opt_j.init(p_j)
    step_j = jtr.make_train_step(cfg_j, jconf, opt_j, ORIG_HW, False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    sd = params_from_jax(tree)
    before = {k: v.clone() for k, v in sd.items()}
    p_p, frozen_p = ptr._split_params(sd, "all")
    assert not frozen_p and set(p_p) == set(sd)
    for v in p_p.values():
        v.requires_grad_(True)
    opt_p = ptr.make_optimizer(pconf, p_p.values())
    step_p = ptr.make_train_step(cfg_p, pconf, opt_p, ORIG_HW, False)
    pb = {k: torch.tensor(v) for k, v in batch.items()}

    lj, lp, first = [], [], None
    jsam.set_flash_attention("interpret")
    try:
        for i in range(n_steps):
            p_j, state_j, loss = step_j(p_j, state_j, frozen_j, jb)
            lj.append(float(loss))
            p_p, opt_p, loss = step_p(p_p, opt_p, frozen_p, pb)
            lp.append(float(loss))
            if i == 0:
                first = (params_from_jax(jax.tree.map(np.asarray, p_j)),
                         {k: v.detach().clone() for k, v in p_p.items()})
    finally:
        jsam.set_flash_attention("auto")
    return lj, lp, first, before


def test_f32_full_finetune_steps_match_jax():
    """Three f32 steps: each loss within 2e-4 * (1 + step) relative; after
    step 1, at least 99% of the updates that moved agree in sign over every
    parameter, encoder included, and the patch embedding moved."""
    tree = _params(_cfg(jconfigs), seed=3)
    batch = _batch(np.random.default_rng(21), 2, 3)
    lj, lp, (j1, p1), before = _run_all(tree, batch, "float32", 3)
    for i, (a, b) in enumerate(zip(lp, lj)):
        tol = 2e-4 * (1 + i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"step {i}: port {lp} jax {lj}")
    assert lp[-1] < lp[0]
    assert _sign_agreement(j1, p1, before) >= 0.99
    k = "vision_encoder.patch_embed.projection.weight"
    assert not torch.allclose(p1[k], before[k])


def test_bf16_full_finetune_steps_match_jax():
    """Two bf16 steps, JAX with both fused decoder ops under "interpret"
    (on this 4x4 grid the image->token op engages; the upscaler needs 1024
    cells and stays unfused in both): losses within 1e-3 relative."""
    tree = _params(_cfg(jconfigs), seed=4)
    batch = _batch(np.random.default_rng(22), 2, 3)
    jsam.set_fused_i2t("interpret")
    jsam.set_fused_upscaler("interpret")
    try:
        lj, lp, _, _ = _run_all(tree, batch, "bfloat16", 2)
    finally:
        jsam.set_fused_i2t("auto")
        jsam.set_fused_upscaler("auto")
    np.testing.assert_allclose(lp, lj, rtol=1e-3)


def test_weight_decay_full_finetune_matches_jax():
    """One f32 step with weight_decay=0.1: every tensor moves as in JAX,
    the ones the loss does not reach (iou head, mask_embed, unused point
    embeddings) included."""
    tree = _params(_cfg(jconfigs), seed=5)
    batch = _batch(np.random.default_rng(23), 2, 3)
    _, _, (j1, p1), before = _run_all(tree, batch, "float32", 1,
                                      weight_decay=0.1)
    unused = [k for k in before if "mask_embed" in k
              or "iou_prediction_head" in k]
    assert unused
    for k in unused:  # decayed, so moved by ~lr
        assert float((p1[k] - before[k]).abs().min()) > 0.5 * LR, k
    _assert_updates_match(j1, p1, before)


pconfigs.register_preset("finetune-test", lambda: _cfg(pconfigs))


def _loop_config(tmp_path, **kw):
    base = dict(base_model="finetune-test", checkpoint=str(tmp_path / "ck"),
                learning_rate=1e-2, epochs=1, batch_size=2, evaluate=False,
                compute_dtype="float32", buckets=(4, 8), display_name="run",
                trainable="all", cache_embeddings=False, ckpt_keep=1)
    base.update(kw)
    return ptr.TrainConfig(**base)


def test_training_full_finetune_cpu(tmp_path):
    """training(trainable='all') for one epoch on the CPU: finite losses,
    the encoder moves, and the checkpoint holds every tensor."""
    config = _loop_config(tmp_path)
    _, sd0 = ptr.prepare_model(config)
    result = ptr.training(config, splits=(_items(4, 0), _items(2, 1)),
                          device="cpu")
    hist = result["history"]
    assert [h["epoch"] for h in hist] == [0]
    assert np.isfinite([hist[0]["train_loss"], hist[0]["valid_loss"]]).all()
    k = "vision_encoder.patch_embed.projection.weight"
    assert not torch.allclose(result["params"][k], sd0[k])
    state, step = ckpt_utils.restore_checkpoint(result["checkpoint_dir"])
    assert step == 0 and set(state["params"]) == set(sd0)
    for k, v in state["params"].items():
        np.testing.assert_array_equal(v.numpy(), result["params"][k].numpy())

    resumed = ptr.training(dataclasses.replace(config, epochs=2, resume=True),
                           splits=(_items(4, 0), _items(2, 1)), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert os.listdir(result["checkpoint_dir"]).count("step_1") == 1


def test_full_finetune_rejects_cached_embeddings(tmp_path):
    with pytest.raises(ValueError, match="cache_embeddings=False"):
        ptr.training(_loop_config(tmp_path, cache_embeddings=True),
                     splits=(_items(2, 0), _items(2, 1)), device="cpu")
