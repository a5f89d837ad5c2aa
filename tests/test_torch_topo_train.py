"""Training with the topological loss, the port against the JAX package on
the CPU at ``sam_tiny`` (f32, cached embeddings, ``topo_interp=16``): the
port's device mode and its host sync mode step for step against the JAX
trainer with ``topo_device=True`` (the limits of the port's step-parity
tests, ``tests/test_torch_train.py``), the eval step likewise, the
pipelined host mode against the one-batch delay rebuilt by hand, the
ground-truth diagram cache, and ``training()`` from the CLI's flags.

The JAX trainer runs only with ``topo_device=True``: its host modes load
the JAX package's native library, whose loader runs ``make`` in
``native/``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch.data.sampling import gt_masks_from_comp_map
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import topology as pt
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr
from test_torch_train import (LR, ORIG_HW, _batch, _items, _jax_hf, _params,
                              _sign_agreement)

INTERP = 16
N_STEPS = 3
TOPO = dict(topological=True, topo_interp=INTERP)


def _embedded_batch(cfg_j, tree, seed, b=2, n_comp=3):
    batch = _batch(np.random.default_rng(seed), b, n_comp)
    pix, _ = jtr.preprocess_image(jnp.asarray(batch["image"]), target_size=128)
    batch["embeddings"] = np.asarray(
        jsam.encode_image(jax.tree.map(jnp.asarray, tree), pix, cfg_j))
    batch["indices"] = np.arange(seed * b, seed * b + b, dtype=np.int32)
    return batch


def _port_config(**kw):
    return ptr.TrainConfig(compute_dtype="float32", learning_rate=LR,
                           evaluate=False, **{**TOPO, **kw})


def _port_state(tree, conf):
    dec, frozen = ptr._split_params(params_from_jax(tree))
    for v in dec.values():
        v.requires_grad_(True)
    return dec, frozen, ptr.make_optimizer(conf, dec.values())


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """N_STEPS steps of the JAX trainer (topo_device=True) on one batch,
    and its eval-step loss at the initial parameters."""
    cfg_j = jconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=3)
    batch = _embedded_batch(cfg_j, tree, 0)
    conf = jtr.TrainConfig(compute_dtype="float32", learning_rate=LR, **TOPO)
    dec, frozen = jtr._split_params(jax.tree.map(jnp.asarray, tree))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "indices"}
    eval_loss = float(jtr.make_eval_step(cfg_j, conf, ORIG_HW, True)(
        dec, frozen, jb))
    opt = jtr.make_optimizer(conf)
    state = opt.init(dec)
    step = jtr.make_train_step(cfg_j, conf, opt, ORIG_HW, True)
    losses, first = [], None
    for i in range(N_STEPS):
        dec, state, loss = step(dec, state, frozen, jb)
        losses.append(float(loss))
        if i == 0:
            first = _jax_hf({**tree, "decoder": dec}, cfg_j)
    return tree, batch, losses, first, eval_loss


@pytest.mark.parametrize("mode", ["device", "host_sync"])
def test_topological_steps_match_jax(jax_run, mode):
    """The port's device mode (T1 / T2's plain twins on the CPU) and its
    host sync mode (the C++ library, with the GT-diagram cache and the
    padding-row skip) against JAX's device mode: each loss within 2e-4 *
    (1 + step) relative, and after step 1 at least 99% of the moved decoder
    weights move the same way."""
    tree, batch, want, jax_first, _ = jax_run
    conf = _port_config(topo_device=mode == "device", topo_pipeline=False)
    dec, frozen, opt = _port_state(tree, conf)
    before = {k: v.detach().clone() for k, v in dec.items()}
    step = ptr.make_train_step(pconfigs.sam_tiny(128), conf, opt, ORIG_HW,
                               True)
    assert hasattr(step, "set_host_batch") == (mode == "host_sync")
    pb = _torch_batch(batch)
    losses = []
    for i in range(N_STEPS):
        if mode == "host_sync":
            step.set_host_batch(batch)  # step 2 on: cache hit, active rows
        dec, opt, loss = step(dec, opt, frozen, pb)
        losses.append(float(loss))
        if i == 0:
            first = {k: v.detach().clone() for k, v in dec.items()}
    for i, (a, b) in enumerate(zip(losses, want)):
        tol = 2e-4 * (1 + i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"step {i}: port {losses} jax {want}")
    assert _sign_agreement(jax_first, first, before) >= 0.99


@pytest.mark.parametrize("mode", ["device", "host"])
def test_topological_eval_step_matches_jax(jax_run, mode):
    """The eval step's loss with the topological term (device mode; host
    mode through its own pairer, fed ``set_host_batch``) within 2e-4 of
    JAX's device-mode eval step."""
    tree, batch, _, _, want = jax_run
    conf = _port_config(topo_device=mode == "device")
    dec, frozen = ptr._split_params(params_from_jax(tree))
    step = ptr.make_eval_step(pconfigs.sam_tiny(128), conf, ORIG_HW, True)
    if mode == "host":
        step.set_host_batch(batch)
    got = float(step(dec, frozen, _torch_batch(batch)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _hand_pipeline(cfg, conf, tree, batches):
    """The pipelined schedule rebuilt from the port's sync pieces: batch k's
    pairing from its grids at the parameters before batch k-1's update,
    batch k's update at the parameters after it."""
    dec, frozen, opt = _port_state(tree, conf)

    def masks(b):
        return ptr._forward_from_embeddings(
            dec, ptr._prompt_entries(frozen), cfg, b["embeddings"], b,
            ORIG_HW, conf.prompt_type)

    def pairing(b):
        with torch.no_grad():
            m = masks(b)
            gt = gt_masks_from_comp_map(b["comp_map"], m.shape[1])
            pred, true = pt.downsample_for_topo(torch.sigmoid(m), gt, INTERP)
        return pt.host_pairing(
            pred.reshape(-1, INTERP, INTERP).numpy(),
            true.reshape(-1, INTERP, INTERP).numpy(),
            feat_d=conf.topo_feat_d,
            row_mask=b["channel_mask"].reshape(-1).numpy())

    def update(b, p):
        loss = ptr._loss_from_masks(masks(b), b, conf, p)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ptr._zero_missing_grads(opt)
        opt.step()
        return float(loss)

    pending = pairing(batches[0])
    losses = []
    for b_prev, b in zip(batches, batches[1:]):
        nxt = pairing(b)
        losses.append(update(b_prev, pending))
        pending = nxt
    losses.append(update(batches[-1], pending))
    return losses


def test_pipelined_schedule_is_the_one_batch_delay():
    """Three batches through the pipelined host step (with the GT cache and
    ``flush``) give exactly the losses of the one-batch delay rebuilt by
    hand; its first call defers (``loss=None``) and its first loss equals
    the sync mode's first step."""
    cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    tree = _params(cfg_j, seed=4)
    batches = [_torch_batch(_embedded_batch(cfg_j, tree, s))
               for s in (1, 2, 3)]
    conf = _port_config(topo_device=False, topo_pipeline=True)
    dec, frozen, opt = _port_state(tree, conf)
    step = ptr.make_train_step(cfg_p, conf, opt, ORIG_HW, True)
    got = []
    for b in batches:
        step.set_host_batch({k: v.numpy() for k, v in b.items()})
        dec, opt, loss = step(dec, opt, frozen, b)
        got.append(loss if loss is None else float(loss))
    dec, opt, loss = step.flush(dec, opt, frozen)
    assert got[0] is None
    got = got[1:] + [float(loss)]
    assert step.flush(dec, opt, frozen)[2] is None  # nothing left
    assert got == _hand_pipeline(cfg_p, conf, tree, batches)

    sync = dataclasses.replace(conf, topo_pipeline=False)
    dec, frozen, opt = _port_state(tree, sync)
    step = ptr.make_train_step(cfg_p, sync, opt, ORIG_HW, True)
    assert float(step(dec, opt, frozen, batches[0])[2]) == got[0]


@pytest.mark.parametrize("pipeline", [False, True])
def test_gt_diagram_cache_is_exact(tmp_path, pipeline):
    """``training()`` over 3 epochs in a host mode: the same train and
    validation losses with the cross-epoch GT-diagram cache on and off."""
    splits = (_items(6, 0), _items(2, 1))
    hists = []
    for cache in (True, False):
        conf = dataclasses.replace(
            _port_config(topo_device=False, topo_pipeline=pipeline,
                         topo_true_cache=cache),
            base_model="tiny-topo", checkpoint=str(tmp_path / f"ck{cache}"),
            epochs=3, batch_size=2, buckets=(4, 8), learning_rate=3e-2,
            shuffle=True)
        hists.append([(h["train_loss"], h["valid_loss"]) for h in
                      ptr.training(conf, splits=splits,
                                   device="cpu")["history"]])
    assert hists[0] == hists[1]
    assert np.isfinite(hists[0]).all() and len(hists[0]) == 3


pconfigs.register_preset("tiny-topo", lambda: pconfigs.sam_tiny(128))


@pytest.mark.parametrize("flags", [[], ["--topo_device", "false"],
                                   ["--topo_device", "false",
                                    "--topo_pipeline", "false"]],
                         ids=["device", "host_pipelined", "host_sync"])
def test_training_from_cli_flags(tmp_path, flags):
    """``--top`` and the mode flags through the CLI's config, then
    ``training()`` for one epoch on the CPU (the CLI's own ``main`` needs a
    card): finite train and validation losses, the topological term in
    them (above the same run's loss without it)."""
    from dilabhelmholtzoct_tpu_torch.train import cli as pcli

    argv = ["--data_directory", str(tmp_path), "--dataset_name", "x",
            "--base_model", "tiny-topo", "--epochs", "1", "--bs", "2",
            "--evaluate", "False", "--compute_dtype", "float32", *flags]
    splits = (_items(4, 0), _items(2, 1))
    hist = {}
    for top in (True, False):
        config = pcli.config_from_args(pcli.build_parser().parse_args(
            argv + (["--top"] if top else [])))
        assert config.topological == top and config.topo_interp == 50
        hist[top] = ptr.training(config, splits=splits,
                                 device="cpu")["history"][0]
    assert np.isfinite([hist[True]["train_loss"], hist[True]["valid_loss"]]).all()
    assert hist[True]["valid_loss"] > hist[False]["valid_loss"]
