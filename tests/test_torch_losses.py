"""Port's segmentation losses against the JAX package's on the same numpy
inputs: with and without a channel mask, C == 1 (the BCE dispatch) and
C > 1, and a fully masked padding row. Tolerance rtol 1e-5 / atol 1e-6
(f32 reductions in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops import losses as jl
from dilabhelmholtzoct_tpu_torch.ops import losses as pl


def _case(c, seed=3):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, c, 16, 16)) * 3).astype(np.float32)
    targets = (rng.random((3, c, 16, 16)) > 0.6).astype(np.float32)
    mask = np.ones((3, c), np.float32)
    mask[0, c // 2:] = 0  # bucket padding channels
    mask[2] = 0           # a padding row of the last batch
    return logits, targets, mask


@pytest.mark.parametrize("name", ["dice_loss", "softmax_ce_prob_targets",
                                  "dice_ce_loss"])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(name, c, masked):
    logits, targets, mask = _case(c)
    jargs = [jnp.asarray(logits), jnp.asarray(targets)]
    targs = [torch.tensor(logits), torch.tensor(targets)]
    if masked:
        jargs.append(jnp.asarray(mask))
        targs.append(torch.tensor(mask))
    want = float(getattr(jl, name)(*jargs))
    got = float(getattr(pl, name)(*targs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bce_with_logits_matches_jax():
    logits, targets, _ = _case(1)
    np.testing.assert_allclose(
        float(pl.bce_with_logits(torch.tensor(logits), torch.tensor(targets))),
        float(jl.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flag", ["diceCE", "dice", "ce", "CrossEntropy"])
def test_segmentation_loss_resolves_like_jax(flag):
    logits, targets, mask = _case(4)
    got = pl.segmentation_loss(flag)(torch.tensor(logits),
                                     torch.tensor(targets), torch.tensor(mask))
    want = jl.segmentation_loss(flag)(jnp.asarray(logits),
                                      jnp.asarray(targets), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        pl.segmentation_loss("focal")


def test_fully_masked_batch_is_finite():
    logits, targets, mask = _case(4)
    zero = torch.zeros_like(torch.tensor(mask))
    for fn in (pl.dice_loss, pl.softmax_ce_prob_targets, pl.dice_ce_loss):
        assert float(fn(torch.tensor(logits), torch.tensor(targets),
                        zero)) == 0.0
