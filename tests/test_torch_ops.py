"""Port's preprocess / postprocess vs the JAX package on the same inputs.

Tolerances: resize weights atol 1e-6 (both are f32 closed forms of the same
formula); normalised pixels atol 1e-4 (values up to ~2.6 after two f32
resize products in another summation order); postprocessed logits atol 1e-5,
rtol 1e-5 (full-f32 products on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops import postprocess as jpost
from dilabhelmholtzoct_tpu.ops import preprocess as jpre
from dilabhelmholtzoct_tpu_torch.ops import postprocess as ppost
from dilabhelmholtzoct_tpu_torch.ops import preprocess as ppre


@pytest.mark.parametrize("n_in,n_out", [(8, 32), (32, 1024), (64, 128),
                                        (1024, 496), (150, 128), (7, 7)])
def test_resize_matrix_matches_jax_no_antialias(n_in, n_out):
    want = jpost._bilinear_operator(n_out, n_in)
    got = ppre.resize_matrix(n_in, n_out, antialias=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(200, 128), (150, 96), (96, 128)])
def test_resize_matrix_matches_jax_antialias(n_in, n_out):
    """jax.image.resize's default antialias widens the kernel on downscale."""
    eye = jnp.eye(n_in, dtype=jnp.float32)
    want = jax.image.resize(eye, (n_out, n_in), method="bilinear")
    got = ppre.resize_matrix(n_in, n_out, antialias=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64),     # exact 2x closed form
                                (64, 96),     # general upscale
                                (200, 150)])  # downscale: antialias
def test_preprocess_image_matches_jax(rng, hw):
    img = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want, want_hw = jpre.preprocess_image(jnp.asarray(img), target_size=128)
    got, got_hw = ppre.preprocess_image(torch.from_numpy(img), target_size=128)
    assert got_hw == want_hw and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_preprocess_shape_and_prompt_rescale(rng):
    assert ppre.preprocess_shape(496, 512) == jpre.preprocess_shape(496, 512)
    assert ppre.preprocess_shape(333, 1000) == jpre.preprocess_shape(333, 1000)
    pts = rng.uniform(0, 200, (3, 2)).astype(np.float32)
    boxes = rng.uniform(0, 200, (2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ppre.rescale_coords(torch.tensor(pts), (200, 150), 128).numpy(),
        np.asarray(jpre.rescale_coords(jnp.asarray(pts), (200, 150), 128)),
        rtol=1e-6)
    np.testing.assert_allclose(
        ppre.rescale_boxes(torch.tensor(boxes), (64, 96), 128).numpy(),
        np.asarray(jpre.rescale_boxes(jnp.asarray(boxes), (64, 96), 128)),
        rtol=1e-6)


@pytest.mark.parametrize("orig_hw", [(64, 96), (496, 512), (200, 150)])
def test_resize_operators_match_jax(orig_hw):
    jr = jpost.resize_operators(32, orig_hw, 128)
    pr = ppost.resize_operators(32, orig_hw, 128)
    for a, b in zip(pr, jr):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("orig_hw", [(64, 96), (120, 50)])
def test_postprocess_masks_blocked_matches_jax(rng, orig_hw):
    x = (rng.normal(size=(2, 3, 8, 8, 2, 2, 2, 2)) * 4).astype(np.float32)
    want = jpost.postprocess_masks_blocked(jnp.asarray(x), orig_hw,
                                           model_size=128)
    got = ppost.postprocess_masks_blocked(torch.tensor(x), orig_hw,
                                          model_size=128)
    assert got.shape == (2, 3, *orig_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
