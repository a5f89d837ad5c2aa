"""The port's prompt mask inputs against the JAX package's: the dense
embedding of a low-res mask (``embed_mask_input``) in f32 and bf16,
``encode_prompts`` / ``sam_forward`` with ``mask_inputs``, and the weight
bridge of the mask embedding.

The config is ``sam_tiny(128)`` (embedding grid 8, so mask inputs of
32x32); every JAX parameter is perturbed by N(0, 0.05) so no bias or
LayerNorm scale is trivial. Tolerances: f32 ``embed_mask_input`` atol and
rtol 1e-5 (three convs and two LayerNorms in another summation order); bf16
see ``test_embed_mask_input_bf16_matches_jax``; ``sam_forward`` atol 3e-4,
rtol 1e-3, the
sam_forward tolerance of tests/test_torch_sam.py (f32 through the encoder
and a two-layer decoder)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax

CFG_J, CFG_P = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), CFG_J))


def _masks(b, seed=1):
    g = CFG_J.prompt.image_embedding_size
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 4 * g, 4 * g, 1)) * 3.0).astype(np.float32)


def test_embed_mask_input_f32_matches_jax():
    tree = _params()
    masks = _masks(2)
    want = np.asarray(jsam.embed_mask_input(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(masks), CFG_J))
    got = psam.embed_mask_input(params_from_jax(tree), torch.tensor(masks),
                                CFG_P)
    g = CFG_P.prompt.image_embedding_size
    assert got.shape == (2, g, g, CFG_P.prompt.hidden_size) == want.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _bf16_ulps(a, b):
    """|a - b| in units of the bf16 spacing at max(|a|, |b|)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                   - 7)


def test_embed_mask_input_bf16_matches_jax():
    """bf16, stage by stage from JAX's own intermediates: each conv with its
    bias and each LayerNorm bit-equal to JAX's. The port's tanh GELU rounds
    the f32 GELU once (as the K3 kernel does): within one bf16 ulp of it at
    every value, and within two bf16 ulps of the stage's scale of JAX's,
    whose plain bf16 GELU on the CPU rounds after each of its ops (40-45%
    of the values land apart, by up to 4 ulps of their own where
    0.5 x (1 + tanh) cancels). End to end the outputs
    are held to two bf16 ulps of the output scale on average and four at
    most (the rule of tests/test_torch_relpos.py for bf16 paths through a
    GELU): the flipped GELU roundings feed the next conv and LayerNorm."""
    tree = _params(seed=2)
    masks = _masks(2, seed=3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    sd = {k: v.to(torch.bfloat16) for k, v in params_from_jax(tree).items()}
    pf, eps = "prompt_encoder.mask_embed", CFG_P.prompt.layer_norm_eps
    me = jp["prompt"]["mask_embed"]

    def jconv(x, name, stride):
        return jax.lax.conv_general_dilated(
            x, me[name]["w"], (stride, stride), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + me[name]["b"]

    def port(x):
        return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)

    def same(got, want, what):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32), what)

    # the port's stages, each fed JAX's bf16 input to it
    sd_conv = {k[len(pf) + 1:]: v for k, v in sd.items() if k.startswith(pf)}

    def pconv(x, name, stride):
        y = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), sd_conv[f"{name}.weight"], stride=stride)
        return y.permute(0, 2, 3, 1) + sd_conv[f"{name}.bias"]

    x = jnp.asarray(masks, jnp.bfloat16)
    for i, (conv, stride) in enumerate((("conv1", 2), ("conv2", 2))):
        y = jconv(x, conv, stride)
        same(pconv(port(x), conv, stride), y, conv)
        ln = me[f"ln{i + 1}"]
        z = jsam.layer_norm(y, ln, eps)
        same(psam.layer_norm(port(y), sd, f"{pf}.layer_norm{i + 1}", eps), z,
             f"layer_norm{i + 1}")
        x = jsam.gelu(z)
        g = psam.gelu(port(z)).float().numpy()
        exact = np.asarray(jax.nn.gelu(z.astype(jnp.float32), approximate=True))
        assert _bf16_ulps(g, exact).max() <= 1.0  # one rounding of f32's
        scale = np.abs(exact).max()
        assert np.abs(g - np.asarray(x, np.float32)).max() <= (
            2 * 2.0 ** -8 * scale)
    same(pconv(port(x), "conv3", 1), jconv(x, "conv3", 1), "conv3")

    want = np.asarray(jsam.embed_mask_input(
        jp, jnp.asarray(masks, jnp.bfloat16), CFG_J), np.float32)
    got = psam.embed_mask_input(sd, torch.tensor(masks).to(torch.bfloat16),
                                CFG_P)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -8 * np.abs(want).max()
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 4 * ulp and diff.mean() <= 2 * ulp, (
        diff.max() / ulp, diff.mean() / ulp)


@pytest.mark.parametrize("case", ["box", "point"])
def test_sam_forward_with_mask_inputs_matches_jax(case):
    tree = _params(seed=4)
    rng = np.random.default_rng(5)
    b = 2
    pix = rng.normal(size=(b, 128, 128, 3)).astype(np.float32)
    if case == "box":
        prompts = dict(boxes=rng.uniform(0, 120, (b, 1, 4)).astype(np.float32))
    else:
        prompts = dict(
            points=rng.uniform(0, 120, (b, 1, 2, 2)).astype(np.float32),
            labels=np.array([[[1, 0]]] * b, np.int32))
    masks = _masks(b, seed=6)
    want = jsam.sam_forward(
        jax.tree.map(jnp.asarray, tree), CFG_J, pixel_values=jnp.asarray(pix),
        mask_inputs=jnp.asarray(masks),
        **{k: jnp.asarray(v) for k, v in prompts.items()})
    sd = params_from_jax(tree)
    kw = {k: torch.tensor(v) for k, v in prompts.items()}
    got = psam.sam_forward(sd, CFG_P, pixel_values=torch.tensor(pix),
                           mask_inputs=torch.tensor(masks), **kw)
    for key in ("pred_masks", "iou_scores"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=3e-4, rtol=1e-3, err_msg=key)
    # the mask branch ran: the no-mask forward gives other masks
    plain = psam.sam_forward(sd, CFG_P,
                             image_embeddings=got["image_embeddings"], **kw)
    assert (plain["pred_masks"] - got["pred_masks"]).abs().max() > 3e-3


def test_encode_prompts_dense_from_mask_inputs():
    """The dense prompt is the mask embedding in the compute dtype; without
    mask inputs it stays the broadcast no-mask row."""
    tree = _params(seed=7)
    sd = params_from_jax(tree)
    masks = torch.tensor(_masks(3, seed=8))
    boxes = torch.tensor(np.random.default_rng(9).uniform(
        0, 120, (3, 1, 4)).astype(np.float32))
    _, dense = psam.encode_prompts(sd, CFG_P, 3, boxes=boxes,
                                   mask_inputs=masks)
    torch.testing.assert_close(dense, psam.embed_mask_input(sd, masks, CFG_P),
                               atol=0, rtol=0)
    _, dense16 = psam.encode_prompts(sd, CFG_P, 3, boxes=boxes,
                                     mask_inputs=masks, dtype=torch.bfloat16)
    assert dense16.dtype == torch.bfloat16
    _, none = psam.encode_prompts(sd, CFG_P, 3, boxes=boxes)
    row = sd["prompt_encoder.no_mask_embed.weight"][0]
    assert torch.equal(none, row.expand_as(none))


def test_params_from_jax_carries_mask_embed():
    tree = _params(seed=10)
    sd = params_from_jax(tree)
    me = tree["prompt"]["mask_embed"]
    pf = "prompt_encoder.mask_embed"
    for name in ("conv1", "conv2", "conv3"):
        # JAX HWIO -> HF (out, in, kh, kw)
        np.testing.assert_array_equal(
            sd[f"{pf}.{name}.weight"].numpy(),
            np.asarray(me[name]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{pf}.{name}.bias"].numpy(),
                                      np.asarray(me[name]["b"]))
    for ln, hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
        np.testing.assert_array_equal(sd[f"{pf}.{hf}.weight"].numpy(),
                                      np.asarray(me[ln]["scale"]))
        np.testing.assert_array_equal(sd[f"{pf}.{hf}.bias"].numpy(),
                                      np.asarray(me[ln]["bias"]))
