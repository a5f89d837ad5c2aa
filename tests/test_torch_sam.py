"""Port's SAM (encoder, prompt encoder, mask decoder, weight bridge) vs the
JAX package on the same parameters and inputs.

The config is tests/test_attention.py's head_dim-64 one (hidden 128, 2
heads, image 128, global layer 1), so the encoder takes the packed-attention
path the kernels serve; window 3 (8 → 9 padded, 9 windows) adds the
pad-token case. Every parameter is perturbed from JAX's init (which zeroes
biases and rel-pos tables) so no term of the math is hidden."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.models.convert import (
    from_hf_state_dict,
    to_hf_state_dict,
)
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "sam_golden.npz")


def _cfg(window_size=4, m=jconfigs):
    """The config in JAX's (default) or the port's dataclasses."""
    return m.SamConfig(
        vision=m.VisionConfig(
            hidden_size=128, num_layers=2, num_heads=2, image_size=128,
            patch_size=16, window_size=window_size, global_attn_indexes=(1,),
            mlp_dim=128, output_channels=32),
        prompt=m.PromptConfig(hidden_size=32, image_embedding_size=8,
                              input_image_size=128),
        decoder=m.DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16,
    )


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


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_config_copy_matches():
    for name in ("facebook/sam-vit-base", "facebook/sam-vit-large",
                 "facebook/sam-vit-huge", "wanglab/medsam-vit-base"):
        assert (repr(pconfigs.config_for(name))
                == repr(jconfigs.config_for(name)))


def test_params_from_jax_round_trip():
    """Port state_dict == the JAX package's to_hf_state_dict, exactly; and
    from_hf_state_dict of it gives the tree back."""
    cfg = _cfg()
    tree = _params(cfg)
    sd = params_from_jax(tree)
    want = to_hf_state_dict(tree, cfg)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    back = from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_init_params_has_hf_names_and_shapes():
    cfg = _cfg()
    sd = psam.init_params(_cfg(m=pconfigs),
                          torch.Generator().manual_seed(0))
    want = to_hf_state_dict(jsam.init_params(jax.random.PRNGKey(0), cfg), cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("window_size", [4, 3])
def test_encode_image_matches_jax(rng, mode, window_size):
    """Tolerance atol 5e-5, rtol 1e-4: tests/test_attention.py's encoder
    lock between the JAX kernel and XLA paths."""
    cfg = _cfg(window_size)
    tree = _params(cfg)
    pix = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    jsam.set_flash_attention(mode)
    try:
        want = jsam.encode_image(_jx(tree), jnp.asarray(pix), cfg)
    finally:
        jsam.set_flash_attention("auto")
    got = psam.encode_image(params_from_jax(tree), torch.tensor(pix),
                            _cfg(window_size, pconfigs))
    assert got.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def _prompt_case(case, rng):
    if case == "box":
        return dict(boxes=rng.uniform(0, 120, (2, 1, 4)).astype(np.float32))
    if case == "point":
        return dict(points=rng.uniform(0, 120, (1, 1, 3, 2)).astype(np.float32),
                    labels=np.array([[[1, 0, -10]]], np.int32))
    if case == "points+box":
        return dict(points=rng.uniform(0, 120, (1, 2, 2, 2)).astype(np.float32),
                    labels=np.array([[[1, 1], [0, 1]]], np.int32),
                    boxes=rng.uniform(0, 120, (1, 2, 4)).astype(np.float32))
    # multi-prompt: pb = 2 takes the shared-first-block path
    return dict(boxes=rng.uniform(0, 120, (1, 2, 4)).astype(np.float32))


@pytest.mark.parametrize("case,blocked,multimask", [
    ("box", True, False), ("point", True, False), ("multi", True, False),
    ("points+box", True, False), ("box", False, False), ("multi", False, True),
])
def test_prompt_encode_and_decode_match_jax(rng, case, blocked, multimask):
    """Sparse/dense prompts, blocked or natural masks and iou vs JAX.
    Tolerance atol 1e-4, rtol 1e-4 (f32 summation order over a 2-layer
    decoder)."""
    cfg, pcfg = _cfg(), _cfg(m=pconfigs)
    tree = _params(cfg)
    sd = params_from_jax(tree)
    prompts = _prompt_case(case, rng)
    b = next(iter(prompts.values())).shape[0]
    emb = rng.normal(size=(b, 8, 8, 32)).astype(np.float32)

    jp = _jx(tree)
    j_sparse, j_dense = jsam.encode_prompts(
        jp, cfg, b, **{k: jnp.asarray(v) for k, v in prompts.items()})
    j_pe = jsam.image_wide_pe(jp, cfg)
    j_masks, j_iou = jsam.decode_masks(jp, cfg, jnp.asarray(emb), j_pe,
                                       j_sparse, j_dense, multimask, blocked)

    p_sparse, p_dense = psam.encode_prompts(
        sd, pcfg, b, **{k: torch.tensor(v) for k, v in prompts.items()})
    p_pe = psam.image_wide_pe(sd, pcfg)
    p_masks, p_iou = psam.decode_masks(sd, pcfg, torch.tensor(emb), p_pe,
                                       p_sparse, p_dense, multimask, blocked)

    np.testing.assert_allclose(p_sparse.numpy(), np.asarray(j_sparse),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(p_dense.numpy(), np.asarray(j_dense), atol=0)
    np.testing.assert_allclose(p_pe.numpy(), np.asarray(j_pe), atol=1e-5,
                               rtol=1e-5)
    assert p_masks.shape == j_masks.shape
    np.testing.assert_allclose(p_masks.numpy(), np.asarray(j_masks),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p_iou.numpy(), np.asarray(j_iou), atol=1e-4,
                               rtol=1e-4)


def _golden():
    base = pconfigs.sam_tiny(image_size=128)
    cfg = pconfigs.SamConfig(
        vision=pconfigs.VisionConfig(
            hidden_size=64, num_layers=3, num_heads=4, image_size=128,
            patch_size=16, window_size=4, global_attn_indexes=(1,),
            mlp_dim=128, output_channels=32),
        prompt=base.prompt, decoder=base.decoder, num_pos_feats=16)
    z = np.load(FIXTURE)
    sd = {k[3:]: torch.tensor(z[k]) for k in z.files if k.startswith("sd.")}
    return z, sd, cfg


@pytest.mark.parametrize("case", ["box", "point"])
def test_sam_forward_matches_golden(case):
    """The HF-recorded fixture loads by name with no mapping; tolerances are
    tests/test_sam_golden.py's (atol 3e-4, rtol 1e-3)."""
    z, sd, cfg = _golden()
    if case == "box":
        out = psam.sam_forward(
            sd, cfg, pixel_values=torch.tensor(z["pix"].transpose(0, 2, 3, 1)),
            boxes=torch.tensor(z["boxes"]))
        np.testing.assert_allclose(out["iou_scores"].numpy(), z["box_iou"],
                                   atol=3e-4, rtol=1e-3)
        want = z["box_masks"]
    else:
        out = psam.sam_forward(
            sd, cfg,
            pixel_values=torch.tensor(z["pix"][:1].transpose(0, 2, 3, 1)),
            points=torch.tensor(z["pts"]), labels=torch.tensor(z["lbl"]))
        want = z["pts_masks"]
    np.testing.assert_allclose(out["pred_masks"].numpy(), want, atol=3e-4,
                               rtol=1e-3)


def test_rel_pos_resize_matches_jax(rng):
    """Non-native geometry resamples the rel-pos table (torch
    F.interpolate semantics, no antialias) — up and down."""
    for n_in, n_out in ((13, 27), (27, 13)):
        rel = rng.normal(size=(n_in, 64)).astype(np.float32)
        want = jsam.resize_rel_pos(jnp.asarray(rel), n_out)
        got = psam.resize_rel_pos(torch.tensor(rel), n_out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# bf16: the training slice's compute dtype
# ---------------------------------------------------------------------------


def _bf16_ulps(a, b):
    """|a - b| in units of the bf16 spacing at max(|a|, |b|), the spacing
    floored at 2^-20: below that, two f32 sums of the same terms in another
    order differ by more than a bf16 spacing of the result."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** np.maximum(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7,
                            -20)
    return np.abs(a - b) / ulp


def _linear_double_rounding(x, w, b):
    """The port's bf16 linear before the repair: the product rounded to
    bf16, then the f32 bias added and rounded again."""
    return (torch.nn.functional.linear(x, w.to(x.dtype)).float()
            + b.float()).to(x.dtype)


def test_bf16_linear_matches_jax(rng):
    """One rounding after the f32 bias add, as JAX's linear. Summation order
    differs between XLA's and PyTorch's f32 dots, so an output may land one
    bf16 rounding apart: at most 1 ulp, on under 1% of the outputs. The
    double rounding before the repair moves far more outputs."""
    x = rng.normal(size=(4096, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 128)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(128,)).astype(np.float32)
    want = np.asarray(jsam.linear(
        jnp.asarray(x, jnp.bfloat16),
        {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(bias,
                                                            jnp.bfloat16)}),
        np.float32)
    sd = {"l.weight": torch.tensor(w.T.copy()).to(torch.bfloat16),
          "l.bias": torch.tensor(bias).to(torch.bfloat16)}
    xt = torch.tensor(x).to(torch.bfloat16)
    got = psam.linear(xt, sd, "l").float().numpy()
    ulps = _bf16_ulps(got, want)
    assert ulps.max() <= 1.0 and (ulps > 0).mean() < 0.01, (
        ulps.max(), (ulps > 0).mean())
    old = _linear_double_rounding(xt, sd["l.weight"], sd["l.bias"])
    old = old.float().numpy()
    assert (_bf16_ulps(old, want) > 0).mean() > 0.05


def test_bf16_attention_matches_jax(rng):
    """f32 logits (JAX: preferred_element_type=f32) for 7 queries over 4096
    keys; before the repair the logits were rounded to bf16 first."""
    q = rng.normal(size=(1, 8, 7, 16)).astype(np.float32)
    k = rng.normal(size=(1, 8, 4096, 16)).astype(np.float32)
    v = rng.normal(size=(1, 8, 4096, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    logits = jnp.einsum("bnqd,bnkd->bnqk", jq * (16 ** -0.5), jk,
                        preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(logits, axis=-1).astype(jnp.bfloat16)
    want = np.asarray(jnp.einsum("bnqk,bnkd->bnqd", attn, jv), np.float32)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = psam._attend(tq, tk, tv).float().numpy()
    ulps = _bf16_ulps(got, want)
    assert ulps.max() <= 1.0 and (ulps > 0).mean() < 0.02, (
        ulps.max(), (ulps > 0).mean())
    old_logits = torch.matmul(tq * 0.25, tk.transpose(-1, -2)).float()
    old = torch.matmul(torch.softmax(old_logits, -1).to(tv.dtype), tv)
    assert _bf16_ulps(old.float().numpy(), want).max() > 2.0


def _cfg_grid32(m=jconfigs):
    """A decoder on a 32x32 grid (1024 cells): both fused ops engage."""
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


@pytest.mark.parametrize("pb", [1, 3])
def test_bf16_blocked_decode_matches_jax_fused(rng, pb):
    """bf16 decode_masks(blocked=True) with K3 and K4 engaged on both sides
    (JAX under "interpret"). Tolerance: 3e-2 of the mask scale and 3e-2 on
    the iou scores — bf16 roundings of a two-layer decoder whose summation
    order differs between the two frameworks."""
    cfg, pcfg = _cfg_grid32(), _cfg_grid32(pconfigs)
    tree = _params(cfg)
    b = 2
    boxes = rng.uniform(0, 500, (b, pb, 4)).astype(np.float32)
    emb = rng.normal(size=(b, 32, 32, 32)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    jsam.set_fused_i2t("interpret")
    jsam.set_fused_upscaler("interpret")
    try:
        js, jd = jsam.encode_prompts(jp, cfg, b, boxes=jnp.asarray(boxes),
                                     dtype=jnp.bfloat16)
        j_masks, j_iou = jsam.decode_masks(
            jp, cfg, jnp.asarray(emb, jnp.bfloat16), jsam.image_wide_pe(jp, cfg),
            js, jd, blocked=True)
    finally:
        jsam.set_fused_i2t("auto")
        jsam.set_fused_upscaler("auto")
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn, upscaler

    sd = {k: v.to(torch.bfloat16) for k, v in params_from_jax(tree).items()}
    calls = []
    orig = (upscaler._UpscaleHyper.apply, decoder_attn._FusedI2T.apply)
    upscaler._UpscaleHyper.apply = lambda *a: (calls.append("k3"),
                                               orig[0](*a))[1]
    decoder_attn._FusedI2T.apply = lambda *a: (calls.append("k4"),
                                               orig[1](*a))[1]
    try:
        ps, pd = psam.encode_prompts(sd, pcfg, b, boxes=torch.tensor(boxes),
                                     dtype=torch.bfloat16)
        p_masks, p_iou = psam.decode_masks(
            sd, pcfg, torch.tensor(emb).to(torch.bfloat16),
            psam.image_wide_pe(sd, pcfg), ps, pd, blocked=True)
    finally:
        upscaler._UpscaleHyper.apply, decoder_attn._FusedI2T.apply = orig
    assert sorted(calls) == ["k3", "k4", "k4"]
    want = np.asarray(j_masks, np.float32)
    assert p_masks.shape == want.shape and p_masks.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(p_masks.numpy() - want).max() / scale < 3e-2
    np.testing.assert_allclose(p_iou.float().numpy(),
                               np.asarray(j_iou, np.float32), atol=3e-2)


def test_encode_image_microbatched_equals_one_batch(rng):
    cfg = _cfg(m=pconfigs)
    sd = params_from_jax(_params(_cfg()))
    pix = torch.tensor(rng.normal(size=(3, 128, 128, 3)).astype(np.float32))
    want = psam.encode_image(sd, pix, cfg)
    got = psam.encode_image_microbatched(sd, pix, cfg, microbatch=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
