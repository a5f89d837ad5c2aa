"""The port's encoder attention switch ``set_flash_attention``
(``dilabhelmholtzoct_tpu_torch/models/sam.py``) against the JAX package's:
the same four modes and rule, the materialized route ('off', and 'auto'
below 196 tokens) against JAX's ``vision_attention`` under 'off', and a
ViT-H-shaped ``trainable='all'`` step (2 layers, 2 heads of 80) against
JAX's on the CPU.

JAX's 'auto' asks ``jax.default_backend()``; the port's 'auto' is that rule
on an accelerator, so the rule's comparison patches the backend to "gpu"
inside the test only. A fixture puts both switches back to 'auto' after
every case. Limits: f32 within 1e-5 of the output's max |value| (summation
order over <= 160 products and 64 keys); bf16 at least 95% bit-equal and
every element within 2 bf16 ulps of the output scale (2 * 2^-8 * max
|value|: one flipped rounding of the bias or the probabilities), the limit
the port's attention kernels hold against their plain versions; the steps
as ``tests/test_torch_finetune.py`` holds the head-dim-64 ones."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.train import trainer as jtr
from dilabhelmholtzoct_tpu_torch import models as pmodels
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import attention as pattn
from dilabhelmholtzoct_tpu_torch.train import trainer as ptr
from test_torch_train import LR, ORIG_HW, _batch, _sign_agreement

MODES = ("auto", "on", "off", "interpret")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _auto_after():
    yield
    for mod in (jsam, psam):
        mod.set_flash_attention("auto")


def _port_route(n_tokens, head_dim, heads):
    """The route the port's ``vision_attention`` takes."""
    if not psam._use_flash(n_tokens):
        return "materialized"
    qkv = torch.empty(1, 1, 3 * heads * head_dim)
    return "packed" if pattn._packed_route(qkv, heads) else "relpos"


def _jax_route(n_tokens, head_dim, heads):
    """The route JAX's ``vision_attention`` takes (``models/sam.py``)."""
    if not jsam._use_flash(n_tokens):
        return "materialized"
    return "packed" if head_dim == 64 and heads % 2 == 0 else "relpos"


@pytest.mark.parametrize("heads", [2, 3, 16])
@pytest.mark.parametrize("head_dim", [16, 64, 80])
@pytest.mark.parametrize("mode", MODES)
def test_switch_matches_jax(monkeypatch, mode, head_dim, heads):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for mod in (jsam, psam):
        mod.set_flash_attention(mode)
    for n in (4, 16, 64, 195, 196, 197, 256, 4096):
        assert _port_route(n, head_dim, heads) == _jax_route(
            n, head_dim, heads), (mode, n)


def test_auto_rule_and_unknown_modes():
    """'auto' is the flash route from 196 tokens (ViT-B / ViT-H's windows
    and global layers), the export is the module's, an unknown mode
    raises and leaves the switch as it was."""
    assert pmodels.set_flash_attention is psam.set_flash_attention
    assert not psam._use_flash(195) and psam._use_flash(196)
    with pytest.raises(ValueError, match="unknown flash-attention"):
        psam.set_flash_attention("always")
    assert psam._FLASH_MODE == "auto"


def test_relpos_backward_message_names_the_switch():
    """The flash route's backward at a head dim other than 64 raises on the
    card (K6 is forward-only); the message names the materialized route."""
    qkv = torch.zeros(1, 16, 3 * 2 * 80)
    with pytest.raises(NotImplementedError,
                       match=r"set_flash_attention\('off'\)"):
        pattn._kernel_dims(qkv, 2)


def _layer_inputs(rng, head_dim, heads=2, hw=(8, 8)):
    c = heads * head_dim
    x = rng.normal(size=(2, *hw, c)).astype(np.float32)
    w = (rng.normal(size=(3 * c, c)) * c ** -0.5).astype(np.float32)
    bq = (rng.normal(size=3 * c) * 0.1).astype(np.float32)
    wp = (rng.normal(size=(c, c)) * c ** -0.5).astype(np.float32)
    bp = (rng.normal(size=c) * 0.1).astype(np.float32)
    rh = (rng.normal(size=(2 * hw[0] - 1, head_dim)) * 0.3).astype(np.float32)
    rw = (rng.normal(size=(2 * hw[1] - 1, head_dim)) * 0.3).astype(np.float32)
    jp = {"qkv": {"w": w.T, "b": bq}, "proj": {"w": wp.T, "b": bp},
          "rel_pos_h": rh, "rel_pos_w": rw}
    sd = {"a.qkv.weight": w, "a.qkv.bias": bq, "a.proj.weight": wp,
          "a.proj.bias": bp, "a.rel_pos_h": rh, "a.rel_pos_w": rw}
    return x, jax.tree.map(jnp.asarray, jp), {
        k: torch.tensor(v) for k, v in sd.items()}


def _assert_dtype_limits(got, want, dtype):
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * scale, (diff.max(), scale)
    else:
        assert (diff == 0).mean() >= 0.95, (diff == 0).mean()
        assert diff.max() <= 2 * 2.0 ** -8 * scale, (diff.max(), scale)


@pytest.mark.parametrize("hw", [(8, 8), (4, 4), (14, 14)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("head_dim", [64, 80])
def test_off_route_matches_jax(rng, head_dim, dtype, hw):
    """One attention layer (qkv projection to output projection) under
    'off' in both packages."""
    tdt, jdt = DTYPES[dtype]
    x, jp, sd = _layer_inputs(rng, head_dim, hw=hw)
    vj = jconfigs.VisionConfig(hidden_size=2 * head_dim, num_heads=2)
    vp = pconfigs.VisionConfig(hidden_size=2 * head_dim, num_heads=2)
    for mod in (jsam, psam):
        mod.set_flash_attention("off")
    want = np.asarray(jsam.vision_attention(jnp.asarray(x, jdt), jp, vj)
                      .astype(jnp.float32))
    got = psam.vision_attention(torch.tensor(x).to(tdt), sd, "a", vp)
    assert got.dtype == tdt
    _assert_dtype_limits(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("head_dim", [64, 80])
def test_off_route_gradient_matches_jax(rng, head_dim):
    """f32 gradients of a scalar of the layer's output with respect to x and
    every parameter, 'off' in both packages (autograd against jax.grad)."""
    x, jp, sd = _layer_inputs(rng, head_dim)
    g = rng.normal(size=x.shape).astype(np.float32)
    vj = jconfigs.VisionConfig(hidden_size=2 * head_dim, num_heads=2)
    vp = pconfigs.VisionConfig(hidden_size=2 * head_dim, num_heads=2)
    for mod in (jsam, psam):
        mod.set_flash_attention("off")
    jx, jw = jax.grad(lambda a, p: jnp.sum(
        jsam.vision_attention(a, p, vj) * g), argnums=(0, 1))(
        jnp.asarray(x), jp)
    xt = torch.tensor(x, requires_grad=True)
    for v in sd.values():
        v.requires_grad_(True)
    (psam.vision_attention(xt, sd, "a", vp) * torch.tensor(g)).sum().backward()
    pairs = [(xt.grad, jx), (sd["a.qkv.weight"].grad, jw["qkv"]["w"].T),
             (sd["a.qkv.bias"].grad, jw["qkv"]["b"]),
             (sd["a.proj.weight"].grad, jw["proj"]["w"].T),
             (sd["a.rel_pos_h"].grad, jw["rel_pos_h"]),
             (sd["a.rel_pos_w"].grad, jw["rel_pos_w"])]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def _vith_cfg(m):
    """ViT-H's attention shape at test size: 2 layers (windowed, global) of
    2 heads of 80, an 8 x 8 grid, windows of 4."""
    return m.SamConfig(
        vision=m.VisionConfig(hidden_size=160, num_layers=2, num_heads=2,
                              image_size=128, patch_size=16, window_size=4,
                              global_attn_indexes=(1,), mlp_dim=128,
                              output_channels=32),
        prompt=m.PromptConfig(hidden_size=32, image_embedding_size=8,
                              input_image_size=128),
        decoder=m.DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16)


def _vith_params(seed):
    """JAX init + N(0, 0.05) on every leaf, N(0, 0.2) rel-pos tables."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), _vith_cfg(jconfigs)))
    for lp in tree["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (rng.normal(size=lp["attn"][key].shape)
                               * 0.2).astype(np.float32)
    return tree


def _vith_steps(tree, batch, dtype, n_steps, grads=False):
    """n_steps of each package's trainable='all' step under 'off'; returns
    (jax losses, port losses, (jax, port) parameters after step 1,
    parameters before, (jax, port) first-step gradients when ``grads``)."""
    kw = dict(compute_dtype=dtype, learning_rate=LR, cache_embeddings=False,
              trainable="all")
    jconf, pconf = jtr.TrainConfig(**kw), ptr.TrainConfig(evaluate=False,
                                                          **kw)
    cfg_j, cfg_p = _vith_cfg(jconfigs), _vith_cfg(pconfigs)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for mod in (jsam, psam):
        mod.set_flash_attention("off")

    g_j = None
    if grads:
        p_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree),
                                          "all")
        keep = optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda g, s, params=None: (jax.tree.map(jnp.zeros_like, g), g))
        _, g_j, _ = jtr.make_train_step(cfg_j, jconf, keep, ORIG_HW, False)(
            p_j, keep.init(p_j), frozen_j, jb)
        g_j = params_from_jax(jax.tree.map(np.asarray, g_j))
    p_j, frozen_j = jtr._split_params(jax.tree.map(jnp.asarray, tree), "all")
    opt_j = jtr.make_optimizer(jconf)
    state_j = opt_j.init(p_j)
    step_j = jtr.make_train_step(cfg_j, jconf, opt_j, ORIG_HW, False)

    sd = params_from_jax(tree)
    before = {k: v.clone() for k, v in sd.items()}
    p_p, frozen_p = ptr._split_params(sd, "all")
    for v in p_p.values():
        v.requires_grad_(True)
    opt_p = ptr.make_optimizer(pconf, p_p.values())
    step_p = ptr.make_train_step(cfg_p, pconf, opt_p, ORIG_HW, False)
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    lj, lp, first, g_p = [], [], None, None
    for i in range(n_steps):
        p_j, state_j, loss = step_j(p_j, state_j, frozen_j, jb)
        lj.append(float(loss))
        p_p, opt_p, loss = step_p(p_p, opt_p, frozen_p, pb)
        lp.append(float(loss))
        if i == 0:
            g_p = {k: v.grad.clone() for k, v in p_p.items()}
            first = (params_from_jax(jax.tree.map(np.asarray, p_j)),
                     ptr.tie_shared_pe({k: v.detach().clone()
                                        for k, v in p_p.items()}))
    return lj, lp, first, before, (g_j, g_p)


def test_vith_shaped_f32_full_finetune_matches_jax():
    """Two f32 ``trainable='all'`` steps at head dim 80 on the materialized
    route: each loss within 2e-4 * (1 + step); step 1's gradient of every
    parameter, the encoder's included, within 1e-4 relative (and 1e-4 of
    its tensor's max |value|, at least 1e-8: the key projection's bias
    has a zero gradient but for rounding, as softmax ignores a constant per
    row); at least 99% of the moved parameters agree in sign; the patch
    embedding moved."""
    tree = _vith_params(3)
    batch = _batch(np.random.default_rng(31), 2, 3)
    lj, lp, (j1, p1), before, (g_j, g_p) = _vith_steps(tree, batch,
                                                       "float32", 2, True)
    for i, (a, b) in enumerate(zip(lp, lj)):
        tol = 2e-4 * (1 + i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"step {i}: port {lp} jax {lj}")
    assert lp[-1] < lp[0]
    assert any(k.startswith("vision_encoder.layers.1.attn") for k in g_p)
    for k, got in g_p.items():
        want = g_j[k].numpy()
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4,
            atol=max(1e-4 * np.abs(want).max(), 1e-8), err_msg=k)
    assert _sign_agreement(j1, p1, before) >= 0.99
    k = "vision_encoder.patch_embed.projection.weight"
    assert not torch.allclose(p1[k], before[k])


def test_vith_shaped_bf16_full_finetune_matches_jax():
    """Two bf16 steps (the ViT-H fine-tune's dtype), JAX with both fused
    decoder ops under "interpret" as the port's bf16 decoder runs them:
    losses within 1e-3 relative, as the head-dim-64 bf16 steps."""
    tree = _vith_params(4)
    batch = _batch(np.random.default_rng(32), 2, 3)
    jsam.set_fused_i2t("interpret")
    jsam.set_fused_upscaler("interpret")
    try:
        lj, lp, _, _, _ = _vith_steps(tree, batch, "bfloat16", 2)
    finally:
        jsam.set_fused_i2t("auto")
        jsam.set_fused_upscaler("auto")
    np.testing.assert_allclose(lp, lj, rtol=1e-3)
    assert np.isfinite(lp).all()
