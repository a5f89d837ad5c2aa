"""The port's decoder routing switches ``set_fused_i2t`` / ``set_fused_upscaler``
(``dilabhelmholtzoct_tpu_torch/models/sam.py``) against the JAX package's
(``dilabhelmholtzoct_tpu/models/sam.py``): the same four modes and rules, the
same warning for ``set_fused_upscaler('on')`` on f32, and the f32 fused route
that ``'on'`` (K4) and ``'interpret'`` (K3) open held against the JAX
package's kernels in interpret mode.

The JAX rules' 'auto' asks ``jax.default_backend()``; the port's 'auto' is
that rule on an accelerator, so the comparison patches the backend to "gpu"
inside the test only. A fixture puts both packages' switches back to 'auto'
after every case, so that no other test in the same worker routes otherwise.
Tolerances of the fused ops: tests/test_torch_decoder_attn.py's (K4 forward
2e-5 in f32) and tests/test_torch_upscaler.py's (K3 forward atol 2e-5, rtol
1e-4); of whole decodes tests/test_torch_sam.py's (1e-4: f32 summation order
over a two-layer decoder)."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.ops.decoder_attn import fused_i2t_ln as j_i2t
from dilabhelmholtzoct_tpu.ops.upscaler import upscale_hyper_masks as j_up
from dilabhelmholtzoct_tpu_torch import models as pmodels
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn, upscaler

MODES = ("auto", "on", "off", "interpret")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (n_tok, internal, nh, pe_batch, n_pixels): the training decoder; too many
# tokens; heads not dividing the width on a 1024-cell grid; a per-image
# positional grid on a small grid
SHAPES = [(7, 128, 8, 1, 4096), (9, 128, 8, 1, 4096), (7, 128, 6, 1, 1024),
          (7, 128, 8, 2, 256)]


@pytest.fixture(autouse=True)
def _auto_after():
    yield
    for mod in (jsam, psam):
        mod.set_fused_i2t("auto")
        mod.set_fused_upscaler("auto")


def _set(mode_i2t, mode_up):
    for mod in (jsam, psam):
        mod.set_fused_i2t(mode_i2t)
        mod.set_fused_upscaler(mode_up)


def _routes(use_upscaler, n_pixels, dtype):
    """(route, warning messages) of one ``_use_fused_upscaler`` call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        route = use_upscaler(n_pixels, dtype)
    return route, [str(w.message) for w in caught]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["train", "9_tokens", "6_heads", "pe_batch_2"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_routing_matches_jax(monkeypatch, mode, dtype, shape):
    n_tok, internal, nh, pe_batch, n_pixels = shape
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _set(mode, mode)
    assert psam._use_fused_i2t(tdt, n_tok, internal, nh, pe_batch) == \
        jsam._use_fused_i2t(jdt, n_tok, internal, nh, pe_batch)
    p_route, p_warn = _routes(psam._use_fused_upscaler, n_pixels, tdt)
    j_route, j_warn = _routes(jsam._use_fused_upscaler, n_pixels, jdt)
    assert p_route == j_route
    assert len(p_warn) == len(j_warn) == (mode == "on" and dtype == "float32")
    for p, j in zip(p_warn, j_warn):
        head = "set_fused_upscaler('on') ignored for non-bf16 inputs"
        assert p.startswith(head) and j.startswith(head)


def test_auto_routes_only_bf16():
    """'auto' keeps the routes the port had before the switches: K4 in bf16,
    K3 in bf16 on grids of >= 1024 cells."""
    assert psam._use_fused_i2t(torch.bfloat16, 7, 128, 8, 1)
    assert not psam._use_fused_i2t(torch.float32, 7, 128, 8, 1)
    assert psam._use_fused_upscaler(1024, torch.bfloat16)
    assert not psam._use_fused_upscaler(1023, torch.bfloat16)
    assert not psam._use_fused_upscaler(4096, torch.float32)


def test_unknown_modes_raise():
    assert pmodels.set_fused_i2t is psam.set_fused_i2t
    assert pmodels.set_fused_upscaler is psam.set_fused_upscaler
    for setter in (psam.set_fused_i2t, psam.set_fused_upscaler):
        with pytest.raises(ValueError, match="unknown fused"):
            setter("always")
    assert psam._FUSED_I2T == psam._FUSED_UPSCALER == "auto"


def _cfg(m=jconfigs):
    """tests/test_torch_sam.py's 32x32-grid decoder (1024 cells)."""
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


def _tree(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(seed), cfg))


def _decode_both(rng, pb, jax_modes, port_modes, record):
    """f32 blocked decode of 2 images x pb boxes in both packages under the
    given (i2t, upscaler) modes; ``record`` collects the port's K3 / K4
    autograd Functions' arguments by name."""
    cfg, pcfg = _cfg(), _cfg(pconfigs)
    tree = _tree(cfg)
    b = 2
    boxes = rng.uniform(0, 500, (b, pb, 4)).astype(np.float32)
    emb = rng.normal(size=(b, 32, 32, 32)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    jsam.set_fused_i2t(jax_modes[0])
    jsam.set_fused_upscaler(jax_modes[1])
    js, jd = jsam.encode_prompts(jp, cfg, b, boxes=jnp.asarray(boxes))
    j_out = jsam.decode_masks(jp, cfg, jnp.asarray(emb),
                              jsam.image_wide_pe(jp, cfg), js, jd,
                              blocked=True)
    sd = params_from_jax(tree)
    psam.set_fused_i2t(port_modes[0])
    psam.set_fused_upscaler(port_modes[1])
    orig = (upscaler._UpscaleHyper.apply, decoder_attn._FusedI2T.apply)

    def spy(name, fn):
        return lambda *a: (record.setdefault(name, []).append(a), fn(*a))[1]

    upscaler._UpscaleHyper.apply = spy("k3", orig[0])
    decoder_attn._FusedI2T.apply = spy("k4", orig[1])
    try:
        ps, pd = psam.encode_prompts(sd, pcfg, b, boxes=torch.tensor(boxes))
        p_out = psam.decode_masks(sd, pcfg, torch.tensor(emb),
                                  psam.image_wide_pe(sd, pcfg), ps, pd,
                                  blocked=True)
    finally:
        upscaler._UpscaleHyper.apply, decoder_attn._FusedI2T.apply = orig
    return p_out, j_out


@pytest.mark.parametrize("pb", [1, 3])
def test_f32_fused_route_matches_jax_interpret(rng, pb):
    """f32 under the port's set_fused_i2t('on') and
    set_fused_upscaler('interpret') (the JAX package under 'interpret' for
    both, its CPU form of the same route): K4 twice and K3 once per decode;
    each op's output on the CPU tensors it was given matches the JAX
    kernel in interpret mode on the same values, and the decode matches the
    JAX decode."""
    record = {}
    (p_masks, p_iou), (j_masks, j_iou) = _decode_both(
        rng, pb, ("interpret", "interpret"), ("on", "interpret"), record)
    assert len(record["k4"]) == 2 and len(record["k3"]) == 1
    for args in record["k4"]:
        keys, pe, tk, tv, wq, bq, wo, bo, g, bt, nh, pbk, eps = args
        assert keys.dtype == torch.float32 and keys.device.type == "cpu"
        got = decoder_attn._FusedI2T.apply(*args)
        j = lambda x: jnp.asarray(x.detach().numpy())
        want = j_i2t(j(keys), j(pe), j(tk), j(tv), {"w": j(wq), "b": j(bq)},
                     {"w": j(wo), "b": j(bo)}, {"scale": j(g), "bias": j(bt)},
                     nh=nh, pb=pbk, eps=eps, interpret=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    (args,) = record["k3"]
    up, w1, b1, g, bt, w2, b2, hyper, eps = args
    assert up.dtype == torch.float32 and up.device.type == "cpu"
    got = upscaler._UpscaleHyper.apply(*args)
    j = lambda x: jnp.asarray(x.detach().numpy())
    want = j_up(j(up), {"ct1_w": j(w1), "ct1_b": j(b1),
                        "ln": {"scale": j(g), "bias": j(bt)},
                        "ct2_w": j(w2), "ct2_b": j(b2)}, j(hyper),
                eps=eps, interpret=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(p_masks.detach().numpy(), np.asarray(j_masks),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p_iou.detach().numpy(), np.asarray(j_iou),
                               atol=1e-4, rtol=1e-4)


def test_upscaler_on_f32_warns_and_keeps_einsum_chain(rng):
    """set_fused_upscaler('on') in f32: both packages warn and decode on the
    einsum chain (no K3), K4 still off under 'auto'."""
    record = {}
    with pytest.warns(UserWarning, match="ignored for non-bf16 inputs"):
        (p_masks, p_iou), (j_masks, j_iou) = _decode_both(
            rng, 1, ("auto", "on"), ("auto", "on"), record)
    assert record == {}
    np.testing.assert_allclose(p_masks.detach().numpy(), np.asarray(j_masks),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p_iou.detach().numpy(), np.asarray(j_iou),
                               atol=1e-4, rtol=1e-4)
