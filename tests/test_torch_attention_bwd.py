"""The backward of the port's packed attention (K5 and its plain version)
and the logsumexp rows of K1 / K2, against the JAX package: the Pallas
kernels in interpret mode (``flash_attention_packed(return_lse=True)``,
``_flash_packed_bwd``, ``packed_attention_vjp``), the way
tests/test_attention.py runs them on the CPU. Also the encoder's gradient
with every layer checkpointed (``encode_image(remat=True)``).

Tolerances: f32 atol 5e-4 / rtol 1e-3 for gradients
(tests/test_attention.py's own for the same backward), atol 1e-4 /
rtol 1e-5 for the logsumexp (an f32 log-sum over <= 196 terms); bf16 within
2 bf16 ulps of each output's max |value| (the same roundings taken in
another summation order can flip one rounding of ds or of the output)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.models.configs import (
    DecoderConfig,
    PromptConfig,
    SamConfig,
    VisionConfig,
)
from dilabhelmholtzoct_tpu.ops import attention as jattn
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn

GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3


def _inputs(rng, b, nh, hw):
    h, w = hw
    n, c = h * w, nh * 64
    return ((rng.normal(size=(b, n, 3 * c)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, nh, n, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(b, nh, n, w)) * 0.3).astype(np.float32),
            rng.normal(size=(b, n, c)).astype(np.float32))


def _to_jax_rows(x, nh):
    """(B, heads, N) -> JAX's head-pair layout (B, pairs, N, 2)."""
    b, _, n = x.shape
    return x.reshape(b, nh // 2, 2, n).transpose(0, 1, 3, 2)


def _from_jax_rows(x):
    """JAX's (B, pairs, N, 2) -> (B, heads, N)."""
    b, pairs, n, _ = x.shape
    return x.transpose(0, 1, 3, 2).reshape(b, 2 * pairs, n)


@pytest.mark.parametrize("b,nh,hw,tiles", [
    (2, 2, (8, 8), dict(tq=16, tk=16)),  # _packed_kernel, 4 key blocks
    (5, 2, (14, 14), {}),                # _windowed_group_kernel
])
def test_plain_lse_matches_jax_interpret(rng, b, nh, hw, tiles):
    qkv, rel_h, rel_w, _ = _inputs(rng, b, nh, hw)
    out_j, lse_j = jattn.flash_attention_packed(
        *map(jnp.asarray, (qkv, rel_h, rel_w)), hw=hw, num_heads=nh,
        interpret=True, return_lse=True, **tiles)
    out, lse = port_attn.packed_attention_plain(
        *map(torch.tensor, (qkv, rel_h, rel_w)), hw=hw, num_heads=nh,
        return_lse=True)
    assert lse.shape == (b, nh, hw[0] * hw[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _from_jax_rows(np.asarray(lse_j)),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=1e-4)


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at max |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,hw,b", [(2, (8, 8), 2), (4, (8, 8), 2),
                                     (2, (4, 4), 6)])
def test_bwd_plain_matches_jax_interpret(rng, dtype, nh, hw, b):
    """packed_attention_bwd_plain vs _flash_packed_bwd (interpret) on the
    same (qkv, rel, dO, L, D); the JAX tiles are cut to 16 rows so that its
    grid has several query and key blocks."""
    qkv, rel_h, rel_w, g = _inputs(rng, b, nh, hw)
    tdt = getattr(torch, dtype)
    # round the inputs once, so that both packages start from the same bits
    qkv, rel_h, rel_w, g = (torch.tensor(a).to(tdt)
                            for a in (qkv, rel_h, rel_w, g))
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w, hw=hw,
                                                num_heads=nh, return_lse=True)
    dvec = port_attn.bwd_dvec(g, out, nh)
    got = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                               dvec, hw=hw, num_heads=nh)
    n = hw[0] * hw[1]

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))

    want = jattn._flash_packed_bwd(
        jx(qkv), jx(rel_h), jx(rel_w), jx(g),
        jnp.asarray(_to_jax_rows(lse.numpy(), nh)),
        jnp.asarray(_to_jax_rows(dvec.numpy(), nh)), hw=hw, num_heads=nh,
        tq=min(16, n), tk=min(16, n), interpret=True)
    for name, a, w in zip(("dqkv", "drel_h", "drel_w"), got, want):
        assert a.dtype == tdt, name
        a, w = a.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=name)
        else:
            err = np.abs(a - w).max()
            assert err <= 2 * _bf16_ulp(w), (name, err, _bf16_ulp(w))


def _jax_vjp_grads(qkv, rel_h, rel_w, t, hw, nh, **tiles):
    f = jattn.packed_attention_vjp(hw=hw, num_heads=nh, interpret=True,
                                   **tiles)
    return jax.grad(lambda *a: jnp.sum(f(*a) * t), argnums=(0, 1, 2))(
        *map(jnp.asarray, (qkv, rel_h, rel_w)))


@pytest.mark.parametrize("b,nh,hw,tiles", [
    (2, 2, (8, 8), dict(tq=16, tk=16)),
    (5, 2, (14, 14), {}),
])
def test_autograd_matches_jax_vjp(rng, b, nh, hw, tiles):
    """Gradients through the port's flash_attention_packed on the CPU (the
    autograd Function with the plain forward and backward) vs jax.grad of
    packed_attention_vjp in interpret mode."""
    qkv, rel_h, rel_w, t = _inputs(rng, b, nh, hw)
    want = _jax_vjp_grads(qkv, rel_h, rel_w, t, hw, nh, **tiles)
    args = [torch.tensor(a, requires_grad=True) for a in (qkv, rel_h, rel_w)]
    port_attn.reset_launch_counts()
    out = port_attn.flash_attention_packed(*args, hw=hw, num_heads=nh)
    (out * torch.tensor(t)).sum().backward()
    assert not any(port_attn.LAUNCHES.values())  # plain versions on the CPU
    for name, a, w in zip(("dqkv", "drel_h", "drel_w"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,nh,hw", [(2, 2, (8, 8)), (3, 4, (5, 7))])
def test_bwd_plain_matches_torch_autograd(rng, b, nh, hw):
    """The backward formula, independently of JAX: f32
    packed_attention_bwd_plain == torch autograd through
    packed_attention_plain (summation order only: atol 1e-5, rtol 1e-4)."""
    qkv, rel_h, rel_w, t = map(torch.tensor, _inputs(rng, b, nh, hw))
    args = [x.clone().requires_grad_(True) for x in (qkv, rel_h, rel_w)]
    out, lse = port_attn.packed_attention_plain(*args, hw=hw, num_heads=nh,
                                                return_lse=True)
    (out * t).sum().backward()
    dvec = port_attn.bwd_dvec(t, out.detach(), nh)
    got = port_attn.packed_attention_bwd_plain(
        qkv, rel_h, rel_w, t, lse.detach(), dvec, hw=hw, num_heads=nh)
    for name, a, x in zip(("dqkv", "drel_h", "drel_w"), got, args):
        np.testing.assert_allclose(a.numpy(), x.grad.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def _encoder_cfg():
    """tests/test_attention.py::test_encoder_grad_flash_matches_xla's
    config: two layers (windowed, global), two heads of 64."""
    return SamConfig(
        vision=VisionConfig(hidden_size=128, num_layers=2, num_heads=2,
                            image_size=64, patch_size=16, window_size=2,
                            global_attn_indexes=(1,), mlp_dim=128,
                            output_channels=32),
        prompt=PromptConfig(hidden_size=32, image_embedding_size=4,
                            input_image_size=64),
        decoder=DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                              mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16)


def test_encoder_grad_with_remat_matches_jax_flash(rng):
    """Gradients of sum(emb^2) wrt every encoder parameter: the port's
    encode_image(remat=True) (checkpointed layers, the autograd Function) vs
    JAX's encode_image under set_flash_attention('interpret'), at
    tests/test_attention.py:276-320's config and tolerance (atol 1e-3,
    rtol 2e-3)."""
    cfg = _encoder_cfg()
    params = jsam.init_params(jax.random.PRNGKey(0), cfg)
    for lp in params["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = jnp.asarray(
                rng.normal(size=lp["attn"][key].shape).astype(np.float32)
                * 0.2)
    pix = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)

    def loss(p):
        jsam.set_flash_attention("interpret")
        try:
            return jnp.sum(jsam.encode_image(p, jnp.asarray(pix), cfg) ** 2)
        finally:
            jsam.set_flash_attention("auto")

    want = params_from_jax(jax.tree.map(np.asarray,
                                        jax.jit(jax.grad(loss))(params)))
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    for v in sd.values():
        v.requires_grad_(True)
    (psam.encode_image(sd, torch.tensor(pix), cfg, remat=True) ** 2).sum() \
        .backward()
    checked = 0
    for k, v in sd.items():
        if v.grad is None:  # outside the encoder: no gradient in JAX either
            assert not np.asarray(want[k]).any(), k
            continue
        np.testing.assert_allclose(v.grad.numpy(), want[k].numpy(), atol=1e-3,
                                   rtol=2e-3, err_msg=k)
        checked += 1
    assert checked == sum(k.startswith("vision_encoder.") for k in sd)
