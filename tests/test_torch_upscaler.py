"""Port's fused upscaler + hypernetwork op (K3) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs.

On the CPU the port's ``torch.autograd.Function`` runs the plain versions
(``upscale_fwd_plain`` / ``upscale_bwd_plain``), which compute exactly what
the CUDA kernels return; tests/test_torch_kernels_gpu.py holds the kernels
to them on the card. Tolerances are tests/test_upscaler.py's: forward f32
atol 2e-5 / rtol 1e-4, every gradient atol = rtol = 5e-4 (f32 summation
order); bf16 by that file's rule against the f32 oracle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models.sam import gelu, layer_norm
from dilabhelmholtzoct_tpu.ops.upscaler import upscale_hyper_masks as j_up
from dilabhelmholtzoct_tpu_torch.ops import upscaler as p_up


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _params(rng, c):
    c1, c2 = c // 4, c // 8
    a = lambda *s, k=0.3: (rng.normal(size=s) * k).astype(np.float32)
    return {"ct1_w": a(c, 2, 2, c1), "ct1_b": a(c1),
            "ln": {"scale": 1.0 + a(c1, k=0.1), "bias": a(c1)},
            "ct2_w": a(c1, 2, 2, c2), "ct2_b": a(c2)}


def _sd(p, dtype=torch.float32, grad=False):
    """The JAX upscale params as the port's HF-named entries."""
    t = lambda x: torch.tensor(x, dtype=dtype, requires_grad=grad)
    return {
        "mask_decoder.upscale_conv1.weight": t(p["ct1_w"].transpose(0, 3, 1, 2)),
        "mask_decoder.upscale_conv1.bias": t(p["ct1_b"]),
        "mask_decoder.upscale_layer_norm.weight": t(p["ln"]["scale"]),
        "mask_decoder.upscale_layer_norm.bias": t(p["ln"]["bias"]),
        "mask_decoder.upscale_conv2.weight": t(p["ct2_w"].transpose(0, 3, 1, 2)),
        "mask_decoder.upscale_conv2.bias": t(p["ct2_b"]),
    }


def _jx(p, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), p)


def _einsum_chain(up, p, hyper):
    """tests/test_upscaler.py's oracle: the JAX blocked einsum branch."""
    w1 = p["ct1_w"].astype(up.dtype)
    u1 = jnp.einsum("bhwc,cdeo->bhwdeo", up, w1) + p["ct1_b"].astype(up.dtype)
    u1 = gelu(layer_norm(u1, jax.tree.map(lambda x: x.astype(up.dtype),
                                          p["ln"]), 1e-6))
    u2 = jnp.einsum("bhwdec,cfgo->bhwdefgo", u1, p["ct2_w"].astype(up.dtype))
    u2 = gelu(u2 + p["ct2_b"].astype(up.dtype))
    return jnp.einsum("btc,bhwdefgc->bthwdefg", hyper.astype(up.dtype), u2,
                      preferred_element_type=jnp.float32)


def _to_blocked(flat, g):
    """(BP, G*G, t*16) -> (BP, t, G, G, 2, 2, 2, 2)."""
    bp = flat.shape[0]
    return np.moveaxis(np.asarray(flat).reshape(bp, g, g, -1, 2, 2, 2, 2), 3, 1)


@pytest.mark.parametrize("c,n_out", [(256, 1), (64, 3)])
def test_forward_matches_jax_kernel_f32(rng, c, n_out):
    bp, g = 2, 8
    up = rng.normal(size=(bp, g * g, c)).astype(np.float32)
    hyper = rng.normal(size=(bp, n_out, c // 8)).astype(np.float32)
    p = _params(rng, c)
    want = j_up(jnp.asarray(up), _jx(p), jnp.asarray(hyper), interpret=True)
    got = p_up.upscale_hyper_masks(torch.tensor(up), _sd(p),
                                   torch.tensor(hyper))
    assert got.dtype == torch.float32 and got.shape == (bp, g * g, n_out * 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_forward_bf16_against_f32_oracle(rng):
    """The port in bf16 must be at least as accurate as the JAX einsum
    chain in bf16 (tests/test_upscaler.py:76-97), and within one bf16
    rounding of the output scale (2e-2 relative) of the JAX kernel in bf16."""
    bp, g, c = 2, 8, 256
    up32 = rng.normal(size=(bp, g, g, c)).astype(np.float32)
    hyper32 = rng.normal(size=(bp, 1, 32)).astype(np.float32)
    p = _params(rng, c)
    oracle = np.asarray(_einsum_chain(jnp.asarray(up32), _jx(p),
                                      jnp.asarray(hyper32)))
    up_b = jnp.asarray(up32).astype(jnp.bfloat16)
    hyper_b = jnp.asarray(hyper32).astype(jnp.bfloat16)
    ref_b = np.asarray(_einsum_chain(up_b, _jx(p, jnp.bfloat16), hyper_b))
    jk = np.asarray(j_up(up_b.reshape(bp, g * g, c), _jx(p, jnp.bfloat16),
                         hyper_b, interpret=True))
    got = p_up.upscale_hyper_masks(
        torch.tensor(up32).to(torch.bfloat16).reshape(bp, g * g, c),
        _sd(p, torch.bfloat16), torch.tensor(hyper32).to(torch.bfloat16))
    got = got.float().numpy()
    scale = np.abs(oracle).max()
    err_port = np.abs(_to_blocked(got, g) - oracle).max() / scale
    err_einsum = np.abs(ref_b - oracle).max() / scale
    assert err_port < max(2.5 * err_einsum, 1e-3), (err_port, err_einsum)
    assert np.abs(got - jk).max() / scale < 2e-2


def test_gradients_match_jax_kernel(rng):
    bp, g, c, n_out = 2, 8, 256, 1
    up = rng.normal(size=(bp, g * g, c)).astype(np.float32)
    hyper = rng.normal(size=(bp, n_out, c // 8)).astype(np.float32)
    p = _params(rng, c)
    ct = rng.normal(size=(bp, g * g, n_out * 16)).astype(np.float32)

    def loss(up_, p_, hyper_):
        return jnp.sum(j_up(up_, p_, hyper_, interpret=True) * ct)

    g_up, g_p, g_hy = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(up), _jx(p), jnp.asarray(hyper))

    sd = _sd(p, grad=True)
    t_up = torch.tensor(up, requires_grad=True)
    t_hy = torch.tensor(hyper, requires_grad=True)
    out = p_up.upscale_hyper_masks(t_up, sd, t_hy)
    names = list(sd)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(),
                                [t_up, t_hy] + [sd[k] for k in names])
    got = dict(zip(["up", "hyper"] + names, (x.numpy() for x in grads)))
    want = {
        "up": g_up, "hyper": g_hy,
        "mask_decoder.upscale_conv1.weight":
            np.asarray(g_p["ct1_w"]).transpose(0, 3, 1, 2),
        "mask_decoder.upscale_conv1.bias": g_p["ct1_b"],
        "mask_decoder.upscale_layer_norm.weight": g_p["ln"]["scale"],
        "mask_decoder.upscale_layer_norm.bias": g_p["ln"]["bias"],
        "mask_decoder.upscale_conv2.weight":
            np.asarray(g_p["ct2_w"]).transpose(0, 3, 1, 2),
        "mask_decoder.upscale_conv2.bias": g_p["ct2_b"],
    }
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=k)


def test_plain_backward_matches_autograd_of_plain_forward(rng):
    """upscale_bwd_plain (what the backward kernel returns) == autograd
    through upscale_fwd_plain, in f32, lane by lane."""
    bp, m, c, n_out = 2, 16, 256, 3
    f = lambda *s, k=0.3: torch.tensor(
        (rng.normal(size=s) * k).astype(np.float32), requires_grad=True)
    args = [f(bp, m, c, k=1.0), f(c, 2, 2, c // 4), f(c // 4),
            f(c // 4, k=0.1), f(c // 4), f(c // 4, 2, 2, c // 8), f(c // 8),
            f(bp, n_out, c // 8, k=1.0)]
    dm = torch.tensor(rng.normal(size=(bp, m, n_out * 16)).astype(np.float32))
    out = p_up.upscale_fwd_plain(*args)
    want = torch.autograd.grad((out * dm).sum(), args)
    d_up, dw1, dw2, db1, dg, dbt, db2, dht = p_up.upscale_bwd_plain(
        *[a.detach() for a in args[:1]], dm, *[a.detach() for a in args[1:]])
    c1, c2 = c // 4, c // 8
    got = [d_up, dw1.reshape(c, 2, 2, c1), db1.reshape(4, c1).sum(0),
           dg.reshape(4, c1).sum(0), dbt.reshape(4, c1).sum(0),
           dw2.reshape(4, c1, 2, 2, c2).sum(0), db2.reshape(16, c2).sum(0),
           dht.reshape(bp, n_out, 16, c2).sum(2)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_cpu_route_launches_nothing(rng):
    p_up.reset_launch_counts()
    p = _params(rng, 256)
    p_up.upscale_hyper_masks(torch.zeros((1, 4, 256)), _sd(p),
                             torch.zeros((1, 1, 32)))
    assert p_up.LAUNCHES == {"upscale_fwd": 0, "upscale_bwd": 0,
                             "upscale_bwd_dw": 0}
