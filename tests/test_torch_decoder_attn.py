"""Port's fused image->token attention + residual + LayerNorm (K4) against
the JAX package's Pallas kernel run in interpret mode, on the same numpy
inputs.

On the CPU the port's ``torch.autograd.Function`` runs the plain versions
(``i2t_fwd_plain`` / ``i2t_bwd_plain``), which compute exactly what the CUDA
kernels return; tests/test_torch_kernels_gpu.py holds the kernels to them on
the card. Tolerances are tests/test_decoder_attn.py's: forward 2e-5 in f32
and 2e-2 in bf16 (one bf16 rounding of |y| <~ 4), every gradient 2e-3
(f32 summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops.decoder_attn import fused_i2t_ln as j_i2t
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as p_i2t

PF = "mask_decoder.transformer.layers.0"
B, M, C, I, NH = 2, 64, 256, 128, 8


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _params(rng):
    a = lambda *s, k=0.2: (rng.normal(size=s) * k).astype(np.float32)
    return ({"w": a(C, I), "b": a(I)}, {"w": a(I, C), "b": a(C)},
            {"scale": 1.0 + a(C, k=0.1), "bias": a(C)})


def _sd(q_p, out_p, ln_p, dtype=torch.float32, grad=False):
    t = lambda x: torch.tensor(x, dtype=dtype, requires_grad=grad)
    pf = f"{PF}.cross_attn_image_to_token"
    return {f"{pf}.q_proj.weight": t(q_p["w"].T.copy()),
            f"{pf}.q_proj.bias": t(q_p["b"]),
            f"{pf}.out_proj.weight": t(out_p["w"].T.copy()),
            f"{pf}.out_proj.bias": t(out_p["b"]),
            f"{PF}.layer_norm4.weight": t(ln_p["scale"]),
            f"{PF}.layer_norm4.bias": t(ln_p["bias"])}


def _inputs(rng, pb, n_tok):
    return (rng.normal(size=(B, M, C)).astype(np.float32),
            rng.normal(size=(1, M, C)).astype(np.float32),
            rng.normal(size=(B * pb, n_tok, I)).astype(np.float32),
            rng.normal(size=(B * pb, n_tok, I)).astype(np.float32))


@pytest.mark.parametrize("pb,n_tok,dtype", [(1, 7, "float32"),
                                            (3, 7, "float32"),
                                            (1, 5, "float32"),
                                            (1, 7, "bfloat16")])
def test_forward_matches_jax_kernel(rng, pb, n_tok, dtype):
    arrays = _inputs(rng, pb, n_tok)
    q_p, out_p, ln_p = _params(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cast = lambda t: jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), t)
    want = j_i2t(*(jnp.asarray(a).astype(jdt) for a in arrays), cast(q_p),
                 cast(out_p), cast(ln_p), nh=NH, pb=pb, interpret=True)
    got = p_i2t.fused_i2t_ln(*(torch.tensor(a).to(tdt) for a in arrays),
                             _sd(q_p, out_p, ln_p, tdt), PF, nh=NH, pb=pb)
    assert got.dtype == tdt and got.shape == (B * pb, M, C)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("pb", [1, 3])
def test_gradients_match_jax_kernel(rng, pb):
    arrays = _inputs(rng, pb, 7)
    q_p, out_p, ln_p = _params(rng)
    ct = rng.normal(size=(B * pb, M, C)).astype(np.float32)

    def loss(keys, pe, tk, tv, q_p_, out_p_, ln_p_):
        return jnp.sum(j_i2t(keys, pe, tk, tv, q_p_, out_p_, ln_p_, nh=NH,
                             pb=pb, interpret=True) * ct)

    jg = jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in arrays), *jax.tree.map(jnp.asarray,
                                                        (q_p, out_p, ln_p)))
    sd = _sd(q_p, out_p, ln_p, grad=True)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = p_i2t.fused_i2t_ln(*ts, sd, PF, nh=NH, pb=pb)
    names = list(sd)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(),
                                ts + [sd[k] for k in names])
    got = [g.numpy() for g in grads]
    want = [*(np.asarray(g) for g in jg[:4]),
            np.asarray(jg[4]["w"]).T, jg[4]["b"],
            np.asarray(jg[5]["w"]).T, jg[5]["b"],
            jg[6]["scale"], jg[6]["bias"]]
    labels = ["keys", "pe", "tok_k", "tok_v"] + names
    for lab, a, w in zip(labels, got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-3, rtol=2e-3,
                                   err_msg=lab)


@pytest.mark.parametrize("pb", [1, 2])
def test_plain_backward_matches_autograd_of_plain_forward(rng, pb):
    """i2t_bwd_plain (what the backward kernel returns, plus the outside
    einsums of the Function) == autograd through i2t_fwd_plain, in f32."""
    arrays = _inputs(rng, pb, 6)
    q_p, out_p, ln_p = _params(rng)
    f = lambda x: torch.tensor(x, requires_grad=True)
    args = [f(a) for a in arrays] + [f(q_p["w"]), f(q_p["b"]), f(out_p["w"]),
                                     f(out_p["b"]), f(ln_p["scale"]),
                                     f(ln_p["bias"])]
    dy = torch.tensor(rng.normal(size=(B * pb, M, C)).astype(np.float32))
    want = torch.autograd.grad(
        (p_i2t.i2t_fwd_plain(*args, nh=NH, pb=pb, eps=1e-6) * dy).sum(), args)
    got = torch.autograd.grad(
        (p_i2t._FusedI2T.apply(*args, NH, pb, 1e-6) * dy).sum(), args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_refuses_more_than_eight_tokens(rng):
    arrays = _inputs(rng, 1, 9)
    sd = _sd(*_params(rng))
    with pytest.raises(ValueError, match="at most 8 tokens"):
        p_i2t.fused_i2t_ln(*(torch.tensor(a) for a in arrays), sd, PF, nh=NH)
    with pytest.raises(ValueError, match="multiple of"):
        p_i2t.fused_i2t_ln(*(torch.tensor(a) for a in _inputs(rng, 1, 7)),
                           sd, PF, nh=3)
