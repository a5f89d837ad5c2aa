"""The bf16 K3 / K4 forwards' numerics, pinned on the CPU through their plain
versions (``i2t_fwd_plain``, ``upscale_fwd_plain``), which the tensor-core
kernels are held to on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py):

  * K4 against the JAX package's own row math: ``ops/decoder_attn.py::
    _chain`` evaluated with jnp outside ``pallas_call``, on operands built
    as ``fused_i2t_ln`` and ``_fwd_kernel`` build them (``_consts``,
    ``_token_mats``). Both sides round at the same points and differ only
    in the order of the f32 sums (torch's matmul against XLA's dot), which
    flips about one rounding of qpre, p, out or proj in 10^4; a flip moves
    the y of its row, so at most 2% of the rows differ at all. Limits: at
    least 99.5% of y's bf16 outputs the same bits, and every output within
    two bf16 ulps of the output scale (2 * 2^-8 * max |y|). (The
    interpret-mode kernel itself differs from its own ``_chain`` on about a
    quarter of the outputs by one bf16 ulp, hence
    tests/test_torch_decoder_attn.py's 2e-2.)
  * Every operand that each kernel feeds to the tensor cores is a bf16
    value in the plain chain (x == bf16(x)), so each tensor-core term is
    exact: K4's qin, qs, rnd(p), rnd(out) and the tokens' k and v; K3's up,
    u1g, u2g and the hypernetwork vectors.
  * K3's plain bf16 forward against the interpret-mode Pallas kernel (its
    LayerNorm sums run as selector matmuls, in another order): at least
    99.5% of the outputs within 1e-5 of max |want|, and all within two
    bf16 ulps of it (2 * 2^-8 * max |want|): a flipped rounding of u1g or
    u2g moves an output by about 2^-8 of one of its 32 terms.

The weights are drawn at the scales of tests/test_torch_decoder_attn.py
(0.2) and tests/test_torch_upscaler.py (0.3).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops import decoder_attn as j_da
from dilabhelmholtzoct_tpu.ops.upscaler import upscale_hyper_masks as j_up
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as p_i2t
from dilabhelmholtzoct_tpu_torch.ops import upscaler as p_up

C, I, NH = 256, 128, 8
BF = torch.bfloat16


def _rng(*key):
    return np.random.default_rng([13, *key])


# ----------------------------------------------------------------- K4 ----
def _i2t_arrays(rng, pb, n_tok, m, b=2):
    a = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    return dict(keys=a(b, m, C), pe=a(1, m, C), tok_k=a(b * pb, n_tok, I),
                tok_v=a(b * pb, n_tok, I), wq=a(C, I, k=0.2), bq=a(I, k=0.2),
                wo=a(I, C, k=0.2), bo=a(C, k=0.2), g=1 + a(C, k=0.1),
                bt=a(C, k=0.2))


def _i2t_port_args(x):
    """The plain forward's operands: activations and weights in bf16,
    biases and LayerNorm parameters in f32 (as ``fused_i2t_ln`` casts)."""
    t = lambda v, dt=BF: torch.tensor(v).to(dt)
    f32 = torch.float32
    return (t(x["keys"]), t(x["pe"]), t(x["tok_k"]), t(x["tok_v"]), t(x["wq"]),
            t(x["bq"], f32), t(x["wo"]), t(x["bo"], f32), t(x["g"], f32),
            t(x["bt"], f32))


def _jax_row_math(x, pb, eps=1e-6):
    """y of the JAX package's ``_chain``, per pair, on the operands that
    ``fused_i2t_ln`` hands to ``pallas_call`` and ``_fwd_kernel`` derives
    from them -- evaluated with jnp, no Pallas kernel."""
    bf = jnp.bfloat16
    keys, pe = jnp.asarray(x["keys"], bf), jnp.asarray(x["pe"], bf)
    tok_k, tok_v = jnp.asarray(x["tok_k"], bf), jnp.asarray(x["tok_v"], bf)
    n_tok = tok_k.shape[1]
    padt = ((0, 0), (0, j_da.T_PAD - n_tok), (0, 0))
    tok_kt = jnp.swapaxes(jnp.pad(tok_k, padt), 1, 2)
    tok_vp = jnp.pad(tok_v, padt)
    wq, wo = jnp.asarray(x["wq"], bf), jnp.asarray(x["wo"], bf)
    row = lambda v: jnp.asarray(v, jnp.float32)[None]
    bq, bo, g, bt = (row(x[k]) for k in ("bq", "bo", "g", "bt"))
    kmask, vmask, pad, sel, sel_t = j_da._consts(I, NH, n_tok)
    kd, vd = jax.vmap(lambda kt, v: j_da._token_mats(kt, v, kmask, vmask,
                                                     bf))(tok_kt, tok_vp)
    chain = functools.partial(j_da._chain, nh=NH, eps=eps)
    y = jax.vmap(lambda k, kd_, vd_: chain(k, pe[0], kd_, vd_, pad, sel,
                                           sel_t, wq, bq, wo, bo, g,
                                           bt)[-1])(
        jnp.repeat(keys, pb, axis=0), kd, vd)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("pb,n_tok,m", [(1, 5, 37), (1, 7, 64), (1, 8, 100),
                                        (3, 5, 64), (3, 7, 100), (3, 8, 37),
                                        (8, 5, 100), (8, 7, 37), (8, 8, 64)])
def test_i2t_plain_bf16_matches_jax_row_math(pb, n_tok, m):
    x = _i2t_arrays(_rng(1, pb, n_tok, m), pb, n_tok, m)
    got = p_i2t.i2t_fwd_plain(*_i2t_port_args(x), nh=NH, pb=pb, eps=1e-6)
    want = _jax_row_math(x, pb)
    assert got.dtype == BF and got.shape == want.shape == (2 * pb, m, C)
    got = got.float().numpy()
    same = float(np.mean(got == want))
    assert same >= 0.995, f"only {same:.5f} of y bit-equal to the JAX _chain"
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2 * 2.0 ** -8, f"max |port - JAX| / max |y| = {err:.3g}"


@pytest.mark.parametrize("pb,n_tok", [(1, 7), (8, 5)])
def test_i2t_tensor_core_operands_are_bf16(pb, n_tok):
    x = _i2t_arrays(_rng(2, pb, n_tok), pb, n_tok, 37)
    qin, qs, k4, v4, _, pr, outb, _, _ = p_i2t._chain(
        *_i2t_port_args(x), nh=NH, pb=pb, eps=1e-6)
    for name, v in (("qin", qin), ("qs", qs), ("tok_k", k4), ("tok_v", v4),
                    ("rnd(p)", pr), ("rnd(out)", outb)):
        assert v.dtype == torch.float32, name
        assert torch.equal(v, v.to(BF).float()), f"{name} is not bf16-exact"


# ----------------------------------------------------------------- K3 ----
def _up_params(rng):
    a = lambda *s, k=0.3: (rng.normal(size=s) * k).astype(np.float32)
    return {"ct1_w": a(C, 2, 2, C // 4), "ct1_b": a(C // 4),
            "ln": {"scale": 1.0 + a(C // 4, k=0.1), "bias": a(C // 4)},
            "ct2_w": a(C // 4, 2, 2, C // 8), "ct2_b": a(C // 8)}


def _up_port_args(up, p, hyper):
    """``upscale_fwd_plain``'s operands from the JAX parameters, cast as
    ``upscale_hyper_masks`` casts them on both sides (weights and
    activations bf16; biases and LayerNorm parameters bf16-rounded, then
    f32)."""
    t = lambda v: torch.tensor(v).to(BF)
    f = lambda v: t(v).float()
    return (t(up), t(p["ct1_w"]), f(p["ct1_b"]), f(p["ln"]["scale"]),
            f(p["ln"]["bias"]), t(p["ct2_w"]), f(p["ct2_b"]), t(hyper))


def _up_case(key, bp, m, n_out):
    rng = _rng(3, *key)
    up = rng.normal(size=(bp, m, C)).astype(np.float32)
    hyper = rng.normal(size=(bp, n_out, C // 8)).astype(np.float32)
    return up, _up_params(rng), hyper


@pytest.mark.parametrize("n_out", [1, 4])
@pytest.mark.parametrize("m", [37, 64, 100])
def test_upscale_plain_bf16_matches_jax_kernel(m, n_out):
    bp = 3
    up, p, hyper = _up_case((m, n_out), bp, m, n_out)
    jp = jax.tree.map(lambda v: jnp.asarray(v).astype(jnp.bfloat16), p)
    want = np.asarray(j_up(jnp.asarray(up).astype(jnp.bfloat16), jp,
                           jnp.asarray(hyper).astype(jnp.bfloat16),
                           interpret=True))
    got = p_up.upscale_fwd_plain(*_up_port_args(up, p, hyper))
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        bp, m, n_out * 16)
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want)
    close = float(np.mean(err <= 1e-5 * scale))
    assert close >= 0.995, f"only {close:.5f} within 1e-5 of max |want|"
    assert err.max() <= 2 * 2.0 ** -8 * scale, (
        f"max |port - JAX| / max |want| = {err.max() / scale:.3g}")


@pytest.mark.parametrize("n_out", [1, 4])
def test_upscale_tensor_core_operands_are_bf16(n_out):
    up, p, hyper = _up_case((0, n_out), 2, 37, n_out)
    args = _up_port_args(up, p, hyper)
    *_, u1g, _, u2g = p_up._chain(*args[:7], 1e-6)
    for name, v in (("up", args[0].float()), ("u1g", u1g), ("u2g", u2g),
                    ("hyper", args[7].float())):
        assert v.dtype == torch.float32, name
        assert torch.equal(v, v.to(BF).float()), f"{name} is not bf16-exact"
