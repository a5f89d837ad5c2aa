"""The bf16 K3 / K4 backwards as two launches (the row pass and the weight
pass) through their plain twins, on the CPU, at the kernels' widths (C =
256, I = 128) with a few pairs and a ragged m:

  * the two twins compose to the fused backward of the previous design
    (copied below as the reference; f32 summation order apart);
  * through the port's autograd Functions they match the JAX package's
    Pallas kernels run in interpret mode (the tolerances of
    tests/test_torch_decoder_attn.py and tests/test_torch_upscaler.py);
  * every scratch row that the weight pass multiplies on the tensor cores
    is already a bf16 value (x == bf16(x)): writing it as bf16 loses
    nothing, so each tensor-core term is exact;
  * the weight pass summed over the kernel's row chunks, in their order,
    agrees with one f32 matmul within 1e-5 of max |dW|.

tests/test_torch_kernels_gpu.py holds the CUDA launches to these twins on
the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops.decoder_attn import fused_i2t_ln as j_i2t
from dilabhelmholtzoct_tpu.ops.upscaler import upscale_hyper_masks as j_up
from dilabhelmholtzoct_tpu_torch import kernels
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as p_i2t
from dilabhelmholtzoct_tpu_torch.ops import upscaler as p_up

C, I, NH = 256, 128, 8
SMS = 132  # an H100's SMs: the weight passes' chunk counts on the card
K4_PARTS, K3_PARTS = SMS // 2, SMS // 3


def _rng(*key):
    return np.random.default_rng([11, *key])


def _t(x, dtype=torch.float32):
    return torch.tensor(x).to(dtype)


# ----------------------------------------------------------------- K4 ----
def _i2t_case(rng, pb, n_tok, m, dtype=torch.float32, b=2):
    a = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    args = (_t(a(b, m, C), dtype), _t(a(1, m, C), dtype),
            _t(a(b * pb, n_tok, I), dtype), _t(a(b * pb, n_tok, I), dtype),
            _t(a(C, I, k=0.2), dtype), _t(a(I, k=0.2)),
            _t(a(I, C, k=0.2), dtype), _t(a(C, k=0.2)),
            _t(1 + a(C, k=0.1)), _t(a(C, k=0.2)))
    dy = _t(a(b * pb, m, C), dtype)
    return args, dy, dict(nh=NH, pb=pb, eps=1e-6)


def _i2t_fused_reference(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy,
                         *, nh, pb, eps):
    """The single fused backward's plain version of the previous design."""
    _rnd, dtype = p_i2t._rnd, keys.dtype
    bp, n_tok, internal = tok_k.shape
    m, c = keys.shape[1:]
    hd = internal // nh
    qin, qs, k4, v4, p, pr, outb, rstd, yn = p_i2t._chain(
        keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh=nh, pb=pb, eps=eps)
    dy32 = dy.float()
    dg, dbt = (dy32 * yn).sum((0, 1)), dy32.sum((0, 1))
    dyn = dy32 * g
    dres = rstd * (dyn - dyn.mean(-1, keepdim=True)
                   - yn * (dyn * yn).mean(-1, keepdim=True))
    dres_b = _rnd(dres, dtype)
    dwo = outb.reshape(-1, internal).T @ dres_b.reshape(-1, c)
    dout_b = _rnd(dres_b @ wo.float().T, dtype)
    dp = torch.einsum("bmhd,bthd->bmht", dout_b.reshape(bp, m, nh, hd), v4)
    pdp = p * dp
    ds_b = _rnd(pdp - p * pdp.sum(-1, keepdim=True), dtype)
    dqb = torch.einsum("bmht,bthd->bmhd", ds_b, k4).reshape(bp, m, -1) * (
        hd ** -0.5)
    dqpre_b = _rnd(dqb, dtype)
    qin_p = qin.repeat_interleave(pb, 0) if pb > 1 else qin
    dwq = qin_p.reshape(-1, c).T @ dqpre_b.reshape(-1, internal)
    dkeys = (dres_b + dqpre_b @ wq.float().T).to(dtype)
    pad = p_i2t._pad_tokens
    return (dkeys, dqpre_b.to(dtype), pad(pr, bp, m, nh).to(dtype),
            pad(ds_b, bp, m, nh).to(dtype), dout_b.to(dtype), dwq,
            dqb.sum((0, 1)), dwo, dres.sum((0, 1)), dg, dbt)


def _assert_close(got, want, rtol, what):
    """max |got - want| <= rtol * max |want|."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} * {scale:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tok", [5, 8])
@pytest.mark.parametrize("pb", [1, 8])
def test_i2t_twins_compose_to_fused_backward(pb, n_tok, dtype):
    args, dy, kw = _i2t_case(_rng(1, pb, n_tok), pb, n_tok, 37, dtype)
    got = p_i2t.i2t_bwd_plain(*args, dy, **kw)
    want = _i2t_fused_reference(*args, dy, **kw)
    names = ("d_keys", "d_qpre", "p", "d_score", "d_out", "dWq", "dbq",
             "dWo", "dbo", "dg", "dbt")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        # identical roundings; the weight products summed in another order
        _assert_close(a, b, 1e-5, name)


@pytest.mark.parametrize("n_tok", [5, 8])
@pytest.mark.parametrize("pb", [1, 8])
def test_i2t_gradients_match_jax_kernel(pb, n_tok):
    """Autograd through the port's Function (the composed twins and the
    outside einsums) against jax.grad of the interpret-mode Pallas K4,
    f32, atol = rtol = 2e-3 (tests/test_torch_decoder_attn.py's)."""
    rng = _rng(2, pb, n_tok)
    b, m = 8 // pb, 64
    a = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    arrays = (a(b, m, C), a(1, m, C), a(b * pb, n_tok, I),
              a(b * pb, n_tok, I))
    q_p = {"w": a(C, I, k=0.2), "b": a(I, k=0.2)}
    out_p = {"w": a(I, C, k=0.2), "b": a(C, k=0.2)}
    ln_p = {"scale": 1.0 + a(C, k=0.1), "bias": a(C, k=0.2)}
    ct = a(b * pb, m, C)

    def loss(keys, pe, tk, tv, q_, o_, l_):
        return jnp.sum(j_i2t(keys, pe, tk, tv, q_, o_, l_, nh=NH, pb=pb,
                             interpret=True) * ct)

    jg = jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(x) for x in arrays),
        *jax.tree.map(jnp.asarray, (q_p, out_p, ln_p)))
    ts = [torch.tensor(x, requires_grad=True) for x in
          (*arrays, q_p["w"], q_p["b"], out_p["w"], out_p["b"],
           ln_p["scale"], ln_p["bias"])]
    out = p_i2t._FusedI2T.apply(*ts, NH, pb, 1e-6)
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(), ts)
    want = [*jg[:4], jg[4]["w"], jg[4]["b"], jg[5]["w"], jg[5]["b"],
            jg[6]["scale"], jg[6]["bias"]]
    for i, (x, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=2e-3,
                                   rtol=2e-3, err_msg=str(i))


def _bf16_exact(x):
    x = x.float()
    return bool(torch.equal(x, x.bfloat16().float()))


@pytest.mark.parametrize("n_tok", [5, 8])
@pytest.mark.parametrize("pb", [1, 8])
def test_i2t_scratch_rows_are_bf16_exact(pb, n_tok):
    """The weight pass's operands at their f32 values in the bf16 chain:
    rnd(out), rnd(d_res), rnd(d_qpre) and rnd(keys + pe)."""
    args, dy, kw = _i2t_case(_rng(3, pb, n_tok), pb, n_tok, 37,
                             torch.bfloat16)
    rows, _ = p_i2t._bwd_rows(*args, dy, **kw)
    _, dqpre, _, _, _, out_rows, dres_rows = rows
    for name, x in (("d_qpre", dqpre), ("rnd(out)", out_rows),
                    ("rnd(d_res)", dres_rows),
                    ("rnd(keys + pe)", (args[0] + args[1]).float())):
        assert x.dtype == torch.float32 and _bf16_exact(x), name
        assert float(x.abs().max()) > 0, name


@pytest.mark.parametrize("pb,m", [(1, 37), (8, 100)])
def test_i2t_weight_pass_chunks_match_one_matmul(pb, m):
    args, dy, kw = _i2t_case(_rng(4, pb), pb, 7, m, torch.bfloat16)
    rows = p_i2t.i2t_bwd_rows_plain(*args, dy, **kw)
    scratch = (args[0], args[1], rows[1], rows[5], rows[6])
    n = rows[1].shape[0] * m
    assert len(kernels.row_chunks(n, K4_PARTS, p_i2t.DW_ROWS)) > 1
    chunked = p_i2t.i2t_bwd_dw_plain(*scratch, pb=pb,
                                     parts=(K4_PARTS, K4_PARTS))
    whole = p_i2t.i2t_bwd_dw_plain(*scratch, pb=pb)
    for name, a, b in zip(("dWq", "dWo"), chunked, whole):
        _assert_close(a, b, 1e-5, name)


# ----------------------------------------------------------------- K3 ----
def _up_case(rng, n_out, m, dtype=torch.float32, bp=3):
    a = lambda *s, k=0.3: (rng.normal(size=s) * k).astype(np.float32)
    args = (_t(a(bp, m, C, k=1.0), dtype), _t(a(C, 2, 2, C // 4), dtype),
            _t(a(C // 4)), _t(1 + a(C // 4, k=0.1)), _t(a(C // 4)),
            _t(a(C // 4, 2, 2, C // 8), dtype), _t(a(C // 8)),
            _t(a(bp, n_out, C // 8, k=1.0), dtype))
    dm = _t(a(bp, m, n_out * 16, k=1.0))
    return args, dm


def _up_fused_reference(up, dm, w1, b1, g, bt, w2, b2, hyper, eps=1e-6):
    """The single fused backward's plain version of the previous design."""
    dtype, approx = up.dtype, up.dtype == torch.bfloat16
    _rnd, _gg = p_up._rnd, p_up._gelu_grad
    bp, m, c = up.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    n_out = hyper.shape[1]
    xc, rstd, y, out1, u1g, u2pre_r, u2g = p_up._chain(up, w1, b1, g, bt, w2,
                                                       b2, eps)
    dm5 = dm.float().reshape(bp, m, n_out, 4, 4)
    hyp = hyper.float()
    d_u2g = torch.einsum("bmtpq,btc->bmpqc", dm5, hyp).reshape(bp, m, 4, -1)
    d_ht = torch.einsum("bmtpq,bmpqc->btpqc", dm5,
                        u2g.reshape(bp, m, 4, 4, c2)).reshape(bp, n_out, -1)
    d_u2pre = d_u2g * _gg(u2pre_r, approx)
    d_u2pre_l = _rnd(d_u2pre, dtype)
    d_u1g = torch.einsum("bmsq,cq->bmsc", d_u2pre_l,
                         w2.float().reshape(c1, 4 * c2))
    d_out1 = d_u1g * _gg(_rnd(out1, dtype), approx)
    dg = (d_out1 * y).sum((0, 1)).reshape(-1)
    dbt = d_out1.sum((0, 1)).reshape(-1)
    d_y = d_out1 * g
    yn = xc * rstd
    d_u1pre = rstd * (d_y - d_y.sum(-1, keepdim=True) / c1
                      - yn * (d_y * yn).sum(-1, keepdim=True) / c1)
    d_u1pre_l = _rnd(d_u1pre, dtype).reshape(bp, m, 4 * c1)
    d_up = (d_u1pre_l @ w1.float().reshape(c, 4 * c1).T).to(dtype)
    dw1 = up.float().reshape(-1, c).T @ d_u1pre_l.reshape(-1, 4 * c1)
    dw2 = torch.einsum("bmsc,bmsq->scq", u1g, d_u2pre_l)
    return (d_up, dw1, dw2, d_u1pre.sum((0, 1)).reshape(-1), dg, dbt,
            d_u2pre.sum((0, 1)).reshape(-1), d_ht)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_out", [1, 3, 4])
def test_upscale_twins_compose_to_fused_backward(n_out, dtype):
    args, dm = _up_case(_rng(5, n_out), n_out, 37, dtype)
    got = p_up.upscale_bwd_plain(args[0], dm, *args[1:])
    want = _up_fused_reference(args[0], dm, *args[1:])
    names = ("d_up", "dW1", "dW2", "db1", "dg", "dbt", "db2", "d_hyper")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _assert_close(a, b, 1e-5, name)


@pytest.mark.parametrize("n_out", [1, 4])
def test_upscale_gradients_match_jax_kernel(n_out):
    """Autograd through the port's Function against jax.grad of the
    interpret-mode Pallas K3, f32, atol = rtol = 5e-4
    (tests/test_torch_upscaler.py's)."""
    rng = _rng(6, n_out)
    bp, m = 2, 64
    a = lambda *s, k=0.3: (rng.normal(size=s) * k).astype(np.float32)
    up, hyper = a(bp, m, C, k=1.0), a(bp, n_out, C // 8, k=1.0)
    p = {"ct1_w": a(C, 2, 2, C // 4), "ct1_b": a(C // 4),
         "ln": {"scale": 1.0 + a(C // 4, k=0.1), "bias": a(C // 4)},
         "ct2_w": a(C // 4, 2, 2, C // 8), "ct2_b": a(C // 8)}
    ct = a(bp, m, n_out * 16, k=1.0)

    def loss(up_, p_, hyper_):
        return jnp.sum(j_up(up_, p_, hyper_, interpret=True) * ct)

    g_up, g_p, g_hy = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(up), jax.tree.map(jnp.asarray, p), jnp.asarray(hyper))
    ts = [torch.tensor(x, requires_grad=True) for x in
          (up, p["ct1_w"], p["ct1_b"], p["ln"]["scale"], p["ln"]["bias"],
           p["ct2_w"], p["ct2_b"], hyper)]
    out = p_up._UpscaleHyper.apply(*ts, 1e-6)
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(), ts)
    want = (g_up, g_p["ct1_w"], g_p["ct1_b"], g_p["ln"]["scale"],
            g_p["ln"]["bias"], g_p["ct2_w"], g_p["ct2_b"], g_hy)
    for i, (x, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=str(i))


@pytest.mark.parametrize("n_out", [1, 4])
def test_upscale_scratch_rows_are_bf16_exact(n_out):
    """The weight pass's operands at their f32 values in the bf16 chain:
    u1g, rnd(d_u2pre), rnd(d_u1pre) (and up, an input)."""
    args, dm = _up_case(_rng(7, n_out), n_out, 37, torch.bfloat16)
    rows, _ = p_up._bwd_rows(args[0], dm, *args[1:], 1e-6)
    for name, x in zip(("u1g", "rnd(d_u2pre)", "rnd(d_u1pre)"), rows[1:]):
        assert x.dtype == torch.float32 and _bf16_exact(x), name
        assert float(x.abs().max()) > 0, name


@pytest.mark.parametrize("m", [37, 100])
def test_upscale_weight_pass_chunks_match_one_matmul(m):
    args, dm = _up_case(_rng(8, m), 1, m, torch.bfloat16, bp=5)
    rows = p_up.upscale_bwd_rows_plain(args[0], dm, *args[1:])
    scratch = (args[0],) + rows[1:4]
    assert len(kernels.row_chunks(5 * m, K3_PARTS, p_up.DW_ROWS)) > 1
    chunked = p_up.upscale_bwd_dw_plain(*scratch, parts=K3_PARTS)
    whole = p_up.upscale_bwd_dw_plain(*scratch)
    for name, a, b in zip(("dW1", "dW2"), chunked, whole):
        _assert_close(a, b, 1e-5, name)


@pytest.mark.parametrize("rows,parts", [(262144, 66), (185, 44), (31, 66)])
def test_row_chunks_cover_rows_in_aligned_order(rows, parts):
    chunks = kernels.row_chunks(rows, parts, 32)
    assert 1 <= len(chunks) <= parts
    assert chunks[0][0] == 0 and chunks[-1][1] == rows
    size = chunks[0][1]
    for (lo, hi), (nlo, _) in zip(chunks, chunks[1:]):
        assert hi == nlo and hi - lo == size
    assert size % 32 == 0 or len(chunks) == 1
