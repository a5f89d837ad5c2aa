"""Port's packed attention (K1 / K2 and their plain version) vs the JAX
package's ``flash_attention_packed`` (Pallas kernels in interpret mode, the
way tests/test_attention.py runs them on the CPU) and ``attention_reference``.

Tolerance, f32: atol 2e-5, rtol 1e-4 — tests/test_attention.py's own for the
same function; the two differ only in summation order. bf16 rounding points:
two bf16 ulps of the output scale, 2 * 2^-8 * max |out|, and at least 99% of
the outputs bit-equal to the interpret-mode Pallas kernel at shapes where it
takes one key block (its running maximum is then the row maximum); each of
the other rounding points reaches less than 90%."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dilabhelmholtzoct_tpu.ops.attention import (
    _window_group,
    attention_reference,
    flash_attention_packed as jax_packed,
)
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn

ATOL, RTOL = 2e-5, 1e-4
BF16_ULP = 2.0 ** -8


def _inputs(rng, b, nh, hw, scale=1.0):
    h, w = hw
    n, c = h * w, nh * 64
    qkv = (rng.normal(size=(b, n, 3 * c)) * scale).astype(np.float32)
    rel_h = (rng.normal(size=(b, nh, n, h)) * 0.3).astype(np.float32)
    rel_w = (rng.normal(size=(b, nh, n, w)) * 0.3).astype(np.float32)
    return qkv, rel_h, rel_w


def _port(qkv, rel_h, rel_w, hw, nh, dtype=torch.float32):
    return port_attn.flash_attention_packed(
        torch.tensor(qkv, dtype=dtype), torch.tensor(rel_h, dtype=dtype),
        torch.tensor(rel_w, dtype=dtype), hw=hw, num_heads=nh)


@pytest.mark.parametrize(
    "b,nh,hw",
    [(2, 2, (8, 8)),      # global shape (K1's branch on the card)
     (1, 4, (8, 16)),     # non-square global grid
     (5, 2, (14, 14)),    # 14x14 windows, JAX grouped-window kernel
     (3, 2, (14, 14))],   # 14x14 windows, JAX single-window grid
)
def test_packed_attention_matches_jax_interpret(rng, b, nh, hw):
    qkv, rel_h, rel_w = _inputs(rng, b, nh, hw, scale=0.5)
    want = jax_packed(jnp.asarray(qkv), jnp.asarray(rel_h),
                      jnp.asarray(rel_w), hw=hw, num_heads=nh, interpret=True)
    got = _port(qkv, rel_h, rel_w, hw, nh)
    assert got.shape == (b, hw[0] * hw[1], nh * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("b,nh,hw", [(2, 2, (8, 8)), (3, 2, (14, 14))])
def test_packed_attention_matches_reference(rng, b, nh, hw):
    qkv, rel_h, rel_w = _inputs(rng, b, nh, hw)
    h, w = hw
    n, d = h * w, 64
    split = qkv.reshape(b, n, 3, nh, d)
    q, k, v = (split[:, :, i].transpose(0, 2, 1, 3).reshape(b * nh, n, d)
               for i in range(3))
    want = attention_reference(
        *map(jnp.asarray, (q, k, v, rel_h.reshape(b * nh, n, h),
                           rel_w.reshape(b * nh, n, w))), hw=hw)
    want = (np.asarray(want).reshape(b, nh, n, d).transpose(0, 2, 1, 3)
            .reshape(b, n, nh * d))
    got = _port(qkv, rel_h, rel_w, hw, nh)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_is_plain_and_launches_nothing(rng):
    qkv, rel_h, rel_w = _inputs(rng, 2, 2, (8, 8))
    port_attn.reset_launch_counts()
    got = _port(qkv, rel_h, rel_w, (8, 8), 2)
    want = port_attn.packed_attention_plain(
        torch.tensor(qkv), torch.tensor(rel_h), torch.tensor(rel_w),
        hw=(8, 8), num_heads=2)
    assert torch.equal(got, want)
    assert not any(port_attn.LAUNCHES.values()), port_attn.LAUNCHES


def test_plain_bf16_keeps_dtype_and_f32_math(rng):
    """bf16 in, bf16 out, f32 softmax inside: within bf16 rounding (2^-8
    relative, atol 2e-2 at these magnitudes) of the f32 result on the same
    rounded inputs."""
    qkv, rel_h, rel_w = _inputs(rng, 2, 2, (14, 14), scale=0.5)
    got = _port(qkv, rel_h, rel_w, (14, 14), 2, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rounded = [torch.tensor(a, dtype=torch.bfloat16).float()
               for a in (qkv, rel_h, rel_w)]
    want = port_attn.packed_attention_plain(*rounded, hw=(14, 14), num_heads=2)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=1e-2)


def _rounded_at(qkv, rel_h, rel_w, hw, nh, point):
    """The plain attention with p rounded to bf16 at another point: "f32"
    never ("attention_reference"'s f32 softmax), "unnorm" the un-normalised
    p with the division last (the global route's), "norm" p / l (the
    windowed routes')."""
    _, _, v, s = port_attn._scores(qkv, rel_h, rel_w, hw, nh)
    p = (s - s.amax(-1, keepdim=True)).exp()
    denom = p.sum(-1, keepdim=True)
    if point == "f32":
        out = torch.matmul(p / denom, v)
    elif point == "unnorm":
        out = torch.matmul(p.to(torch.bfloat16).float(), v) / denom
    else:
        out = torch.matmul((p / denom).to(torch.bfloat16).float(), v)
    return port_attn._merge_heads(out).to(torch.bfloat16)


@pytest.mark.parametrize("b,hw,point,wrong", [
    (1, (32, 32), "unnorm", ("f32", "norm")),  # global: _packed_kernel
    (25, (14, 14), "norm", ("f32", "unnorm")),  # 25 windows: grouped kernel
    # one block, but no window group (b has no factor 2 or 5): _packed_kernel
    (1, (14, 14), "unnorm", ("f32", "norm")),
    (3, (9, 7), "unnorm", ("f32", "norm")),
    # past 256 tokens, one block of N <= 512 and an even b: grouped kernel
    (2, (20, 15), "norm", ("f32", "unnorm")),
    (4, (16, 32), "norm", ("f32", "unnorm")),
])
def test_plain_bf16_rounding_points(rng, b, hw, point, wrong):
    """bf16: the plain version rounds p where the TPU kernel of the JAX
    route rounds it (``_packed_kernel``: un-normalised, divided last;
    ``_windowed_group_kernel``, taken for one block of N <= 512 and a b
    divisible by 2 or 5: normalised), so nearly every output is bit-equal
    to the interpret-mode Pallas kernel; the f32 softmax or the other
    kernel's point are not."""
    qkv, rel_h, rel_w = _inputs(rng, b, 2, hw, scale=0.5)
    want = jax_packed(*(jnp.asarray(a, dtype=jnp.bfloat16)
                        for a in (qkv, rel_h, rel_w)),
                      hw=hw, num_heads=2, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = _port(qkv, rel_h, rel_w, hw, 2, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * BF16_ULP * np.abs(want).max())
    assert (got == want).mean() >= 0.99
    tensors = [torch.tensor(a, dtype=torch.bfloat16)
               for a in (qkv, rel_h, rel_w)]
    assert torch.equal(_rounded_at(*tensors, hw, 2, point),
                       torch.tensor(got, dtype=torch.bfloat16))
    for other in wrong:
        bad = _rounded_at(*tensors, hw, 2, other).float().numpy()
        assert (bad == want).mean() < 0.9, other


def test_normalised_rounding_is_the_jax_route():
    """``normalised_rounding`` is the JAX package's condition for its
    grouped-window kernel at the default tiles: one query block and one key
    block (N <= 512) and ``_window_group(b) > 1``."""
    for b in range(1, 31):
        for n in (63, 196, 256, 300, 512, 513, 4096):
            want = n <= 512 and _window_group(b) > 1
            assert port_attn.normalised_rounding(b, n) == want, (b, n)


def test_wrapper_rejects_bad_shapes(rng):
    qkv, rel_h, rel_w = _inputs(rng, 1, 2, (8, 8))
    with pytest.raises(ValueError):
        port_attn.flash_attention_packed(
            torch.tensor(qkv), torch.tensor(rel_h), torch.tensor(rel_w),
            hw=(4, 8), num_heads=2)
    with pytest.raises(ValueError):
        port_attn.flash_attention_packed(
            torch.tensor(qkv), torch.tensor(rel_w), torch.tensor(rel_h[..., :4]),
            hw=(8, 8), num_heads=2)
