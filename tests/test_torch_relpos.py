"""Port's any-head-dim attention (K6's plain version, which CPU tensors
take) vs the JAX package's ``flash_attention_relpos`` (the Pallas kernel in
interpret mode, the way tests/test_attention.py runs it on the CPU), and the
encoders that reach it (head_dim 80, and the test-size model's 16) vs the
JAX encoder under ``set_flash_attention('interpret')``.

Tolerances: f32 atol 2e-5, rtol 1e-4 — tests/test_attention.py's own for the
same kernel; bf16 two bf16 ulps of the output scale, 2 * 2^-8 * max |out|
(about 2.5e-3 for these inputs), and at one key block — where the kernel's
running maximum is the row maximum — at least 99% of the outputs bit-equal;
encoder 1e-4, the tolerance of tests/test_torch_sam.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu.ops.attention import flash_attention_relpos
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.models.convert import params_from_jax
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn

ATOL, RTOL = 2e-5, 1e-4
BF16_ULP = 2.0 ** -8


def _inputs(rng, b, nh, d, hw):
    n = hw[0] * hw[1]
    return ((rng.normal(size=(b, n, 3 * nh * d)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, nh, n, hw[0])) * 0.3).astype(np.float32),
            (rng.normal(size=(b, nh, n, hw[1])) * 0.3).astype(np.float32))


def _jax_relpos(qkv, rel_h, rel_w, hw, nh, dtype):
    """The JAX route of ``models/sam.py::vision_attention``: head-major
    (B * heads, N, d) copies in, the kernel, token order out."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // nh
    x = qkv.reshape(b, n, 3, nh, d).transpose(2, 0, 3, 1, 4).reshape(
        3, b * nh, n, d)
    out = flash_attention_relpos(
        *(jnp.asarray(a, dtype=dtype) for a in (
            x[0], x[1], x[2], rel_h.reshape(b * nh, n, hw[0]),
            rel_w.reshape(b * nh, n, hw[1]))), hw=hw, interpret=True)
    out = np.asarray(out.astype(jnp.float32))
    return out.reshape(b, nh, n, d).transpose(0, 2, 1, 3).reshape(b, n, nh * d)


def _port(arrays, hw, nh, dtype=torch.float32):
    return port_attn.flash_attention_packed(
        *(torch.tensor(a, dtype=dtype) for a in arrays), hw=hw, num_heads=nh)


@pytest.mark.parametrize("hw", [(8, 8), (8, 16), (14, 14)])
@pytest.mark.parametrize("d", [32, 80])
def test_relpos_attention_matches_jax_interpret(rng, d, hw):
    arrays = _inputs(rng, 2, 2, d, hw)
    want = _jax_relpos(*arrays, hw, 2, jnp.float32)
    got = _port(arrays, hw, 2)
    assert got.shape == (2, hw[0] * hw[1], 2 * d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def _wrong_rounding(qkv, rel_h, rel_w, hw, nh, kind):
    """Rounding points of the packed kernels, which K6 must not take: "fold"
    scales q before the product (rounding it to qkv's dtype; K1 / K2 / K7
    fold 1/8, exact at head dim 64 but not at 80), "norm" divides p by the
    denominator before rounding it (K2 / K7, the windowed routes; K1, the
    global route, rounds the un-normalised p as K6 does)."""
    dt = qkv.dtype
    b, n, _ = qkv.shape
    q, k, v = port_attn._split_heads(qkv, nh)
    bias = (rel_h.float().reshape(b, nh, n, hw[0], 1)
            + rel_w.float().reshape(b, nh, n, 1, hw[1])).reshape(b, nh, n, n)
    scale = q.shape[-1] ** -0.5
    if kind == "fold":
        s = torch.matmul((q * scale).to(dt).float(), k.transpose(-1, -2))
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = (s + bias - (s + bias).amax(-1, keepdim=True)).exp()
    denom = p.sum(-1, keepdim=True)
    if kind == "norm":
        out = torch.matmul((p / denom).to(dt).float(), v)
    else:
        out = torch.matmul(p.to(dt).float(), v) / denom
    return port_attn._merge_heads(out).to(dt)


@pytest.mark.parametrize("hw", [(8, 8), (14, 14)])
@pytest.mark.parametrize("d", [32, 80])
def test_relpos_attention_bf16_rounding_points(rng, d, hw):
    """bf16, one key block: the port rounds where the TPU kernel rounds, so
    nearly every output is bit-equal; with the scale folded into a bf16 q, or
    p normalised before its rounding, about half of them are not."""
    arrays = _inputs(rng, 2, 2, d, hw)
    want = _jax_relpos(*arrays, hw, 2, jnp.bfloat16)
    got = _port(arrays, hw, 2, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * BF16_ULP * np.abs(want).max())
    assert (got == want).mean() >= 0.99
    tensors = [torch.tensor(a, dtype=torch.bfloat16) for a in arrays]
    for kind in ("fold", "norm"):
        wrong = _wrong_rounding(*tensors, hw, 2, kind).float().numpy()
        assert (wrong == want).mean() < 0.9, kind


def test_relpos_route_is_plain_on_cpu_and_launches_nothing(rng):
    """CPU tensors off the packed route (head_dim != 64, or an odd head
    count) take ``relpos_attention_plain``; head_dim 64 with an even count
    stays on ``packed_attention_plain``."""
    port_attn.reset_launch_counts()
    for nh, d, plain in ((2, 80, port_attn.relpos_attention_plain),
                         (3, 64, port_attn.relpos_attention_plain),
                         (2, 64, port_attn.packed_attention_plain)):
        tensors = [torch.tensor(a) for a in _inputs(rng, 1, nh, d, (4, 4))]
        got = port_attn.flash_attention_packed(*tensors, hw=(4, 4),
                                               num_heads=nh)
        assert torch.equal(got, plain(*tensors, hw=(4, 4), num_heads=nh))
    assert not any(port_attn.LAUNCHES.values()), port_attn.LAUNCHES


def _cfg_d80(window_size, m):
    """3 layers of 2 heads of 80, one global layer, an 8x8 grid."""
    return m.SamConfig(
        vision=m.VisionConfig(
            hidden_size=160, num_layers=3, num_heads=2, image_size=128,
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


@pytest.mark.parametrize("case", ["d80_window4", "d80_window3_padded",
                                  "sam_tiny"])
def test_encoder_off_the_packed_route_matches_jax(rng, case):
    """``encode_image`` of models whose attention is K6 (head_dim 80 with
    windows of 4, and of 3 — 8 → 9 padded, the pad-token case —, and the
    test-size model's head_dim 16) against the JAX encoder with its Pallas
    kernel in interpret mode."""
    if case == "sam_tiny":
        cfg_j, cfg_p = jconfigs.sam_tiny(128), pconfigs.sam_tiny(128)
    else:
        ws = 4 if case == "d80_window4" else 3
        cfg_j, cfg_p = _cfg_d80(ws, jconfigs), _cfg_d80(ws, pconfigs)
    tree = _params(cfg_j)
    pix = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    jsam.set_flash_attention("interpret")
    try:
        want = jsam.encode_image(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(pix), cfg_j)
    finally:
        jsam.set_flash_attention("auto")
    psam.set_flash_attention("interpret")  # K6's twin below 196 tokens
    try:
        got = psam.encode_image(params_from_jax(tree), torch.tensor(pix),
                                cfg_p)
    finally:
        psam.set_flash_attention("auto")
    assert got.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _items(n, seed, hw=(48, 64)):
    """{'image', 'label'} items: random uint8 images, three box labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = np.zeros(hw, np.uint8)
        for c in range(1, 4):
            y, x = int(rng.integers(2, 30)), int(rng.integers(2, 44))
            lab[y:y + 14, x:x + 18] = c
        out.append({"image": rng.integers(0, 255, (*hw, 3), dtype=np.uint8),
                    "label": lab})
    return out


def test_bf16_precompute_vith_shaped_matches_jax(rng, monkeypatch):
    """The bf16 embedding precompute of a ViT-H-shaped cut (2 layers, one
    windowed and one global, heads of 80) goes through K6's plain version
    once per layer and image, and agrees with the JAX package's precompute
    at the same dtype, its Pallas kernel in interpret mode: within 4 bf16
    ulps of the output scale (4 * 2^-8 * max |out|), and on average within
    half of one. The two frameworks sum the f32 products of the linears in
    another order, so a bf16 rounding may flip in each layer and in the
    neck: about 70% of the outputs differ by an ulp of their own."""
    from dilabhelmholtzoct_tpu.data.pipeline import PromptedDataset as JDS
    from dilabhelmholtzoct_tpu.train import trainer as jtr
    from dilabhelmholtzoct_tpu_torch.data.pipeline import PromptedDataset
    from dilabhelmholtzoct_tpu_torch.train import trainer as ptr

    def cut(m):
        cfg = _cfg_d80(4, m)
        return cfg.__class__(**{**cfg.__dict__, "vision": cfg.vision.__class__(
            **{**cfg.vision.__dict__, "num_layers": 2,
               "global_attn_indexes": (1,)})})

    cfg_j, cfg_p = cut(jconfigs), cut(pconfigs)
    assert cfg_p.vision.hidden_size // cfg_p.vision.num_heads == 80
    tree = _params(cfg_j, seed=3)
    items = _items(3, 5)
    jsam.set_flash_attention("interpret")
    try:
        want = np.asarray(jtr.precompute_embeddings(
            jax.tree.map(jnp.asarray, tree), cfg_j, JDS(items, seed=3),
            batch_size=2, dtype=jnp.bfloat16, verbose=False).astype(
                jnp.float32))
    finally:
        jsam.set_flash_attention("auto")
    calls = []
    plain = port_attn.relpos_attention_plain

    def counted(*a, **kw):
        calls.append(kw["hw"])
        return plain(*a, **kw)

    monkeypatch.setattr(port_attn, "relpos_attention_plain", counted)
    port_attn.reset_launch_counts()
    psam.set_flash_attention("interpret")  # K6's twin below 196 tokens
    try:
        got = ptr.precompute_embeddings(
            params_from_jax(tree), cfg_p, PromptedDataset(items, seed=3),
            batch_size=2, dtype=torch.bfloat16, verbose=False)
    finally:
        psam.set_flash_attention("auto")
    assert not any(port_attn.LAUNCHES.values()), port_attn.LAUNCHES
    assert sorted(set(calls)) == [(4, 4), (8, 8)]
    assert len(calls) == 2 * len(items)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    ulp = BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    assert np.abs(got - want).mean() <= 0.5 * ulp


@pytest.mark.parametrize("b,nh,hw", [(2, 2, (20, 15)),   # 300 tokens
                                     (1, 2, (30, 34)),   # W != 64
                                     (1, 2, (64, 64))])  # ViT's global grid
def test_packed_bf16_global_equals_relpos_plain_bitwise(rng, b, nh, hw):
    """At head dim 64 in bf16, past WINDOW_MAX_TOKENS, where the JAX route
    takes ``_packed_kernel`` (``normalised_rounding`` false), the packed
    route's plain version (K1's: q times 1/8 before the product) gives the
    same bits as K6's (the score times 1/8 after it): the scale is a power
    of two, and both round the un-normalised p and divide last. This is
    why the bf16 K1 runs on K6's kernel (``attention_fwd_cuda``). Where it
    takes the grouped-window kernel (300 tokens at an even b), the packed
    plain version is K6's arithmetic with p / l rounded instead, the same
    bits as K6's score with that rounding point."""
    arrays = _inputs(rng, b, nh, 64, hw)
    args = [torch.tensor(a, dtype=torch.bfloat16) for a in arrays]
    assert hw[0] * hw[1] > port_attn.WINDOW_MAX_TOKENS
    packed = port_attn.packed_attention_plain(*args, hw=hw, num_heads=nh)
    relpos = port_attn.relpos_attention_plain(*args, hw=hw, num_heads=nh)
    assert packed.dtype == relpos.dtype == torch.bfloat16
    if port_attn.normalised_rounding(b, hw[0] * hw[1]):
        assert torch.equal(packed, _wrong_rounding(*args, hw, nh, "norm"))
        assert not torch.equal(packed, relpos)
    else:
        assert torch.equal(packed, relpos)


@pytest.mark.parametrize("b,nh,hw", [(3, 2, (20, 15)),   # 300 tokens, odd b
                                     (1, 2, (30, 34)),   # W != 64
                                     (1, 2, (64, 64))])  # ViT's global grid
def test_packed_f32_global_equals_relpos_plain_bitwise(rng, b, nh, hw):
    """At head dim 64 in f32, where the JAX route takes ``_packed_kernel``
    (``normalised_rounding`` false), the packed route's plain version (K1's:
    q times 1/8 before the product) gives the same bits as K6's (the score
    times 1/8 after it), the output and the logsumexp rows: the scale is a
    power of two, and both divide last. This is why the f32 K1 runs on the
    f32 K6's kernel with its LSE rows (``attention_fwd_cuda``)."""
    arrays = _inputs(rng, b, nh, 64, hw)
    args = [torch.tensor(a) for a in arrays]
    n = hw[0] * hw[1]
    assert n > port_attn.WINDOW_MAX_TOKENS
    assert not port_attn.normalised_rounding(b, n)
    packed, lse_p = port_attn.packed_attention_plain(
        *args, hw=hw, num_heads=nh, return_lse=True)
    relpos, lse_r = port_attn.relpos_attention_plain(
        *args, hw=hw, num_heads=nh, return_lse=True)
    assert packed.dtype == relpos.dtype == torch.float32
    assert lse_p.shape == lse_r.shape == (b, nh, n)
    assert torch.equal(packed, relpos)
    assert torch.equal(lse_p, lse_r)
