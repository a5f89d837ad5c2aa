"""The port's CUDA kernels against their plain PyTorch versions on the same
card tensors: encoder attention K1 (global) and K2 (windowed) with their
logsumexp rows, its backward K5, the any-head-dim forward K6, the
image-layout windowed forward K7, the upscaler K3 and the image->token
attention K4 (their forwards on the tensor cores, bf16 and f32 in split
TF32; the backwards of both as their two launches, the row pass and the
weight pass, each against its plain twin; the kernels on wgmma and TMA --
the bf16 K6 and K1 (K6's kernel with the logsumexp rows), the f32 K6 and
K1 in split TF32 (likewise one kernel), K5's bf16 dq kernel in each of its
modes and its dk/dv kernel, K5's f32 kernels in split TF32, both K4 weight
passes -- on their own plans);
the topological loss's pairing
T1 (on its shared-memory route and, for grids past one block's shared
memory, its global one) and matching T2 against their numpy twins and the
host library; one
request through a small engine on the card; and, card against CPU, prompt
mask inputs and one augmented uncached bf16 train step.

Needs an NVIDIA card and nvcc; skips without a card. This file imports
neither JAX nor tests/conftest.py's fixtures, so where JAX is not installed
it runs on its own:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances of the attention forwards (K1, K2, K6, K7): f32 atol 1e-4, rtol
1e-3 (summation order over up to 4096 keys); bf16 two bf16 ulps of the
case's output scale, 2 * 2^-8 * max |plain| -- about 4e-4 at a 4096-key
layer, whose outputs average thousands of values and stay below 0.1, so a
fixed limit sized for |out| ~ 1 would pass a kernel that dropped the bias
or rounded at another point. The backward and K3 / K4 state theirs."""

import numpy as np
import pytest
import torch

from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn
from test_torch_topology_parallel import _blobs, _downsampled_mask


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker collects the same
    # tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def assert_forward_close(got, want):
    """An attention forward against its plain version, see the module's
    tolerances."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3)
    else:
        limit = 2 * 2.0 ** -8 * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= limit, f"max |kernel - plain| {err:.3g} > {limit:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,hw", [(1, 12, (64, 64)),   # K1, ViT-B global
                                     (25, 12, (14, 14)),  # K2, ViT-B windows
                                     (3, 2, (9, 7)),      # K2, ragged 63 keys
                                     (2, 2, (20, 15)),    # K1, ragged tiles
                                     (2, 2, (30, 34)),    # K1, ragged grid
                                     (1, 2, (64, 64))])   # K1, 2 heads
def test_kernels_match_plain_on_card(cuda_device, dtype, b, nh, hw):
    rng = np.random.default_rng(0)
    n = hw[0] * hw[1]
    arrays = (rng.normal(size=(b, n, 3 * nh * 64)) * 0.5,
              rng.normal(size=(b, nh, n, hw[0])) * 0.3,
              rng.normal(size=(b, nh, n, hw[1])) * 0.3)
    args = [torch.tensor(a, dtype=dtype, device=cuda_device) for a in arrays]
    kind = ("attn_windowed" if n <= port_attn.WINDOW_MAX_TOKENS
            else "attn_global")
    before = port_attn.LAUNCHES[kind]
    got = port_attn.flash_attention_packed(*args, hw=hw, num_heads=nh)
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES[kind] == before + 1
    assert got.dtype == dtype and got.shape == (b, n, nh * 64)
    want = port_attn.packed_attention_plain(*args, hw=hw, num_heads=nh)
    assert_forward_close(got, want)
    # no atomics: a second run gives the same bits
    assert torch.equal(got, port_attn.flash_attention_packed(
        *args, hw=hw, num_heads=nh))


def _attn_inputs(dev, dtype, b, nh, hw, seed=0):
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    arrays = (rng.normal(size=(b, n, 3 * nh * 64)) * 0.5,
              rng.normal(size=(b, nh, n, hw[0])) * 0.3,
              rng.normal(size=(b, nh, n, hw[1])) * 0.3,
              rng.normal(size=(b, n, nh * 64)))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


ATTN_SHAPES = [(1, 12, (64, 64)),   # ViT-B global layer
               (25, 12, (14, 14)),  # ViT-B windows of one image
               (3, 2, (9, 7)),      # ragged: one 63-token tile
               (2, 2, (20, 15)),    # ragged: 300 tokens over 5 tiles
               (2, 2, (30, 34)),    # ragged global grid: 1020 tokens, W != 64
               (1, 2, (64, 64))]    # 4096 tokens at 2 heads


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,hw", ATTN_SHAPES)
def test_kernel_lse_matches_plain_on_card(cuda_device, dtype, b, nh, hw):
    """The logsumexp rows K1 / K2 write for the backward: f32 sums over the
    same widened inputs (atol 2e-4 on values ~ log N + max score)."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, dtype, b, nh, hw)
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w, hw=hw,
                                            num_heads=nh, return_lse=True)
    want_out, want = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, hw=hw, num_heads=nh, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, nh, hw[0] * hw[1])
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)
    assert torch.equal(out, port_attn.attention_fwd_cuda(
        qkv, rel_h, rel_w, hw=hw, num_heads=nh))  # the LSE changes nothing


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,hw", ATTN_SHAPES)
def test_attention_bwd_kernels_match_plain_on_card(cuda_device, dtype, b, nh,
                                                   hw):
    """K5 (both kernels: in f32 the split-TF32 wgmma kernels, in bf16 the
    wgmma kernels) against ``packed_attention_bwd_plain`` on the same (qkv,
    rel, dO, L, D), each output relative to its max |plain|."""
    qkv, rel_h, rel_w, g = _attn_inputs(cuda_device, dtype, b, nh, hw)
    kw = dict(hw=hw, num_heads=nh)
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)
    before = dict(port_attn.LAUNCHES)
    got = port_attn.attention_bwd_cuda(qkv, rel_h, rel_w, g, lse, dvec, **kw)
    torch.cuda.synchronize()
    for name in ("attn_bwd_dq", "attn_bwd_dkv"):
        assert port_attn.LAUNCHES[name] == before[name] + 1, name
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
    for name, a, bb in zip(("dqkv", "drel_h", "drel_w"), got, want):
        assert a.shape == bb.shape and a.dtype == bb.dtype, name
        assert bool(torch.isfinite(a.float()).all()), name
        _rel_close(a, bb, K34_TOL[dtype], name)
    # no atomics: a second run gives the same bits
    again = port_attn.attention_bwd_cuda(qkv, rel_h, rel_w, g, lse, dvec, **kw)
    for name, a, bb in zip(("dqkv", "drel_h", "drel_w"), got, again):
        assert torch.equal(a, bb), name
    if dtype == torch.float32:
        ran = _device_kernels(lambda: port_attn.attention_bwd_cuda(
            qkv, rel_h, rel_w, g, lse, dvec, **kw))
        assert any("attn_bwd_dq_wgmma_tf32_kernel" in k for k in ran), ran
        assert any("attn_bwd_dkv_wgmma_tf32_kernel" in k for k in ran), ran


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", ATTN_SHAPES + [
    (2, 2, (4, 64)),    # W = 64, even H: two rounds of 128 keys
    (2, 2, (3, 64))])   # W = 64, odd H: the factor rows looked up
def test_attention_dkv_wgmma_on_card(cuda_device, b, nh, hw):
    """K5's bf16 dk/dv kernel on wgmma and TMA (``attn_bwd_dkv_wgmma_kernel``)
    alone, on each kind of grid (a window's keys in units of 128 whose
    query tiles a second unit finds in L2, a global grid's 128 keys a unit
    over a streamed ring; W = 64 and W != 64, the ragged 63 / 300 /
    1020-token grids): the k and v columns of dqkv against
    ``packed_attention_bwd_plain`` (``K34_TOL`` of max |plain|), the q
    columns untouched, one launch, and the same bits on a second run."""
    qkv, rel_h, rel_w, g = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw, seed=5)
    kw = dict(hw=hw, num_heads=nh)
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)

    def dkv():
        dqkv = torch.full_like(qkv, 7.0)
        port_attn.attention_bwd_dkv_cuda(qkv, rel_h, rel_w, g, lse, dvec,
                                         dqkv, **kw)
        return dqkv

    before = port_attn.LAUNCHES["attn_bwd_dkv"]
    got = dkv()
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_bwd_dkv"] == before + 1
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)[0]
    c = nh * 64
    assert bool((got[..., :c] == 7.0).all())
    for name, cols in (("dk", slice(c, 2 * c)), ("dv", slice(2 * c, None))):
        assert bool(torch.isfinite(got[..., cols].float()).all()), name
        _rel_close(got[..., cols], want[..., cols], K34_TOL[torch.bfloat16],
                   name)
    assert torch.equal(got, dkv())


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", ATTN_SHAPES + [
    (2, 2, (3, 64)),    # ROW_TILE at an odd grid height
    (4, 2, (4, 16)),    # GRID: a window of one tile, W = 16
    (1, 2, (8, 32))])   # GENERIC: W = 32, 256 tokens in 4 key tiles
def test_attention_dq_wgmma_on_card(cuda_device, b, nh, hw):
    """K5's bf16 dq kernel on wgmma and TMA (``attn_bwd_dq_wgmma_kernel``)
    alone, in each of its modes (``dq_plan``: ROW_TILE at W = 64, GRID on a
    window in tiles of 7 grid rows, GENERIC through the shared ds tile,
    the ragged 63 / 300 / 1020-token grids among them): the q columns of
    dqkv, drel_h and drel_w against ``packed_attention_bwd_plain``
    (``K34_TOL`` of max |plain|), the k and v columns untouched, one
    launch, and the same bits on a second run."""
    qkv, rel_h, rel_w, g = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw, seed=6)
    kw = dict(hw=hw, num_heads=nh)
    n = hw[0] * hw[1]
    mode = port_attn.dq_plan(n, hw).mode
    assert mode == ("row_tile" if hw[1] == 64 else "grid"
                    if hw[0] <= 14 and hw[1] <= 16 else "generic")
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)

    def dq():
        dqkv = torch.full_like(qkv, 7.0)
        drel = port_attn.attention_bwd_dq_cuda(qkv, rel_h, rel_w, g, lse,
                                               dvec, dqkv, **kw)
        return (dqkv,) + tuple(drel)

    before = port_attn.LAUNCHES["attn_bwd_dq"]
    got = dq()
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_bwd_dq"] == before + 1
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
    c = nh * 64
    assert bool((got[0][..., c:] == 7.0).all())
    for name, x, w in (("dq", got[0][..., :c], want[0][..., :c]),
                       ("drel_h", got[1], want[1]),
                       ("drel_w", got[2], want[2])):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape, name
        assert bool(torch.isfinite(x.float()).all()), name
        _rel_close(x, w, K34_TOL[torch.bfloat16], f"{mode} {name}")
    for x, y in zip(got, dq()):
        assert torch.equal(x, y)


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` ran, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) > 0}


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [
    (1, 12, (64, 64)),   # ViT-B global layer: dq "row_tile", dk/dv "row_tile"
    (25, 12, (14, 14)),  # ViT-B windows of one image: dq "grid"
    (2, 2, (9, 7)),      # ragged: one 63-token query tile, 5 key tiles
    (1, 2, (20, 24))])   # generic: dq "row_tile" at W = 24, one tile a row
def test_attention_bwd_f32_wgmma_on_card(cuda_device, b, nh, hw):
    """K5's f32 kernels on split-TF32 wgmma and TMA
    (``attn_bwd_dq_wgmma_tf32_kernel`` on ``dq_plan_f32``,
    ``attn_bwd_dkv_wgmma_tf32_kernel`` on ``dkv_plan_f32``), each alone:
    its columns of dqkv (and drel) against ``packed_attention_bwd_plain``
    within 1e-4 of max |plain|, the other columns untouched, one launch,
    the new kernels (and no other attention backward) on the card, and the
    same bits on a second run."""
    qkv, rel_h, rel_w, g = _attn_inputs(cuda_device, torch.float32, b, nh,
                                        hw, seed=8)
    kw = dict(hw=hw, num_heads=nh)
    n = hw[0] * hw[1]
    assert port_attn.dq_plan_f32(n, hw).mode == (
        "grid" if hw[1] <= 16 else "row_tile")
    assert port_attn.dkv_plan_f32(n, hw).mode == (
        "row_tile" if hw[1] == 64 and hw[0] % 2 == 0 else "generic")
    out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                return_lse=True, **kw)
    dvec = port_attn.bwd_dvec(g, out, nh)
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, g, lse,
                                                dvec, **kw)
    c = nh * 64

    def dq():
        dqkv = torch.full_like(qkv, 7.0)
        drel = port_attn.attention_bwd_dq_cuda(qkv, rel_h, rel_w, g, lse,
                                               dvec, dqkv, **kw)
        return (dqkv,) + tuple(drel)

    def dkv():
        dqkv = torch.full_like(qkv, 7.0)
        port_attn.attention_bwd_dkv_cuda(qkv, rel_h, rel_w, g, lse, dvec,
                                         dqkv, **kw)
        return dqkv

    before = dict(port_attn.LAUNCHES)
    got_q, got_kv = dq(), dkv()
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_bwd_dq"] == before["attn_bwd_dq"] + 1
    assert port_attn.LAUNCHES["attn_bwd_dkv"] == before["attn_bwd_dkv"] + 1
    assert bool((got_q[0][..., c:] == 7.0).all())
    assert bool((got_kv[..., :c] == 7.0).all())
    for name, x, w in (("dq", got_q[0][..., :c], want[0][..., :c]),
                       ("drel_h", got_q[1], want[1]),
                       ("drel_w", got_q[2], want[2]),
                       ("dk", got_kv[..., c:2 * c], want[0][..., c:2 * c]),
                       ("dv", got_kv[..., 2 * c:], want[0][..., 2 * c:])):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        _rel_close(x, w, K34_TOL[torch.float32], name)
    for x, y in zip(got_q, dq()):
        assert torch.equal(x, y)
    assert torch.equal(got_kv, dkv())
    ran = _device_kernels(lambda: (dq(), dkv()))
    for name in ("attn_bwd_dq_wgmma_tf32_kernel",
                 "attn_bwd_dkv_wgmma_tf32_kernel"):
        assert any(name in k for k in ran), (name, ran)
    assert not any("attn_bwd_d" in k and "tf32" not in k for k in ran), ran


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [s for s in ATTN_SHAPES
                                     if s[2][0] * s[2][1] > 256])
def test_k1_bf16_on_the_wgmma_body_on_card(cuda_device, b, nh, hw):
    """The bf16 K1 is the bf16 K6's kernel (``attn_relpos_wgmma_kernel``,
    on ``relpos_plan(64, n, hw, norm)``) with its logsumexp rows: the output
    against ``packed_attention_plain`` (two bf16 ulps of the output scale)
    and L against its f32 logsumexp (atol 2e-4), counted as one K1 launch
    and no K6 launch, and the same bits of both on a second run; where the
    JAX route rounds the un-normalised p (``normalised_rounding`` false),
    the bits of K6's own instance."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw, seed=7)
    kw = dict(hw=hw, num_heads=nh)
    before = dict(port_attn.LAUNCHES)
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                            return_lse=True, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"attn_global": 1}, launched
    want_out, want_lse = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, return_lse=True, **kw)
    assert_forward_close(out, want_out)
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)
    out2, lse2 = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                              return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    # without the rows, the same output (K6's own instance)
    if not port_attn.normalised_rounding(b, hw[0] * hw[1]):
        assert torch.equal(out, port_attn.attention_relpos_cuda(
            qkv, rel_h, rel_w, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [s for s in ATTN_SHAPES
                                     if s[2][0] * s[2][1] <= 512] + [
    (1, 2, (14, 14)),   # one window: K6's rounding in one tile
    (4, 2, (16, 32)),   # 512 tokens, normalised: two passes of 8 tiles
    (2, 2, (8, 32)),    # windowed, W > 16: two passes over 64-key tiles
    (2, 2, (4, 64))])   # windowed, two grid rows of 64: two passes
def test_k2_bf16_on_the_wgmma_body_on_card(cuda_device, b, nh, hw):
    """The bf16 K2 is the bf16 K6's kernel (``attn_relpos_wgmma_kernel`` on
    ``relpos_plan(64, n, hw, norm)``) at the JAX route's rounding point
    (``normalised_rounding``: the normalised p in one tile or in two passes
    over several, else K6's): the output against the repaired
    ``packed_attention_plain`` (two bf16 ulps of the output scale) and L
    against its f32 logsumexp (atol 2e-4), counted as one K2 launch (one K1
    past 256 tokens), and the same bits of both on a second run."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw, seed=9)
    n = hw[0] * hw[1]
    kw = dict(hw=hw, num_heads=nh)
    kind = ("attn_windowed" if n <= port_attn.WINDOW_MAX_TOKENS
            else "attn_global")
    before = dict(port_attn.LAUNCHES)
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                            return_lse=True, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                if v != before[k]}
    assert launched == {kind: 1}, launched
    want_out, want_lse = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, return_lse=True, **kw)
    assert_forward_close(out, want_out)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)
    out2, lse2 = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                              return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if not port_attn.normalised_rounding(b, n):  # K6's rounding: its bits
        assert torch.equal(out, port_attn.attention_relpos_cuda(
            qkv, rel_h, rel_w, **kw))


@pytest.mark.gpu
def test_attention_autograd_runs_k5_on_card(cuda_device):
    """Gradients through ``flash_attention_packed`` on the card (K1 with
    LSE, then K5) against autograd through the plain version, f32."""
    qkv, rel_h, rel_w, t = _attn_inputs(cuda_device, torch.float32, 2, 2,
                                        (20, 15))
    grads = []
    for fn in (port_attn.flash_attention_packed,
               port_attn.packed_attention_plain):
        before = dict(port_attn.LAUNCHES)
        args = [x.clone().requires_grad_(True) for x in (qkv, rel_h, rel_w)]
        (fn(*args, hw=(20, 15), num_heads=2) * t).sum().backward()
        grads.append([x.grad for x in args])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()}
        kernel = fn is port_attn.flash_attention_packed
        assert launched == {"attn_global": int(kernel), "attn_windowed": 0,
                            "attn_bwd_dq": int(kernel),
                            "attn_bwd_dkv": int(kernel), "attn_relpos": 0,
                            "attn_windowed_image": 0}, launched
    for name, a, bb in zip(("dqkv", "drel_h", "drel_w"), *grads):
        _rel_close(a, bb, K34_TOL[torch.float32], name)
    # the f32 route: K5's split-TF32 wgmma kernels
    args = [x.clone().requires_grad_(True) for x in (qkv, rel_h, rel_w)]
    ran = _device_kernels(lambda: (port_attn.flash_attention_packed(
        *args, hw=(20, 15), num_heads=2) * t).sum().backward())
    for name in ("attn_bwd_dq_wgmma_tf32_kernel",
                 "attn_bwd_dkv_wgmma_tf32_kernel"):
        assert any(name in k for k in ran), (name, ran)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [(2, 2, (30, 34)),    # K1, ragged grid
                                     (4, 2, (14, 14)),    # K2, windows
                                     (1, 2, (64, 64))])   # K1, 4096 tokens
def test_attention_autograd_bf16_runs_k5_on_card(cuda_device, b, nh, hw):
    """bf16 gradients through ``flash_attention_packed`` on the card (K1's
    tensor-core kernel or K2 with the LSE rows, then K5's tensor-core
    kernels) against the plain versions of the same forward and backward,
    each output relative to its max |plain|."""
    qkv, rel_h, rel_w, t = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw)
    kw = dict(hw=hw, num_heads=nh)
    fwd = ("attn_windowed" if hw[0] * hw[1] <= port_attn.WINDOW_MAX_TOKENS
           else "attn_global")
    before = dict(port_attn.LAUNCHES)
    args = [x.clone().requires_grad_(True) for x in (qkv, rel_h, rel_w)]
    out = port_attn.flash_attention_packed(*args, **kw)
    out.backward(t)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items() if
                v != before[k]}
    assert launched == {fwd: 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1}, launched
    want_out, lse = port_attn.packed_attention_plain(qkv, rel_h, rel_w,
                                                     return_lse=True, **kw)
    assert_forward_close(out.detach(), want_out)
    dvec = port_attn.bwd_dvec(t, want_out, nh)
    want = port_attn.packed_attention_bwd_plain(qkv, rel_h, rel_w, t, lse,
                                                dvec, **kw)
    for name, x, w in zip(("dqkv", "drel_h", "drel_w"), args, want):
        assert x.grad.dtype == torch.bfloat16, name
        _rel_close(x.grad, w, K34_TOL[torch.bfloat16], name)


@pytest.mark.gpu
def test_kernels_refuse_other_head_dims(cuda_device):
    """Head dims other than 64 go to K6, which is forward-only and takes
    multiples of 4 up to 128: a gradient, or a head dim beyond that, raises
    (never the plain version on a CUDA tensor)."""
    qkv = torch.zeros((1, 16, 3 * 2 * 32), device=cuda_device)
    rel = torch.zeros((1, 2, 16, 4), device=cuda_device)
    with pytest.raises(NotImplementedError, match="K6"):
        port_attn.flash_attention_packed(qkv.requires_grad_(True), rel, rel,
                                         hw=(4, 4), num_heads=2)
    for d in (132, 18):
        qkv = torch.zeros((1, 16, 3 * 2 * d), device=cuda_device)
        with pytest.raises(NotImplementedError, match="multiple of 4"):
            port_attn.flash_attention_packed(qkv, rel, rel, hw=(4, 4),
                                             num_heads=2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,d,hw", [
    (1, 16, 80, (64, 64)),   # ViT-H global layer
    (25, 16, 80, (14, 14)),  # ViT-H windows of one image, 196 keys
    (2, 4, 16, (8, 8)),      # the test-size model's global layer, 64 keys
    (8, 4, 16, (4, 4)),      # ... and its windows, 16 keys
    (3, 2, 32, (14, 14)),
    (2, 3, 64, (20, 15)),    # head_dim 64 with an odd head count
    (1, 2, 128, (9, 7)),     # the widest head, ragged
    (2, 2, 72, (8, 16))])    # a head dim that is no multiple of 16
def test_relpos_kernel_matches_plain_on_card(cuda_device, dtype, b, nh, d,
                                             hw):
    """K6 against ``relpos_attention_plain`` through the public entry, and
    the same bits on a second run (f32: the split-TF32 wgmma kernel, bf16:
    the bf16 wgmma kernel). bf16: the kernel rounds p against the running
    maximum of its key tiles, the plain version against the row maximum,
    so single roundings differ."""
    rng = np.random.default_rng(0)
    n = hw[0] * hw[1]
    arrays = (rng.normal(size=(b, n, 3 * nh * d)) * 0.5,
              rng.normal(size=(b, nh, n, hw[0])) * 0.3,
              rng.normal(size=(b, nh, n, hw[1])) * 0.3)
    args = [torch.tensor(a, dtype=dtype, device=cuda_device) for a in arrays]
    before = dict(port_attn.LAUNCHES)
    got = port_attn.flash_attention_packed(*args, hw=hw, num_heads=nh)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items() if
                v != before[k]}
    assert launched == {"attn_relpos": 1}, launched
    assert got.dtype == dtype and got.shape == (b, n, nh * d)
    want = port_attn.relpos_attention_plain(*args, hw=hw, num_heads=nh)
    assert_forward_close(got, want)
    assert torch.equal(got, port_attn.flash_attention_packed(
        *args, hw=hw, num_heads=nh))


def _relpos_inputs(dev, dtype, b, nh, d, hw, seed=0):
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    arrays = (rng.normal(size=(b, n, 3 * nh * d)) * 0.5,
              rng.normal(size=(b, nh, n, hw[0])) * 0.3,
              rng.normal(size=(b, nh, n, hw[1])) * 0.3)
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 20, 48, 80, 128])
@pytest.mark.parametrize("b,nh,hw", [(1, 2, (64, 64)),   # global, W = 64
                                     (4, 2, (14, 14)),   # windows, 196 keys
                                     (1, 3, (30, 34))])  # global, W != 64
def test_relpos_mma_kernel_head_dims_on_card(cuda_device, d, b, nh, hw):
    """The bf16 K6 on the tensor cores at head dims that take the padded
    rows (20: 8-byte copies, padded to 32; 48: padded to 48 + 8; 80: the
    ViT-H head) against ``relpos_attention_plain``, on both bias routes
    (a key tile that is one grid row, and the generic lookups with keys
    masked past N), and twice with identical bits."""
    args = _relpos_inputs(cuda_device, torch.bfloat16, b, nh, d, hw)
    before = port_attn.LAUNCHES["attn_relpos"]
    got = port_attn.flash_attention_packed(*args, hw=hw, num_heads=nh)
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_relpos"] == before + 1
    assert got.shape == (b, hw[0] * hw[1], nh * d)
    assert bool(torch.isfinite(got.float()).all())
    want = port_attn.relpos_attention_plain(*args, hw=hw, num_heads=nh)
    assert_forward_close(got, want)
    assert torch.equal(got, port_attn.flash_attention_packed(
        *args, hw=hw, num_heads=nh))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 20, 48, 80, 128])
@pytest.mark.parametrize("b,nh,hw", [(8, 2, (4, 4)),      # 8 windows of 16
                                     (25, 2, (14, 14)),   # 25 windows of 196
                                     (1, 2, (64, 64))])   # N = 4096
def test_relpos_wgmma_kernel_on_card(cuda_device, d, b, nh, hw):
    """The bf16 K6 on wgmma and TMA (``attn_relpos_wgmma_kernel``) on each
    of its key tiles -- a whole window of 224 slots (two of 7 grid rows past
    dp = 80), two grid rows of 64 -- at head dims that take one slab (16),
    padded heads (20 -> 32, the wrapper's zero columns), 48 = 32 + 16,
    ViT-H's 80 = 64 + 16 and 128 = 64 + 64, against
    ``relpos_attention_plain``, one launch, and twice with identical
    bits."""
    n = hw[0] * hw[1]
    plan = port_attn.relpos_plan(d, n, hw)
    assert plan.nk == ((224 if plan.dp <= 80 else 112) if n <= 256 else 128)
    args = _relpos_inputs(cuda_device, torch.bfloat16, b, nh, d, hw, seed=3)
    before = port_attn.LAUNCHES["attn_relpos"]
    got = port_attn.attention_relpos_cuda(*args, hw=hw, num_heads=nh)
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_relpos"] == before + 1
    assert bool(torch.isfinite(got.float()).all())
    assert_forward_close(got, port_attn.relpos_attention_plain(
        *args, hw=hw, num_heads=nh))
    assert torch.equal(got, port_attn.attention_relpos_cuda(
        *args, hw=hw, num_heads=nh))


def assert_f32_close(got, want, what="out"):
    """An f32 output of the split-TF32 wgmma kernel against its plain twin:
    within 1e-4 of max |plain| (``chip_smoke.py``'s f32 limit)."""
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all()), what
    limit = 1e-4 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= limit, f"{what}: max |kernel - plain| {err:.3g} > {limit:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [
    (1, 12, (64, 64)),   # ViT-B's global layer, serving
    (4, 12, (64, 64)),   # ... in the f32 full fine-tune, B = 4
    (1, 16, (64, 64)),   # ViT-L's 16 heads
    (2, 2, (30, 34)),    # a ragged global grid, W != 64
    (3, 2, (20, 15)),    # 300 tokens, odd B: _packed_kernel's rounding
    (1, 2, (63, 65))])   # ragged N = 4095
def test_k1_f32_on_the_wgmma_tf32_kernel_on_card(cuda_device, b, nh, hw):
    """The f32 K1 is the f32 K6's kernel (``attn_relpos_wgmma_tf32_kernel``
    on ``relpos_plan_f32``) with its logsumexp rows: the output and L
    against ``packed_attention_plain`` within 1e-4 of max |plain|, one K1
    launch and no K6 launch, the same bits of both on a second run, and,
    without the rows, the bits of K6's own launch."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, torch.float32, b, nh,
                                        hw, seed=5)
    kw = dict(hw=hw, num_heads=nh)
    before = dict(port_attn.LAUNCHES)
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                            return_lse=True, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"attn_global": 1}, launched
    want_out, want_lse = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, return_lse=True, **kw)
    assert_f32_close(out, want_out)
    assert_f32_close(lse, want_lse, "lse")
    out2, lse2 = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                              return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, port_attn.attention_relpos_cuda(
        qkv, rel_h, rel_w, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [(25, 12, (14, 14)),  # ViT-B windows
                                     (100, 12, (14, 14)),  # ... at B = 4
                                     (6, 2, (3, 3)),      # 9 keys of 16
                                     (5, 3, (4, 4)),      # one key tile
                                     (3, 2, (16, 16)),    # 256 keys
                                     (2, 2, (9, 7))])     # 63 keys
def test_k2_f32_on_the_wgmma_tf32_kernel_on_card(cuda_device, b, nh, hw):
    """The f32 K2 is the f32 K6's kernel in its GRID mode
    (``attn_relpos_wgmma_tf32_kernel`` on ``relpos_plan_f32``) with its
    logsumexp rows, at the bf16 K2's shapes and ViT-B's B = 4: the output
    and L against ``packed_attention_plain`` within atol 1e-4, one K2
    launch and nothing else, the same bits of both on a second run, and,
    without the rows, the bits of K6's own launch."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, torch.float32, b, nh,
                                        hw, seed=6)
    kw = dict(hw=hw, num_heads=nh)
    assert port_attn.relpos_plan_f32(64, hw[0] * hw[1], hw).mode == "grid"
    before = dict(port_attn.LAUNCHES)
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                            return_lse=True, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"attn_windowed": 1}, launched
    want_out, want_lse = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, return_lse=True, **kw)
    assert_forward_close(out, want_out)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-4, rtol=0)
    out2, lse2 = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                              return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, port_attn.attention_relpos_cuda(
        qkv, rel_h, rel_w, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 48, 80, 128])
@pytest.mark.parametrize("b,nh,hw", [(1, 2, (64, 64)),   # global, W = 64
                                     (4, 2, (14, 14)),   # windows, 196 keys
                                     (8, 2, (4, 4)),     # windows of 16
                                     (1, 3, (30, 34)),   # a non-SAM grid
                                     (2, 2, (10, 20)),   # ragged N = 200
                                     (1, 2, (63, 65))])  # ragged N = 4095
def test_relpos_wgmma_tf32_kernel_on_card(cuda_device, d, b, nh, hw):
    """The f32 K6 on wgmma and TMA (``attn_relpos_wgmma_tf32_kernel``) in
    each of its modes -- "row_tile" (W = 64), "grid" (windows up to 16 x
    16), "generic" (any other grid, keys masked past N) -- at head dims of
    one slab of 16 columns, of 32, 48 = 32 + 16, ViT-H's 80 = 32 + 32 + 16
    and 128 (one K / V stage on a global grid), against
    ``relpos_attention_plain`` within 1e-4 of max |plain|, one launch, and
    twice with identical bits."""
    n = hw[0] * hw[1]
    plan = port_attn.relpos_plan_f32(d, n, hw)
    assert plan.mode == ("grid" if max(hw) <= 16 else
                         "row_tile" if hw[1] == 64 else "generic")
    args = _relpos_inputs(cuda_device, torch.float32, b, nh, d, hw, seed=4)
    before = port_attn.LAUNCHES["attn_relpos"]
    got = port_attn.attention_relpos_cuda(*args, hw=hw, num_heads=nh)
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_relpos"] == before + 1
    assert_f32_close(got, port_attn.relpos_attention_plain(
        *args, hw=hw, num_heads=nh))
    assert torch.equal(got, port_attn.attention_relpos_cuda(
        *args, hw=hw, num_heads=nh))


@pytest.mark.gpu
@pytest.mark.parametrize("b,hw", [(1, (64, 64)),    # ViT-H's global layer
                                  (25, (14, 14))])  # its windows of one image
def test_relpos_wgmma_tf32_vith_on_card(cuda_device, b, hw):
    """The f32 K6 at ViT-H's full width (16 heads of 80) in serving's
    layers, through the public entry: one launch, within 1e-4 of max
    |plain|, the same bits on a second run."""
    args = _relpos_inputs(cuda_device, torch.float32, b, 16, 80, hw, seed=6)
    kw = dict(hw=hw, num_heads=16)
    before = dict(port_attn.LAUNCHES)
    got = port_attn.flash_attention_packed(*args, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"attn_relpos": 1}, launched
    assert_f32_close(got, port_attn.relpos_attention_plain(*args, **kw))
    assert torch.equal(got, port_attn.flash_attention_packed(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,pb", [(8, 37, 1),    # 296 rows
                                     (8, 43, 8),    # 344 rows, one image
                                     (3, 5, 1),     # 15 rows: one stage
                                     (16, 521, 8)])  # 8336 rows, 66 chunks
def test_i2t_dw_tf32_wgmma_on_card(cuda_device, bp, m, pb):
    """The f32 K4 weight pass on wgmma and TMA (``i2t_bwd_dw_tf32_kernel``)
    against ``i2t_bwd_dw_plain`` (1e-4 of max |plain|), on row counts that
    are no multiple of its 16-row stage and with pb = 1 and 8, one launch,
    and the same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)
    args = (r(bp // pb, m, 256), r(1, m, 256), r(bp, m, 128), r(bp, m, 128),
            r(bp, m, 256))
    with full_fp32():
        before = i2t.LAUNCHES["i2t_bwd_dw"]
        got = i2t.i2t_bwd_dw_cuda(*args, pb=pb)
        torch.cuda.synchronize()
        assert i2t.LAUNCHES["i2t_bwd_dw"] == before + 1
        for name, a, w in zip(("dWq", "dWo"), got,
                              i2t.i2t_bwd_dw_plain(*args, pb=pb)):
            assert a.shape == w.shape and a.dtype == w.dtype, name
            _rel_close(a, w, K34_TOL[torch.float32], name)
        assert _same_bits(got, i2t.i2t_bwd_dw_cuda(*args, pb=pb))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,pb", [(8, 37, 1),    # 296 rows, short stages
                                     (8, 43, 8),    # 344 rows, one image
                                     (1, 5, 1),     # one chunk of 5 rows
                                     (3, 100, 1),   # full and short stages
                                     (16, 521, 8),  # 8336 rows
                                     (4, 4096, 2)])  # the main path's pairs
def test_i2t_dw_bf16_wgmma_on_card(cuda_device, bp, m, pb):
    """The bf16 K4 weight pass on wgmma and TMA (``i2t_bwd_dw_wgmma_kernel``)
    against ``i2t_bwd_dw_plain`` on the plan's chunks (its products exact,
    the f32 sums in another order: 1e-4 of max |plain|), on pair lengths
    that are no multiple of its 32-row stage, pb = 1, 2 and 8, and a lone
    chunk shorter than one stage; one launch, the same bits on a second
    call."""
    from dilabhelmholtzoct_tpu_torch import kernels
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(13)
    r = lambda *s: torch.randn(s, generator=gen,
                               device=cuda_device).bfloat16()
    args = (r(bp // pb, m, 256), r(1, m, 256), r(bp, m, 128), r(bp, m, 128),
            r(bp, m, 256))
    chunks, _, _ = i2t.dw_plan_bf16(bp, m, kernels.sm_count(cuda_device))
    before = i2t.LAUNCHES["i2t_bwd_dw"]
    got = i2t.i2t_bwd_dw_cuda(*args, pb=pb)
    torch.cuda.synchronize()
    assert i2t.LAUNCHES["i2t_bwd_dw"] == before + 1
    want = i2t.i2t_bwd_dw_plain(*args, pb=pb,
                                parts=tuple(len(c) for c in chunks))
    for name, a, w in zip(("dWq", "dWo"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[torch.float32], name)
    assert _same_bits(got, i2t.i2t_bwd_dw_cuda(*args, pb=pb))


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hw", [(25, 12, (14, 14)),  # ViT-B windows
                                     (6, 2, (3, 3)),      # 9 keys of 16
                                     (5, 3, (4, 4)),      # one m16 tile
                                     (3, 2, (16, 16)),    # 256 keys, 16 tiles
                                     (2, 2, (9, 7))])     # 63 keys
def test_windowed_mma_kernel_on_card(cuda_device, b, nh, hw):
    """The bf16 K2 on the tensor cores (on wgmma and TMA since it became an
    instance of ``attn_relpos_wgmma_kernel``) against
    ``packed_attention_plain``: output within two bf16 ulps of its scale
    and the logsumexp rows within atol 2e-4; the LSE changes nothing, and
    a second run gives the same bits."""
    qkv, rel_h, rel_w, _ = _attn_inputs(cuda_device, torch.bfloat16, b, nh,
                                        hw)
    kw = dict(hw=hw, num_heads=nh)
    before = port_attn.LAUNCHES["attn_windowed"]
    out, lse = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w,
                                            return_lse=True, **kw)
    torch.cuda.synchronize()
    assert port_attn.LAUNCHES["attn_windowed"] == before + 1
    want_out, want_lse = port_attn.packed_attention_plain(
        qkv, rel_h, rel_w, return_lse=True, **kw)
    assert_forward_close(out, want_out)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-4, rtol=1e-5)
    again = port_attn.attention_fwd_cuda(qkv, rel_h, rel_w, **kw)
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("hw,ws", [((64, 64), 14), ((28, 20), 14),
                                   ((9, 7), 4)])
def test_winimg_mma_kernel_deterministic_on_card(cuda_device, hw, ws):
    """The bf16 K7 twice on the same inputs: identical bits."""
    qkv, rel, bias = _winimg_inputs(cuda_device, torch.bfloat16, 2, 3, hw, ws)
    kw = dict(ws=ws, num_heads=3)
    a = port_attn.flash_attention_windowed_image(qkv, rel, bias, **kw)
    b = port_attn.flash_attention_windowed_image(qkv, rel, bias, **kw)
    assert torch.equal(a, b)


def _winimg_inputs(dev, dtype, b, nh, hw, ws, seed=0):
    rng = np.random.default_rng(seed)
    c = nh * 64
    arrays = (rng.normal(size=(b, *hw, 3 * c)) * 0.5,
              rng.normal(size=(b, nh, *hw, 2 * ws)) * 0.3,
              rng.normal(size=(3 * c,)) * 0.5)
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,hw,ws", [(1, 12, (64, 64), 14),  # ViT-B
                                        (2, 2, (28, 20), 14),   # ragged W
                                        (1, 2, (28, 28), 14),   # no pad
                                        (2, 4, (9, 7), 4)])
def test_winimg_kernel_matches_plain_and_k2_on_card(cuda_device, dtype, b,
                                                    nh, hw, ws):
    """K7 against its plain version (the partitioned route on plain
    attention), and against K2 on the partitioned windows of the same qkv:
    in f32 bit-equal (both run the same code once their rows are in shared
    memory); in bf16 within two bf16 ulps of the output scale (the bf16 K2
    runs on the wgmma body, K7 on mma.sync; both round the normalised p on
    these windows)."""
    qkv, rel, bias = _winimg_inputs(cuda_device, dtype, b, nh, hw, ws)
    before = dict(port_attn.LAUNCHES)
    got = port_attn.flash_attention_windowed_image(qkv, rel, bias, ws=ws,
                                                   num_heads=nh)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items() if
                v != before[k]}
    assert launched == {"attn_windowed_image": 1}, launched
    assert got.dtype == dtype and got.shape == (b, *hw, nh * 64)
    want = port_attn.windowed_image_attention_plain(qkv, rel, bias, ws=ws,
                                                    num_heads=nh)
    assert_forward_close(got, want)
    # the partitioned route on K2
    win, rel_h, rel_w, padded = port_attn.partition_image_operands(
        qkv, rel, bias, ws)
    k2 = port_attn.attention_fwd_cuda(win, rel_h, rel_w, hw=(ws, ws),
                                      num_heads=nh)
    k2 = port_attn.window_unpartition(k2.reshape(-1, ws, ws, nh * 64), ws,
                                      padded, hw)
    # K2 runs on the wgmma bodies, K7 on mma.sync: the two agree within
    # the forward's limit against plain, in both types
    if dtype == torch.bfloat16:
        assert port_attn.normalised_rounding(win.shape[0], ws * ws)
    assert_forward_close(got, k2.contiguous())


# the f32 kernels on the tensor cores in split TF32: library -> kernels
TF32_KERNELS = {"attention_bwd_wgmma_tf32": ("attn_bwd_dq_wgmma_tf32_kernel",
                                             "attn_bwd_dkv_wgmma_tf32_kernel"),
                "attention_relpos_wgmma_tf32": (
                    "attn_relpos_wgmma_tf32_kernel",),
                "attention_winimg": ("attn_winimg_tf32_kernel",),
                "upscaler": ("upscale_fwd_tf32_kernel",
                             "upscale_bwd_rows_tf32_kernel",
                             "upscale_bwd_dw_tf32_kernel"),
                "decoder_attn": ("i2t_fwd_tf32_kernel",
                                 "i2t_bwd_rows_tf32_kernel",
                                 "i2t_bwd_dw_tf32_kernel")}


@pytest.mark.gpu
@pytest.mark.parametrize("lib", sorted(TF32_KERNELS))
def test_f32_kernels_on_tf32_tensor_cores(cuda_device, lib):
    """The f32 K1, K2, K3, K4, K5, K6 and K7 kernels hold TF32 tensor-core
    instructions (HMMA.1688.F32.TF32 from mma.sync; HGMMA on TF32 in the
    kernels on wgmma: the K3 / K4 weight passes, the K1 / K2 / K6 kernel
    and K5's two kernels, which hold no HMMA) in their SASS and use no local
    memory (no spills, no stack), from ``cuobjdump`` on the built
    library."""
    import subprocess

    from dilabhelmholtzoct_tpu_torch import kernels

    kernels.library(lib)  # built at first use
    path = str(kernels.library_path(lib))
    tool = kernels.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    usage = subprocess.run([tool, "-res-usage", path], capture_output=True,
                           text=True, check=True, timeout=300).stdout
    tf32, hmma, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            tf32[fn] = hmma[fn] = 0
        elif fn and "MMA" in line and "TF32" in line:  # HMMA or HGMMA
            tf32[fn] += 1
            hmma[fn] += "HMMA" in line
    lines = usage.splitlines()
    for name in TF32_KERNELS[lib]:
        found = [f for f in tf32 if name in f]
        assert found, f"{name} is not in the SASS of {lib}"
        for f in found:
            assert tf32[f] > 0, f"{f}: no TF32 tensor-core instruction"
            if "wgmma" in name:  # HGMMA alone, no mma.sync
                assert hmma[f] == 0, f"{f}: {hmma[f]} HMMA"
            # the resource line follows the function's name
            res = next(lines[i + 1] for i, x in enumerate(lines)
                       if f in x and i + 1 < len(lines))
            assert "STACK:0 " in res and "LOCAL:0 " in res, f"{f}: {res}"


@pytest.mark.gpu
def test_tiny_engine_request_on_card(cuda_device):
    """A box request through ``SegmentationEngine`` at the test-size model
    (head_dim 16: K6 for all 3 layers) on the card against the same engine
    on the CPU, f32."""
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.inference.engine import SegmentationEngine
    from dilabhelmholtzoct_tpu_torch.models import sam as psam
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_tiny

    cfg = sam_tiny()
    sd = synthetic.random_params(cfg, seed=0)
    img = synthetic.oct_image(seed=0)[:120, :128]
    box = [20, 30, 90, 100]
    before = dict(port_attn.LAUNCHES)
    psam.set_flash_attention("on")  # the flash route below 196 tokens
    try:
        _, probs = SegmentationEngine(sd, cfg, device=cuda_device).segment(
            img, box, "bbox")
        launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items()
                    if v != before[k]}
        _, want = SegmentationEngine(sd, cfg, device="cpu").segment(
            img, box, "bbox")
    finally:
        psam.set_flash_attention("auto")
    assert launched == {"attn_relpos": 3}, launched
    assert probs.shape == want.shape == (1, 120, 128)
    np.testing.assert_allclose(probs, want, atol=1e-4)


def _rel_close(got, want, tol, what):
    """max |got - want| <= tol * max |want| (gradients and masks are sums of
    many terms: the tolerance is relative to the tensor's scale)."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, f"{what}: max |kernel - plain| / max |plain| = {err:.3g}"


# f32: summation order; bf16: a re-ordered f32 sum may flip one rounding to
# bf16 of an intermediate (one ulp = 2^-8 relative) before further products
K34_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 64, 3)])
def test_upscaler_kernels_match_plain_on_card(cuda_device, dtype, bp, m,
                                              n_out):
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    r = lambda *s, k=0.3, dt=dtype: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    f32 = torch.float32
    args = (r(bp, m, 256, k=1.0), r(256, 2, 2, 64), r(64, dt=f32),
            1 + r(64, k=0.1, dt=f32), r(64, dt=f32), r(64, 2, 2, 32),
            r(32, dt=f32), r(bp, n_out, 32, k=1.0))
    dm = r(bp, m, n_out * 16, k=1.0, dt=f32)
    before = dict(up_op.LAUNCHES)
    out = up_op.upscale_fwd_cuda(*args)
    grads = up_op.upscale_bwd_cuda(args[0], dm, *args[1:])
    torch.cuda.synchronize()
    assert up_op.LAUNCHES["upscale_fwd"] == before["upscale_fwd"] + 1
    assert up_op.LAUNCHES["upscale_bwd"] == before["upscale_bwd"] + 1
    _rel_close(out, up_op.upscale_fwd_plain(*args), K34_TOL[dtype], "fwd")
    want = up_op.upscale_bwd_plain(args[0], dm, *args[1:])
    names = ("d_up", "dW1", "dW2", "db1", "dg", "dbt", "db2", "d_hyper")
    for name, a, b in zip(names, grads, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _rel_close(a, b, K34_TOL[dtype], name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 100), (3, 5, 64)])
def test_decoder_attn_kernels_match_plain_on_card(cuda_device, dtype, pb,
                                                  n_tok, m):
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    r = lambda *s, k=0.2, dt=dtype: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    f32, b = torch.float32, 2
    args = (r(b, m, 256, k=1.0), r(1, m, 256, k=1.0),
            r(b * pb, n_tok, 128, k=1.0), r(b * pb, n_tok, 128, k=1.0),
            r(256, 128), r(128, dt=f32), r(128, 256), r(256, dt=f32),
            1 + r(256, k=0.1, dt=f32), r(256, dt=f32))
    dy = r(b * pb, m, 256, k=1.0)
    kw = dict(nh=8, pb=pb, eps=1e-6)
    before = dict(i2t.LAUNCHES)
    out = i2t.i2t_fwd_cuda(*args, **kw)
    grads = i2t.i2t_bwd_cuda(*args, dy, **kw)
    torch.cuda.synchronize()
    assert i2t.LAUNCHES["i2t_fwd"] == before["i2t_fwd"] + 1
    assert i2t.LAUNCHES["i2t_bwd"] == before["i2t_bwd"] + 1
    _rel_close(out, i2t.i2t_fwd_plain(*args, **kw), K34_TOL[dtype], "fwd")
    want = i2t.i2t_bwd_plain(*args, dy, **kw)
    names = ("d_keys", "d_qpre", "p", "d_score", "d_out", "dWq", "dbq",
             "dWo", "dbo", "dg", "dbt")
    for name, a, bb in zip(names, grads, want):
        assert a.shape == bb.shape and a.dtype == bb.dtype, name
        _rel_close(a, bb, K34_TOL[dtype], name)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 100), (8, 5, 37), (2, 8, 64),
                                        (8, 7, 4096), (1, 1, 129),
                                        (8, 8, 1)])
def test_i2t_fwd_mma_on_card(cuda_device, pb, n_tok, m):
    """The bf16 K4 forward on wgmma and TMA (``i2t_fwd_wgmma_kernel``)
    against ``i2t_fwd_plain`` on ragged m (64 rows a unit) and at the
    training width (4096 rows), with the pb pairs of an image sharing one
    q projection, 1-8 tokens: within two bf16 ulps of the output scale,
    at least 99.5% of y bit-equal to the plain version's, and the same
    bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    bf = torch.bfloat16
    r = lambda *s, k=0.2, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    f32, b = torch.float32, 2
    args = (r(b, m, 256, k=1.0), r(1, m, 256, k=1.0),
            r(b * pb, n_tok, 128, k=1.0), r(b * pb, n_tok, 128, k=1.0),
            r(256, 128), r(128, dt=f32), r(128, 256), r(256, dt=f32),
            1 + r(256, k=0.1, dt=f32), r(256, dt=f32))
    kw = dict(nh=8, pb=pb, eps=1e-6)
    before = i2t.LAUNCHES["i2t_fwd"]
    got = i2t.i2t_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert i2t.LAUNCHES["i2t_fwd"] == before + 1
    want = i2t.i2t_fwd_plain(*args, **kw)
    assert got.shape == want.shape == (b * pb, m, 256)
    assert got.dtype == want.dtype == bf
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 * 2.0 ** -8 * scale, f"y: {err:.3g} of {scale:.3g}"
    same = float((got == want).float().mean())
    assert same >= 0.995, f"y: {same:.4f} bit-equal"
    assert torch.equal(got, i2t.i2t_fwd_cuda(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 37, 4), (5, 64, 3)])
def test_upscale_fwd_mma_on_card(cuda_device, bp, m, n_out):
    """The bf16 K3 forward on the tensor cores (``upscale_fwd_wgmma_kernel``:
    wgmma, and mma.sync for the hypernetwork sum) against
    ``upscale_fwd_plain`` (K34_TOL: 2e-2 of max |out|), on a ragged m and
    1-4 mask tokens; the same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    r = lambda *s, k=0.3, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    args = (r(bp, m, 256, k=1.0), r(256, 2, 2, 64), r(64, dt=f32),
            1 + r(64, k=0.1, dt=f32), r(64, dt=f32), r(64, 2, 2, 32),
            r(32, dt=f32), r(bp, n_out, 32, k=1.0))
    before = up_op.LAUNCHES["upscale_fwd"]
    got = up_op.upscale_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert up_op.LAUNCHES["upscale_fwd"] == before + 1
    want = up_op.upscale_fwd_plain(*args)
    assert got.shape == want.shape == (bp, m, n_out * 16)
    assert got.dtype == want.dtype == f32
    _rel_close(got, want, K34_TOL[bf], "masks")
    assert torch.equal(got, up_op.upscale_fwd_cuda(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 100), (8, 5, 37), (2, 8, 64),
                                        (1, 1, 5)])
def test_i2t_bwd_mma_passes_on_card(cuda_device, pb, n_tok, m):
    """The bf16 K4 backward's row pass (``i2t_bwd_rows``) against its plain
    twin, and its weight pass (``i2t_bwd_dw``) against its twin on the
    same scratch rows (products exact, f32 summation order: 1e-4 of max
    |dW|), on a ragged m (m = 5: fewer rows than one weight-pass stage);
    both the same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    bf = torch.bfloat16
    r = lambda *s, k=0.2, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    f32, b = torch.float32, 2
    args = (r(b, m, 256, k=1.0), r(1, m, 256, k=1.0),
            r(b * pb, n_tok, 128, k=1.0), r(b * pb, n_tok, 128, k=1.0),
            r(256, 128), r(128, dt=f32), r(128, 256), r(256, dt=f32),
            1 + r(256, k=0.1, dt=f32), r(256, dt=f32))
    dy = r(b * pb, m, 256, k=1.0)
    kw = dict(nh=8, pb=pb, eps=1e-6)
    before = dict(i2t.LAUNCHES)
    rows = i2t.i2t_bwd_rows_cuda(*args, dy, **kw)
    scratch = (args[0], args[1], rows[1], rows[5], rows[6])
    dw = i2t.i2t_bwd_dw_cuda(*scratch, pb=pb)
    torch.cuda.synchronize()
    assert i2t.LAUNCHES["i2t_bwd"] == before["i2t_bwd"] + 1
    assert i2t.LAUNCHES["i2t_bwd_dw"] == before["i2t_bwd_dw"] + 1
    names = ("d_keys", "d_qpre", "p", "d_score", "d_out", "out_rows",
             "dres_rows", "dbq", "dbo", "dg", "dbt")
    want = i2t.i2t_bwd_rows_plain(*args, dy, **kw)
    for name, a, w in zip(names, rows, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[bf], name)
    for name, a, w in zip(("dWq", "dWo"), dw,
                          i2t.i2t_bwd_dw_plain(*scratch, pb=pb)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[f32], name)
    assert _same_bits(rows, i2t.i2t_bwd_rows_cuda(*args, dy, **kw))
    assert _same_bits(dw, i2t.i2t_bwd_dw_cuda(*scratch, pb=pb))


@pytest.mark.gpu
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 4096), (8, 7, 4096),
                                        (1, 1, 100), (8, 8, 37),
                                        (2, 3, 64), (1, 5, 129)])
def test_i2t_bwd_rows_wgmma_on_card(cuda_device, pb, n_tok, m):
    """The bf16 row pass on wgmma and TMA (``i2t_bwd_rows_wgmma_kernel``)
    against ``i2t_bwd_rows_plain`` at 16 pairs of the training shape (64
    rows a unit: 1024 units) and on small ragged shapes, pb 1 and 8, 1-8
    tokens: every output within ``K34_TOL`` (bf16) of its scale (the
    column sums against the twin's own), at least 99.5% of each
    bf16 row output bit-equal to the twin's (as the K4 forward's), and the
    same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    r = lambda *s, k=0.2, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    bp = 16 if m == 4096 else 8
    args = (r(bp // pb, m, 256, k=1.0), r(1, m, 256, k=1.0),
            r(bp, n_tok, 128, k=1.0), r(bp, n_tok, 128, k=1.0),
            r(256, 128, k=0.06), r(128, dt=f32), r(128, 256, k=0.09),
            r(256, dt=f32), 1 + r(256, k=0.1, dt=f32), r(256, dt=f32))
    dy = r(bp, m, 256, k=1.0)
    kw = dict(nh=8, pb=pb, eps=1e-6)
    before = i2t.LAUNCHES["i2t_bwd"]
    rows = i2t.i2t_bwd_rows_cuda(*args, dy, **kw)
    torch.cuda.synchronize()
    assert i2t.LAUNCHES["i2t_bwd"] == before + 1
    want = i2t.i2t_bwd_rows_plain(*args, dy, **kw)
    names = ("d_keys", "d_qpre", "p", "d_score", "d_out", "out_rows",
             "dres_rows", "dbq", "dbo", "dg", "dbt")
    for name, a, w in zip(names, rows, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[bf], name)
        if a.dtype == bf:
            same = float((a == w).float().mean())
            assert same >= 0.995, f"{name}: {same:.4f} bit-equal"
    assert _same_bits(rows, i2t.i2t_bwd_rows_cuda(*args, dy, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 37, 4), (5, 64, 3),
                                        (2, 5, 1), (4, 4096, 1),
                                        (3, 129, 2), (200, 64, 4)])
def test_upscale_bwd_mma_passes_on_card(cuda_device, bp, m, n_out):
    """The bf16 K3 backward's row pass on wgmma and TMA
    (``upscale_bwd_rows_wgmma_kernel``, 64 rows a unit; 200 units of 64
    rows spread over more than one unit a block) against its plain twin
    (``K34_TOL``: 2e-2 of each output's max), and its weight pass
    (``upscale_bwd_dw``) against its twin on the same scratch rows (1e-4 of
    max |dW|), on ragged m and 1-4 mask tokens; both the same bits on a
    second call."""
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    r = lambda *s, k=0.3, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    args = (r(bp, m, 256, k=1.0), r(256, 2, 2, 64), r(64, dt=f32),
            1 + r(64, k=0.1, dt=f32), r(64, dt=f32), r(64, 2, 2, 32),
            r(32, dt=f32), r(bp, n_out, 32, k=1.0))
    dm = r(bp, m, n_out * 16, k=1.0, dt=f32)
    before = dict(up_op.LAUNCHES)
    rows = up_op.upscale_bwd_rows_cuda(args[0], dm, *args[1:])
    scratch = (args[0],) + rows[1:4]
    dw = up_op.upscale_bwd_dw_cuda(*scratch)
    torch.cuda.synchronize()
    assert up_op.LAUNCHES["upscale_bwd"] == before["upscale_bwd"] + 1
    assert up_op.LAUNCHES["upscale_bwd_dw"] == before["upscale_bwd_dw"] + 1
    names = ("d_up", "u1g_rows", "d2_rows", "du1_rows", "db1", "dg", "dbt",
             "db2", "d_hyper")
    want = up_op.upscale_bwd_rows_plain(args[0], dm, *args[1:])
    for name, a, w in zip(names, rows, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[bf], name)
    for name, a, w in zip(("dW1", "dW2"), dw,
                          up_op.upscale_bwd_dw_plain(*scratch)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[f32], name)
    assert _same_bits(rows, up_op.upscale_bwd_rows_cuda(args[0], dm,
                                                        *args[1:]))
    assert _same_bits(dw, up_op.upscale_bwd_dw_cuda(*scratch))


@pytest.mark.gpu
def test_k3_k4_refuse_other_widths(cuda_device):
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    z = lambda *s: torch.zeros(s, device=cuda_device)
    with pytest.raises(NotImplementedError, match="C = 256"):
        up_op.upscale_fwd_cuda(z(1, 4, 64), z(64, 2, 2, 16), z(16), z(16),
                               z(16), z(16, 2, 2, 8), z(8), z(1, 1, 8))
    with pytest.raises(NotImplementedError, match="heads"):
        i2t.i2t_fwd_cuda(z(1, 4, 256), z(1, 4, 256), z(1, 7, 128),
                         z(1, 7, 128), z(256, 128), z(128), z(128, 256),
                         z(256), z(256), z(256), nh=4, pb=1, eps=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 100), (8, 5, 37), (8, 7, 64),
                                        (2, 8, 130), (1, 1, 5)])
def test_i2t_tf32_launches_on_card(cuda_device, pb, n_tok, m):
    """The f32 K4 in split TF32: the forward (``i2t_fwd_tf32_kernel``), the
    row pass and the weight pass each against its plain twin (K34_TOL: 1e-4
    of max |plain|; the weight pass on the row pass's own scratch rows), on
    ragged m and with the pb = 8 shared first layer; the same bits on a
    second call; m = 5 leaves three of a super-tile's four slots empty."""
    from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as i2t

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    f32, b = torch.float32, 2
    r = lambda *s, k=0.2: torch.randn(s, generator=gen,
                                      device=cuda_device) * k
    args = (r(b, m, 256, k=1.0), r(1, m, 256, k=1.0),
            r(b * pb, n_tok, 128, k=1.0), r(b * pb, n_tok, 128, k=1.0),
            r(256, 128), r(128), r(128, 256), r(256), 1 + r(256, k=0.1),
            r(256))
    dy = r(b * pb, m, 256, k=1.0)
    kw = dict(nh=8, pb=pb, eps=1e-6)
    before = dict(i2t.LAUNCHES)
    y = i2t.i2t_fwd_cuda(*args, **kw)
    rows = i2t.i2t_bwd_rows_cuda(*args, dy, **kw)
    scratch = (args[0], args[1], rows[1], rows[5], rows[6])
    dw = i2t.i2t_bwd_dw_cuda(*scratch, pb=pb)
    torch.cuda.synchronize()
    assert {k: i2t.LAUNCHES[k] - before[k] for k in before} == {
        "i2t_fwd": 1, "i2t_bwd": 1, "i2t_bwd_dw": 1}
    _rel_close(y, i2t.i2t_fwd_plain(*args, **kw), K34_TOL[f32], "y")
    names = ("d_keys", "d_qpre", "p", "d_score", "d_out", "out_rows",
             "dres_rows", "dbq", "dbo", "dg", "dbt")
    for name, a, w in zip(names, rows,
                          i2t.i2t_bwd_rows_plain(*args, dy, **kw)):
        assert a.shape == w.shape and a.dtype == w.dtype == f32, name
        _rel_close(a, w, K34_TOL[f32], name)
    for name, a, w in zip(("dWq", "dWo"), dw,
                          i2t.i2t_bwd_dw_plain(*scratch, pb=pb)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[f32], name)
    assert torch.equal(y, i2t.i2t_fwd_cuda(*args, **kw))
    assert _same_bits(rows, i2t.i2t_bwd_rows_cuda(*args, dy, **kw))
    assert _same_bits(dw, i2t.i2t_bwd_dw_cuda(*scratch, pb=pb))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 37, 4), (5, 64, 3),
                                        (2, 130, 2), (2, 5, 1)])
def test_upscale_tf32_launches_on_card(cuda_device, bp, m, n_out):
    """The f32 K3 in split TF32: the forward (``upscale_fwd_tf32_kernel``),
    the row pass and the weight pass each against its plain twin (1e-4 of
    max |plain|; the weight pass on the row pass's own scratch rows), on
    ragged m and 1-4 mask tokens; the same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    f32 = torch.float32
    r = lambda *s, k=0.3: torch.randn(s, generator=gen,
                                      device=cuda_device) * k
    args = (r(bp, m, 256, k=1.0), r(256, 2, 2, 64), r(64), 1 + r(64, k=0.1),
            r(64), r(64, 2, 2, 32), r(32), r(bp, n_out, 32, k=1.0))
    dm = r(bp, m, n_out * 16, k=1.0)
    bw = (args[0], dm) + args[1:]
    before = dict(up_op.LAUNCHES)
    out = up_op.upscale_fwd_cuda(*args)
    rows = up_op.upscale_bwd_rows_cuda(*bw)
    scratch = (args[0],) + rows[1:4]
    dw = up_op.upscale_bwd_dw_cuda(*scratch)
    torch.cuda.synchronize()
    assert {k: up_op.LAUNCHES[k] - before[k] for k in before} == {
        "upscale_fwd": 1, "upscale_bwd": 1, "upscale_bwd_dw": 1}
    _rel_close(out, up_op.upscale_fwd_plain(*args), K34_TOL[f32], "masks")
    names = ("d_up", "u1g_rows", "d2_rows", "du1_rows", "db1", "dg", "dbt",
             "db2", "d_hyper")
    for name, a, w in zip(names, rows, up_op.upscale_bwd_rows_plain(*bw)):
        assert a.shape == w.shape and a.dtype == w.dtype == f32, name
        _rel_close(a, w, K34_TOL[f32], name)
    for name, a, w in zip(("dW1", "dW2"), dw,
                          up_op.upscale_bwd_dw_plain(*scratch)):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        _rel_close(a, w, K34_TOL[f32], name)
    assert torch.equal(out, up_op.upscale_fwd_cuda(*args))
    assert _same_bits(rows, up_op.upscale_bwd_rows_cuda(*bw))
    assert _same_bits(dw, up_op.upscale_bwd_dw_cuda(*scratch))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (3, 100, 4),
                                        (2, 100, 2), (2, 4096, 1),
                                        (2, 4096, 3), (5, 4096, 4)])
def test_upscale_fwd_wgmma_on_card(cuda_device, bp, m, n_out):
    """The bf16 K3 forward on wgmma and TMA (``upscale_fwd_wgmma_kernel``, on
    the units of ``upscale_fwd_plan_bf16``) against ``upscale_fwd_plain``
    (K34_TOL: 2e-2 of max |out|) at M = 100 (a ragged last unit) and 4096,
    1-4 mask tokens; one launch, and the same bits on a second call."""
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(25)
    bf, f32 = torch.bfloat16, torch.float32
    r = lambda *s, k=1.0, dt=bf: (torch.randn(
        s, generator=gen, device=cuda_device) * k).to(dt)
    args = (r(bp, m, 256), r(256, 2, 2, 64, k=0.06), r(64, k=0.1, dt=f32),
            1 + r(64, k=0.1, dt=f32), r(64, k=0.1, dt=f32),
            r(64, 2, 2, 32, k=0.12), r(32, k=0.1, dt=f32), r(bp, n_out, 32))
    before = up_op.LAUNCHES["upscale_fwd"]
    got = up_op.upscale_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert up_op.LAUNCHES["upscale_fwd"] == before + 1
    want = up_op.upscale_fwd_plain(*args)
    assert got.shape == want.shape == (bp, m, n_out * 16)
    assert got.dtype == want.dtype == f32
    _rel_close(got, want, K34_TOL[bf], "masks")
    assert torch.equal(got, up_op.upscale_fwd_cuda(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m", [(8, 37),      # 296 rows: 16-row chunks
                                  (1, 15),      # a lone chunk of 15 rows
                                  (3, 100),     # 300 rows, a short last one
                                  (16, 521),    # 8336 rows, 66 chunks
                                  (4, 4096)])   # 16384 rows, the pairs' m
def test_upscale_dw_tf32_wgmma_on_card(cuda_device, bp, m):
    """The f32 K3 weight pass on TF32 wgmma and TMA
    (``upscale_bwd_dw_tf32_kernel``) against ``upscale_bwd_dw_plain`` on
    the chunks of ``upscale_dw_plan_f32`` (1e-4 of max |plain|), on row
    counts that are no multiple of its 16-row stage and a lone chunk
    shorter than one stage; one launch, and the same bits on a second
    call."""
    from dilabhelmholtzoct_tpu_torch import kernels
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.ops import upscaler as up_op

    gen = torch.Generator(device=cuda_device).manual_seed(19)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)
    scratch = (r(bp, m, 256), r(bp, m, 256), r(bp, m, 512), r(bp, m, 256))
    plan = up_op.upscale_dw_plan_f32(bp * m, kernels.sm_count(cuda_device))
    with full_fp32():
        before = up_op.LAUNCHES["upscale_bwd_dw"]
        got = up_op.upscale_bwd_dw_cuda(*scratch)
        torch.cuda.synchronize()
        assert up_op.LAUNCHES["upscale_bwd_dw"] == before + 1
        want = up_op.upscale_bwd_dw_plain(*scratch, parts=len(plan.chunks))
        for name, a, w in zip(("dW1", "dW2"), got, want):
            assert a.shape == w.shape and a.dtype == w.dtype, name
            _rel_close(a, w, K34_TOL[torch.float32], name)
        assert _same_bits(got, up_op.upscale_bwd_dw_cuda(*scratch))


# ---------------------------------------------------------------------------
# T1 / T2, the topological loss's pairing and matching (csrc/topology.cu),
# against their plain twins (ops/topology_ref.py) and the host library
# (ops/native.py, g++): the kernels' block-parallel phases
# (csrc/persistence_parallel.h) give the results of the host's sequential
# algorithm (csrc/persistence_core.h), so the bars are equal index for index
# and in the same order, and the matching is the host library's; against
# the twin (scipy) the matching cost per row holds within rtol 1e-6 (another
# matching of equal cost may be picked). Plateaus, thin grids, the cap and
# exact cost ties are where a parallel pairing or matching could go astray.
# ---------------------------------------------------------------------------


def _sigmoid_noise(rng, n, h=50, w=50):
    return (1 / (1 + np.exp(-rng.normal(size=(n, h, w))))).astype(np.float32)


def _quantized(x, step=0.25):
    """Few distinct values: equal costs in T2, equal persistences in T1."""
    return (np.round(x / step) * step).astype(np.float32)


TOPO_GRIDS = {
    # case: (grids from a seeded rng, max_bars)
    "noise_64x50x50": (lambda rng: _sigmoid_noise(rng, 64), 512),
    "one_grid": (lambda rng: _sigmoid_noise(rng, 1), 512),
    "plateaus": (lambda rng: (np.round(rng.random((6, 30, 20)) * 3) / 3)
                 .astype(np.float32), 512),
    # near-binary plateaus (many basins, few bars) and the step's true
    # grids: binary masks through the loss's downsample
    "blobs_plateaus": (lambda rng: _blobs(rng, 8), 512),
    "downsampled_mask": (lambda rng: _downsampled_mask(rng, 8), 512),
    "saturated": (lambda rng: np.minimum(
        _sigmoid_noise(rng, 4) * 1.5, 1.0).astype(np.float32), 512),
    "constant": (lambda rng: np.full((3, 12, 12), 0.5, np.float32), 512),
    "thin": (lambda rng: rng.random((4, 1, 37)).astype(np.float32), 512),
    "thin_column": (lambda rng: rng.random((4, 50, 1)).astype(np.float32),
                    512),
    # above the cap: the kept bars and their order decided by kept_before,
    # ties of equal persistence included (quantized values)
    "above_cap": (lambda rng: _sigmoid_noise(rng, 8), 64),
    "above_cap_512": (lambda rng: _sigmoid_noise(rng, 4, 72, 72), 512),
    "above_cap_ties": (lambda rng: (np.round(rng.random((8, 40, 40)) * 6)
                                    / 6).astype(np.float32), 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("feat_d", [0, 1])
@pytest.mark.parametrize("case", sorted(TOPO_GRIDS))
def test_cubical_pairs_on_card(cuda_device, case, feat_d):
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    make, k = TOPO_GRIDS[case]
    grids = make(np.random.default_rng(sorted(TOPO_GRIDS).index(case)))
    g = torch.tensor(grids, device=cuda_device)
    before = ptd.LAUNCHES["cubical_pairs"]
    got = ptd.device_cubical_pairs(g, feat_d, k)
    torch.cuda.synchronize()
    assert ptd.LAUNCHES["cubical_pairs"] == before + 1
    twin = ptd.cubical_pairs_plain(torch.tensor(grids), feat_d, k)
    host = native.cubical_pairs_batch(grids, k)
    want_host = (host[f"h{feat_d}_birth"], host[f"h{feat_d}_death"],
                 host["counts"][:, feat_d])
    for a, b, c in zip(got, twin, want_host):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
        np.testing.assert_array_equal(a.cpu().numpy(), c)
    if case.startswith("above_cap"):
        assert int(got[2].min()) == k  # the cap did act
    assert all(torch.equal(a, b) for a, b in zip(
        got, ptd.device_cubical_pairs(g, feat_d, k)))


def _row_costs(flat, pb, pd, matched, target, const_term, q=2.0):
    flat = flat.double().cpu()
    pb, pd = pb.long().cpu(), pd.long().cpu()
    valid = pb >= 0
    b = flat.gather(1, pb.clamp(min=0))
    d = flat.gather(1, pd.clamp(min=0))
    t = target.double().cpu()
    cm = torch.maximum((b - t[..., 0]).abs(), (d - t[..., 1]).abs()) ** q
    cd = ((d - b).abs() / 2) ** q
    cost = torch.where(matched.cpu().bool() & valid, cm,
                       torch.where(valid, cd, 0.0))
    return (cost.sum(1) + const_term.double().cpu()).numpy()


def _blob_targets(rng, n, h=50, w=50):
    """Near-binary ground truth: rings (one H1 bar each) and blobs."""
    out = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y, x = rng.integers(5, h // 2, 2)
        out[i, y:y + 18, x:x + 18] = 1.0
        if i % 2:
            out[i, y + 6:y + 12, x + 6:x + 12] = 0.0  # a hole
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("feat_d", [0, 1])
@pytest.mark.parametrize("n,true_kind,q", [(64, "blobs", 2.0),
                                           (1, "blobs", 2.0),
                                           (8, "noise", 2.0),
                                           (8, "blobs", 1.0),
                                           (8, "ties", 2.0),
                                           (8, "ties", 1.0),
                                           (8, "empty", 2.0)])
def test_wasserstein_match_on_card(cuda_device, n, true_kind, q, feat_d):
    """T2 on the pairing of pred noise grids against ground-truth-like
    targets (or noise, both diagrams large, so rows of either orientation;
    or quantized noise against quantized noise, exact cost ties; or empty
    targets, no true bar), as ``device_pairing`` calls it."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    rng = np.random.default_rng(n + feat_d)
    pred = _sigmoid_noise(rng, n)
    true = {"blobs": lambda: _blob_targets(rng, n),
            "noise": lambda: _sigmoid_noise(rng, n),
            "ties": lambda: _quantized(_sigmoid_noise(rng, n)),
            "empty": lambda: np.zeros((n, 50, 50), np.float32)}[true_kind]()
    if true_kind == "ties":
        pred = _quantized(pred)
    sp = torch.tensor(pred, device=cuda_device)
    st = torch.tensor(true, device=cuda_device)
    b, d, c = ptd.device_cubical_pairs(torch.cat([sp, st]), feat_d)
    flat_t = st.reshape(n, -1)
    true_bars = torch.stack([flat_t.gather(1, b[n:].clamp(min=0).long()),
                             flat_t.gather(1, d[n:].clamp(min=0).long())],
                            -1).contiguous()
    args = (sp.reshape(n, -1).contiguous(), b[:n], d[:n], c[:n], true_bars,
            c[n:].clone())  # a slice at row n is not 16-byte aligned
    before = ptd.LAUNCHES["wasserstein_match"]
    got = ptd.wasserstein_match_cuda(*args, q)
    torch.cuda.synchronize()
    assert ptd.LAUNCHES["wasserstein_match"] == before + 1
    assert all(torch.equal(x, y)
               for x, y in zip(got, ptd.wasserstein_match_cuda(*args, q)))
    twin = ptd.wasserstein_match_plain(*(a.cpu() for a in args), q)
    np.testing.assert_allclose(_row_costs(args[0], b[:n], d[:n], *got, q),
                               _row_costs(args[0], b[:n], d[:n], *twin, q),
                               rtol=1e-6)
    nt = c[n:].cpu().numpy()
    host = native.wasserstein_match_batch(
        args[0].cpu().numpy(), b[:n].cpu().numpy(), d[:n].cpu().numpy(),
        c[:n].cpu().numpy(), [true_bars[i, :nt[i]].cpu().numpy()
                              for i in range(n)], q, b.shape[1])
    for x, y in zip(got, host):
        np.testing.assert_array_equal(x.cpu().numpy(), y)
    if true_kind == "empty":
        assert not got[0].any() and not got[2].any()


def _noise_and_blobs(rng, size):
    """4 grids of sigmoid noise, then 4 of blobs, size x size."""
    return np.concatenate([_sigmoid_noise(rng, 4, size, size),
                           _blobs(rng, 4, size, size)])


@pytest.mark.gpu
@pytest.mark.parametrize("feat_d", [0, 1])
@pytest.mark.parametrize("size", [100, 128, 182, 255])
def test_cubical_pairs_global_route_on_card(cuda_device, size, feat_d):
    """Grids past one block's shared memory take T1's global route (its
    arrays in a global scratch buffer; int32 slots from 182x182): one
    launch, the bars, counts and cap equal to the host library's, the same
    bits on a second run."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    grids = _noise_and_blobs(np.random.default_rng(size + feat_d), size)
    g = torch.tensor(grids, device=cuda_device)
    assert ptd.t1_scratch_bytes(size, size, feat_d) > 0
    before = dict(ptd.T1_ROUTES)
    got = ptd.device_cubical_pairs(g, feat_d)
    torch.cuda.synchronize()
    assert ptd.T1_ROUTES == {"shared": before["shared"],
                             "global": before["global"] + 1}
    host = native.cubical_pairs_batch(grids, ptd.MAX_BARS)
    for a, b in zip(got, (host[f"h{feat_d}_birth"], host[f"h{feat_d}_death"],
                          host["counts"][:, feat_d])):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    assert int(got[2][:4].min()) == ptd.MAX_BARS  # noise: the cap acts
    assert all(torch.equal(a, b) for a, b in zip(
        got, ptd.device_cubical_pairs(g, feat_d)))


@pytest.mark.gpu
@pytest.mark.parametrize("feat_d", [0, 1])
def test_cubical_pairs_shared_route_on_card(cuda_device, feat_d):
    """A 50x50 grid (the loss's default topo_interp) keeps T1's
    shared-memory route, equal to the host library."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    grids = _noise_and_blobs(np.random.default_rng(feat_d), 50)
    assert ptd.t1_scratch_bytes(50, 50, feat_d) == 0
    before = dict(ptd.T1_ROUTES)
    got = ptd.device_cubical_pairs(torch.tensor(grids, device=cuda_device),
                                   feat_d)
    torch.cuda.synchronize()
    assert ptd.T1_ROUTES == {"shared": before["shared"] + 1,
                             "global": before["global"]}
    host = native.cubical_pairs_batch(grids, ptd.MAX_BARS)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  host[f"h{feat_d}_birth"])
    np.testing.assert_array_equal(got[2].cpu().numpy(),
                                  host["counts"][:, feat_d])


@pytest.mark.gpu
def test_wasserstein_match_512_a_side_on_card(cuda_device):
    """T2 on the H1 bars of 255x255 noise grids, 512 a side (the cap):
    its scratch does not grow with the grid; the matching equals the host
    library's and its cost the twin's within rtol 1e-6."""
    from dilabhelmholtzoct_tpu_torch.ops import native
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    g = torch.tensor(_sigmoid_noise(np.random.default_rng(9), 8, 255, 255),
                     device=cuda_device)
    b, d, c = ptd.device_cubical_pairs(g, 1)
    assert int(c.min()) == 512
    flat_t = g[4:].reshape(4, -1)
    true_bars = torch.stack([flat_t.gather(1, b[4:].long()),
                             flat_t.gather(1, d[4:].long())], -1).contiguous()
    args = (g[:4].reshape(4, -1).contiguous(), b[:4].contiguous(),
            d[:4].contiguous(), c[:4].clone(), true_bars, c[4:].clone())
    got = ptd.wasserstein_match_cuda(*args, 2.0)
    torch.cuda.synchronize()
    host = native.wasserstein_match_batch(
        *(a.cpu().numpy() for a in args[:4]),
        [t.cpu().numpy() for t in true_bars], 2.0, 512)
    for x, y in zip(got, host):
        np.testing.assert_array_equal(x.cpu().numpy(), y)
    twin = ptd.wasserstein_match_plain(*(a.cpu() for a in args), 2.0)
    np.testing.assert_allclose(_row_costs(args[0], b[:4], d[:4], *got),
                               _row_costs(args[0], b[:4], d[:4], *twin),
                               rtol=1e-6)


@pytest.mark.gpu
def test_topology_kernels_refuse_beyond_shared_memory(cuda_device):
    """What cannot run is refused before any launch, and nothing is
    counted: a T1 grid past JAX's capacity of 65534 cells (ValueError; a
    200x200 grid runs, on the global route), and a T2 operand past one
    block's shared memory (NotImplementedError)."""
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    before = dict(ptd.LAUNCHES)
    with pytest.raises(ValueError, match="65534 cells"):
        ptd.device_cubical_pairs(
            torch.zeros((1, 256, 256), device=cuda_device), 1)
    k = 4096
    idx = torch.zeros((1, k), dtype=torch.int32, device=cuda_device)
    cnt = torch.ones((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="4096 pred"):
        ptd.wasserstein_match_cuda(
            torch.zeros((1, 64), device=cuda_device), idx, idx.clone(), cnt,
            torch.zeros((1, k, 2), device=cuda_device), cnt.clone(), 2.0)
    assert ptd.LAUNCHES == before
    ptd.cubical_pairs_cuda(torch.zeros((1, 200, 200), device=cuda_device), 1)
    assert ptd.LAUNCHES == {**before,
                            "cubical_pairs": before["cubical_pairs"] + 1}


@pytest.mark.gpu
def test_topo_loss_device_on_card(cuda_device):
    """``topo_loss_device`` on the card (T1 x1, T2 x1) against the host
    pairing's ``topo_loss`` on the same card tensors and against the CPU
    twin: loss rtol 2e-5, gradient rtol 1e-4 / atol 1e-6."""
    from dilabhelmholtzoct_tpu_torch.ops import topology as pt
    from dilabhelmholtzoct_tpu_torch.ops import topology_device as ptd

    rng = np.random.default_rng(3)
    pred = _sigmoid_noise(rng, 8, 64, 64).reshape(2, 4, 64, 64)
    true = _blob_targets(rng, 8, 64, 64).reshape(2, 4, 64, 64)
    cm = np.ones((2, 4), np.float32)
    cm[1, 3] = 0.0
    kw = dict(lamda=0.1, interp=50, feat_d=1, loss_q=2)
    out = {}
    for name, fn, dev in (("card", ptd.topo_loss_device, cuda_device),
                          ("host", pt.topo_loss, cuda_device),
                          ("cpu", ptd.topo_loss_device, "cpu")):
        p = torch.tensor(pred, device=dev, requires_grad=True)
        before = dict(ptd.LAUNCHES)
        loss = fn(p, torch.tensor(true, device=dev),
                  channel_mask=torch.tensor(cm, device=dev), **kw)
        loss.backward()
        launched = {k: v - before[k] for k, v in ptd.LAUNCHES.items()}
        assert launched == dict.fromkeys(
            launched, 1 if name == "card" else 0), (name, launched)
        out[name] = (float(loss), p.grad.cpu().numpy())
    for name in ("host", "cpu"):
        np.testing.assert_allclose(out["card"][0], out[name][0], rtol=2e-5)
        np.testing.assert_allclose(out["card"][1], out[name][1], rtol=1e-4,
                                   atol=1e-6)


def _small_encoder_vitb_decoder():
    """The test-size encoder (3 layers of 4 heads of 16: K6) in front of
    ViT-B's prompt encoder and decoder (256 wide, 8 heads: the widths the
    bf16 K4 kernels take) on an 8x8 grid."""
    import dataclasses

    from dilabhelmholtzoct_tpu_torch.models.configs import (sam_tiny,
                                                            sam_vit_base)

    base, tiny = sam_vit_base(), sam_tiny()
    return dataclasses.replace(
        base, vision=dataclasses.replace(tiny.vision, output_channels=256),
        prompt=dataclasses.replace(base.prompt, image_embedding_size=8,
                                   input_image_size=128))


@pytest.mark.gpu
def test_mask_inputs_on_card(cuda_device):
    """``embed_mask_input`` (cuDNN convs under ``full_fp32``) and
    ``sam_forward(mask_inputs=)`` at ``_small_encoder_vitb_decoder`` (K6
    for the 3 encoder layers) on the card against the CPU, f32: the dense
    embedding within 1e-5, the masks within atol 3e-4 / rtol 1e-3 (the
    port's sam_forward tolerance against JAX); a bf16 forward (K4 in the
    decoder) is finite."""
    from dilabhelmholtzoct_tpu_torch.device import full_fp32
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.models import sam as psam

    cfg = _small_encoder_vitb_decoder()
    sd = synthetic.random_params(cfg, seed=1)
    rng = np.random.default_rng(2)
    g = cfg.prompt.image_embedding_size
    masks = (rng.normal(size=(2, 4 * g, 4 * g, 1)) * 3).astype(np.float32)
    pix = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    boxes = rng.uniform(0, 120, (2, 1, 4)).astype(np.float32)
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        sdd = {k: v.to(dev) for k, v in sd.items()}
        with torch.no_grad(), full_fp32():
            dense = psam.embed_mask_input(sdd, torch.tensor(masks, device=dev),
                                          cfg)
            fwd = psam.sam_forward(sdd, cfg,
                                   pixel_values=torch.tensor(pix, device=dev),
                                   boxes=torch.tensor(boxes, device=dev),
                                   mask_inputs=torch.tensor(masks, device=dev))
        out[name] = (dense.cpu().numpy(), fwd["pred_masks"].cpu().numpy())
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out["card"][1], out["cpu"][1], atol=3e-4,
                               rtol=1e-3)
    sd16 = {k: v.to(cuda_device, torch.bfloat16) for k, v in sd.items()}
    with torch.no_grad():
        fwd16 = psam.sam_forward(
            sd16, cfg, pixel_values=torch.tensor(pix, device=cuda_device,
                                                 dtype=torch.bfloat16),
            boxes=torch.tensor(boxes, device=cuda_device),
            mask_inputs=torch.tensor(masks, device=cuda_device,
                                     dtype=torch.bfloat16))
    assert bool(torch.isfinite(fwd16["pred_masks"].float()).all())


@pytest.mark.gpu
def test_augmented_uncached_bf16_step_on_card(cuda_device):
    """One bf16 decoder step with the encoder inside (K6, and K4 in the
    decoder, at ``_small_encoder_vitb_decoder``) on a batch of an
    augmented, 'Jet'-coloured dataset, on the card
    and on the CPU from the same weights: the loss within 2e-2 relative and
    at least 90% of the moved decoder weights moved the same way
    (chip_smoke.py's STEP_LOSS_RTOL and SIGN_AGREE_MIN)."""
    from dilabhelmholtzoct_tpu_torch.data.augment import make_augmenter
    from dilabhelmholtzoct_tpu_torch.data.pipeline import (PromptedDataset,
                                                           batches)
    from dilabhelmholtzoct_tpu_torch.inference import synthetic
    from dilabhelmholtzoct_tpu_torch.train import trainer as tr

    cfg = _small_encoder_vitb_decoder()
    sd = synthetic.random_params(cfg, seed=3)
    items = [{"image": it["image"][:120, :128], "label": it["label"][:120, :128]}
             for it in synthetic.oct_training_items(2, seed=4)]
    ops = ("hflip", "vflip", "brightness", "contrast", "gaussian_noise",
           "shift")
    ds = PromptedDataset(items, pseudocolor="Jet", seed=5,
                         augment=make_augmenter(ops))
    batch = next(iter(batches(ds, 2, epoch=1, num_workers=1)))
    config = tr.TrainConfig(cache_embeddings=False, data_transforms=ops,
                            pseudocolor="Jet", evaluate=False)
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        decoder, frozen = tr._split_params({k: v.to(dev, copy=True)
                                            for k, v in sd.items()})
        for v in decoder.values():
            v.requires_grad_(True)
        before = {k: v.detach().clone() for k, v in decoder.items()}
        opt = tr.make_optimizer(config, decoder.values())
        step = tr.make_train_step(cfg, config, opt, (120, 128), False)
        db = {k: torch.as_tensor(batch[k]).to(dev)
              for k in ("image", "prompts", "comp_map", "channel_mask")}
        decoder, opt, loss = step(decoder, opt, frozen, db)
        out[name] = (float(loss), {k: (v.detach() - before[k]).cpu()
                                   for k, v in decoder.items()})
    (l_card, d_card), (l_cpu, d_cpu) = out["card"], out["cpu"]
    assert np.isfinite(l_card)
    assert abs(l_card - l_cpu) <= 2e-2 * abs(l_cpu), (l_card, l_cpu)
    agree = total = 0
    for k, dc in d_cpu.items():
        moved = dc.abs() > 1e-3 * config.learning_rate
        agree += int((torch.sign(dc) == torch.sign(d_card[k]))[moved].sum())
        total += int(moved.sum())
    assert total > 0 and agree / total >= 0.90, (agree, total)
