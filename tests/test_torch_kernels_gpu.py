"""The port's CUDA kernels against their plain PyTorch versions on the same
card tensors: encoder attention K1 (global) and K2 (windowed) with their
logsumexp rows, its backward K5, the any-head-dim forward K6, the
image-layout windowed forward K7, the upscaler K3 and the image->token
attention K4 (their forwards on the tensor cores, bf16 and f32 in split
TF32; the backwards of both as their two launches, the row pass and the
weight pass, each against its plain twin); and one request through a small
engine on the card.

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
    """K5 (both kernels) against ``packed_attention_bwd_plain`` on the same
    (qkv, rel, dO, L, D), each output relative to its max |plain|."""
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
    the same bits on a second run (f32: the split-TF32 flash body, bf16:
    the mma kernel). bf16: the kernel rounds p against the running maximum
    of its key tiles, the plain version against the row maximum, so single
    roundings differ."""
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
@pytest.mark.parametrize("b,nh,hw", [(25, 12, (14, 14)),  # ViT-B windows
                                     (6, 2, (3, 3)),      # 9 keys of 16
                                     (5, 3, (4, 4)),      # one m16 tile
                                     (3, 2, (16, 16)),    # 256 keys, 16 tiles
                                     (2, 2, (9, 7))])     # 63 keys
def test_windowed_mma_kernel_on_card(cuda_device, b, nh, hw):
    """The bf16 K2 on the tensor cores (one block per window and head)
    against ``packed_attention_plain``: output within two bf16 ulps of its
    scale and the logsumexp rows within atol 2e-4; the LSE changes nothing,
    and a second run gives the same bits."""
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
    attention), and bit-equal to K2 on the partitioned windows of the same
    qkv: both run the same code once their rows are in shared memory."""
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
    assert torch.equal(got, k2)


# the f32 kernels on the tensor cores in split TF32: library -> kernels
TF32_KERNELS = {"attention": ("attn_global_tf32_kernel",
                              "attn_windowed_tf32_kernel"),
                "attention_bwd": ("attn_bwd_dq_tf32_kernel",
                                  "attn_bwd_dkv_tf32_kernel"),
                "attention_relpos": ("attn_relpos_tf32_kernel",),
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
    instructions (HMMA.1688.F32.TF32) in their SASS and use no local memory
    (no spills, no stack), from ``cuobjdump`` on the built library."""
    import subprocess

    from dilabhelmholtzoct_tpu_torch import kernels

    kernels.library(lib)  # built at first use
    path = str(kernels.library_path(lib))
    tool = kernels.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    usage = subprocess.run([tool, "-res-usage", path], capture_output=True,
                           text=True, check=True, timeout=300).stdout
    tf32, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            tf32[fn] = 0
        elif fn and "HMMA" in line and "TF32" in line:
            tf32[fn] += 1
    lines = usage.splitlines()
    for name in TF32_KERNELS[lib]:
        found = [f for f in tf32 if name in f]
        assert found, f"{name} is not in the SASS of {lib}"
        for f in found:
            assert tf32[f] > 0, f"{f}: no TF32 tensor-core instruction"
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
    from dilabhelmholtzoct_tpu_torch.models.configs import sam_tiny

    cfg = sam_tiny()
    sd = synthetic.random_params(cfg, seed=0)
    img = synthetic.oct_image(seed=0)[:120, :128]
    box = [20, 30, 90, 100]
    before = dict(port_attn.LAUNCHES)
    _, probs = SegmentationEngine(sd, cfg, device=cuda_device).segment(
        img, box, "bbox")
    launched = {k: v - before[k] for k, v in port_attn.LAUNCHES.items() if
                v != before[k]}
    assert launched == {"attn_relpos": 3}, launched
    _, want = SegmentationEngine(sd, cfg, device="cpu").segment(img, box,
                                                                "bbox")
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
@pytest.mark.parametrize("pb,n_tok,m", [(1, 7, 100), (8, 5, 37), (2, 8, 64)])
def test_i2t_fwd_mma_on_card(cuda_device, pb, n_tok, m):
    """The bf16 K4 forward on the tensor cores (``i2t_fwd_mma_kernel``)
    against ``i2t_fwd_plain`` (K34_TOL: 2e-2 of max |y|), on a ragged m,
    with the pb pairs of an image sharing one q projection; the same bits
    on a second call."""
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
    _rel_close(got, want, K34_TOL[bf], "y")
    assert torch.equal(got, i2t.i2t_fwd_cuda(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 37, 4), (5, 64, 3)])
def test_upscale_fwd_mma_on_card(cuda_device, bp, m, n_out):
    """The bf16 K3 forward on the tensor cores (``upscale_fwd_mma_kernel``)
    against ``upscale_fwd_plain`` (K34_TOL: 2e-2 of max |out|), on a ragged
    m and 1-4 mask tokens; the same bits on a second call."""
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
@pytest.mark.parametrize("bp,m,n_out", [(3, 100, 1), (2, 37, 4), (5, 64, 3),
                                        (2, 5, 1)])
def test_upscale_bwd_mma_passes_on_card(cuda_device, bp, m, n_out):
    """The bf16 K3 backward's row pass (``upscale_bwd_rows``) against its
    plain twin, and its weight pass (``upscale_bwd_dw``) against its twin
    on the same scratch rows (1e-4 of max |dW|), on a ragged m; both the
    same bits on a second call."""
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
