"""The port's CUDA attention kernels (K1 global, K2 windowed) against their
plain PyTorch version on the same card tensors.

Needs an NVIDIA card and nvcc; skips without a card. This file imports
neither JAX nor tests/conftest.py's fixtures, so where JAX is not installed
it runs on its own:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances: f32 atol 1e-4, rtol 1e-3 (summation order over up to 4096
keys); bf16 atol 2e-2 (one bf16 rounding of the output)."""

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,hw", [(1, 12, (64, 64)),   # K1, ViT-B global
                                     (25, 12, (14, 14)),  # K2, ViT-B windows
                                     (3, 2, (9, 7)),      # K2, ragged 63 keys
                                     (2, 2, (20, 15))])   # K1, ragged tiles
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
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=1e-3)


@pytest.mark.gpu
def test_kernels_refuse_other_head_dims(cuda_device):
    qkv = torch.zeros((1, 16, 3 * 2 * 32), device=cuda_device)
    rel = torch.zeros((1, 2, 16, 4), device=cuda_device)
    with pytest.raises(NotImplementedError, match="K6"):
        port_attn.flash_attention_packed(qkv, rel, rel, hw=(4, 4), num_heads=2)
