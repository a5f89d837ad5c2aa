"""Port's image-layout windowed attention route (``set_fused_windowed('on')``
→ ``flash_attention_windowed_image``: K7 on the card, its plain version on
CPU tensors) vs the JAX package's, whose Pallas kernel runs in interpret
mode here as in tests/test_attention.py, through ``vision_layer`` on the same
layer parameters and input; and vs the port's own partitioned route.

Grids (28, 28) (whole windows of 14), (20, 20) and (28, 20) (tail windows
with pad tokens, which take the qkv bias row), with 2 heads and with 4 (two
head pairs for the TPU kernel). Tolerance atol 5e-5, rtol 1e-4:
tests/test_attention.py's own for the fused against the partitioned route."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models import sam as psam
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn

ATOL, RTOL = 5e-5, 1e-4
WS = 14
PREFIX = "layer"


def _layer(rng, heads):
    """One encoder layer's parameters: the JAX tree and the port's HF-named
    entries (weights transposed to (out, in))."""
    c = 64 * heads

    def lin(n_in, n_out):
        return {"w": (rng.normal(size=(n_in, n_out)) * 0.05).astype(np.float32),
                "b": (rng.normal(size=(n_out,)) * 0.05).astype(np.float32)}

    def ln():
        return {"scale": (1 + rng.normal(size=(c,)) * 0.05).astype(np.float32),
                "bias": (rng.normal(size=(c,)) * 0.05).astype(np.float32)}

    tree = {
        "ln1": ln(), "ln2": ln(),
        "attn": {"qkv": lin(c, 3 * c), "proj": lin(c, c),
                 "rel_pos_h": (rng.normal(size=(2 * WS - 1, 64)) * 0.2
                               ).astype(np.float32),
                 "rel_pos_w": (rng.normal(size=(2 * WS - 1, 64)) * 0.2
                               ).astype(np.float32)},
        "mlp1": lin(c, 2 * c), "mlp2": lin(2 * c, c),
    }
    sd = {}
    for name, key in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
        sd[f"{PREFIX}.{name}.weight"] = torch.tensor(tree[key]["scale"])
        sd[f"{PREFIX}.{name}.bias"] = torch.tensor(tree[key]["bias"])
    for name, p in (("attn.qkv", tree["attn"]["qkv"]),
                    ("attn.proj", tree["attn"]["proj"]),
                    ("mlp.lin1", tree["mlp1"]), ("mlp.lin2", tree["mlp2"])):
        sd[f"{PREFIX}.{name}.weight"] = torch.tensor(p["w"].T.copy())
        sd[f"{PREFIX}.{name}.bias"] = torch.tensor(p["b"])
    for key in ("rel_pos_h", "rel_pos_w"):
        sd[f"{PREFIX}.attn.{key}"] = torch.tensor(tree["attn"][key])
    return tree, sd


def _vcfg(m, heads):
    return m.VisionConfig(hidden_size=64 * heads, num_heads=heads,
                          window_size=WS, mlp_dim=128 * heads)


def _port_layer(x, sd, heads, mode):
    psam.set_fused_windowed(mode)
    try:
        return psam.vision_layer(torch.tensor(x), sd, PREFIX,
                                 _vcfg(pconfigs, heads), WS, fused_win=True)
    finally:
        psam.set_fused_windowed("auto")


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hw", [(28, 28), (20, 20), (28, 20)])
def test_fused_windowed_layer_matches_jax_interpret(rng, hw, heads):
    tree, sd = _layer(rng, heads)
    x = rng.normal(size=(2, *hw, 64 * heads)).astype(np.float32)
    jsam.set_flash_attention("interpret")
    jsam.set_fused_windowed("interpret")
    try:
        want = jsam.vision_layer(
            jnp.asarray(x), jax.tree.map(jnp.asarray, tree),
            _vcfg(jconfigs, heads), WS, fused_win=True)
    finally:
        jsam.set_flash_attention("auto")
        jsam.set_fused_windowed("auto")
    got = _port_layer(x, sd, heads, "on")
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hw", [(28, 28), (20, 20), (28, 20), (9, 31)])
def test_fused_windowed_layer_matches_partitioned(rng, hw, heads):
    """The port's two routes on the same layer: they differ only in the
    shapes of the qkv and output products (real tokens against padded
    windows), so in summation order."""
    _, sd = _layer(rng, heads)
    x = rng.normal(size=(2, *hw, 64 * heads)).astype(np.float32)
    want = _port_layer(x, sd, heads, "off")
    got = _port_layer(x, sd, heads, "on")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(_port_layer(x, sd, heads, "interpret"), got)
    assert torch.equal(_port_layer(x, sd, heads, "auto"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_image_plain_is_the_partitioned_attention(rng, dtype):
    """The wrapper on CPU tensors: the plain version, nothing launched; a pad
    token's q, k and v are the bias row (a window that reaches past the image
    differs from one cut off at its edge)."""
    b, heads, hw = 2, 2, (20, 17)
    c = 64 * heads
    qkv = torch.tensor(rng.normal(size=(b, *hw, 3 * c)) * 0.5, dtype=dtype)
    rel = torch.tensor(rng.normal(size=(b, heads, *hw, 2 * WS)) * 0.3,
                       dtype=dtype)
    bias = torch.tensor(rng.normal(size=(3 * c,)) * 0.5, dtype=dtype)
    port_attn.reset_launch_counts()
    got = port_attn.flash_attention_windowed_image(qkv, rel, bias, ws=WS,
                                                   num_heads=heads)
    assert not any(port_attn.LAUNCHES.values()), port_attn.LAUNCHES
    assert got.shape == (b, *hw, c) and got.dtype == dtype
    # by hand for the bottom-right window: 6 x 3 real tokens, the rest pad
    win = bias.expand(WS, WS, 3 * c).clone()
    win[:6, :3] = qkv[1, 14:, 14:]
    r = torch.zeros((heads, WS, WS, 2 * WS), dtype=dtype)
    r[:, :6, :3] = rel[1, :, 14:, 14:]
    r = r.reshape(1, heads, WS * WS, 2 * WS)
    want = port_attn.packed_attention_plain(
        win.reshape(1, WS * WS, 3 * c), r[..., :WS].contiguous(),
        r[..., WS:].contiguous(), hw=(WS, WS), num_heads=heads)
    want = want.reshape(WS, WS, c)[:6, :3]
    assert torch.equal(got[1, 14:, 14:], want)
    other = port_attn.flash_attention_windowed_image(
        qkv, rel, torch.zeros_like(bias), ws=WS, num_heads=heads)
    assert not torch.equal(other[1, 14:, 14:], want)
    assert torch.equal(other[:, :14, :14], got[:, :14, :14])


def test_fused_windowed_switch():
    """Modes as the JAX package's; off for a head dim other than 64 or an
    odd head count (the kernel's limits there)."""
    with pytest.raises(ValueError, match="mode"):
        psam.set_fused_windowed("fast")
    v64 = _vcfg(pconfigs, 2)
    v80 = pconfigs.VisionConfig(hidden_size=160, num_heads=2, window_size=WS)
    v_odd = pconfigs.VisionConfig(hidden_size=192, num_heads=3,
                                  window_size=WS)
    try:
        for mode, want in (("auto", False), ("off", False), ("on", True),
                           ("interpret", True)):
            psam.set_fused_windowed(mode)
            assert psam._use_fused_windowed(v64) is want, mode
            assert psam._use_fused_windowed(v80) is False
            assert psam._use_fused_windowed(v_odd) is False
    finally:
        psam.set_fused_windowed("auto")
    assert psam._FUSED_WINDOWED == "auto"


def test_windowed_image_refuses_gradients_and_bad_shapes(rng):
    qkv = torch.zeros((1, 4, 4, 3 * 128))
    rel = torch.zeros((1, 2, 4, 4, 8))
    bias = torch.zeros((3 * 128,))
    kw = dict(ws=4, num_heads=2)
    with pytest.raises(NotImplementedError, match="forward-only"):
        port_attn.flash_attention_windowed_image(
            qkv.clone().requires_grad_(True), rel, bias, **kw)
    with pytest.raises(ValueError, match="head_dim 64"):
        port_attn.flash_attention_windowed_image(qkv[..., :240], rel,
                                                 bias[:240], **kw)
    with pytest.raises(ValueError, match="rel must be"):
        port_attn.flash_attention_windowed_image(qkv, rel[..., :6], bias,
                                                 **kw)
    with pytest.raises(ValueError, match="more than"):
        port_attn.flash_attention_windowed_image(
            qkv, torch.zeros((1, 2, 4, 4, 34)), bias, ws=17, num_heads=2)
