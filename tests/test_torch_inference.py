"""The slice as a whole: the port's SegmentationEngine(device="cpu") vs the
JAX SegmentationEngine on the same parameters, image and prompts, plus the
engine's cache, prompt parsing, app event and checkpoint loading.

Tolerance: probabilities atol 1e-4 (a whole encoder + decoder + postprocess
in another f32 summation order); binary masks equal except at pixels whose
probability lies within 1e-4 of the 0.5 threshold."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dilabhelmholtzoct_tpu.inference.engine import (
    SegmentationEngine as JaxEngine,
)
from dilabhelmholtzoct_tpu.models import configs as jconfigs
from dilabhelmholtzoct_tpu.models import sam as jsam
from dilabhelmholtzoct_tpu_torch.inference.app import segment_event
from dilabhelmholtzoct_tpu_torch.inference.engine import (
    SegmentationEngine,
    parse_image_prompter_points,
    point_marker,
)
from dilabhelmholtzoct_tpu_torch.models import configs as pconfigs
from dilabhelmholtzoct_tpu_torch.models.convert import (
    load_state_dict,
    params_from_jax,
)

TOL = 1e-4


def _cfg(m):
    """tests/test_attention.py's head_dim-64 config, window 3 (padded)."""
    return m.SamConfig(
        vision=m.VisionConfig(
            hidden_size=128, num_layers=2, num_heads=2, image_size=128,
            patch_size=16, window_size=3, global_attn_indexes=(1,),
            mlp_dim=128, output_channels=32),
        prompt=m.PromptConfig(hidden_size=32, image_embedding_size=8,
                              input_image_size=128),
        decoder=m.DecoderConfig(hidden_size=32, num_layers=2, num_heads=4,
                                mlp_dim=64, iou_head_hidden_dim=32),
        num_pos_feats=16,
    )


@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(1)
    t = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05).astype(
            np.float32),
        jsam.init_params(jax.random.PRNGKey(1), _cfg(jconfigs)))
    for lp in t["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (rng.normal(size=lp["attn"][key].shape)
                               * 0.2).astype(np.float32)
    return t


@pytest.fixture(scope="module")
def engines(tree):
    return (JaxEngine(jax.tree.map(jnp.asarray, tree), _cfg(jconfigs)),
            SegmentationEngine(params_from_jax(tree), _cfg(pconfigs),
                               device="cpu"))


@pytest.fixture
def engine(tree):
    return SegmentationEngine(params_from_jax(tree), _cfg(pconfigs),
                              device="cpu")


@pytest.mark.parametrize("prompt,kind", [
    ([10, 12, 50, 40], "bbox"),
    ([30, 20], "points"),
    ([[5, 5, 30, 30], [40, 10, 90, 50], [20, 30, 60, 60]], "bbox"),  # bucket 4
])
def test_segment_matches_jax_engine(engines, rng, prompt, kind):
    jeng, peng = engines
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    want_bin, want_p = jeng.segment(img, prompt, kind)
    got_bin, got_p = peng.segment(img, prompt, kind)
    n = len(np.atleast_2d(prompt))
    assert got_bin.shape == got_p.shape == (n, 64, 96)
    assert got_bin.dtype == np.uint8 and got_p.dtype == np.float32
    np.testing.assert_allclose(got_p, want_p, atol=TOL)
    near = np.abs(want_p - 0.5) <= TOL
    assert np.array_equal(got_bin[~near], want_bin[~near])


def test_segment_without_probs(engine, rng):
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    binary, probs = engine.segment(img, [10, 10, 50, 40], with_probs=False)
    assert probs is None and binary.shape == (1, 64, 96)
    assert set(np.unique(binary)) <= {0, 1}


def test_encoder_cache_is_lru(tree, rng):
    eng = SegmentationEngine(params_from_jax(tree), _cfg(pconfigs),
                             cache_size=2, device="cpu")
    a, b, c = (rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
               for _ in range(3))
    eng.segment(a, [1, 1, 20, 20])
    emb_a = next(iter(eng._cache.values()))
    eng.segment(a, [5, 5, 30, 30])
    assert len(eng._cache) == 1  # same image: no re-encode
    eng.segment(b, [1, 1, 20, 20])
    eng.segment(a, [2, 2, 9, 9])  # hit: a becomes most recent
    eng.segment(c, [1, 1, 20, 20])  # evicts b, not a
    assert len(eng._cache) == 2
    assert any(v is emb_a for v in eng._cache.values())
    # identical bytes under another shape are another image: a new entry,
    # which evicts the least recent (a)
    eng.segment(a.reshape(96, 64, 3), [1, 1, 20, 20])
    assert len(eng._cache) == 2
    assert not any(v is emb_a for v in eng._cache.values())


def test_parse_image_prompter_events():
    parsed = parse_image_prompter_points(
        [[10, 20, 1, 0, 0, 1], [10, 20, 1, 50, 60, 1]])
    assert parsed == [("points", [10, 20]), ("bbox", [10, 20, 50, 60])]


def test_point_marker():
    m = point_marker((32, 32), 5, 7)
    assert m[7, 5] == 1 and m[6, 4] == 1 and m[8, 6] == 1
    assert m.sum() == 9


def test_segment_event_mixed(engine, rng):
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    out_img, masks = segment_event(
        engine, {"image": img, "points": [[10, 20, 1, 0, 0, 1],
                                          [5, 5, 1, 40, 40, 1]]})
    assert out_img is img
    assert [label for _, label in masks] == ["point", "mask", "box", "mask"]
    assert masks[1][0].shape == (64, 96)


def test_segment_event_empty_inputs(engine):
    assert segment_event(engine, None) == (None, [])
    assert segment_event(engine, {"image": None, "points": None}) == (None, [])
    img = np.zeros((32, 32, 3), np.uint8)
    out_img, masks = segment_event(engine, {"image": img, "points": None})
    assert masks == [] and out_img is img


def test_engine_defaults_to_the_card(tree):
    """No device argument means cuda; with no card that is an error, never a
    silent move to the host."""
    sd, cfg = params_from_jax(tree), _cfg(pconfigs)
    if torch.cuda.is_available():
        assert SegmentationEngine(sd, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SegmentationEngine(sd, cfg)


def test_from_checkpoint_loads_pt(tree, tmp_path, rng):
    sd = params_from_jax(tree)
    path = str(tmp_path / "ft.pt")
    torch.save(sd, path)
    pconfigs.register_preset("torch-test-tiny", lambda: _cfg(pconfigs))
    eng = SegmentationEngine.from_checkpoint("torch-test-tiny", path,
                                             device="cpu")
    ref = SegmentationEngine(sd, _cfg(pconfigs), device="cpu")
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    assert np.array_equal(eng.segment(img, [10, 10, 50, 40])[1],
                          ref.segment(img, [10, 10, 50, 40])[1])


def test_load_state_dict_formats(tmp_path):
    lin = torch.nn.Linear(3, 2)
    pickled = str(tmp_path / "module.pth")
    torch.save(lin, pickled)  # a whole pickled module
    with pytest.raises(pickle.UnpicklingError):
        load_state_dict(pickled)  # refused unless opted in
    sd = load_state_dict(pickled, allow_pickled_module=True)
    assert torch.equal(sd["weight"], lin.weight.detach())
    try:
        from safetensors.torch import save_file
    except ImportError:
        return
    st = str(tmp_path / "w.safetensors")
    save_file({"a": torch.arange(4, dtype=torch.bfloat16)}, st)
    out = load_state_dict(st)
    assert out["a"].dtype == torch.float32 and out["a"].tolist() == [0, 1, 2, 3]
