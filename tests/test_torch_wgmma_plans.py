"""The launch plans of the kernels on wgmma and TMA, as pure functions
pinned on the CPU: ``ops.attention.relpos_plan`` (the bf16 K6, K1 and K2,
``csrc/attention_relpos_wgmma.cu``: key tile, ring depths, shared memory,
rounding point and passes), ``ops.attention.relpos_plan_f32`` (the f32 K6,
K1 and K2, ``csrc/attention_relpos_wgmma_tf32.cu``: mode, key tile, ring
depths, shared memory), ``ops.attention.dq_plan`` (K5's bf16 dq
kernel, ``csrc/attention_bwd.cu``: mode, key tile, ring depths and shared
memory), ``ops.attention.dq_plan_f32`` / ``dkv_plan_f32`` (K5's f32
kernels, ``csrc/attention_bwd_wgmma_tf32.cu``: mode, tiles, ring depths,
image and shared-memory bytes), ``ops.decoder_attn.dw_plan_f32`` / ``dw_plan_bf16`` (the K4
weight pass in both types: its row chunks and blocks) and
``ops.upscaler.upscale_dw_plan_f32`` (the f32 K3 weight pass: chunks,
units and their order, ring and blocks), with the order in which the
weight passes' plain twins sum those chunks, and
``ops.decoder_attn.rows_plan_bf16`` (the bf16 K4 row pass: units, ring,
blocks) with the column sums taken over its partials,
``ops.decoder_attn.fwd_plan_bf16`` (the bf16 K4 forward: units of an
image's rows with all of its pairs, ring, blocks) and
``ops.upscaler.rows_plan_bf16`` (the bf16 K3 row pass: units, ring,
blocks, shared memory) with its partials, and
``ops.upscaler.upscale_fwd_plan_bf16`` (the bf16 K3 forward). The
kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""

import pytest
import torch

from dilabhelmholtzoct_tpu_torch import kernels
from dilabhelmholtzoct_tpu_torch.ops import attention as port_attn
from dilabhelmholtzoct_tpu_torch.ops import decoder_attn as port_i2t
from dilabhelmholtzoct_tpu_torch.ops import upscaler as port_up

GRIDS_UP_TO_256 = [(h, w) for h in range(1, 257) for w in range(1, 257)
                   if h * w <= 256]


def _stage_bytes(dp, nk, h, w):
    """``wg::Layout`` written out: slabs of 64, then 32 and 16 columns,
    each padded to 1 KB; a unit stage holds Q (128 rows) and 128 rows of
    each bias factor (+ 16 elements of slack), a K / V stage K and V."""
    up = lambda x, m: -(-x // m) * m
    widths = [64] * (dp // 64) + [x for x in (32, 16) if dp % 64 & x]
    tile = lambda rows: sum(up(rows * x * 2, 1024) for x in widths)
    rel = up(2 * (128 * h + 16), 16) + up(2 * (128 * w + 16), 16)
    return tile(128) + rel, 2 * tile(nk)


@pytest.mark.parametrize("d", range(4, 129, 4))
def test_relpos_plan_every_head_dim_and_window(d):
    """Every head dim K6 takes (multiples of 4 up to 128) has a plan on
    every grid of N <= 256 tokens (the windowed route): the key tile is one
    whole window of 224 slots where the grid fits 14 x 16 cells (past
    dp = 80 tiles of 7 grid rows, with two K / V stages), two grid rows of
    64 where W = 64 and H is even, else tiles of 64; the rings fit in 227 KB with at least one stage each, and
    the shared memory is the layout's own sum."""
    dp = -(-d // 16) * 16
    for h, w in GRIDS_UP_TO_256:
        n = h * w
        plan = port_attn.relpos_plan(d, n, (h, w))
        assert plan.route == "windowed" and plan.dp == dp
        if h <= 14 and w <= 16:
            rows = 14 if dp <= 80 else 7
            assert (plan.nk, plan.tiles) == (16 * rows, -(-h // rows)), (h, w)
            assert plan.kv_stages >= 2 or plan.tiles == 1
        elif w == 64 and h % 2 == 0:
            assert (plan.nk, plan.tiles) == (128, n // 128), (h, w)
        else:
            assert (plan.nk, plan.tiles) == (64, -(-n // 64)), (h, w)
        unit, kv = _stage_bytes(dp, plan.nk, h, w)
        assert plan.smem == (1152 + plan.u_stages * unit
                             + plan.kv_stages * kv)
        assert plan.smem <= port_attn.SMEM_MAX
        assert 1 <= plan.kv_stages <= 4 and 1 <= plan.u_stages <= 2


@pytest.mark.parametrize("d,hw,want", [
    # ViT-H: a window of 14 x 14 (one tile, units double-buffered) and the
    # global layer of 64 x 64 (three K / V stages)
    (80, (14, 14), ("windowed", 80, 224, 1, 2, 2, 199936)),
    (80, (64, 64), ("global", 80, 128, 32, 3, 2, 230656)),
    # the widest head: windows in two tiles of 7 grid rows, three K / V
    # stages beside one unit stage; on the global layer two K / V stages
    (128, (14, 14), ("windowed", 128, 112, 2, 3, 1, 213184)),
    (128, (64, 64), ("global", 128, 128, 32, 2, 1, 197824)),
    # padded heads, a ragged global grid, the test-size model's layers
    (20, (30, 34), ("global", 32, 64, 16, 4, 2, 83200)),
    (16, (4, 4), ("windowed", 16, 224, 1, 2, 2, 42240)),
    (16, (8, 8), ("windowed", 16, 224, 1, 2, 2, 46336)),
    (112, (16, 16), ("windowed", 112, 64, 4, 4, 2, 189696)),
])
def test_relpos_plan_pinned(d, hw, want):
    """The plans of the main path's and the test shapes, pinned: route,
    columns, key tile, tiles per unit, K / V and unit stages, bytes."""
    p = port_attn.relpos_plan(d, hw[0] * hw[1], hw)
    assert (p.route, p.dp, p.nk, p.tiles, p.kv_stages, p.u_stages,
            p.smem) == want


# the main path's grids and the test shapes: ViT-B / L / H global and
# windowed, ragged N (200 = 10 x 20, 4095 = 63 x 65), a non-SAM grid, the
# test-size model's
F32_GRIDS = [(64, 64), (14, 14), (10, 20), (63, 65), (30, 34), (8, 8),
             (4, 4), (12, 10), (32, 64), (3, 64), (16, 16), (1, 256)]


def _f32_bytes(dp, mode):
    """``wt::Layout`` written out: (unit stage, K / V stage, V slot) bytes:
    Q of 128 rows (and for "row_tile" the unit's 128 rel_w rows of 64); K,
    its lo part and V^T's hi and lo parts of 32 key slots; V of 32 rows,
    f32 each."""
    return (128 * dp * 4 + (128 * 64 * 4 if mode == "row_tile" else 0),
            4 * 4 * 32 * dp, 4 * 32 * dp)


@pytest.mark.parametrize("d", range(4, 129, 4))
def test_relpos_plan_f32_every_head_dim(d):
    """Every head dim K6 takes (multiples of 4 up to 128) has an f32 plan on
    every grid of the main path and of the tests and on every grid of N <=
    256 tokens: "grid" where the grid fits 16 x 16 cells (tiles of 2 grid
    rows of 16 slots), "row_tile" where W = 64 (tiles of half a grid row),
    else "generic" (32 keys a tile); the rings fit in 227 KB, and the
    shared memory is the layout's own sum. A unit of fewer than 16 tiles (a
    window) takes two unit stages beside at least two K / V stages where
    they fit; a longer one the deepest K / V ring, one unit stage."""
    dp = -(-d // 16) * 16
    for h, w in F32_GRIDS + GRIDS_UP_TO_256:
        n = h * w
        plan = port_attn.relpos_plan_f32(d, n, (h, w))
        mode = ("grid" if h <= 16 and w <= 16 else
                "row_tile" if w == 64 else "generic")
        tiles = -(-h // 2) if mode == "grid" else -(-n // 32)
        assert (plan.mode, plan.dp, plan.tiles) == (mode, dp, tiles), (
            d, h, w)
        unit, stage, slot = _f32_bytes(dp, mode)
        assert plan.smem == (1280 + plan.u_stages * unit
                             + plan.kv_stages * stage
                             + plan.v_slots * slot), (d, h, w)
        assert plan.smem <= port_attn.SMEM_MAX
        assert 1 <= plan.kv_stages <= 4 and 1 <= plan.v_slots <= 2
        assert plan.kv_stages >= 2 or dp == 128, (d, h, w)
        if tiles >= 16:
            assert plan.u_stages == 1
            if plan.kv_stages < 4:  # a deeper ring would not fit
                assert (plan.smem + stage - (plan.v_slots - 1) * slot
                        > port_attn.SMEM_MAX), (d, h, w)
        elif plan.u_stages == 1:  # two unit stages would not fit
            assert (1280 + 2 * unit + 2 * stage + slot
                    > port_attn.SMEM_MAX), (d, h, w)


@pytest.mark.parametrize("d,hw,want", [
    # ViT-H: the global layer (three K / V stages beside the unit's Q and
    # rel_w rows) and the 14 x 14 window (seven tiles of 2 grid rows, the
    # next unit's Q landing beside)
    (80, (64, 64), ("row_tile", 80, 128, 3, 1, 2, 218368)),
    (80, (14, 14), ("grid", 80, 7, 3, 2, 2, 226560)),
    # ViT-B / ViT-L's K1: four K / V stages
    (64, (64, 64), ("row_tile", 64, 128, 4, 1, 2, 214272)),
    # the widest head: one K / V stage on the global grid, two on a window
    (128, (64, 64), ("row_tile", 128, 128, 1, 1, 2, 197888)),
    (128, (14, 14), ("grid", 128, 7, 2, 1, 2, 230656)),
    # padded heads, ragged N, a non-SAM grid, the test-size model's layers
    (20, (64, 64), ("row_tile", 32, 128, 4, 1, 2, 124160)),
    (48, (14, 14), ("grid", 48, 7, 3, 2, 2, 136448)),
    (32, (10, 20), ("generic", 32, 7, 3, 2, 2, 91392)),
    (64, (63, 65), ("generic", 64, 128, 4, 1, 2, 181504)),
    (112, (63, 65), ("generic", 112, 128, 2, 1, 2, 201984)),
    (80, (30, 34), ("generic", 80, 32, 4, 1, 2, 226560)),
    (16, (8, 8), ("grid", 16, 4, 3, 2, 2, 46336)),
    (16, (4, 4), ("grid", 16, 2, 3, 2, 2, 46336)),
])
def test_relpos_plan_f32_pinned(d, hw, want):
    """The f32 plans of the main path's and the test shapes, pinned: mode,
    columns, tiles per unit, K / V stages, unit stages, V slots, bytes."""
    p = port_attn.relpos_plan_f32(d, hw[0] * hw[1], hw)
    assert (p.mode, p.dp, p.tiles, p.kv_stages, p.u_stages, p.v_slots,
            p.smem) == want


@pytest.mark.parametrize("b,hw,want", [
    # ViT-B / L's windowed layers (25 windows of 14 x 14 an image) at B = 1
    # and the f32 full fine-tune's B = 4: seven tiles of 2 grid rows, three
    # K / V stages beside two unit stages; 2 units a (window, head)
    (25, (14, 14), ("grid", 64, 7, 3, 2, 2, 181504, 600)),
    (100, (14, 14), ("grid", 64, 7, 3, 2, 2, 181504, 2400)),
    # ragged windows: 9 keys in one tile, 9 x 7 in five, 16 x 16 in eight
    (6, (3, 3), ("grid", 64, 2, 3, 2, 2, 181504, 12)),
    (2, (9, 7), ("grid", 64, 5, 3, 2, 2, 181504, 4)),
    (3, (16, 16), ("grid", 64, 8, 3, 2, 2, 181504, 12)),
])
def test_relpos_plan_f32_of_the_k2_route(b, hw, want):
    """The f32 K2 runs on the f32 K6's kernel in its GRID mode: the plan of
    head dim 64 over SAM's window (B = 1 and 4: 25 and 100 windows, 12
    heads) and ragged windows, pinned (mode, columns, tiles, K / V stages,
    unit stages, V slots, bytes within 227 KB), and its units of 128 query
    rows, one persistent block an SM at most (132 on an H100)."""
    n, heads = hw[0] * hw[1], 12 if b >= 25 else 2
    p = port_attn.relpos_plan_f32(64, n, hw)
    units = b * heads * -(-n // 128)
    assert (p.mode, p.dp, p.tiles, p.kv_stages, p.u_stages, p.v_slots,
            p.smem, units) == want
    assert p.smem <= port_attn.SMEM_MAX == 232448
    assert port_attn.relpos_blocks(b, heads, n, 132) == min(units, 132)


def test_relpos_plan_f32_refuses_other_head_dims():
    """A head dim K6 does not take raises, in f32 as in bf16."""
    for d in (2, 6, 130, 132):
        with pytest.raises(NotImplementedError, match="K6"):
            port_attn.relpos_plan_f32(d, 196, (14, 14))


def _dq_stage_bytes(nk, h, w, generic):
    """``dq::Layout`` written out: a unit stage holds Q and dO (128 rows of
    64 bf16 each), L and D (128 f32 each) and, but for GENERIC (which reads
    the factors from device memory), 128 rows of each bias factor (+ 16
    elements of slack), padded to 1 KB; a K / V stage K and V of nk slots;
    GENERIC each warpgroup's bf16 ds tile (64 x 72), f32 dRh and dRw."""
    up = lambda x, m: -(-x // m) * m
    rel = 0 if generic else (up(2 * (128 * h + 16), 16)
                             + up(2 * (128 * w + 16), 16))
    sums = 2 * (64 * 72 * 2 + 4 * 64 * (h + w)) if generic else 0
    return up(2 * 16384 + 2 * 512 + rel, 1024), 2 * nk * 128, sums


def test_dq_plan_modes_and_bytes():
    """K5's bf16 dq kernel has a plan on every grid of N <= 256 tokens and
    on the global grids below: W = 64 a 64-key tile per grid row
    (ROW_TILE, any H); a window of at most 14 x 16 cells tiles of 7 grid
    rows of 16 slots (GRID, 112); else tiles of 64 keys (GENERIC). Two K /
    V stages at least where a unit has more than one tile, the rings in
    227 KB, and the shared memory the layout's own sum."""
    for h, w in GRIDS_UP_TO_256 + [(64, 64), (32, 64), (3, 64), (30, 34),
                                   (48, 48), (16, 100), (125, 125)]:
        n = h * w
        plan = port_attn.dq_plan(n, (h, w))
        if w == 64:
            want = ("row_tile", 64, h)
        elif h <= 14 and w <= 16:
            want = ("grid", 112, -(-h // 7))
        else:
            want = ("generic", 64, -(-n // 64))
        assert (plan.mode, plan.nk, plan.tiles) == want, (h, w)
        unit, kv, sums = _dq_stage_bytes(plan.nk, h, w,
                                         plan.mode == "generic")
        assert plan.smem == (1152 + plan.u_stages * unit
                             + plan.kv_stages * kv + sums), (h, w)
        assert plan.smem <= port_attn.SMEM_MAX, (h, w)
        assert plan.kv_stages >= 2 or plan.tiles == 1, (h, w)
        assert 1 <= plan.kv_stages <= 4 and 1 <= plan.u_stages <= 2


@pytest.mark.parametrize("hw,want", [
    # ViT-B / ViT-L: the global layer (64 tiles a unit, four K / V stages)
    # and the 14 x 14 window (two tiles of 7 grid rows)
    ((64, 64), ("row_tile", 64, 64, 4, 2, 201856)),
    ((14, 14), ("grid", 112, 2, 4, 2, 199808)),
    # the ragged test grids: 63 tokens in a window's two tiles, 300 and
    # 1020 tokens through the shared ds tile
    ((9, 7), ("grid", 112, 2, 4, 2, 193664)),
    ((20, 15), ("generic", 64, 5, 4, 2, 170624)),
    ((30, 34), ("generic", 64, 16, 4, 2, 185472)),
    # the widest grid of N <= 256: one unit stage, two K / V stages
    ((1, 256), ("generic", 64, 4, 2, 1, 217728)),
])
def test_dq_plan_pinned(hw, want):
    """The plans of the main path's and the test shapes, pinned: mode, key
    tile, tiles per unit, K / V and unit stages, bytes."""
    p = port_attn.dq_plan(hw[0] * hw[1], hw)
    assert (p.mode, p.nk, p.tiles, p.kv_stages, p.u_stages, p.smem) == want


def _bwd_f32_bytes(h, w):
    """``bt::QUnit`` / ``bt::QImage`` of csrc/attention_bwd_wgmma_tf32.cu
    written out: (the dq unit stage, the dk/dv query stage). The dq unit:
    Q and dO, 2 x 32 KB, and where W > 16 L and D (2 x 512 bytes) and 128
    rel_w rows of 32 ceil(W / 32) + 8 f32, rounded up to 1 KB. The dk/dv
    stage: 8 parts of 32 x 64 f32 (Q and dO raw by TMA, the rest the
    image), L and D (2 x 128 bytes), 32 rel_w rows and, but for W = 64 at
    an even H, 32 rel_h rows, each padded by 4 floats where its length is a
    multiple of 8, rounded up to 1 KB."""
    up = lambda x, m: -(-x // m) * m
    pitch = lambda x: x if x % 8 else x + 4
    tpr = 0 if w <= 16 else -(-w // 32)
    unit = (up(65536 + 1024 + 512 * (32 * tpr + 8), 1024) if tpr
            else 65536)
    row_tile = w == 64 and h % 2 == 0
    stage = up(8 * 8192 + 256 + 128 * pitch(w)
               + (0 if row_tile else 128 * pitch(h)), 1024)
    return unit, stage


BWD_F32_GRIDS = GRIDS_UP_TO_256 + [(64, 64), (32, 64), (3, 64), (30, 34),
                                   (48, 48), (125, 64), (7, 17), (20, 24)]


def test_dq_plan_f32_modes_and_bytes():
    """K5's f32 dq kernel has a plan on every grid of W <= 64 among the
    grids of N <= 256 tokens and the global ones below: W <= 16 a tile of
    two grid rows of 16 slots (GRID, ceil(H / 2) tiles), else 32-slot tiles
    of one grid row, ceil(W / 32) a row (ROW, H of them each); the K / V
    ring of stages of 48 KB (its K and V rows and its image), two at least
    where a unit has more than one tile; the rings in 227 KB, the shared
    memory the layout's own sum. Past W = 64 it raises."""
    for h, w in BWD_F32_GRIDS:
        n = h * w
        if w > 64:
            with pytest.raises(NotImplementedError, match="K5 f32 dq"):
                port_attn.dq_plan_f32(n, (h, w))
            continue
        plan = port_attn.dq_plan_f32(n, (h, w))
        tpr = 0 if w <= 16 else -(-w // 32)
        want = (("grid", 0, -(-h // 2)) if w <= 16
                else ("row_tile", tpr, h * tpr))
        assert (plan.mode, plan.tpr, plan.tiles) == want, (h, w)
        unit, _ = _bwd_f32_bytes(h, w)
        assert plan.smem == (1152 + plan.u_stages * unit
                             + plan.kv_stages * 49152), (h, w)
        assert plan.smem <= port_attn.SMEM_MAX, (h, w)
        assert plan.kv_stages >= 2 or plan.tiles == 1, (h, w)
        assert 1 <= plan.kv_stages <= 4 and 1 <= plan.u_stages <= 2
        # the image: K^T raw and lo, and for ROW K's and V's lo rows
        assert plan.image == (4 if tpr else 2) * 8192, (h, w)


def test_dkv_plan_f32_modes_and_bytes():
    """K5's f32 dk/dv kernel has a plan on every grid of N <= 256 tokens and
    on the global ones: "row_tile" where W = 64 and H is even, else
    "generic"; ceil(N / 32) query tiles; the deepest ring of up to three
    query stages beside the unit's 64 KB of K and V, two on every SAM grid
    (one only where a bias row is ~100 wide or more); the image (what the
    pre-pass writes a tile) the stage but for its 16 KB of raw Q and dO;
    the shared memory the layout's own sum, in 227 KB."""
    for h, w in BWD_F32_GRIDS:
        n = h * w
        plan = port_attn.dkv_plan_f32(n, (h, w))
        assert plan.mode == ("row_tile" if w == 64 and h % 2 == 0
                             else "generic"), (h, w)
        assert plan.qtiles == -(-n // 32)
        _, stage = _bwd_f32_bytes(h, w)
        assert plan.image == stage - 16384, (h, w)
        assert plan.smem == 1152 + 65536 + plan.stages * stage, (h, w)
        assert plan.smem <= port_attn.SMEM_MAX, (h, w)
        assert 1 <= plan.stages <= 3
        if plan.stages < 3:  # the next stage would not fit
            assert plan.smem + stage > port_attn.SMEM_MAX, (h, w)
        if max(h, w) <= 64:
            assert plan.stages >= 2, (h, w)


@pytest.mark.parametrize("cfg", ["sam_vit_base", "sam_vit_large",
                                 "sam_vit_huge", "sam_tiny"])
def test_bwd_f32_plans_fit_every_sam_grid(cfg):
    """Every grid a SAM encoder attends over -- its global layers' (image /
    patch)^2 grid and its windows -- has an f32 K5 plan of each kernel, with
    two stages of each ring where a unit has more than one tile."""
    from dilabhelmholtzoct_tpu_torch.models import configs

    v = getattr(configs, cfg)().vision
    for hw in ((v.grid_size, v.grid_size), (v.window_size, v.window_size)):
        n = hw[0] * hw[1]
        dq, dkv = port_attn.dq_plan_f32(n, hw), port_attn.dkv_plan_f32(n, hw)
        assert dq.smem <= port_attn.SMEM_MAX and dkv.smem <= port_attn.SMEM_MAX
        assert dq.kv_stages >= 2 or dq.tiles == 1
        assert dkv.stages >= 2


@pytest.mark.parametrize("hw,want_dq,want_dkv", [
    # ViT-B / L / H: the global layer (two 32-slot tiles a grid row; 128
    # query tiles of 73 KB stages, K / V of one unit) and the 14 x 14 window
    # (tiles of two grid rows: 7; two unit stages of 64 KB)
    ((64, 64), ("row_tile", 2, 128, 32768, 2, 1, 202880),
     ("row_tile", 128, 58368, 2, 216192)),
    ((14, 14), ("grid", 0, 7, 16384, 2, 2, 230528),
     ("generic", 7, 53248, 2, 205952)),
    # the card tests' ragged (9, 7) and generic (20, 24) grids
    ((9, 7), ("grid", 0, 5, 16384, 2, 2, 230528),
     ("generic", 2, 52224, 2, 203904)),
    ((20, 24), ("row_tile", 1, 20, 32768, 2, 1, 186496),
     ("generic", 15, 56320, 2, 212096)),
])
def test_bwd_f32_plans_pinned(hw, want_dq, want_dkv):
    """The f32 K5 plans of the main path's and the card tests' shapes,
    pinned: dq mode, tiles a grid row, tiles, image bytes, K / V and unit
    stages, bytes; dk/dv mode, query tiles, image bytes, stages, bytes."""
    n = hw[0] * hw[1]
    q = port_attn.dq_plan_f32(n, hw)
    kv = port_attn.dkv_plan_f32(n, hw)
    assert (q.mode, q.tpr, q.tiles, q.image, q.kv_stages, q.u_stages,
            q.smem) == want_dq
    assert (kv.mode, kv.qtiles, kv.image, kv.stages, kv.smem) == want_dkv


def test_relpos_plan_row_tile_needs_an_even_grid_height():
    """Two grid rows of 64 make a 128-key tile only where the grid has an
    even number of rows; an odd one streams 64-key tiles, and a head dim
    K6 does not take raises."""
    assert port_attn.relpos_plan(64, 63 * 64, (63, 64)).nk == 64
    assert port_attn.relpos_plan(64, 62 * 64, (62, 64)).nk == 128
    for d in (2, 6, 130, 132):
        with pytest.raises(NotImplementedError, match="K6"):
            port_attn.relpos_plan(d, 196, (14, 14))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,sms", [(64 * 4096, 132), (8 * 4096, 132),
                                      (296, 132), (15, 132), (1000, 7),
                                      (344, 1)])
def test_dw_plan_chunks_cover_the_rows_in_order(dtype, rows, sms):
    """The weight pass's chunks cover rows 0..rows-1 once, in order. f32:
    about sm / 2 of them, each a multiple of its 16-row stage but the last;
    the nominal chunk is that multiple; at most one persistent block per
    SM. bf16 (one pair of ``rows`` rows here): each weight its own chunks
    of whole 32-row stages, one block per chunk, one wave of blocks at
    most (two at least), and dWq^T, which reads 1280 bytes a row against
    dWo's 768, with about 5 / 3 as many chunks."""
    if dtype == torch.float32:
        chunks, size, blocks = port_i2t.dw_plan_f32(rows, sms)
        align = 16
        assert align == port_i2t.DW32_ROWS
        assert chunks[0][0] == 0 and chunks[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all((hi - lo) % align == 0 for lo, hi in chunks[:-1])
        assert len(chunks) <= max(1, sms // 2) and size % align == 0
        assert all(hi - lo <= size for lo, hi in chunks)
        assert chunks == kernels.row_chunks(rows, max(1, sms // 2), align)
        assert blocks == min(2 * len(chunks), sms)
        return
    assert port_i2t.DW_ROWS == 32
    chunks, size, blocks = port_i2t.dw_plan_bf16(1, rows, sms)
    stages = -(-rows // 32)
    assert blocks == len(chunks[0]) + len(chunks[1]) <= max(2, sms)
    for ch, per in zip(chunks, size):
        assert ch[0][0] == 0 and ch[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(ch, ch[1:]))
        assert all(hi - lo == 32 * per for lo, hi in ch[:-1])
        assert 0 < ch[-1][1] - ch[-1][0] <= 32 * per
        assert len(ch) == -(-stages // per)
    if sms >= 8 and stages >= 2 * sms:  # enough to balance: within 10%
        work = [b * -(-stages // len(ch)) for b, ch in
                zip(port_i2t.DW_ROW_BYTES, chunks)]
        assert max(work) <= 1.1 * min(work), work


def test_dw_plan_bf16_stages_start_at_each_pair():
    """bf16: a pair's rows are cut into 32-row stages from its first row,
    so a chunk starts at a pair's start or 32 k rows after it, and the
    plan's chunks of 64 pairs of 4096 rows (the main path) are those of one
    run of 262144 rows; pairs of 37 rows take two stages each."""
    chunks, size, blocks = port_i2t.dw_plan_bf16(64, 4096, 132)
    assert (chunks, size) == port_i2t.dw_plan_bf16(1, 64 * 4096, 132)[:2]
    assert [len(c) for c in chunks] == [50, 82] and size == (164, 100)
    assert blocks == 132
    got, per = port_i2t.dw_stage_chunks(8, 37, 3)  # 16 stages of 32 / 5
    assert per == 6 and got == [(0, 111), (111, 222), (222, 296)]
    got, per = port_i2t.dw_stage_chunks(3, 100, 4)  # 12 stages
    assert per == 3 and got == [(0, 96), (96, 164), (164, 232),
                                (232, 300)]
    got, per = port_i2t.dw_stage_chunks(2, 130, 2)  # 10 stages
    assert per == 5 and got == [(0, 130), (130, 260)]
    for bp, m, parts in ((16, 521, 50), (1, 5, 82), (4, 4096, 7)):
        got, per = port_i2t.dw_stage_chunks(bp, m, parts)
        starts = {p * m + 32 * k for p in range(bp) for k in range(-(-m // 32))}
        assert got[0][0] == 0 and got[-1][1] == bp * m
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        assert all(lo in starts for lo, _ in got) and len(got) <= parts


def test_dw_plain_follows_the_f32_stage():
    """``i2t_bwd_dw_plain`` sums its chunks in the kernel's order: at f32
    chunks aligned to 16 rows, at bf16 to 32 (the same sum over all rows,
    to f32 rounding)."""
    g = torch.Generator().manual_seed(0)
    bp, m, pb = 2, 37, 2
    keys = torch.randn((bp // pb, m, 256), generator=g)
    pe = torch.randn((1, m, 256), generator=g)
    dq, orow = (torch.randn((bp, m, 128), generator=g) for _ in range(2))
    dres = torch.randn((bp, m, 256), generator=g)
    args = (keys, pe, dq, orow, dres)
    one = port_i2t.i2t_bwd_dw_plain(*args, pb=pb)
    three = port_i2t.i2t_bwd_dw_plain(*args, pb=pb, parts=3)
    x, y = dq.reshape(-1, 128), (keys + pe).repeat_interleave(pb, 0)
    y = y.reshape(-1, 256)
    by_hand = sum(x[lo:hi].T @ y[lo:hi] for lo, hi in ((0, 32), (32, 64),
                                                        (64, 74)))
    assert torch.equal(three[0], by_hand.T)
    for a, b in zip(one, three):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_dw_plain_follows_the_bf16_stage():
    """``i2t_bwd_dw_plain`` on bf16 rows sums the bf16 kernel's chunks
    (``dw_stage_chunks``: whole 32-row stages of each pair), a (dWo,
    dWq^T) pair of chunk counts as ``dw_plan_bf16`` gives them: the same
    sum over all rows to f32 rounding."""
    g = torch.Generator().manual_seed(1)
    bp, m, pb = 4, 37, 2
    r = lambda *s: torch.randn(s, generator=g).bfloat16()
    keys, pe = r(bp // pb, m, 256), r(1, m, 256)
    dq, orow, dres = r(bp, m, 128), r(bp, m, 128), r(bp, m, 256)
    args = (keys, pe, dq, orow, dres)
    one = port_i2t.i2t_bwd_dw_plain(*args, pb=pb)
    three = port_i2t.i2t_bwd_dw_plain(*args, pb=pb, parts=(3, 3))
    pair = port_i2t.i2t_bwd_dw_plain(*args, pb=pb, parts=(2, 3))
    x = dq.float().reshape(-1, 128)
    y = (keys + pe).float().repeat_interleave(pb, 0).reshape(-1, 256)
    xo, yo = orow.float().reshape(-1, 128), dres.float().reshape(-1, 256)
    # 4 pairs of 37 rows: stages of 32 and 5 rows, 8 in all; 3 parts of 3
    # stages (the last 2), 2 parts of 4
    three_rows = ((0, 69), (69, 111), (111, 148))
    by_hand = sum(x[lo:hi].T @ y[lo:hi] for lo, hi in three_rows)
    assert torch.equal(three[0], by_hand.T)
    by_hand = sum(xo[lo:hi].T @ yo[lo:hi] for lo, hi in ((0, 74), (74, 148)))
    assert torch.equal(pair[1], by_hand)
    by_hand = sum(x[lo:hi].T @ y[lo:hi] for lo, hi in three_rows)
    assert torch.equal(pair[0], by_hand.T)
    for a, b in zip(one, three):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bp,m,sms", [(64, 4096, 132), (64, 4096, 114),
                                      (8, 4096, 132), (16, 521, 78),
                                      (3, 100, 16), (2, 37, 3), (1, 5, 132),
                                      (4, 64, 1)])
def test_dw_plan_bf16_on_every_card(bp, m, sms):
    """The bf16 plan on cards of other SM counts and on other pair shapes:
    each weight's chunks are runs of whole stages of one size (the last may
    be shorter) that start where a pair or one of its 32-row stages
    starts, cover all rows in order, one block each; no more blocks than
    SMs (two at least, one per weight); dWq^T, which reads more bytes a
    row, never gets fewer chunks than dWo."""
    (c0, c1), (s0, s1), blocks = port_i2t.dw_plan_bf16(bp, m, sms)
    starts = {p * m + 32 * k for p in range(bp) for k in range(-(-m // 32))}
    spp, rows = -(-m // 32), bp * m
    for ch, per in ((c0, s0), (c1, s1)):
        assert ch[0][0] == 0 and ch[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(ch, ch[1:]))
        assert all(lo in starts for lo, _ in ch)
        assert len(ch) == -(-bp * spp // per)
    assert blocks == len(c0) + len(c1) <= max(2, sms)
    assert len(c1) >= len(c0)


@pytest.mark.parametrize("bp,m,sms,want", [
    # the training shape: 64 pairs x 4096 rows (pb 1 and 8 alike: a unit
    # is 64 rows of one pair), 4096 units on 132 blocks
    (64, 4096, 132, (64, 3, 4096, 132, 230528)),
    # ragged m: 129 rows in three units a pair, the last of one row
    (8, 129, 132, (64, 3, 24, 12, 230528)),
    (3, 37, 2, (64, 3, 3, 2, 230528)),
])
def test_rows_plan_bf16_pinned(bp, m, sms, want):
    """The bf16 row pass's plan, pinned: rows a unit, ring slots, units,
    blocks (one an SM, at most half the units: two consumer warpgroups
    a block) and shared memory (Wq and Wo, 128 KB, three 32 KB slots, 1 KB
    of alignment and barriers) within 227 KB."""
    p = port_i2t.rows_plan_bf16(bp, m, sms)
    assert (p.rows, p.stages, p.units, p.blocks, p.smem) == want
    assert p.smem <= port_attn.SMEM_MAX


@pytest.mark.parametrize("bp,m,pb,sms", [(4, 37, 2, 3), (8, 100, 8, 5),
                                         (2, 129, 1, 132)])
def test_rows_plain_bf16_sums_the_plan_in_order(bp, m, pb, sms):
    """The bf16 row pass's column sums as the kernel and the wrapper take
    them on the plan ``rows_plan_bf16`` gives: block b takes units b, b +
    G, ... (u = pair * tpp + row // 64), its two consumer warpgroups take
    them in turns, warp w of a warpgroup rows 16 w.. of a unit; dbq has a
    partial a consumer warp (``ROWS_WARPS`` a block), dbo, dg and dbt one a
    consumer warpgroup. Each row lands in one partial, and the partials
    (each the plain twin's sums over its rows) added as the wrapper adds
    them equal the twin's sums over all rows to f32 summation order."""
    g = torch.Generator().manual_seed(bp * 100 + m)
    r = lambda *s, k=1.0: k * torch.randn(s, generator=g)
    bf = torch.bfloat16
    keys, pe = r(bp // pb, m, 256).to(bf), r(1, m, 256).to(bf)
    tok_k, tok_v = r(bp, 7, 128).to(bf), r(bp, 7, 128).to(bf)
    wts = (r(256, 128, k=0.06).to(bf), r(128, k=0.1),
           r(128, 256, k=0.09).to(bf), r(256, k=0.1), 1 + r(256, k=0.1),
           r(256, k=0.1))
    dy = r(bp, m, 256).to(bf)
    kw = dict(nh=8, eps=1e-6)
    plan = port_i2t.rows_plan_bf16(bp, m, sms)
    tpp, nw = -(-m // plan.rows), port_i2t.ROWS_WARPS
    assert plan.units == bp * tpp
    dbq = torch.zeros(plan.blocks * nw, 128)
    per_wg = torch.zeros(3, plan.blocks * 2, 256)
    taken = torch.zeros(bp, m, dtype=torch.long)
    for blk in range(plan.blocks):
        for k, u in enumerate(range(blk, plan.units, plan.blocks)):
            pair, r0 = divmod(u, tpp)
            wg = blk * 2 + k % 2
            for w in range(4):
                lo = plan.rows * r0 + 16 * w
                hi = min(m, lo + 16)
                if lo >= hi:
                    continue
                taken[pair, lo:hi] += 1
                part = port_i2t.i2t_bwd_rows_plain(
                    keys[pair // pb:pair // pb + 1, lo:hi], pe[:, lo:hi],
                    tok_k[pair:pair + 1], tok_v[pair:pair + 1], *wts,
                    dy[pair:pair + 1, lo:hi], pb=1, **kw)[7:]
                dbq[wg * 4 + w] += part[0]
                for i in range(3):
                    per_wg[i, wg] += part[1 + i]
    assert torch.equal(taken, torch.ones_like(taken))
    got = (dbq.sum(0),) + tuple(x.sum(0) for x in per_wg)
    want = port_i2t.i2t_bwd_rows_plain(keys, pe, tok_k, tok_v, *wts, dy,
                                       pb=pb, **kw)[7:]
    for a, b in zip(want, got):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * float(
            a.abs().max()))


@pytest.mark.parametrize("bp,m,pb,sms", [(4, 37, 2, 7), (8, 43, 8, 13),
                                         (1, 5, 1, 132), (3, 100, 1, 5),
                                         (2, 130, 2, 3), (6, 64, 3, 132)])
def test_dw_plain_bf16_sums_the_plan_in_order(bp, m, pb, sms):
    """The bf16 plain twin on the counts ``dw_plan_bf16`` gives: each
    weight is the sum of its chunks' products taken in the plan's order,
    bit for bit, as ``i2t_dw_sum_kernel`` adds the kernel's partials."""
    g = torch.Generator().manual_seed(bp * 1000 + m)
    r = lambda *s: torch.randn(s, generator=g).bfloat16()
    keys, pe = r(bp // pb, m, 256), r(1, m, 256)
    dq, orow, dres = r(bp, m, 128), r(bp, m, 128), r(bp, m, 256)
    chunks, _, _ = port_i2t.dw_plan_bf16(bp, m, sms)
    dwq, dwo = port_i2t.i2t_bwd_dw_plain(keys, pe, dq, orow, dres, pb=pb,
                                         parts=tuple(len(c) for c in chunks))
    x = dq.float().reshape(-1, 128)
    y = (keys + pe).float().repeat_interleave(pb, 0).reshape(-1, 256)
    xo, yo = orow.float().reshape(-1, 128), dres.float().reshape(-1, 256)
    assert torch.equal(dwo, sum(xo[lo:hi].T @ yo[lo:hi]
                                for lo, hi in chunks[0]))
    assert torch.equal(dwq, sum(x[lo:hi].T @ y[lo:hi]
                                for lo, hi in chunks[1]).T)


def test_relpos_plan_norm_takes_two_passes_over_several_tiles():
    """K2's rounding point (``norm``, head dim 64): on every grid of N <=
    512 tokens the plan is the one without it but for the flag and the
    passes, 2 where a unit has several key tiles (the first pass finds
    each row's max and sum, the producer issuing ``passes * tiles`` tiles a
    unit), 1 where one tile holds all keys (SAM's windows); another head
    dim raises."""
    for h, w in GRIDS_UP_TO_256 + [(20, 15), (16, 32), (8, 64), (2, 256),
                                   (22, 23), (1, 512)]:
        n = h * w
        plain = port_attn.relpos_plan(64, n, (h, w))
        plan = port_attn.relpos_plan(64, n, (h, w), True)
        assert plan.norm and not plain.norm and plain.passes == 1
        assert plan.passes == (2 if plan.tiles > 1 else 1), (h, w)
        assert (plan.route, plan.dp, plan.nk, plan.tiles, plan.kv_stages,
                plan.u_stages, plan.smem) == (
                    plain.route, plain.dp, plain.nk, plain.tiles,
                    plain.kv_stages, plain.u_stages, plain.smem), (h, w)
        assert plan.kv_stages >= 2 or plan.passes * plan.tiles == 1
    with pytest.raises(NotImplementedError, match="head_dim 64"):
        port_attn.relpos_plan(80, 196, (14, 14), True)


@pytest.mark.parametrize("b,hw,want", [
    # SAM's windows (B * 25 of them): one 224-slot tile, one pass
    (25, (14, 14), (True, 224, 1, 1, 2, 2)),
    (1, (14, 14), (False, 224, 1, 1, 2, 2)),
    # the ragged test grids: 63 tokens (b has no factor 2 or 5), 300 and
    # 512 tokens in two passes over 64-key tiles, two grid rows of 64
    (3, (9, 7), (False, 224, 1, 1, 2, 2)),
    (2, (20, 15), (True, 64, 5, 2, 4, 2)),
    (4, (16, 32), (True, 64, 8, 2, 4, 2)),
    (2, (4, 64), (True, 128, 2, 2, 4, 2)),
    # past 512 tokens or an odd count of a window's group: K1's rounding
    (2, (30, 34), (False, 64, 16, 1, 4, 2)),
    (1, (64, 64), (False, 128, 32, 1, 4, 2)),
])
def test_relpos_plan_of_the_bf16_k1_k2_route(b, hw, want):
    """The plan ``attention_fwd_cuda`` launches in bf16: the rounding point
    is ``normalised_rounding(B, N)``; pinned: the flag, key tile, tiles,
    passes, K / V and unit stages."""
    n = hw[0] * hw[1]
    p = port_attn.relpos_plan(64, n, hw, port_attn.normalised_rounding(b, n))
    assert (p.norm, p.nk, p.tiles, p.passes, p.kv_stages,
            p.u_stages) == want


def _dw32_smem(stages):
    """``dwu::smem`` written out: 2 KB of alignment slack and mbarriers,
    stages of 16 rows of X (128 f32) and Y (256 f32), two B buffers of a
    stage's split Y^T (hi and lo)."""
    return 2048 + stages * 16 * (128 + 256) * 4 + 2 * 2 * 256 * 16 * 4


@pytest.mark.parametrize("rows,sms", [(64 * 4096, 132), (64 * 4096, 114),
                                      (8 * 4096, 132), (296, 132),
                                      (15, 132), (1000, 7), (185, 1)])
def test_upscale_dw_plan_f32_units_in_order(rows, sms):
    """The f32 K3 weight pass's plan: about sm / 2 chunks (accumulator
    chains as long as the f32 K4 weight pass's) covering the rows once, in
    order, each a multiple of the 16-row stage but the last; four units a
    chunk in (chunk, kind) order, so that a chunk's two dW1 units (kinds 0
    and 1, which read the same rnd(d_u1pre) rows) are neighbours and run
    in the same wave of blocks where the blocks are even in number; one
    block per SM at most; the ring of 6
    stages in a block's shared memory."""
    p = port_up.upscale_dw_plan_f32(rows, sms)
    assert port_up.DW32_ROWS == 16
    assert p.chunks[0][0] == 0 and p.chunks[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(p.chunks, p.chunks[1:]))
    assert all((hi - lo) % 16 == 0 for lo, hi in p.chunks[:-1])
    assert all(hi - lo <= p.chunk for lo, hi in p.chunks)
    assert p.chunk % 16 == 0 and len(p.chunks) <= max(1, sms // 2)
    assert list(p.chunks) == kernels.row_chunks(rows, max(1, sms // 2), 16)
    assert p.units == tuple((c, k) for c in range(len(p.chunks))
                            for k in range(4))
    assert p.blocks == min(len(p.units), sms)
    for u, (c, kind) in enumerate(p.units):
        if kind == 0:  # its dW1 twin: the next unit, in the same wave
            assert p.units[u + 1] == (c, 1)
            # wherever the blocks are even in number (an H100's 132 SMs) or
            # take every unit at once
            if p.blocks % 2 == 0 or p.blocks == len(p.units):
                assert u // p.blocks == (u + 1) // p.blocks
    assert p.stages == port_up.DW32_STAGES == 6
    assert _dw32_smem(p.stages) <= port_attn.SMEM_MAX < _dw32_smem(7)


def test_upscale_dw_plan_f32_pinned():
    """The main path's plan (64 pairs x 4096 rows on 132 SMs): 66 chunks of
    3984 rows (the last 2560), 264 units on 132 blocks, two each."""
    p = port_up.upscale_dw_plan_f32(64 * 4096, 132)
    assert (len(p.chunks), p.chunk, len(p.units), p.stages,
            p.blocks) == (66, 3984, 264, 6, 132)
    assert p.chunks[-1] == (65 * 3984, 64 * 4096)


@pytest.mark.parametrize("bp,m,sms", [(5, 37, 8), (3, 100, 132), (1, 15, 4)])
def test_upscale_dw_plain_f32_sums_the_plan_in_order(bp, m, sms):
    """``upscale_bwd_dw_plain`` on f32 rows with the plan's chunk count sums
    the plan's chunks' products in its order, bit for bit, as the wrapper
    adds the kernel's partials; one chunk or several agree to f32
    rounding."""
    g = torch.Generator().manual_seed(bp * 100 + m)
    r = lambda *s: torch.randn(s, generator=g)
    up, u1g, du1 = r(bp, m, 256), r(bp, m, 256), r(bp, m, 256)
    d2 = r(bp, m, 512)
    plan = port_up.upscale_dw_plan_f32(bp * m, sms)
    dw1, dw2 = port_up.upscale_bwd_dw_plain(up, u1g, d2, du1,
                                            parts=len(plan.chunks))
    n = bp * m
    x1, y1 = up.reshape(n, 256), du1.reshape(n, 256)
    x2, y2 = u1g.reshape(n, 4, 64), d2.reshape(n, 4, 128)
    assert torch.equal(dw1, sum(x1[lo:hi].T @ y1[lo:hi]
                                for lo, hi in plan.chunks))
    assert torch.equal(dw2, sum(torch.einsum("rsc,rsq->scq", x2[lo:hi],
                                             y2[lo:hi])
                                for lo, hi in plan.chunks))
    one = port_up.upscale_bwd_dw_plain(up, u1g, d2, du1)
    for a, b in zip(one, (dw1, dw2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bimg,m,pb,sms", [
    (64, 4096, 1, 132), (8, 4096, 8, 132), (8, 4096, 8, 8),
    (3, 129, 1, 132), (2, 37, 8, 8), (5, 100, 3, 132), (1, 1, 8, 132)])
def test_fwd_plan_bf16_covers_every_row_once(bimg, m, pb, sms):
    """The bf16 K4 forward's plan: unit u is rows 64 (u % tpp).. of image
    u // tpp with all of its pb pairs; block b takes units b, b + G, ...,
    its two consumer warpgroups in turns. Every (pair, row) is computed by
    exactly one warpgroup, the blocks are at most one an SM and at most
    half the units, and the shared memory fits a block."""
    plan = port_i2t.fwd_plan_bf16(bimg, m, sms)
    tpp = -(-m // plan.rows)
    assert plan.rows == 64 and plan.stages == port_i2t.FWD_SLOTS == 2
    assert plan.units == bimg * tpp
    assert 1 <= plan.blocks <= min(sms, -(-plan.units // 2))
    assert plan.smem <= port_attn.SMEM_MAX
    taken = torch.zeros(bimg * pb, m, dtype=torch.long)
    for blk in range(plan.blocks):
        for u in range(blk, plan.units, plan.blocks):
            img, tile = divmod(u, tpp)
            lo = plan.rows * tile
            taken[img * pb:(img + 1) * pb, lo:min(m, lo + plan.rows)] += 1
    assert torch.equal(taken, torch.ones_like(taken))


def test_fwd_plan_bf16_pinned():
    """At the training shape (64 pairs of 4096 rows): pb 1, 4096 units on
    132 blocks; pb 8 (8 images), 512 units; Wq and Wo (128 KB), a 32 KB
    keys slot and a 16 KB y stage a warpgroup, 1 KB of alignment and
    barriers."""
    got = [port_i2t.fwd_plan_bf16(64 // pb, 4096, 132) for pb in (1, 8)]
    assert [(p.units, p.blocks, p.smem) for p in got] == [
        (4096, 132, 230528), (512, 132, 230528)]


@pytest.mark.parametrize("bp,m,sms", [(64, 4096, 132), (64, 4096, 8),
                                      (3, 129, 132), (5, 37, 8), (1, 1, 132),
                                      (200, 64, 132)])
def test_upscale_rows_plan_bf16_covers_every_row_once(bp, m, sms):
    """The bf16 K3 row pass's plan: unit u is rows 64 (u % tpp).. of pair
    u // tpp; block b takes units b, b + G, ..., both its consumer
    warpgroups on each. Every row is in exactly one unit, the blocks are
    at most one an SM and at most one a unit, and the shared memory (W1,
    W2, the up and rnd(d_u1pre) slots, the d_hyper sums, two units' hyper)
    fits a block."""
    plan = port_up.rows_plan_bf16(bp, m, sms)
    tpp = -(-m // plan.rows)
    assert plan.rows == 64 and plan.units == bp * tpp
    assert 1 <= plan.blocks <= min(sms, plan.units)
    assert plan.smem == 230976 <= port_attn.SMEM_MAX
    taken = torch.zeros(bp, m, dtype=torch.long)
    for blk in range(plan.blocks):
        for u in range(blk, plan.units, plan.blocks):
            pair, tile = divmod(u, tpp)
            taken[pair, plan.rows * tile:plan.rows * (tile + 1)] += 1
    assert torch.equal(taken, torch.ones_like(taken))


@pytest.mark.parametrize("bp,m,n_out,sms", [(3, 37, 1, 2), (2, 130, 4, 3),
                                            (4, 64, 2, 132), (2, 100, 3, 1)])
def test_upscale_rows_plain_bf16_sums_the_plan_in_order(bp, m, n_out, sms):
    """The bf16 K3 row pass's sums as the kernel and the wrapper take them
    on the plan ``rows_plan_bf16`` gives: block b takes units b, b + G, ...
    (u = pair * tpp + row // 64); the column sums db1, dg, dbt and db2 have
    a partial a block and warp index w (rows 16 w.. of each of the block's
    units: the two warpgroups' warps w hold the unit's (d, e) blocks 0-1
    and 2-3), d_hyper one a unit. Each row lands in one partial of each,
    and the partials (each the plain twin's sums over its rows) added as
    the wrapper adds them equal the twin's sums over all rows to f32
    summation order."""
    g = torch.Generator().manual_seed(bp * 100 + m + n_out)
    r = lambda *s, k=1.0: k * torch.randn(s, generator=g)
    bf = torch.bfloat16
    up = r(bp, m, 256).to(bf)
    dm = r(bp, m, n_out * 16)
    wts = (r(256, 2, 2, 64, k=0.06).to(bf), r(64, k=0.1), 1 + r(64, k=0.1),
           r(64, k=0.1), r(64, 2, 2, 32, k=0.12).to(bf), r(32, k=0.1))
    hyper = r(bp, n_out, 32).to(bf)
    plan = port_up.rows_plan_bf16(bp, m, sms)
    tpp = -(-m // plan.rows)
    cols = torch.zeros(4, plan.blocks * port_up.ROWS_PARTS, 512)
    dht = torch.zeros(bp, tpp, n_out, 512)
    taken = torch.zeros(2, bp, m, dtype=torch.long)
    for blk in range(plan.blocks):
        for u in range(blk, plan.units, plan.blocks):
            pair, tile = divmod(u, tpp)
            lo = plan.rows * tile
            sl = slice(pair, pair + 1)
            unit = port_up.upscale_bwd_rows_plain(
                up[sl, lo:lo + plan.rows], dm[sl, lo:lo + plan.rows],
                *wts, hyper[sl])
            dht[pair, tile] = unit[8][0]
            taken[1, pair, lo:lo + plan.rows] += 1
            for w in range(port_up.ROWS_PARTS):
                a, b = lo + 16 * w, min(m, lo + 16 * w + 16)
                if a >= b:
                    continue
                taken[0, pair, a:b] += 1
                part = port_up.upscale_bwd_rows_plain(
                    up[sl, a:b], dm[sl, a:b], *wts, hyper[sl])[4:8]
                for i, x in enumerate(part):
                    cols[i, blk * port_up.ROWS_PARTS + w, :x.numel()] += x
    assert torch.equal(taken, torch.ones_like(taken))
    want = port_up.upscale_bwd_rows_plain(up, dm, *wts, hyper)[4:]
    got = tuple(cols[i].sum(0)[:x.numel()] for i, x in enumerate(want[:4]))
    got += (dht.sum(1),)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * float(
            a.abs().max()))



@pytest.mark.parametrize("bp,m,sms", [(64, 4096, 132), (64, 4096, 8),
                                      (3, 129, 132), (5, 37, 8), (1, 1, 132),
                                      (3, 100, 132), (200, 64, 132)])
def test_upscale_fwd_plan_bf16_covers_every_row_once(bp, m, sms):
    """The bf16 K3 forward's plan (``upscale_fwd_plan_bf16``): unit u is rows
    64 (u % tpp).. of pair u // tpp, M need not be a multiple of 64; block
    b takes units b, b + G, ..., both its warpgroups on each. Every row is
    in exactly one unit, the blocks are at most one an SM and one a unit,
    and the shared memory (W1, W2 and two up slots) fits a block."""
    plan = port_up.upscale_fwd_plan_bf16(bp, m, sms)
    tpp = -(-m // plan.rows)
    assert plan.rows == 64 and plan.units == bp * tpp
    assert 1 <= plan.blocks <= min(sms, plan.units)
    assert plan.smem == 214080 <= port_attn.SMEM_MAX
    taken = torch.zeros(bp, m, dtype=torch.long)
    for blk in range(plan.blocks):
        for u in range(blk, plan.units, plan.blocks):
            pair, tile = divmod(u, tpp)
            taken[pair, plan.rows * tile:plan.rows * (tile + 1)] += 1
    assert torch.equal(taken, torch.ones_like(taken))


def test_upscale_fwd_plan_bf16_pinned():
    """At the training shape (64 pairs of 4096 rows, 132 SMs): 4096 units of
    64 rows on 132 blocks (31 or 32 units a block)."""
    p = port_up.upscale_fwd_plan_bf16(64, 4096, 132)
    assert (p.rows, p.units, p.blocks) == (64, 4096, 132)
