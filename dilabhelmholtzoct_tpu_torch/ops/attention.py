"""Encoder self-attention over the fused qkv, with decomposed rel-pos bias,
forward and backward.

``flash_attention_packed`` is the port of
``dilabhelmholtzoct_tpu/ops/attention.py::flash_attention_packed`` and, when
a gradient is needed, of its custom VJP ``packed_attention_vjp``; for the
models the JAX package sends to ``flash_attention_relpos`` instead (a head
dim other than 64, or an odd head count) it is the port of that function
too, without the head-major copies around it. It reads the raw qkv
projection (B, N, 3C) and writes token-order (B, N, C). On a CUDA tensor it
launches hand-written kernels:

  * K1 ``attn_relpos_wgmma_tf32_kernel`` (f32) /
    ``attn_relpos_wgmma_kernel`` (bf16): the K6 kernels below, which at
    head dim 64 compute the same function, with the rows' logsumexp, for
    the global layers (N > WINDOW_MAX_TOKENS; N = 4096 at ViT-B), replacing
    the TPU ``_packed_kernel``;
  * K2, the same two kernels (bf16 at the rounding point of the JAX route:
    ``normalised_rounding``; in f32 nothing is rounded, so both points are
    one function) for the windowed layers (N <= 256; 14x14 windows at
    ViT-B), replacing the TPU ``_windowed_group_kernel``.
    With a gradient to take, K1 / K2 also write the rows' logsumexp (the
    TPU kernels' ``return_lse``);
  * K5's dq and dk/dv kernels, on wgmma and TMA, for the backward of
    either, replacing the TPU ``_flash_packed_bwd``
    (``_packed_bwd_dq_kernel``, ``_packed_bwd_dkv_kernel``): f32
    ``attn_bwd_dq_wgmma_tf32_kernel`` / ``attn_bwd_dkv_wgmma_tf32_kernel``
    in split TF32 (``csrc/attention_bwd_wgmma_tf32.cu``, on the plans of
    ``dq_plan_f32`` / ``dkv_plan_f32``), bf16 ``attn_bwd_dq_wgmma_kernel``
    on the plan of ``dq_plan`` / ``attn_bwd_dkv_wgmma_kernel``
    (``csrc/attention_bwd.cu``);
  * K6 ``attn_relpos_wgmma_tf32_kernel`` (f32, split TF32 on wgmma and
    TMA, ``csrc/attention_relpos_wgmma_tf32.cu``, launched on the plan of
    ``relpos_plan_f32``) / ``attn_relpos_wgmma_kernel`` (bf16, on wgmma and
    TMA, ``csrc/attention_relpos_wgmma.cu``, on the plan of
    ``relpos_plan``) for every layer of a model off the packed route
    (ViT-H: 16 heads of 80), replacing the TPU ``_flash_kernel``. Forward
    only, as there.

``flash_attention_windowed_image`` is the port of the JAX function of that
name, the windowed layers' attention read from the image-layout qkv
(B, H, W, 3C) with no window partition around it: K7 ``attn_winimg_kernel``
(``csrc/attention_winimg.cu``), replacing the TPU
``_windowed_image_kernel``. Forward only, head dim 64.

Their bounds on an H100 and what the design does about them are noted at
the top of each CUDA source. On a CPU tensor the wrapper runs
``packed_attention_plain``, ``packed_attention_bwd_plain``,
``relpos_attention_plain`` and ``windowed_image_attention_plain``, the same
functions with a materialised (N, N) bias and f32 arithmetic, rounded where
the kernels round. A CUDA tensor never reaches a plain version: the kernel
launches or the wrapper raises.

``LAUNCHES`` counts kernel launches (one per kernel launched), so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import kernels

# K1 / K2 / K5 / K6 / K7 launch counts; a plain integer each, reset by the
# caller
LAUNCHES = {"attn_global": 0, "attn_windowed": 0, "attn_bwd_dq": 0,
            "attn_bwd_dkv": 0, "attn_relpos": 0, "attn_windowed_image": 0}
WINDOW_MAX_TOKENS = 256  # K2 / K7 hold all keys of a window in shared memory
HEAD_DIM = 64            # K1 / K2 / K5 / K7
RELPOS_MAX_HEAD_DIM = 128  # K6 takes every multiple of 4 up to this

_BOUND = {"attention_bwd": False,
          "attention_bwd_wgmma_tf32": False, "attention_relpos_wgmma": False,
          "attention_relpos_wgmma_tf32": False, "attention_winimg": False}
SMEM_MAX = 232448  # shared memory a block may use on an H100
RELPOS_SMEM_FIXED = 1024 + 128  # wg::SMEM_FIXED: alignment slack, mbarriers


@dataclasses.dataclass(frozen=True)
class RelposPlan:
    """The launch plan of the bf16 K6 (``attn_relpos_wgmma_kernel``):
    ``route`` "windowed" (N <= WINDOW_MAX_TOKENS) or "global", the head dim
    rounded up to 16 columns (``dp``), the key tile (``nk``: 224 a whole
    window of at most 14 x 16 grid cells, or 112 its first or last 7 grid
    rows past dp = 80; 128 two grid rows of 64; else 64), the tiles per
    unit of 128 query rows, the depths of the K / V ring
    and of the unit (Q and bias rows) ring, the shared memory of a
    block in bytes, the rounding point (``norm``: the normalised p rounded
    before p.v, the JAX ``_windowed_group_kernel``'s, which the bf16 K2
    takes; else the un-normalised p, K6's and K1's) and the passes a unit
    makes over its key tiles (2 for ``norm`` over several tiles: the first
    finds each row's max and sum from the scores alone, the second rounds
    p / l for p.v; else 1). The producer issues ``passes * tiles`` key
    tiles a unit, the first pass's without V."""
    route: str
    dp: int
    nk: int
    tiles: int
    kv_stages: int
    u_stages: int
    smem: int
    norm: bool = False
    passes: int = 1


def _relpos_slabs(dp):
    """The column slabs of a bf16 K6 head of ``dp`` columns: 64-column ones
    (128-byte swizzle), then a 32- and a 16-column one where dp % 64 holds
    them (``wg::slab_width``)."""
    return [64] * (dp // 64) + [w for w in (32, 16) if dp & w]


def _relpos_stage_bytes(dp, nk, h, w):
    """(unit stage, K / V stage) bytes: ``wg::Layout`` of
    csrc/attention_relpos_wgmma.cu (a unit stage's Q slabs of 128 rows and
    its bias rows; K and V of NK key slots)."""
    up = lambda x, m: -(-x // m) * m
    tile = lambda rows: sum(up(rows * sw * 2, 1024) for sw in _relpos_slabs(dp))
    rel = up(2 * (128 * h + 16), 16) + up(2 * (128 * w + 16), 16)
    return tile(128) + rel, 2 * tile(nk)


def _ring_depths(tiles):
    """(unit stages, K / V stages) of the wgmma attention kernels' rings, in
    the order a plan tries them: a unit of one tile double-buffers units; a
    unit of several tiles issues a tile's scores before it releases the
    tile before, so it wants three K / V stages (two at least) to keep a
    load in flight."""
    return (((2, 2), (2, 1), (1, 1)) if tiles == 1 else
            ((2, 4), (2, 3), (1, 4), (1, 3), (2, 2), (1, 2)))


@functools.lru_cache(maxsize=None)
def relpos_plan(d: int, n: int, hw, norm: bool = False) -> RelposPlan:
    """The bf16 K6's plan for head dim ``d`` over an ``hw`` grid of ``n``
    tokens, rounding p where ``norm`` says (``RelposPlan``; ``norm`` at
    head dim 64 alone): the deepest rings that fit in a block's shared
    memory. A unit that issues one tile (a window) takes two unit and two
    K / V stages where they fit (the next unit loads while this one
    computes); a unit of several tiles up to four K / V stages, three at
    least where they fit, two at the least (it issues a tile's S before it
    releases the tile before). Raises where none fits."""
    _check_relpos_head_dim(d)
    if norm and d != HEAD_DIM:
        raise NotImplementedError(
            f"the normalised rounding point (K2's) is built for head_dim "
            f"{HEAD_DIM} alone, got {d}")
    dp = -(-d // 16) * 16
    h, w = hw
    if h <= 14 and w <= 16:  # a window: 14 grid rows a tile, 7 past DP 80
        rows = 14 if dp <= 80 else 7
        nk, tiles = 16 * rows, -(-h // rows)
    elif w == 64 and h % 2 == 0:
        nk, tiles = 128, n // 128
    else:
        nk, tiles = 64, -(-n // 64)
    passes = 2 if norm and tiles > 1 else 1
    unit, kv = _relpos_stage_bytes(dp, nk, h, w)
    for u_stages, kv_stages in _ring_depths(passes * tiles):
        smem = RELPOS_SMEM_FIXED + u_stages * unit + kv_stages * kv
        if smem <= SMEM_MAX:
            return RelposPlan(
                "windowed" if n <= WINDOW_MAX_TOKENS else "global", dp, nk,
                tiles, kv_stages, u_stages, smem, norm, passes)
    raise NotImplementedError(
        f"K6 bf16: no plan fits in shared memory for head_dim {d} over a "
        f"{hw} grid (one stage takes {RELPOS_SMEM_FIXED + unit + kv} "
        "bytes)")


@dataclasses.dataclass(frozen=True)
class RelposPlanF32:
    """The launch plan of the f32 K6 and K1 (``attn_relpos_wgmma_tf32_kernel``,
    ``csrc/attention_relpos_wgmma_tf32.cu``): ``mode`` "grid" (a window of
    at most 16 x 16 cells: tiles of 2 grid rows of 16 key slots),
    "row_tile" (W = 64: a tile is half a grid row) or "generic" (32 keys a
    tile), the head dim rounded up to 16 columns (``dp``), the tiles of
    ``RELPOS_F32_NK`` key slots per unit of 128 query rows, the depths of
    the K / V stage ring, of the unit (Q, and for "row_tile" rel_w) ring and
    of the V landing slots, and the shared memory of a block in bytes."""
    mode: str
    dp: int
    tiles: int
    kv_stages: int
    u_stages: int
    v_slots: int
    smem: int


RELPOS_F32_SMEM_FIXED = 1024 + 256  # wt::SMEM_FIXED: alignment slack, mbarriers
RELPOS_F32_NK = 32  # wt::NK


def _check_relpos_head_dim(d):
    if d < 4 or d % 4 or d > RELPOS_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"K6 (attn_relpos) takes a head_dim that is a multiple of 4 up "
            f"to {RELPOS_MAX_HEAD_DIM}, got {d}")


def _f32_rings(tiles):
    """(K / V stages, unit stages, V slots) of the f32 K6 in the order its
    plan tries them: a short unit (a window: fewer than 16 tiles) wants the
    next unit's Q landing while it computes, two unit stages beside at least
    two K / V stages; a long one the deepest K / V ring."""
    deep = [(kv, 1, v) for kv in (4, 3, 2, 1) for v in (2, 1)]
    if tiles >= 16:
        return deep
    return [(kv, 2, v) for kv in (3, 2) for v in (2, 1)] + deep


@functools.lru_cache(maxsize=None)
def relpos_plan_f32(d: int, n: int, hw) -> RelposPlanF32:
    """The f32 K6's (and K1's) plan for head dim ``d`` over an ``hw`` grid
    of ``n`` tokens (``RelposPlanF32``): a stage of the K / V ring holds K,
    its lo part and V^T's hi and lo parts (16 nk dp bytes), a unit stage Q
    (512 dp) and for "row_tile" the unit's rel_w rows (32 KB), a V landing
    slot 4 nk dp; the first rings of ``_f32_rings`` that fit in a block's
    shared memory. Raises where none fits."""
    _check_relpos_head_dim(d)
    dp = -(-d // 16) * 16
    h, w = hw
    mode = ("grid" if h <= 16 and w <= 16 else
            "row_tile" if w == 64 else "generic")
    nk = RELPOS_F32_NK
    tiles = -(-h // (nk // 16)) if mode == "grid" else -(-n // nk)
    unit = 128 * dp * 4 + (128 * 64 * 4 if mode == "row_tile" else 0)
    stage, slot = 16 * nk * dp, 4 * nk * dp
    for kv_stages, u_stages, v_slots in _f32_rings(tiles):
        smem = (RELPOS_F32_SMEM_FIXED + u_stages * unit + kv_stages * stage
                + v_slots * slot)
        if smem <= SMEM_MAX:
            return RelposPlanF32(mode, dp, tiles, kv_stages, u_stages,
                                 v_slots, smem)
    raise NotImplementedError(
        f"K6 f32: no plan fits in shared memory for head_dim {d} over a "
        f"{hw} grid")


@dataclasses.dataclass(frozen=True)
class DqPlan:
    """The launch plan of K5's bf16 dq kernel (``attn_bwd_dq_wgmma_kernel``):
    ``mode`` "row_tile" (W = 64: a 64-key tile is one grid row), "grid" (a
    window of at most 14 x 16 cells: tiles of 7 grid rows, 112 key slots)
    or "generic" (64 keys a tile, drel through a shared tile), the key tile
    (``nk``), the tiles per unit of 128 query rows, the depths of the K / V
    ring and of the unit (Q, dO, L, D and bias rows) ring, and the shared
    memory of a block in bytes."""
    mode: str
    nk: int
    tiles: int
    kv_stages: int
    u_stages: int
    smem: int


DQ_SMEM_FIXED = 1024 + 128  # dq::SMEM_FIXED: alignment slack, mbarriers


def _dq_stage_bytes(nk, h, w, generic):
    """(unit stage, K / V stage, both warpgroups' sums) bytes:
    ``dq::Layout`` of csrc/attention_bwd.cu (a unit stage's Q and dO of 128
    rows, its L and D and, but for GENERIC, its bias rows; K and V of NK key
    slots; GENERIC a warpgroup's bf16 ds tile of 64 x 72 and its f32 dRh
    and dRw)."""
    up = lambda x, m: -(-x // m) * m
    rows = 2 * 128 * HEAD_DIM * 2 + 2 * 4 * 128
    rel = 0 if generic else (up(2 * (128 * h + 16), 16)
                             + up(2 * (128 * w + 16), 16))
    sums = 2 * (2 * 64 * 72 + 4 * 64 * (h + w)) if generic else 0
    return up(rows + rel, 1024), 2 * nk * HEAD_DIM * 2, sums


@functools.lru_cache(maxsize=None)
def dq_plan(n: int, hw) -> DqPlan:
    """K5's bf16 dq kernel's plan over an ``hw`` grid of ``n`` tokens: the
    deepest rings that fit in a block's shared memory (``_ring_depths``).
    Raises where none fits."""
    h, w = hw
    if w == 64:
        mode, nk, tiles = "row_tile", 64, h
    elif h <= 14 and w <= 16:
        mode, nk, tiles = "grid", 112, -(-h // 7)
    else:
        mode, nk, tiles = "generic", 64, -(-n // 64)
    unit, kv, sums = _dq_stage_bytes(nk, h, w, mode == "generic")
    for u_stages, kv_stages in _ring_depths(tiles):
        smem = DQ_SMEM_FIXED + u_stages * unit + kv_stages * kv + sums
        if smem <= SMEM_MAX:
            return DqPlan(mode, nk, tiles, kv_stages, u_stages, smem)
    raise NotImplementedError(
        f"K5 bf16 dq: no plan fits in shared memory over a {hw} grid (one "
        f"stage takes {DQ_SMEM_FIXED + unit + kv + sums} bytes)")


@dataclasses.dataclass(frozen=True)
class DqPlanF32:
    """The launch plan of K5's f32 dq kernel (``attn_bwd_dq_wgmma_tf32_kernel``,
    ``csrc/attention_bwd_wgmma_tf32.cu``): ``mode`` "grid" (W <= 16: a tile
    is two grid rows of 16 key slots) or "row_tile" (16 < W <= 64: a grid
    row is ``tpr`` tiles of 32 slots; 2 at W = 64), ``tpr`` (0 for "grid"),
    the key tiles, the bytes of a key tile's image in the scratch tensor
    (K^T raw and lo, and for "row_tile" K's and V's lo rows: "grid" has the
    kernel write those), the depths of the K / V ring and of the unit (Q,
    dO and for "row_tile" L, D and rel_w rows of 128 queries) ring, and the
    shared memory of a block in bytes."""
    mode: str
    tpr: int
    tiles: int
    image: int
    kv_stages: int
    u_stages: int
    smem: int


@dataclasses.dataclass(frozen=True)
class DkvPlanF32:
    """The launch plan of K5's f32 dk/dv kernel
    (``attn_bwd_dkv_wgmma_tf32_kernel``): ``mode`` "row_tile" (W = 64 and an
    even H: a warpgroup's 64 keys are one grid row) or "generic", the query
    tiles of 32, the bytes of a query tile's image in the scratch tensor
    (Q's and dO's lo rows and transposes, raw and lo, L, D and bias rows),
    the depth of the ring of query stages, and the shared memory of a block
    in bytes."""
    mode: str
    qtiles: int
    image: int
    stages: int
    smem: int


BWD_F32_SMEM_FIXED = 1024 + 128  # bt::SMEM_FIXED: alignment slack, mbarriers
BWD_F32_PART = 32 * HEAD_DIM * 4  # bt::PART: one 32 x 64 f32 part of an image
BWD_F32_RAW = 2 * BWD_F32_PART  # bt::RAW: a stage's raw rows, landed by TMA
BWD_F32_KV_STAGE = 6 * BWD_F32_PART  # bt::KV_STAGE: the dq kernel's K / V stage
BWD_F32_UNIT_KV = 4 * 128 * 128  # bt::UNIT_KV: a dk/dv unit's K and V


def _up(x, m):
    return -(-x // m) * m


def _factor_pitch(length):
    """bt::pitch: a staged bias row of the dk/dv image, padded by 4 floats
    where its length is a multiple of 8."""
    return length if length % 8 else length + 4


@functools.lru_cache(maxsize=None)
def dq_plan_f32(n: int, hw) -> DqPlanF32:
    """K5's f32 dq kernel's plan over an ``hw`` grid of ``n`` tokens: a unit
    stage holds Q and dO (2 x 32 KB) and for "row_tile" L and D (1 KB) and
    the unit's rel_w rows (128 x (32 tpr + 8) f32, 1 KB-aligned), a K / V
    stage a key tile's K and V rows (16 KB, TMA), their lo parts (16 KB:
    "grid" writes them in the kernel, "row_tile" lands them with the image)
    and K^T's raw and lo parts (16 KB, the image); the deepest rings that
    fit in a block's shared memory, with two K / V stages at least where a
    unit has more than one tile. Raises where none fits (W > 64)."""
    h, w = hw
    if w > 64:
        raise NotImplementedError(
            f"K5 f32 dq: no plan for a {hw} grid (a grid row takes at most "
            "64 keys)")
    tpr = 0 if w <= 16 else -(-w // 32)
    tiles = h * tpr if tpr else -(-h // 2)
    unit = (_up(2 * 2 * 128 * 128 + 2 * 4 * 128 + 4 * 128 * (32 * tpr + 8),
                1024) if tpr else 2 * 2 * 128 * 128)
    for u_stages, kv_stages in ((2, 3), (2, 2), (1, 4), (1, 3), (1, 2),
                                (1, 1)):
        smem = (BWD_F32_SMEM_FIXED + u_stages * unit
                + kv_stages * BWD_F32_KV_STAGE)
        if smem <= SMEM_MAX and (kv_stages > 1 or tiles == 1):
            # the stage past the raw rows ("row_tile") or past their lo
            # parts too ("grid")
            image = BWD_F32_KV_STAGE - (1 if tpr else 2) * BWD_F32_RAW
            return DqPlanF32("row_tile" if tpr else "grid", tpr, tiles,
                             image, kv_stages, u_stages, smem)
    raise NotImplementedError(
        f"K5 f32 dq: no plan fits in shared memory over a {hw} grid")


@functools.lru_cache(maxsize=None)
def dkv_plan_f32(n: int, hw) -> DkvPlanF32:
    """K5's f32 dk/dv kernel's plan over an ``hw`` grid of ``n`` tokens: a
    unit's K and V (64 KB) beside a ring of query stages, each a query
    tile's Q and dO rows (16 KB, TMA) and its image (6 parts of 8 KB, L and
    D, 32 rel_w rows and, but for "row_tile", 32 rel_h rows of
    ``_factor_pitch`` f32; the stage 1 KB-aligned); the deepest ring of up
    to three stages that fits (one only where a bias row is ~100 wide or
    more: no SAM grid). Raises where none fits."""
    h, w = hw
    row_tile = w == 64 and h % 2 == 0
    stage = _up(8 * BWD_F32_PART + 2 * 4 * 32 + 4 * 32 * _factor_pitch(w)
                + (0 if row_tile else 4 * 32 * _factor_pitch(h)), 1024)
    image = stage - BWD_F32_RAW
    for stages in (3, 2, 1):
        smem = BWD_F32_SMEM_FIXED + BWD_F32_UNIT_KV + stages * stage
        if smem <= SMEM_MAX:
            return DkvPlanF32("row_tile" if row_tile else "generic",
                              -(-n // 32), image, stages, smem)
    raise NotImplementedError(
        f"K5 f32 dk/dv: no plan fits in shared memory over a {hw} grid (a "
        f"query tile's image takes {image} bytes)")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(qkv, rel_h, rel_w, hw, num_heads):
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3C) with C % heads == 0, got "
                         f"{tuple(qkv.shape)} for {num_heads} heads")
    b, n, c3 = qkv.shape
    h, w = hw
    if n != h * w:
        raise ValueError(f"N={n} is not hw={hw}")
    if tuple(rel_h.shape) != (b, num_heads, n, h):
        raise ValueError(f"rel_h must be {(b, num_heads, n, h)}, got "
                         f"{tuple(rel_h.shape)}")
    if tuple(rel_w.shape) != (b, num_heads, n, w):
        raise ValueError(f"rel_w must be {(b, num_heads, n, w)}, got "
                         f"{tuple(rel_w.shape)}")


def _split_heads(qkv, num_heads):
    """(B, N, 3C) -> q, k, v each (B, heads, N, d) in f32."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    x = qkv.float().reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _merge_heads(x):
    """(B, heads, N, d) -> (B, N, heads * d)."""
    b, nh, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, nh * d)


def _scores(qkv, rel_h, rel_w, hw, num_heads):
    """q, k, v (f32, q already times 1/sqrt(d)) and the (B, heads, N, N) f32
    scores with the materialised bias."""
    b, n, _ = qkv.shape
    h, w = hw
    q, k, v = _split_heads(qkv, num_heads)
    q = q * q.shape[-1] ** -0.5
    bias = (rel_h.float().reshape(b, num_heads, n, h, 1)
            + rel_w.float().reshape(b, num_heads, n, 1, w))
    s = torch.matmul(q, k.transpose(-1, -2))
    return q, k, v, s.add_(bias.reshape(b, num_heads, n, n))


def normalised_rounding(b: int, n: int) -> bool:
    """True where the JAX package's ``flash_attention_packed`` takes its
    grouped-window kernel (``_windowed_group_kernel``), which rounds the
    normalised p / l to the input dtype before the p.v product: one query
    and one key block (N <= 512 with the default tiles) and a batch of
    windows that ``_window_group`` groups (b divisible by 2 or 5). Every
    other call takes ``_packed_kernel``, which rounds the un-normalised p
    and divides last. This copy of the rule imports nothing of the JAX
    package."""
    return n <= 512 and (b % 2 == 0 or b % 5 == 0)


def packed_attention_plain(qkv, rel_h, rel_w, *, hw, num_heads: int,
                           return_lse: bool = False, normalised=None):
    """Plain PyTorch version: materialised (N, N) bias, f32 softmax, the
    output cast back to the input dtype (``attention_reference`` math on the
    packed qkv). ``return_lse=True`` also returns the rows' logsumexp of the
    scaled scores, (B, heads, N) f32, as K1 / K2 write it.

    The probabilities enter the p.v product where the TPU kernel of the JAX
    package's route takes them (``normalised_rounding(B, N)``, unless
    ``normalised`` says which), rounded to the input dtype (in f32 nothing
    is rounded): ``_windowed_group_kernel`` the normalised p / l;
    ``_packed_kernel`` (every other B and N) the un-normalised p =
    exp(s - max), the f32 product divided by the f32 denominator last.
    ``windowed_image_attention_plain`` asks for p / l, the rounding of the
    TPU ``_windowed_image_kernel``."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    _, _, v, s = _scores(qkv, rel_h, rel_w, hw, num_heads)
    if normalised is None:
        normalised = normalised_rounding(qkv.shape[0], qkv.shape[1])
    p = (s - s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    if normalised:  # out of place: autograd keeps exp's output
        out = torch.matmul(_rnd(p / denom, qkv.dtype), v)
    else:
        out = torch.matmul(_rnd(p, qkv.dtype), v).div_(denom)
    del p
    out = _merge_heads(out).to(qkv.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def relpos_attention_plain(qkv, rel_h, rel_w, *, hw, num_heads: int,
                           return_lse: bool = False):
    """Plain PyTorch version of K6, rounding where the TPU ``_flash_kernel``
    rounds: the scale multiplies the f32 score after the q.k product (not q
    before it), the un-normalised p = exp(s - max) is rounded to qkv's dtype
    for the p.v product while the denominator sums the f32 p, and the
    division comes last with one rounding of the output. Any head dim.
    ``return_lse=True`` also returns the rows' logsumexp of the scaled
    scores, (B, heads, N) f32, as the f32 K1 (this kernel) writes it."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    bias = (rel_h.float().reshape(b, num_heads, n, hw[0], 1)
            + rel_w.float().reshape(b, num_heads, n, 1, hw[1]))
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s.add_(bias.reshape(b, num_heads, n, n))
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(_rnd(p, qkv.dtype), v) / denom
    out = _merge_heads(out).to(qkv.dtype)
    return (out, lse) if return_lse else out


def window_partition(x, window_size: int):
    """(B, H, W, C) → (B*nW, ws, ws, C) with bottom/right zero padding."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = h + pad_h, w + pad_w
    x = x.reshape(b, ph // window_size, window_size, pw // window_size,
                  window_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window_size, window_size, c), (ph, pw)


def window_unpartition(windows, window_size: int, padded_hw, hw):
    ph, pw = padded_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((ph // window_size) * (pw // window_size))
    x = windows.reshape(b, ph // window_size, pw // window_size, window_size,
                        window_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
    return x[:, :h, :w, :]


def _check_image(qkv_img, rel, qkv_bias, ws, num_heads):
    if qkv_img.dim() != 4 or qkv_img.shape[3] != 3 * num_heads * HEAD_DIM:
        raise ValueError(
            f"qkv_img must be (B, H, W, 3 * heads * {HEAD_DIM}), got "
            f"{tuple(qkv_img.shape)} for {num_heads} heads (the image-layout "
            f"windowed attention takes head_dim {HEAD_DIM})")
    b, h, w, c3 = qkv_img.shape
    if ws * ws > WINDOW_MAX_TOKENS:
        raise ValueError(f"window {ws}x{ws} holds more than "
                         f"{WINDOW_MAX_TOKENS} tokens")
    if tuple(rel.shape) != (b, num_heads, h, w, 2 * ws):
        raise ValueError(f"rel must be {(b, num_heads, h, w, 2 * ws)}, got "
                         f"{tuple(rel.shape)}")
    if tuple(qkv_bias.shape) != (c3,):
        raise ValueError(f"qkv_bias must be ({c3},), got "
                         f"{tuple(qkv_bias.shape)}")


def partition_image_operands(qkv_img, rel, qkv_bias, ws: int):
    """K7's operands as the partitioned route sees them: the image-layout
    qkv padded to whole windows with the bias row (what the qkv projection
    makes of a zero-padded token) and cut into windows (BnW, ws^2, 3C), the
    bias factors per window, rel_h and rel_w (BnW, heads, ws^2, ws) with
    zeros for pad queries (their outputs are dropped), and the padded grid
    for ``window_unpartition``."""
    b, h, w, c3 = qkv_img.shape
    heads = rel.shape[1]
    ph, pw = -(-h // ws) * ws, -(-w // ws) * ws
    x = qkv_bias.to(qkv_img.dtype).expand(b, ph, pw, c3).clone()
    x[:, :h, :w] = qkv_img
    win, padded_hw = window_partition(x, ws)
    r, _ = window_partition(rel.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1),
                            ws)
    r = r.reshape(-1, ws * ws, heads, 2 * ws).transpose(1, 2)
    return (win.reshape(-1, ws * ws, c3), r[..., :ws].contiguous(),
            r[..., ws:].contiguous(), padded_hw)


def windowed_image_attention_plain(qkv_img, rel, qkv_bias, *, ws: int,
                                   num_heads: int):
    """Plain PyTorch version of K7, by way of the partitioned route:
    ``partition_image_operands``, ``packed_attention_plain`` per window (in
    bf16 its windowed rounding point, the TPU ``_windowed_image_kernel``'s:
    the normalised p / l rounded before the p.v product), un-partition and
    crop."""
    _check_image(qkv_img, rel, qkv_bias, ws, num_heads)
    _, h, w, c3 = qkv_img.shape
    win, rel_h, rel_w, padded_hw = partition_image_operands(qkv_img, rel,
                                                            qkv_bias, ws)
    out = packed_attention_plain(win, rel_h, rel_w, hw=(ws, ws),
                                 num_heads=num_heads, normalised=True)
    return window_unpartition(out.reshape(-1, ws, ws, c3 // 3), ws,
                              padded_hw, (h, w)).contiguous()


def _rnd(x, dtype):
    """x rounded to ``dtype`` and widened back to f32 (identity for f32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def bwd_dvec(g_out, out, num_heads: int):
    """D = rowsum(dO * O) per head, (B, heads, N) f32, from the output
    cotangent as received and the forward's output (B, N, C) — ``f_bwd`` in
    the JAX package, an elementwise reduction outside any kernel there
    too."""
    b, n, _ = out.shape
    d = (g_out.float() * out.float()).reshape(b, n, num_heads, -1).sum(-1)
    return d.transpose(1, 2).contiguous()


def packed_attention_bwd_plain(qkv, rel_h, rel_w, g_out, lse, dvec, *, hw,
                               num_heads: int):
    """Plain PyTorch version of K5: (dqkv (B, N, 3C), drel_h, drel_w) from the
    forward's inputs, the output cotangent ``g_out`` (B, N, C) in qkv's
    dtype, the forward's ``lse`` and ``dvec`` = rowsum(g_out * out) per head,
    both (B, heads, N) f32.

    Rounds where the TPU kernels round (``_packed_bwd_dq_kernel``,
    ``_packed_bwd_dkv_kernel``): for dq and drel, ds = rnd(p * (dp - D))
    with p in f32, dq = rnd(sum / sqrt(d)), drel the f32 sums of that ds;
    for dk and dv, p_b = rnd(p) first and ds = rnd(p_b * (dp - D)). rnd
    rounds to qkv's dtype (nothing in f32). Any head_dim d (the kernels
    take 64)."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    dt = qkv.dtype
    b, n, _ = qkv.shape
    h, w = hw
    q, k, v, p = _scores(qkv, rel_h, rel_w, hw, num_heads)
    g = g_out.float().reshape(b, n, num_heads, -1).transpose(1, 2)
    p.sub_(lse[..., None]).exp_()  # f32
    dp = torch.matmul(g, v.transpose(-1, -2)).sub_(dvec[..., None])
    ds = _rnd(p * dp, dt)  # the dq kernel's ds
    dq = (torch.matmul(ds, k) * k.shape[-1] ** -0.5).to(dt)
    drel_h = ds.reshape(b, num_heads, n, h, w).sum(-1).to(rel_h.dtype)
    drel_w = ds.reshape(b, num_heads, n, h, w).sum(-2).to(rel_w.dtype)
    del ds
    p = _rnd(p, dt)  # the dk/dv kernel's p, then its ds
    dv = torch.matmul(p.transpose(-1, -2), g).to(dt)
    ds = _rnd(p.mul_(dp), dt)
    dk = torch.matmul(ds.transpose(-1, -2), q).to(dt)
    dqkv = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)],
                     dim=-1)
    return dqkv, drel_h, drel_w


def _bind(name):
    lib = kernels.library(name)
    if not _BOUND[name]:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "attention_relpos_wgmma_tf32":
            fns = [(lib.dhoct_attn_relpos_f32, [p] * 5 + [i] * 11 + [p])]
        elif name == "attention_relpos_wgmma":
            fns = [(lib.dhoct_attn_relpos_bf16, [p] * 5 + [i] * 13 + [p])]
        elif name == "attention_winimg":
            fns = [(lib.dhoct_attn_windowed_image, [p] * 4 + [i] * 6 + [p])]
        elif name == "attention_bwd_wgmma_tf32":
            fns = [(lib.dhoct_attn_bwd_dq_f32, [p] * 10 + [i] * 10 + [p]),
                   (lib.dhoct_attn_bwd_dkv_f32, [p] * 8 + [i] * 8 + [p])]
        else:
            fns = [(lib.dhoct_attn_bwd_dq, [p] * 9 + [i] * 9 + [p]),
                   (lib.dhoct_attn_bwd_dkv, [p] * 7 + [i] * 6 + [p])]
        for fn, sig in fns:
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        lib.dhoct_error_string.argtypes = [ctypes.c_int]
        lib.dhoct_error_string.restype = ctypes.c_char_p
        _BOUND[name] = True
    return lib


def _packed_route(qkv, num_heads) -> bool:
    """True where the JAX package takes its packed kernels (K1 / K2 here):
    head_dim 64 and an even head count; every other model goes to K6."""
    return (qkv.shape[2] // 3 // num_heads == HEAD_DIM
            and num_heads % 2 == 0)


def _kernel_dims(qkv, num_heads):
    d = qkv.shape[2] // 3 // num_heads
    if d != HEAD_DIM:
        raise NotImplementedError(
            f"K1 / K2 and the backward K5 take head_dim {HEAD_DIM}, got {d}. "
            "flash_attention_packed sends the forward of any other head dim "
            "to K6 (attn_relpos), which has no backward, as the TPU "
            "flash_attention_relpos has none: train such a model on the "
            "materialized route, models.set_flash_attention('off'), as the "
            "JAX package does")


def attention_fwd_cuda(qkv, rel_h, rel_w, *, hw, num_heads: int,
                       return_lse: bool = False):
    """Launch K1 (N > WINDOW_MAX_TOKENS) or K2; same contract as
    ``packed_attention_plain``. In bf16 both are the bf16 K6's kernel
    (``attn_relpos_wgmma_kernel`` on ``relpos_plan(64, n, hw, norm)``), with
    the logsumexp rows, at the rounding point of the JAX route
    (``normalised_rounding(B, N)``: the normalised p, K2's on SAM's
    windows, or the un-normalised p divided last, K6's and K1's); at head
    dim 64 it computes the same function. In f32 both are the f32 K6's
    kernel (``attn_relpos_wgmma_tf32_kernel`` on ``relpos_plan_f32``) with
    the logsumexp rows. Its launches count as ``attn_windowed`` (N <=
    WINDOW_MAX_TOKENS) or ``attn_global``."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, c3 = qkv.shape
    _kernel_dims(qkv, num_heads)
    kernels.check_operands("attention", (qkv, rel_h, rel_w), (qkv.dtype,) * 3)
    name = "attn_windowed" if n <= WINDOW_MAX_TOKENS else "attn_global"
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, n), dtype=torch.float32,
                       device=qkv.device) if return_lse else None)
    if qkv.dtype == torch.bfloat16:
        lib, err = _launch_relpos_bf16(qkv, rel_h, rel_w, out, lse, hw,
                                       num_heads, normalised_rounding(b, n))
    else:
        lib, err = _launch_relpos_f32(qkv, rel_h, rel_w, out, lse, hw,
                                      num_heads)
    kernels.raise_on_error(err, lib.dhoct_error_string, name)
    LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def _padded_heads(qkv, num_heads, dp):
    """qkv with each head padded to ``dp`` columns of zeros, (B, N, 3 heads
    dp); qkv itself where its heads have ``dp`` columns already."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if d == dp:
        return qkv
    return torch.nn.functional.pad(qkv.view(b, n, 3 * num_heads, d),
                                   (0, dp - d)).view(b, n, 3 * num_heads * dp)


def relpos_blocks(b: int, num_heads: int, n: int, sm_count: int) -> int:
    """Persistent blocks of a K6 launch (either type) over its units of 128
    query rows of one (batch, head): one an SM at most."""
    return min(b * num_heads * -(-n // 128), sm_count)


def _launch_relpos_f32(qkv, rel_h, rel_w, out, lse, hw, num_heads):
    """Launch ``attn_relpos_wgmma_tf32_kernel`` on the plan of
    ``relpos_plan_f32``, one persistent block per SM at most, writing
    ``out`` and, where ``lse`` is not None, the rows' logsumexp; returns
    (the library, its error code). Where the head dim is no multiple of 16
    qkv is first copied with each head padded to ``dp`` columns of zeros (no
    ViT's head: 64 and 80 are multiples)."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    plan = relpos_plan_f32(d, n, tuple(hw))
    src = _padded_heads(qkv, num_heads, plan.dp)
    lib = _bind("attention_relpos_wgmma_tf32")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with kernels.on_device(qkv.device):
        err = lib.dhoct_attn_relpos_f32(
            src.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, n,
            num_heads, d, hw[0], hw[1], src.shape[2] // (3 * num_heads),
            plan.kv_stages, plan.v_slots, plan.u_stages,
            relpos_blocks(b, num_heads, n, kernels.sm_count(qkv.device)),
            stream)
    return lib, err


def _launch_relpos_bf16(qkv, rel_h, rel_w, out, lse, hw, num_heads,
                        norm=False):
    """Launch ``attn_relpos_wgmma_kernel`` on the plan of ``relpos_plan``,
    one persistent block per SM at most, writing ``out`` and, where ``lse``
    is not None, the rows' logsumexp, with p rounded where ``norm`` says
    (``RelposPlan``); returns (the library, its error code).
    The kernel reads each head in slabs of 16 columns: where the head dim is
    no multiple of 16, qkv is first copied with each head padded to ``dp``
    columns of zeros, for the same kernel (no ViT's head: 64 and 80 are
    multiples)."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    plan = relpos_plan(d, n, tuple(hw), norm)
    src = _padded_heads(qkv, num_heads, plan.dp)
    lib = _bind("attention_relpos_wgmma")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with kernels.on_device(qkv.device):
        err = lib.dhoct_attn_relpos_bf16(
            src.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, n,
            num_heads, d, hw[0], hw[1], src.shape[2] // (3 * num_heads),
            plan.nk, plan.kv_stages, plan.u_stages, plan.passes,
            int(plan.norm),
            relpos_blocks(b, num_heads, n, kernels.sm_count(qkv.device)),
            stream)
    return lib, err


def attention_relpos_cuda(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Launch K6 (f32 ``attn_relpos_wgmma_tf32_kernel``:
    ``_launch_relpos_f32``, bf16 ``attn_relpos_wgmma_kernel``:
    ``_launch_relpos_bf16``); same contract as ``relpos_attention_plain``."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, c3 = qkv.shape
    _check_relpos_head_dim(c3 // 3 // num_heads)
    kernels.check_operands("attn_relpos", (qkv, rel_h, rel_w),
                           (qkv.dtype,) * 3)
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if qkv.dtype == torch.float32:
        lib, err = _launch_relpos_f32(qkv, rel_h, rel_w, out, None, hw,
                                      num_heads)
    else:
        lib, err = _launch_relpos_bf16(qkv, rel_h, rel_w, out, None, hw,
                                       num_heads)
    kernels.raise_on_error(err, lib.dhoct_error_string, "attn_relpos")
    LAUNCHES["attn_relpos"] += 1
    return out


def attention_windowed_image_cuda(qkv_img, rel, qkv_bias, *, ws: int,
                                  num_heads: int):
    """Launch K7; same contract as ``windowed_image_attention_plain``."""
    _check_image(qkv_img, rel, qkv_bias, ws, num_heads)
    b, h, w, c3 = qkv_img.shape
    bias = qkv_bias.to(qkv_img.dtype).contiguous()
    kernels.check_operands("attn_windowed_image", (qkv_img, rel, bias),
                           (qkv_img.dtype,) * 3)
    lib = _bind("attention_winimg")
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv_img.dtype,
                      device=qkv_img.device)
    stream = torch.cuda.current_stream(qkv_img.device).cuda_stream
    with torch.cuda.device(qkv_img.device):
        err = lib.dhoct_attn_windowed_image(
            qkv_img.data_ptr(), rel.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, num_heads, ws,
            kernels.DTYPE_CODE[qkv_img.dtype], stream)
    kernels.raise_on_error(err, lib.dhoct_error_string,
                           "attn_windowed_image")
    LAUNCHES["attn_windowed_image"] += 1
    return out


def _bwd_operands(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, hw,
                  num_heads):
    """Check K5's operands; returns (the library of qkv's dtype, operand
    pointers, (B, N, heads, H, W), the stream)."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    _kernel_dims(qkv, num_heads)
    b, n, c3 = qkv.shape
    dt, f32 = qkv.dtype, torch.float32
    args = (qkv, rel_h, rel_w, g_out, lse, dvec, dqkv)
    kernels.check_operands("attn_bwd", args, (dt, dt, dt, dt, f32, f32, dt))
    if (g_out.shape != (b, n, c3 // 3) or lse.shape != (b, num_heads, n)
            or dvec.shape != lse.shape or dqkv.shape != qkv.shape):
        raise ValueError(f"g_out must be {(b, n, c3 // 3)}, lse and dvec "
                         f"{(b, num_heads, n)}, dqkv {tuple(qkv.shape)}; got "
                         f"{tuple(g_out.shape)}, {tuple(lse.shape)}, "
                         f"{tuple(dvec.shape)}, {tuple(dqkv.shape)}")
    lib = _bind("attention_bwd_wgmma_tf32" if dt == f32 else "attention_bwd")
    return (lib, [t.data_ptr() for t in args],
            (b, n, num_heads, hw[0], hw[1]),
            torch.cuda.current_stream(qkv.device).cuda_stream)


def _blocks(qkv, num_heads):
    """Persistent blocks of a K5 launch over units of 128 rows: one an SM
    at most."""
    b, n = qkv.shape[:2]
    return min(b * num_heads * -(-n // 128), kernels.sm_count(qkv.device))


def attention_bwd_dq_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, *, hw,
                          num_heads: int):
    """Launch K5's dq kernel: writes dq into the q columns of ``dqkv``
    (B, N, 3C) and returns (drel_h, drel_w). bf16
    ``attn_bwd_dq_wgmma_kernel`` on the plan of ``dq_plan``; f32
    ``attn_bwd_dq_wgmma_tf32_kernel`` on the plan of ``dq_plan_f32``, after
    its pre-pass writes the key tiles' images into a scratch tensor; one
    persistent block per SM at most."""
    lib, ptrs, dims, stream = _bwd_operands(qkv, rel_h, rel_w, g_out, lse,
                                            dvec, dqkv, hw, num_heads)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    b, n = qkv.shape[:2]
    blocks = _blocks(qkv, num_heads)
    with kernels.on_device(qkv.device):
        if qkv.dtype == torch.float32:
            p = dq_plan_f32(n, tuple(hw))
            img = torch.empty(b * num_heads * p.tiles * p.image,
                              dtype=torch.uint8, device=qkv.device)
            err = lib.dhoct_attn_bwd_dq_f32(
                *ptrs, drel_h.data_ptr(), drel_w.data_ptr(), img.data_ptr(),
                *dims, p.tpr, p.tiles, p.kv_stages, p.u_stages, blocks,
                stream)
        else:
            p = dq_plan(n, tuple(hw))
            err = lib.dhoct_attn_bwd_dq(
                *ptrs, drel_h.data_ptr(), drel_w.data_ptr(), *dims, p.nk,
                p.kv_stages, p.u_stages, blocks, stream)
    kernels.raise_on_error(err, lib.dhoct_error_string, "attn_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    return drel_h, drel_w


def attention_bwd_dkv_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, *, hw,
                           num_heads: int):
    """Launch K5's dk/dv kernel: writes dk and dv into the k and v columns
    of ``dqkv`` (B, N, 3C). bf16 ``attn_bwd_dkv_wgmma_kernel`` (the library
    sizes its ring of query stages); f32 ``attn_bwd_dkv_wgmma_tf32_kernel``
    on the plan of ``dkv_plan_f32``, after its pre-pass writes the query
    tiles' images into a scratch tensor; one persistent block per SM at
    most."""
    lib, ptrs, dims, stream = _bwd_operands(qkv, rel_h, rel_w, g_out, lse,
                                            dvec, dqkv, hw, num_heads)
    b, n = qkv.shape[:2]
    blocks = _blocks(qkv, num_heads)
    with kernels.on_device(qkv.device):
        if qkv.dtype == torch.float32:
            p = dkv_plan_f32(n, tuple(hw))
            img = torch.empty(b * num_heads * p.qtiles * p.image,
                              dtype=torch.uint8, device=qkv.device)
            err = lib.dhoct_attn_bwd_dkv_f32(*ptrs, img.data_ptr(), *dims,
                                             p.image, p.stages, blocks,
                                             stream)
        else:
            err = lib.dhoct_attn_bwd_dkv(*ptrs, *dims, blocks, stream)
    kernels.raise_on_error(err, lib.dhoct_error_string, "attn_bwd_dkv")
    LAUNCHES["attn_bwd_dkv"] += 1


def attention_bwd_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, *, hw,
                       num_heads: int):
    """Launch K5, the dq kernel and then the dk/dv kernel, into one dqkv;
    same contract as ``packed_attention_bwd_plain``."""
    dqkv = torch.empty_like(qkv)
    kw = dict(hw=hw, num_heads=num_heads)
    drel_h, drel_w = attention_bwd_dq_cuda(qkv, rel_h, rel_w, g_out, lse,
                                           dvec, dqkv, **kw)
    attention_bwd_dkv_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, **kw)
    return dqkv, drel_h, drel_w


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {t.device}")
    return t.device.type


class _PackedAttention(torch.autograd.Function):
    """K1 / K2 forward with the logsumexp rows saved, K5 backward (the plain
    versions of both on a CPU tensor) — the JAX package's
    ``packed_attention_vjp``."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, hw, num_heads):
        kw = dict(hw=hw, num_heads=num_heads)
        if _device_kind(qkv) == "cuda":
            out, lse = attention_fwd_cuda(qkv, rel_h, rel_w, return_lse=True,
                                          **kw)
        else:
            out, lse = packed_attention_plain(qkv, rel_h, rel_w,
                                              return_lse=True, **kw)
        ctx.kw = kw
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        return out

    @staticmethod
    def backward(ctx, g_out):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dvec = bwd_dvec(g_out, out, ctx.kw["num_heads"])
        # autograd may hand over a strided cotangent; the kernels take it
        # contiguous, in qkv's dtype
        g = g_out.to(qkv.dtype).contiguous()
        if _device_kind(qkv) == "cuda":
            dqkv, drh, drw = attention_bwd_cuda(qkv, rel_h, rel_w, g, lse,
                                                dvec, **ctx.kw)
        else:
            dqkv, drh, drw = packed_attention_bwd_plain(qkv, rel_h, rel_w, g,
                                                        lse, dvec, **ctx.kw)
        return dqkv, drh.to(rel_h.dtype), drw.to(rel_w.dtype), None, None


def flash_attention_packed(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Attention over the fused qkv projection.

    qkv:   (B, N, 3C), feature order (3, heads, head_dim)
    rel_h: (B, heads, N, hw[0]) bias factor over key rows
    rel_w: (B, heads, N, hw[1]) bias factor over key columns
    Returns (B, N, C) in token order, in qkv's dtype.

    CPU tensors take the plain versions. CUDA tensors launch a kernel or
    raise: with head_dim 64 and an even head count (the JAX package's packed
    route) K1 (global) or K2 (windowed, N <= 256), and K5 in the backward;
    any other model K6, forward only (with a gradient to take it raises
    ``NotImplementedError``). Differentiable in qkv, rel_h and rel_w."""
    kind = _device_kind(qkv)
    _check(qkv, rel_h, rel_w, hw, num_heads)
    kw = dict(hw=hw, num_heads=num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad or rel_h.requires_grad
                                    or rel_w.requires_grad):
        return _PackedAttention.apply(qkv, rel_h, rel_w, hw, num_heads)
    if _packed_route(qkv, num_heads):
        if kind == "cpu":
            return packed_attention_plain(qkv, rel_h, rel_w, **kw)
        return attention_fwd_cuda(qkv, rel_h, rel_w, **kw)
    if kind == "cpu":
        return relpos_attention_plain(qkv, rel_h, rel_w, **kw)
    return attention_relpos_cuda(qkv, rel_h, rel_w, **kw)


def flash_attention_windowed_image(qkv_img, rel, qkv_bias, *, ws: int,
                                   num_heads: int):
    """Windowed attention over the image-layout qkv projection, with no
    window partition in device memory.

    qkv_img:  (B, H, W, 3C) qkv projection (bias included) of the H x W real
              tokens, feature order (3, heads, 64)
    rel:      (B, heads, H, W, 2 * ws) per-token bias factors over the key
              rows ([..., :ws]) and key columns ([..., ws:]) of the token's
              window
    qkv_bias: (3C,) the projection's bias: the q, k and v of the pad tokens
              of windows that reach past H or W
    Returns (B, H, W, C) in qkv_img's dtype. Forward only (the JAX function
    is too): tensors that require grad are not supported.

    CPU tensors take ``windowed_image_attention_plain``; CUDA tensors launch
    K7 or raise."""
    kind = _device_kind(qkv_img)
    if torch.is_grad_enabled() and (qkv_img.requires_grad or rel.requires_grad
                                    or qkv_bias.requires_grad):
        raise NotImplementedError(
            "flash_attention_windowed_image is forward-only; the partitioned "
            "route (flash_attention_packed) has the backward")
    if kind == "cpu":
        return windowed_image_attention_plain(qkv_img, rel, qkv_bias, ws=ws,
                                              num_heads=num_heads)
    return attention_windowed_image_cuda(qkv_img, rel, qkv_bias, ws=ws,
                                         num_heads=num_heads)
