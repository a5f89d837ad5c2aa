"""Fused mask-decoder upscaler and hypernetwork product (K3).

``upscale_hyper_masks`` is the port of
``dilabhelmholtzoct_tpu/ops/upscaler.py::upscale_hyper_masks``: SAM's
``output_upscaling`` chain (2x2 transposed conv -> LayerNorm2d -> GELU ->
2x2 transposed conv -> GELU) followed by the per-mask-token hypernetwork
dot, computed per embedding row. Both transposed convolutions have stride ==
kernel, so each is a per-row product, and the (BP, 4G, 4G, C/8) second
upscale never exists in device memory. On a CUDA tensor it launches the
hand-written kernels of ``csrc/upscaler.cu``:

  * ``upscale_fwd`` replacing the TPU ``_fused_fwd`` (``_fwd_kernel``), one
    persistent block per SM: in bf16 ``upscale_fwd_wgmma_kernel`` on wgmma
    with TMA loads (``upscale_fwd_plan_bf16``), in f32
    ``upscale_fwd_tf32_kernel`` (split TF32: hi.hi + hi.lo + lo.hi on the
    TF32 tensor cores, f32 accuracy);
  * the backward replacing the TPU ``_fused_bwd`` (``_bwd_kernel``): it
    recomputes the chain per row and returns d_up together with the
    per-lane weight gradients summed over all rows and the per-pair
    hypernetwork gradient. It is two launches on the tensor cores, in bf16
    and in f32 (split TF32): ``upscale_bwd_rows`` (the row pass; it also
    writes u1g, rnd(d_u2pre) and rnd(d_u1pre) per row as scratch in the
    input dtype; in bf16 ``upscale_bwd_rows_wgmma_kernel`` on wgmma with
    TMA loads, ``rows_plan_bf16``) and ``upscale_bwd_dw`` (the weight pass:
    dW1 and dW2 as
    split-K products over row chunks; in f32 on TF32 wgmma and TMA,
    ``upscale_bwd_dw_tf32_kernel`` on the plan of ``upscale_dw_plan_f32``,
    whose four units of a chunk read 6 KB a row against the rows' 5 KB).

The JAX package routes here only in bf16 unless
``set_fused_upscaler('interpret')`` forces it (``models/sam.py``); the f32
kernels serve that route.

On a CPU tensor the same ``torch.autograd.Function`` runs
``upscale_fwd_plain`` / ``upscale_bwd_plain``, which compute exactly what
the kernels return from the same inputs; ``upscale_bwd_plain`` is the
composition of the two passes' plain twins, ``upscale_bwd_rows_plain`` and
``upscale_bwd_dw_plain``. A CUDA tensor never reaches a plain version: the
kernel launches or the wrapper raises.

Lane layouts (as in the JAX package): axis 1 of the first upscale is
(d, e, c1), 4*C1 lanes; axis 2 of the second is (d, e, f, g, c2), 16*C2
lanes; the output is (BP, G*G, n_out*16) f32 with lanes (t, d, e, f, g),
pixel (4h+2d+f, 4w+2e+g).

Rounding points (the JAX kernel's, ``upscaler.py:77-99,119-138``):
``u1pre = up.W1 + b1`` and its LayerNorm in f32; the LN output rounded to
the input dtype before a f32 GELU, rounded again (``u1g``);
``u2pre = u1g.W2 + b2`` in f32, rounded, GELU, rounded (``u2g``); the
hypernetwork product in f32. GELU is the tanh form for bf16 and the erf form
for f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import kernels

# launch counts of the K3 kernels; a plain integer each, reset by the caller
LAUNCHES = {"upscale_fwd": 0, "upscale_bwd": 0, "upscale_bwd_dw": 0}
CHANNELS = 256     # the only decoder width the CUDA kernels take (every SAM)
MAX_OUT = 4        # mask tokens per pair the kernels take
ROW_SLOTS = 4      # 16-row tiles in flight per block of the f32 row pass,
                   # a warp pair each
# the bf16 row pass (rwu:: in csrc/upscaler.cu): units of 64 rows of a
# pair, both warpgroups on a unit, one slot of its up rows and one of its
# rnd(d_u1pre) rows (32 KB each) beside W1 and W2 (144 KB), the
# warpgroups' d_hyper sums (8 KB each) and the pair's hyper (two units'
# 256 B); one partial of the column sums a
# block and warp index (ROWS_PARTS a block), of d_hyper a unit
ROWS_RR = 64
ROWS_PARTS = 4
ROWS_SMEM = 1024 + 2 * (ROWS_RR * 2 * CHANNELS) + 2 * (
    CHANNELS * CHANNELS + (CHANNELS // 4) * (CHANNELS // 2)) + 2 * 4 * (
    4 * MAX_OUT * 128) + 2 * 2 * MAX_OUT * (CHANNELS // 8) + 64
# the bf16 forward (fwu::): units of 64 rows of a pair shared by both
# warpgroups, W1 and W2 (144 KB) beside two slots of up rows (32 KB each)
FWD_SMEM = 1024 + 2 * (CHANNELS * CHANNELS + (CHANNELS // 4) * (
    CHANNELS // 2)) + 2 * (ROWS_RR * 2 * CHANNELS) + 64
F32_ROWS = 64      # rows of an f32 super-tile (dec32::ROWS)
DW_ROWS = 32       # rows per stage of the bf16 weight pass (dec::DW_SR)
DW32_ROWS = 16     # rows per stage of the f32 weight pass (dwu::KR)
DW32_STAGES = 6    # its ring (dwu::MAX_STAGES: 6 x 24 KB beside 64 KB of B)

_BOUND = False
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _gelu(x32, approx: bool):
    return F.gelu(x32, approximate="tanh" if approx else "none")


def _gelu_grad(x32, approx: bool):
    if approx:
        x2 = x32 * x32
        t = torch.tanh(_SQRT_2_OVER_PI * (x32 + 0.044715 * x32 * x2))
        di = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * x2)
        return 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * di
    phi = torch.exp(-0.5 * x32 * x32) * (1.0 / math.sqrt(2.0 * math.pi))
    cdf = 0.5 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))
    return cdf + x32 * phi


def _rnd(x32, dtype):
    """Round an f32 tensor to ``dtype`` and widen it back."""
    return x32.to(dtype).float()


def _chain(up, w1, b1, g, bt, w2, b2, eps):
    """Forward row chain in the kernel's rounding order.

    up (BP, M, C); w1 (C, 2, 2, C1); w2 (C1, 2, 2, C2) in up's dtype; b1, g,
    bt (C1,) and b2 (C2,) f32. Returns the stages the backward needs, all f32:
    u1pre-centred xc (BP, M, 4, C1), rstd (BP, M, 4, 1), y, out1, u1g,
    u2pre rounded (BP, M, 4, 4*C2), u2g."""
    dtype = up.dtype
    approx = dtype == torch.bfloat16
    bp, m, c = up.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    u1pre = (up.float() @ w1.float().reshape(c, 4 * c1)).reshape(bp, m, 4, c1)
    u1pre = u1pre + b1
    mu = u1pre.sum(-1, keepdim=True) * (1.0 / c1)
    xc = u1pre - mu
    var = (xc * xc).sum(-1, keepdim=True) * (1.0 / c1)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    out1 = y * g + bt
    u1g = _rnd(_gelu(_rnd(out1, dtype), approx), dtype)
    u2pre = torch.einsum("bmsc,cq->bmsq", u1g, w2.float().reshape(c1, 4 * c2))
    u2pre_r = _rnd(u2pre + b2.repeat(4), dtype)
    u2g = _rnd(_gelu(u2pre_r, approx), dtype)
    return xc, rstd, y, out1, u1g, u2pre_r, u2g


def upscale_fwd_plain(up, w1, b1, g, bt, w2, b2, hyper, eps: float = 1e-6):
    """Plain PyTorch K3 forward: (BP, M, n_out*16) f32, lanes (t, d, e, f, g)."""
    *_, u2g = _chain(up, w1, b1, g, bt, w2, b2, eps)
    bp, m = up.shape[:2]
    c2 = w2.shape[-1]
    u2g = u2g.reshape(bp, m, 4, 4, c2)  # (b, m, de, fg, c2)
    out = torch.einsum("bmpqc,btc->bmtpq", u2g, hyper.float())
    return out.reshape(bp, m, -1)


def _bwd_rows(up, dm, w1, b1, g, bt, w2, b2, hyper, eps):
    """The row part of the backward in f32, at the kernel's rounding points:
    d_up and the scratch rows (each already rounded to up's dtype, so
    casting them to it loses nothing), then the per-lane sums."""
    dtype = up.dtype
    approx = dtype == torch.bfloat16
    bp, m, c = up.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    n_out = hyper.shape[1]
    xc, rstd, y, out1, u1g, u2pre_r, u2g = _chain(up, w1, b1, g, bt, w2, b2,
                                                  eps)
    dm5 = dm.float().reshape(bp, m, n_out, 4, 4)  # (b, m, t, de, fg)
    hyp = hyper.float()  # (b, t, c2)
    d_u2g = torch.einsum("bmtpq,btc->bmpqc", dm5, hyp).reshape(bp, m, 4, -1)
    d_ht = torch.einsum("bmtpq,bmpqc->btpqc", dm5,
                        u2g.reshape(bp, m, 4, 4, c2)).reshape(bp, n_out, -1)
    d_u2pre = d_u2g * _gelu_grad(u2pre_r, approx)
    d_u2pre_l = _rnd(d_u2pre, dtype)
    w2f = w2.float().reshape(c1, 4 * c2)
    d_u1g = torch.einsum("bmsq,cq->bmsc", d_u2pre_l, w2f)
    d_out1 = d_u1g * _gelu_grad(_rnd(out1, dtype), approx)
    dg = (d_out1 * y).sum((0, 1)).reshape(-1)
    dbt = d_out1.sum((0, 1)).reshape(-1)
    d_y = d_out1 * g
    yn = xc * rstd
    mean_dy = d_y.sum(-1, keepdim=True) * (1.0 / c1)
    mean_dyy = (d_y * yn).sum(-1, keepdim=True) * (1.0 / c1)
    d_u1pre = rstd * (d_y - mean_dy - yn * mean_dyy)
    d_u1pre_l = _rnd(d_u1pre, dtype).reshape(bp, m, 4 * c1)
    w1f = w1.float().reshape(c, 4 * c1)
    d_up = d_u1pre_l @ w1f.T
    db1 = d_u1pre.sum((0, 1)).reshape(-1)
    db2 = d_u2pre.sum((0, 1)).reshape(-1)
    rows = (d_up, u1g.reshape(bp, m, -1), d_u2pre_l.reshape(bp, m, -1),
            d_u1pre_l)
    return rows, (db1, dg, dbt, db2, d_ht)


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """The launch plan of K3's bf16 kernels on units of rows (the row pass
    ``upscale_bwd_rows_wgmma_kernel`` and the forward
    ``upscale_fwd_wgmma_kernel``): units of ``rows`` rows of one pair (unit
    u: pair u // tpp, rows ``rows`` * (u % tpp).., tpp = ceil(m / rows)),
    the ``units``, the persistent ``blocks`` (block b takes units b, b +
    blocks, ...) and the block's shared memory in bytes."""
    rows: int
    units: int
    blocks: int
    smem: int


def _units_plan(bp, m, sm_count, smem):
    units = bp * -(-m // ROWS_RR)
    return RowsPlan(ROWS_RR, units, max(1, min(sm_count, units)), smem)


@functools.lru_cache(maxsize=None)
def rows_plan_bf16(bp: int, m: int, sm_count: int) -> RowsPlan:
    """The bf16 row pass's plan over ``bp`` pairs of ``m`` rows: units of
    64 rows, one block an SM at most (a block's two consumer warpgroups
    share its unit)."""
    return _units_plan(bp, m, sm_count, ROWS_SMEM)


@functools.lru_cache(maxsize=None)
def upscale_fwd_plan_bf16(bp: int, m: int, sm_count: int) -> RowsPlan:
    """The bf16 forward's plan (``upscale_fwd_wgmma_kernel``): units of 64
    rows of a pair, both warpgroups on a unit, one block an SM at most."""
    return _units_plan(bp, m, sm_count, FWD_SMEM)


def upscale_bwd_rows_plain(up, dm, w1, b1, g, bt, w2, b2, hyper,
                           eps: float = 1e-6):
    """Plain PyTorch twin of the row pass ``upscale_bwd_rows``: per row, in
    up's dtype, d_up (BP, M, C) and the weight pass's scratch u1g (BP, M,
    4*C1, lanes (d, e, c1)), rnd(d_u2pre) (BP, M, 16*C2, lanes (d, e, f, g,
    c2)) and rnd(d_u1pre) (BP, M, 4*C1); summed over all rows in f32: db1,
    dg, dbt (4*C1,), db2 (16*C2,), d_hyper (BP, n_out, 16*C2) per pair."""
    rows, sums = _bwd_rows(up, dm, w1, b1, g, bt, w2, b2, hyper, eps)
    return tuple(x.to(up.dtype) for x in rows) + sums


@dataclasses.dataclass(frozen=True)
class DwPlanF32:
    """The launch plan of the f32 weight pass (``upscale_bwd_dw_tf32_kernel``):
    the row chunks (one partial of dW1 and dW2 each, added up in this
    order), the nominal chunk in rows (a multiple of ``DW32_ROWS``; a lone
    chunk may be shorter), the units (chunk index, kind) in the order the
    blocks take them (block b: units b, b + blocks, ...; kinds 0 and 1 the
    dW1 halves of 128 output rows, 2 and 3 the dW2 pairs of (d, e) blocks),
    the ring's stages and the persistent blocks."""
    chunks: tuple
    chunk: int
    units: tuple
    stages: int
    blocks: int


@functools.lru_cache(maxsize=None)
def upscale_dw_plan_f32(rows: int, sm_count: int) -> DwPlanF32:
    """The f32 weight pass's plan over ``rows`` rows: about sm_count / 2
    chunks aligned to its 16-row stage (each chunk one accumulator chain
    per output element, as long as the f32 K4 weight pass's: the tensor
    cores' f32 sums do not round to nearest, and their error grows with
    the chain), four units a chunk in (chunk, kind) order, one persistent
    block per SM at most. A chunk's two dW1 units are neighbours in that
    order, so they run in the same wave of blocks and the second read of
    the chunk's rnd(d_u1pre) rows comes from L2."""
    chunks = tuple(kernels.row_chunks(rows, max(1, sm_count // 2),
                                      DW32_ROWS))
    size = -(-chunks[0][1] // DW32_ROWS) * DW32_ROWS
    units = tuple((c, kind) for c in range(len(chunks)) for kind in range(4))
    return DwPlanF32(chunks, size, units, DW32_STAGES,
                     min(len(units), sm_count))


def upscale_bwd_dw_plain(up, u1g_rows, d2_rows, du1_rows, *, parts: int = 1):
    """Plain PyTorch twin of the weight pass ``upscale_bwd_dw``: dW1 (C,
    4*C1) = sum_r up^T rnd(d_u1pre) and dW2 (4, C1, 4*C2), dW2[de] = sum_r
    u1g[de]^T rnd(d_u2pre)[de], in f32, summed over ``parts`` row chunks in
    the kernel's order (``kernels.row_chunks``, aligned to the stage of the
    weight pass of up's dtype: ``DW32_ROWS`` in f32, the chunks of
    ``upscale_dw_plan_f32``, ``DW_ROWS`` in bf16)."""
    bp, m, c = up.shape
    n = bp * m
    x1, y1 = up.float().reshape(n, c), du1_rows.float().reshape(n, -1)
    x2 = u1g_rows.float().reshape(n, 4, -1)
    y2 = d2_rows.float().reshape(n, 4, -1)
    align = DW32_ROWS if up.dtype == torch.float32 else DW_ROWS
    chunks = kernels.row_chunks(n, parts, align)
    dw1 = sum(x1[lo:hi].T @ y1[lo:hi] for lo, hi in chunks)
    dw2 = sum(torch.einsum("rsc,rsq->scq", x2[lo:hi], y2[lo:hi])
              for lo, hi in chunks)
    return dw1, dw2


def upscale_bwd_plain(up, dm, w1, b1, g, bt, w2, b2, hyper,
                      eps: float = 1e-6):
    """Plain PyTorch K3 backward, returning exactly what the kernels return:

    d_up (BP, M, C) in up's dtype, then per-lane sums over all rows in f32:
    dW1 (C, 4*C1) lanes (d, e, c1); dW2 (4, C1, 4*C2), one (C1, (f, g, c2))
    block per (d, e); db1, dg, dbt (4*C1,); db2 (16*C2,) lanes
    (d, e, f, g, c2); d_hyper (BP, n_out, 16*C2), summed over each pair's
    rows. The composition of the row pass's and the weight pass's plain
    twins."""
    (d_up, u1g_rows, d2_rows, du1_rows, db1, dg, dbt, db2,
     d_ht) = upscale_bwd_rows_plain(up, dm, w1, b1, g, bt, w2, b2, hyper,
                                    eps=eps)
    dw1, dw2 = upscale_bwd_dw_plain(up, u1g_rows, d2_rows, du1_rows)
    return d_up, dw1, dw2, db1, dg, dbt, db2, d_ht


def _bind():
    global _BOUND
    lib = kernels.library("upscaler")
    if not _BOUND:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.dhoct_upscale_fwd.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float,
                                                            p]
        lib.dhoct_upscale_bwd_rows.argtypes = [p] + [i] * 5 + [
            ctypes.c_float, p]
        lib.dhoct_upscale_bwd_dw.argtypes = [p] + [i] * 6 + [p]
        for fn in (lib.dhoct_upscale_fwd, lib.dhoct_upscale_bwd_rows,
                   lib.dhoct_upscale_bwd_dw):
            fn.restype = ctypes.c_int
        lib.dhoct_upscale_error_string.argtypes = [ctypes.c_int]
        lib.dhoct_upscale_error_string.restype = ctypes.c_char_p
        _BOUND = True
    return lib


def _kernel_shapes(up, w1, w2, hyper):
    bp, m, c = up.shape
    if c != CHANNELS or w1.shape != (c, 2, 2, c // 4) or w2.shape != (
            c // 4, 2, 2, c // 8):
        raise NotImplementedError(
            f"the K3 kernels take C = {CHANNELS} (W1 (256, 2, 2, 64), W2 "
            f"(64, 2, 2, 32)); got up {tuple(up.shape)}, W1 "
            f"{tuple(w1.shape)}, W2 {tuple(w2.shape)}")
    n_out = hyper.shape[1]
    if hyper.shape != (bp, n_out, c // 8) or not 1 <= n_out <= MAX_OUT:
        raise NotImplementedError(
            f"hyper must be (BP, n_out <= {MAX_OUT}, C/8), got "
            f"{tuple(hyper.shape)}")
    return bp, m, c, n_out


def _blocks(dev, dt, bp: int, m: int) -> int:
    """Persistent blocks of the K3 forward and the f32 row pass: one per
    SM, at most one per 64-row unit (bf16, ``upscale_fwd_plan_bf16``) or
    per 64-row super-tile (f32)."""
    if dt == torch.bfloat16:
        return upscale_fwd_plan_bf16(bp, m, kernels.sm_count(dev)).blocks
    return min(kernels.sm_count(dev), bp * -(-m // F32_ROWS))


def upscale_fwd_cuda(up, w1, b1, g, bt, w2, b2, hyper, eps: float = 1e-6):
    """Launch ``upscale_fwd`` (csrc/upscaler.cu); same contract as
    ``upscale_fwd_plain``, on one persistent block per SM (``_blocks``)."""
    bp, m, c, n_out = _kernel_shapes(up, w1, w2, hyper)
    f32, dt = torch.float32, up.dtype
    args = (up, w1, b1, g, bt, w2, b2, hyper)
    kernels.check_operands("upscale_fwd", args,
                           (dt, dt, f32, f32, f32, dt, f32, dt))
    lib = _bind()
    dev = up.device
    out = torch.empty((bp, m, n_out * 16), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        blocks = _blocks(dev, dt, bp, m)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dhoct_upscale_fwd(*(t.data_ptr() for t in args),
                                    out.data_ptr(), bp, m, n_out, blocks,
                                    kernels.DTYPE_CODE[dt], eps, stream)
    kernels.raise_on_error(err, lib.dhoct_upscale_error_string, "upscale_fwd")
    LAUNCHES["upscale_fwd"] += 1
    return out


def upscale_bwd_rows_cuda(up, dm, w1, b1, g, bt, w2, b2, hyper,
                          eps: float = 1e-6):
    """Launch the row pass ``upscale_bwd_rows`` (csrc/upscaler.cu): bf16
    ``upscale_bwd_rows_wgmma_kernel`` on the plan of ``rows_plan_bf16``,
    f32 ``upscale_bwd_rows_tf32_kernel`` on one persistent block per SM
    (``_blocks``); same contract as ``upscale_bwd_rows_plain``. The kernel
    writes partials of each per-lane sum (bf16: one a block and warp index,
    ``ROWS_PARTS`` a block; f32: one a slot) and of d_hyper (bf16: one a
    64-row unit; f32: one a 16-row tile); they are summed here in a fixed
    order. The f32 kernel also reads W1^T, made here."""
    bp, m, c, n_out = _kernel_shapes(up, w1, w2, hyper)
    f32, dt = torch.float32, up.dtype
    args = (up, dm, w1, b1, g, bt, w2, b2, hyper)
    kernels.check_operands("upscale_bwd_rows", args,
                           (dt, f32, dt, f32, f32, f32, dt, f32, dt))
    if dm.shape != (bp, m, n_out * 16):
        raise ValueError(f"dm must be {(bp, m, n_out * 16)}, got "
                         f"{tuple(dm.shape)}")
    lib = _bind()
    dev = up.device
    with torch.cuda.device(dev):
        if dt == torch.bfloat16:
            plan = rows_plan_bf16(bp, m, kernels.sm_count(dev))
            blocks, nw, tile = plan.blocks, plan.blocks * ROWS_PARTS, plan.rows
        else:
            blocks = _blocks(dev, dt, bp, m)
            nw, tile = blocks * ROW_SLOTS, 16
        rows = tuple(torch.empty((bp, m, w), dtype=dt, device=dev)
                     for w in (c, c, 2 * c, c))  # d_up, u1g, d_u2pre, d_u1pre
        sums = tuple(torch.empty((nw, w), dtype=f32, device=dev)
                     for w in (c, c, c, 2 * c))  # db1, dg, dbt, db2
        dht = torch.empty((bp, -(-m // tile), n_out, 2 * c), dtype=f32,
                          device=dev)
        wts = () if dt == torch.bfloat16 else (w1.reshape(c, c).t()
                                                .contiguous(),)
        err = lib.dhoct_upscale_bwd_rows(
            kernels.pointers(args + rows + sums + (dht,) + wts), bp, m, n_out,
            blocks, kernels.DTYPE_CODE[dt], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on_error(err, lib.dhoct_upscale_error_string,
                           "upscale_bwd_rows")
    LAUNCHES["upscale_bwd"] += 1
    return rows + tuple(x.sum(0) for x in sums) + (dht.sum(1),)


def upscale_bwd_dw_cuda(up, u1g_rows, d2_rows, du1_rows):
    """Launch the weight pass ``upscale_bwd_dw`` (csrc/upscaler.cu): in bf16
    ``upscale_bwd_dw_kernel``, one block per (row chunk, output tile), 3
    tiles of the weight gradients, about one per SM; in f32
    ``upscale_bwd_dw_tf32_kernel`` on TF32 wgmma and TMA, on the plan of
    ``upscale_dw_plan_f32``. Same contract as ``upscale_bwd_dw_plain``. The
    per-chunk partials are summed here in a fixed order."""
    bp, m, c = up.shape
    dt = up.dtype
    args = (up, u1g_rows, d2_rows, du1_rows)
    kernels.check_operands("upscale_bwd_dw", args, (dt,) * 4)
    if (c != CHANNELS or u1g_rows.shape != (bp, m, c)
            or d2_rows.shape != (bp, m, 2 * c)
            or du1_rows.shape != (bp, m, c)):
        raise ValueError("upscale_bwd_dw: up, u1g and rnd(d_u1pre) (BP, M, "
                         "256), rnd(d_u2pre) (BP, M, 512)")
    lib = _bind()
    dev = up.device
    with kernels.on_device(dev):
        sms = kernels.sm_count(dev)
        if dt == torch.bfloat16:  # three blocks a chunk
            chunks = kernels.row_chunks(bp * m, max(1, sms // 3), DW_ROWS)
            # the nominal chunk, a multiple of DW_ROWS (a lone chunk may be
            # shorter: fewer than DW_ROWS rows in all)
            size = -(-chunks[0][1] // DW_ROWS) * DW_ROWS
            stages = blocks = 0
        else:
            plan = upscale_dw_plan_f32(bp * m, sms)
            chunks, size = plan.chunks, plan.chunk
            stages, blocks = plan.stages, plan.blocks
        part = torch.empty((len(chunks), c * c + c * c // 2),
                           dtype=torch.float32, device=dev)
        err = lib.dhoct_upscale_bwd_dw(
            kernels.pointers(args + (part,)), bp * m, size, len(chunks),
            stages, blocks, kernels.DTYPE_CODE[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on_error(err, lib.dhoct_upscale_error_string,
                           "upscale_bwd_dw")
    LAUNCHES["upscale_bwd_dw"] += 1
    dw = part.sum(0)
    return dw[:c * c].reshape(c, c), dw[c * c:].reshape(4, c // 4, c // 2)


def upscale_bwd_cuda(up, dm, w1, b1, g, bt, w2, b2, hyper,
                     eps: float = 1e-6):
    """The K3 backward on the card (csrc/upscaler.cu): the row pass and the
    weight pass; same contract as ``upscale_bwd_plain`` (the gradients
    repeat bit for bit from run to run: no atomics)."""
    (d_up, u1g_rows, d2_rows, du1_rows, db1, dg, dbt, db2,
     dht) = upscale_bwd_rows_cuda(up, dm, w1, b1, g, bt, w2, b2, hyper,
                                  eps=eps)
    dw1, dw2 = upscale_bwd_dw_cuda(up, u1g_rows, d2_rows, du1_rows)
    return d_up, dw1, dw2, db1, dg, dbt, db2, dht


def _fwd(*args, eps):
    if args[0].device.type == "cuda":
        return upscale_fwd_cuda(*args, eps=eps)
    if args[0].device.type != "cpu":
        raise ValueError(f"no upscaler kernel for device {args[0].device}")
    return upscale_fwd_plain(*args, eps=eps)


def _bwd(*args, eps):
    if args[0].device.type == "cuda":
        return upscale_bwd_cuda(*args, eps=eps)
    return upscale_bwd_plain(*args, eps=eps)


class _UpscaleHyper(torch.autograd.Function):
    @staticmethod
    def forward(ctx, up, w1, b1, g, bt, w2, b2, hyper, eps):
        ctx.eps = eps
        ctx.save_for_backward(up, w1, b1, g, bt, w2, b2, hyper)
        return _fwd(up, w1, b1, g, bt, w2, b2, hyper, eps=eps)

    @staticmethod
    def backward(ctx, dm):
        up, w1, b1, g, bt, w2, b2, hyper = ctx.saved_tensors
        c1, c2 = w1.shape[-1], w2.shape[-1]
        d_up, dw1, dw2, db1, dg, dbt, db2, dht = _bwd(
            up, dm.contiguous(), w1, b1, g, bt, w2, b2, hyper, eps=ctx.eps)
        # per-lane sums -> parameter shapes, cast like the JAX custom VJP
        return (d_up,
                dw1.reshape(w1.shape).to(w1.dtype),
                db1.reshape(4, c1).sum(0),
                dg.reshape(4, c1).sum(0),
                dbt.reshape(4, c1).sum(0),
                dw2.reshape(4, c1, 2, 2, c2).sum(0).to(w2.dtype),
                db2.reshape(16, c2).sum(0),
                dht.reshape(hyper.shape[0], hyper.shape[1], 16, c2).sum(2)
                .to(hyper.dtype),
                None)


def upscale_hyper_masks(up_flat, sd, hyper_sl, *, eps: float = 1e-6):
    """Fused upscale (2x2 convT -> LN2d -> GELU -> 2x2 convT -> GELU) times
    the hypernetwork vectors.

    up_flat: (BP, G*G, C); sd: the HF-named state_dict (its
    ``mask_decoder.upscale_*`` entries); hyper_sl: (BP, n_out, C/8).
    Returns (BP, G*G, n_out*16) f32, lanes (t, d, e, f, g) — the pixel
    (4h+2d+f, 4w+2e+g) block offset of the blocked decode. Weights are cast
    to up's dtype, biases and LayerNorm parameters to f32, as the JAX
    package casts them."""
    dt = up_flat.dtype

    def convt(n):  # HF (in, out, 2, 2) -> (in, 2, 2, out)
        return sd[f"mask_decoder.upscale_conv{n}.weight"].to(dt).permute(
            0, 2, 3, 1).contiguous()

    f32 = torch.float32
    return _UpscaleHyper.apply(
        up_flat.contiguous(), convt(1),
        sd["mask_decoder.upscale_conv1.bias"].to(f32),
        sd["mask_decoder.upscale_layer_norm.weight"].to(f32),
        sd["mask_decoder.upscale_layer_norm.bias"].to(f32),
        convt(2), sd["mask_decoder.upscale_conv2.bias"].to(f32),
        hyper_sl.to(dt).contiguous(), eps)
