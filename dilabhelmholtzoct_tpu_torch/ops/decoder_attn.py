"""Fused image->token cross-attention + residual + LayerNorm (K4).

``fused_i2t_ln`` is the port of
``dilabhelmholtzoct_tpu/ops/decoder_attn.py::fused_i2t_ln``: the image-side
update of SAM's two-way block,

    keys = LN(keys + Attn(q = keys + pe, k = tok_k, v = tok_v)),

as a per-row chain over the (pairs x grid) image rows with <= 8 prompt
tokens on the key side. On a CUDA tensor it launches the hand-written
kernels of ``csrc/decoder_attn.cu``:

  * ``i2t_fwd`` replacing the TPU ``_fused_fwd`` (``_fwd_kernel``), one
    persistent block per SM, the pb pairs of an image sharing one q
    projection: in bf16 ``i2t_fwd_mma_kernel``, in f32
    ``i2t_fwd_tf32_kernel`` (split TF32: hi.hi + hi.lo + lo.hi on the TF32
    tensor cores, f32 accuracy);
  * the backward replacing the TPU ``_fused_bwd`` (``_bwd_kernel``): it
    recomputes the chain per row, returns d_keys per row, the q/out
    projection and LayerNorm gradients summed over all rows, and the per-row
    intermediates (d_qpre, p, d_score, d_out) from which the cross-row token
    and positional gradients are formed outside — as plain ``torch.einsum``,
    as the JAX package leaves them to XLA (``decoder_attn.py:320-347``).
    It is two launches on the tensor cores, in bf16 and in f32 (split
    TF32): ``i2t_bwd_rows`` (the row pass; it also writes rnd(out) and
    rnd(d_res) per row as scratch in the input dtype) and ``i2t_bwd_dw``
    (the weight pass: dWo and dWq as split-K products over row chunks).

The JAX package routes here only in bf16 unless ``set_fused_i2t('on')``
forces it (``models/sam.py``); the f32 kernels serve that route.

On a CPU tensor the same ``torch.autograd.Function`` runs ``i2t_fwd_plain``
/ ``i2t_bwd_plain``, which compute exactly what the kernels return from the
same inputs; ``i2t_bwd_plain`` is the composition of the two passes' plain
twins, ``i2t_bwd_rows_plain`` and ``i2t_bwd_dw_plain``. A CUDA tensor never
reaches a plain version.

Rounding points (the JAX kernel's, ``decoder_attn.py:86-117``): ``qin =
keys + pe`` in the input dtype; ``qpre`` in f32, rounded; scores of the
rounded ``q * scale`` (scale in the input dtype) against k in f32; softmax in
f32, ``p`` rounded; ``out`` in f32, rounded; ``proj`` in f32, rounded, then
the residual add in the input dtype; LayerNorm in f32, ``y`` rounded. The
softmax is shifted by each head's own maximum (the TPU kernel's global row
maximum was a Mosaic workaround; softmax is shift-invariant).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# launch counts of the K4 kernels; a plain integer each, reset by the caller
LAUNCHES = {"i2t_fwd": 0, "i2t_bwd": 0, "i2t_bwd_dw": 0}
T_PAD = 8          # token capacity per head (the training paths use 7)
CHANNELS = 256     # the widths the CUDA kernels take (every SAM decoder)
INTERNAL = 128
HEADS = 8
ROW_SLOTS = 4      # 16-row tiles in flight per block, a warp pair each
F32_ROWS = 64      # rows of an f32 super-tile (dec32::ROWS)
DW_ROWS = 32       # rows per stage of the weight pass (dec::DW_SR)

_BOUND = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rnd(x32, dtype):
    return x32.to(dtype).float()


def _scale(hd, dtype):
    """1/sqrt(hd) in the input dtype, as the JAX kernel multiplies by it."""
    return torch.tensor(hd ** -0.5, dtype=dtype).float().item()


def _chain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, *, nh, pb, eps):
    dtype = keys.dtype
    bimg, m, c = keys.shape
    bp, n_tok, internal = tok_k.shape
    hd = internal // nh
    qin = (keys + pe).float()
    qb = _rnd(qin @ wq.float() + bq, dtype)
    keys_p = keys
    if pb > 1:
        qb = qb.repeat_interleave(pb, 0)
        keys_p = keys.repeat_interleave(pb, 0)
    qs = _rnd(qb * _scale(hd, dtype), dtype).reshape(bp, m, nh, hd)
    k4 = tok_k.float().reshape(bp, n_tok, nh, hd)
    v4 = tok_v.float().reshape(bp, n_tok, nh, hd)
    s = torch.einsum("bmhd,bthd->bmht", qs, k4)
    p = torch.softmax(s, dim=-1)
    pr = _rnd(p, dtype)
    outb = _rnd(torch.einsum("bmht,bthd->bmhd", pr, v4).reshape(bp, m, -1),
                dtype)
    proj = outb @ wo.float() + bo
    res = (keys_p + proj.to(dtype)).float()
    mu = res.mean(-1, keepdim=True)
    xc = res - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    yn = xc * rstd
    return qin, qs, k4, v4, p, pr, outb, rstd, yn


def i2t_fwd_plain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, *, nh: int,
                  pb: int, eps: float):
    """Plain PyTorch K4 forward: (B_img * pb, M, C) in keys' dtype."""
    *_, yn = _chain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh=nh,
                    pb=pb, eps=eps)
    return (yn * g + bt).to(keys.dtype)


def _pad_tokens(x, bp, m, nh):
    """(BP, M, nh, n_tok) -> (BP, M, nh * T_PAD), zeros on the pad tokens."""
    out = x.new_zeros((bp, m, nh, T_PAD))
    out[..., :x.shape[-1]] = x
    return out.reshape(bp, m, nh * T_PAD)


def _bwd_rows(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *, nh, pb,
              eps):
    """The row part of the backward in f32, at the kernel's rounding points:
    the per-row outputs and scratch rows (each already rounded to keys'
    dtype, so casting them to it loses nothing), then the per-lane sums."""
    dtype = keys.dtype
    bp, n_tok, internal = tok_k.shape
    m, c = keys.shape[1:]
    hd = internal // nh
    qin, qs, k4, v4, p, pr, outb, rstd, yn = _chain(
        keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh=nh, pb=pb, eps=eps)
    dy32 = dy.float()
    dg = (dy32 * yn).sum((0, 1))
    dbt = dy32.sum((0, 1))
    dyn = dy32 * g
    mean_dyn = dyn.mean(-1, keepdim=True)
    mean_dyy = (dyn * yn).mean(-1, keepdim=True)
    dres = rstd * (dyn - mean_dyn - yn * mean_dyy)
    dres_b = _rnd(dres, dtype)
    dbo = dres.sum((0, 1))
    dout_b = _rnd(dres_b @ wo.float().T, dtype)
    dp = torch.einsum("bmhd,bthd->bmht", dout_b.reshape(bp, m, nh, hd), v4)
    pdp = p * dp
    ds_b = _rnd(pdp - p * pdp.sum(-1, keepdim=True), dtype)
    dqb = torch.einsum("bmht,bthd->bmhd", ds_b, k4).reshape(bp, m, -1) * (
        hd ** -0.5)
    dqpre_b = _rnd(dqb, dtype)
    dbq = dqb.sum((0, 1))
    dkeys = dres_b + dqpre_b @ wq.float().T
    rows = (dkeys, dqpre_b, _pad_tokens(pr, bp, m, nh),
            _pad_tokens(ds_b, bp, m, nh), dout_b, outb, dres_b)
    return rows, (dbq, dbo, dg, dbt)


def i2t_bwd_rows_plain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *,
                       nh: int, pb: int, eps: float):
    """Plain PyTorch twin of the row pass ``i2t_bwd_rows``: per pair and
    row, in keys' dtype, d_keys (before the sum over the pb prompts of an
    image), d_qpre (BP, M, I), p and d_score (BP, M, nh * T_PAD, zero on the
    pad tokens), d_out (BP, M, I), and the weight pass's scratch rnd(out)
    (BP, M, I) and rnd(d_res) (BP, M, C); summed over all rows in f32: dbq
    (I,), dbo, dg, dbt (C,)."""
    rows, sums = _bwd_rows(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy,
                           nh=nh, pb=pb, eps=eps)
    return tuple(x.to(keys.dtype) for x in rows) + sums


def i2t_bwd_dw_plain(keys, pe, dqpre, out_rows, dres_rows, *, pb: int,
                     parts: int = 1):
    """Plain PyTorch twin of the weight pass ``i2t_bwd_dw``: dWq (C, I) =
    sum_r rnd(keys[pair / pb] + pe)^T rnd(d_qpre) and dWo (I, C) = sum_r
    rnd(out)^T rnd(d_res) in f32, summed over ``parts`` row chunks in the
    kernel's order (``kernels.row_chunks``)."""
    bp, m, internal = dqpre.shape
    c = keys.shape[-1]
    qin = (keys + pe).float()
    if pb > 1:
        qin = qin.repeat_interleave(pb, 0)
    n = bp * m
    a = (dqpre.float().reshape(n, internal), out_rows.float().reshape(n, -1))
    b = (qin.reshape(n, c), dres_rows.float().reshape(n, c))
    dwqt, dwo = (sum(x[lo:hi].T @ y[lo:hi]
                     for lo, hi in kernels.row_chunks(n, parts, DW_ROWS))
                 for x, y in zip(a, b))
    return dwqt.T, dwo


def i2t_bwd_plain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *,
                  nh: int, pb: int, eps: float):
    """Plain PyTorch K4 backward, returning exactly what the kernels return:

    per pair and row, in keys' dtype: d_keys (before the sum over the pb
    prompts of an image), d_qpre (BP, M, I), p and d_score (BP, M,
    nh * T_PAD, zero on the pad tokens), d_out (BP, M, I); summed over all
    rows in f32: dWq (C, I), dbq (I,), dWo (I, C), dbo, dg, dbt (C,). The
    composition of the row pass's and the weight pass's plain twins."""
    (dkeys, dqpre, p, ds, dout, out_rows, dres_rows, dbq, dbo, dg,
     dbt) = i2t_bwd_rows_plain(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                               dy, nh=nh, pb=pb, eps=eps)
    dwq, dwo = i2t_bwd_dw_plain(keys, pe, dqpre, out_rows, dres_rows, pb=pb)
    return dkeys, dqpre, p, ds, dout, dwq, dbq, dwo, dbo, dg, dbt


def _bind():
    global _BOUND
    lib = kernels.library("decoder_attn")
    if not _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dhoct_i2t_fwd.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, p]
        lib.dhoct_i2t_bwd_rows.argtypes = [p] + [i] * 6 + [ctypes.c_float, p]
        lib.dhoct_i2t_bwd_dw.argtypes = [p] + [i] * 6 + [p]
        for fn in (lib.dhoct_i2t_fwd, lib.dhoct_i2t_bwd_rows,
                   lib.dhoct_i2t_bwd_dw):
            fn.restype = ctypes.c_int
        lib.dhoct_i2t_error_string.argtypes = [ctypes.c_int]
        lib.dhoct_i2t_error_string.restype = ctypes.c_char_p
        _BOUND = True
    return lib


def _check_args(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh, pb):
    """Shape rules shared by every route; raises on what K4 does not take."""
    bimg, m, c = keys.shape
    bp, n_tok, internal = tok_k.shape
    if n_tok > T_PAD:
        raise ValueError(f"fused_i2t_ln takes at most {T_PAD} tokens, got "
                         f"{n_tok}")
    if internal % nh:
        raise ValueError(f"internal width {internal} is not a multiple of "
                         f"{nh} heads")
    if bp != bimg * pb or tok_v.shape != tok_k.shape:
        raise ValueError(f"tok_k/tok_v must be ({bimg * pb}, T, I), got "
                         f"{tuple(tok_k.shape)}, {tuple(tok_v.shape)}")
    if pe.shape != (1, m, c):
        raise ValueError(f"pe must be (1, {m}, {c}), got {tuple(pe.shape)}")
    if wq.shape != (c, internal) or wo.shape != (internal, c):
        raise ValueError("wq must be (C, I) and wo (I, C)")
    return bimg, m, c, bp, n_tok, internal


def _kernel_widths(c, internal, nh):
    if (c, internal, nh) != (CHANNELS, INTERNAL, HEADS):
        raise NotImplementedError(
            f"the K4 kernels take C={CHANNELS}, I={INTERNAL}, {HEADS} heads; "
            f"got C={c}, I={internal}, {nh} heads")


def _blocks(dev, dt, pairs, m):
    """Persistent blocks of a K4 row kernel: one per SM, at most one per
    ROW_SLOTS 16-row tiles (bf16) or per 64-row super-tile (f32) of
    ``pairs`` pairs (or images)."""
    if dt == torch.bfloat16:
        work = -(-pairs * -(-m // 16) // ROW_SLOTS)
    else:
        work = pairs * -(-m // F32_ROWS)
    return min(kernels.sm_count(dev), work)


def i2t_fwd_cuda(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, *, nh: int,
                 pb: int, eps: float):
    """Launch ``i2t_fwd`` (csrc/decoder_attn.cu); same contract as
    ``i2t_fwd_plain``, on one persistent block per SM (``_blocks``)."""
    bimg, m, c, bp, n_tok, internal = _check_args(
        keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh, pb)
    _kernel_widths(c, internal, nh)
    dt, f32 = keys.dtype, torch.float32
    args = (keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt)
    kernels.check_operands("i2t_fwd", args,
                           (dt, dt, dt, dt, dt, f32, dt, f32, f32, f32))
    lib = _bind()
    dev = keys.device
    out = torch.empty((bp, m, c), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        blocks = _blocks(dev, dt, bimg, m)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dhoct_i2t_fwd(*(t.data_ptr() for t in args), out.data_ptr(),
                                bp, m, pb, n_tok, blocks,
                                kernels.DTYPE_CODE[dt], eps, stream)
    kernels.raise_on_error(err, lib.dhoct_i2t_error_string, "i2t_fwd")
    LAUNCHES["i2t_fwd"] += 1
    return out


def i2t_bwd_rows_cuda(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *,
                      nh: int, pb: int, eps: float):
    """Launch the row pass ``i2t_bwd_rows`` (csrc/decoder_attn.cu) on one
    persistent block per SM (``_blocks``); same contract as
    ``i2t_bwd_rows_plain``. The kernel writes one partial of each per-lane
    sum per slot (a warp pair); they are summed here in a fixed order. The
    f32 kernel also reads Wq^T and Wo^T, made here."""
    bimg, m, c, bp, n_tok, internal = _check_args(
        keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh, pb)
    _kernel_widths(c, internal, nh)
    dt, f32 = keys.dtype, torch.float32
    args = (keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy)
    kernels.check_operands("i2t_bwd_rows", args,
                           (dt,) * 5 + (f32, dt, f32, f32, f32, dt))
    if dy.shape != (bp, m, c):
        raise ValueError(f"dy must be {(bp, m, c)}, got {tuple(dy.shape)}")
    lib = _bind()
    dev = keys.device
    with torch.cuda.device(dev):
        blocks = _blocks(dev, dt, bp, m)
        nw = blocks * ROW_SLOTS
        rows = (bp, m)
        outs = tuple(torch.empty(rows + (w,), dtype=dt, device=dev)
                     for w in (c, internal, nh * T_PAD, nh * T_PAD, internal,
                               internal, c))
        sums = tuple(torch.empty((nw, w), dtype=f32, device=dev)
                     for w in (internal, c, c, c))
        wts = () if dt == torch.bfloat16 else (wq.t().contiguous(),
                                                wo.t().contiguous())
        err = lib.dhoct_i2t_bwd_rows(
            kernels.pointers(args + outs + sums + wts), bp, m, pb, n_tok,
            blocks, kernels.DTYPE_CODE[dt], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on_error(err, lib.dhoct_i2t_error_string, "i2t_bwd_rows")
    LAUNCHES["i2t_bwd"] += 1
    return outs + tuple(x.sum(0) for x in sums)


def i2t_bwd_dw_cuda(keys, pe, dqpre, out_rows, dres_rows, *, pb: int):
    """Launch the weight pass ``i2t_bwd_dw`` (csrc/decoder_attn.cu): one
    block per (row chunk, weight) in bf16, per (row chunk, weight, half of
    C) in f32, about one per SM; same contract as ``i2t_bwd_dw_plain``. The
    per-chunk partials are summed here in a fixed order."""
    bp, m, internal = dqpre.shape
    c = keys.shape[-1]
    dt = keys.dtype
    args = (keys, pe, dqpre, out_rows, dres_rows)
    kernels.check_operands("i2t_bwd_dw", args, (dt,) * 5)
    if (keys.shape != (bp // pb, m, c) or pe.shape != (1, m, c)
            or out_rows.shape != (bp, m, internal)
            or dres_rows.shape != (bp, m, c)
            or (c, internal) != (CHANNELS, INTERNAL)):
        raise ValueError("i2t_bwd_dw: keys (BP / pb, M, 256), pe (1, M, 256),"
                         " d_qpre and rnd(out) (BP, M, 128), rnd(d_res) (BP, "
                         "M, 256)")
    lib = _bind()
    dev = keys.device
    with torch.cuda.device(dev):
        per_chunk = 2 if dt == torch.bfloat16 else 4  # blocks of a chunk
        chunks = kernels.row_chunks(
            bp * m, max(1, kernels.sm_count(dev) // per_chunk), DW_ROWS)
        part = torch.empty((2, len(chunks), internal, c), dtype=torch.float32,
                           device=dev)
        # the nominal chunk, a multiple of DW_ROWS (a lone chunk may be
        # shorter: fewer than DW_ROWS rows in all)
        size = -(-chunks[0][1] // DW_ROWS) * DW_ROWS
        err = lib.dhoct_i2t_bwd_dw(kernels.pointers(args + (part,)), bp, m, pb,
                                   size, len(chunks),
                                   kernels.DTYPE_CODE[dt],
                                   torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on_error(err, lib.dhoct_i2t_error_string, "i2t_bwd_dw")
    LAUNCHES["i2t_bwd_dw"] += 1
    dwo, dwqt = part.sum(1)
    return dwqt.t(), dwo


def i2t_bwd_cuda(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, dy, *,
                 nh: int, pb: int, eps: float):
    """The K4 backward on the card (csrc/decoder_attn.cu): the row pass and
    the weight pass; same contract as ``i2t_bwd_plain``."""
    (dkeys, dqpre, p, ds, dout, out_rows, dres_rows, dbq, dbo, dg,
     dbt) = i2t_bwd_rows_cuda(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                              dy, nh=nh, pb=pb, eps=eps)
    dwq, dwo = i2t_bwd_dw_cuda(keys, pe, dqpre, out_rows, dres_rows, pb=pb)
    return dkeys, dqpre, p, ds, dout, dwq, dbq, dwo, dbo, dg, dbt


class _FusedI2T(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt, nh, pb,
                eps):
        args = (keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt)
        ctx.nh, ctx.pb, ctx.eps = nh, pb, eps
        ctx.save_for_backward(*args)
        if keys.device.type == "cuda":
            return i2t_fwd_cuda(*args, nh=nh, pb=pb, eps=eps)
        if keys.device.type != "cpu":
            raise ValueError(f"no K4 kernel for device {keys.device}")
        _check_args(*args, nh, pb)
        return i2t_fwd_plain(*args, nh=nh, pb=pb, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt = ctx.saved_tensors
        nh, pb = ctx.nh, ctx.pb
        bwd = i2t_bwd_cuda if keys.device.type == "cuda" else i2t_bwd_plain
        (dkeys_pair, dqpre, p_rows, ds_rows, dout_rows, dwq, dbq, dwo, dbo,
         dg, dbt) = bwd(keys, pe, tok_k, tok_v, wq, bq, wo, bo, g, bt,
                        dy.contiguous(), nh=nh, pb=pb, eps=ctx.eps)
        # cross-row reductions, outside the kernel as in the JAX package
        dtype = keys.dtype
        bimg, m, c = keys.shape
        bp, n_tok, internal = tok_k.shape
        hd = internal // nh
        qb = _rnd((keys + pe).float() @ wq.float() + bq, dtype)
        if pb > 1:
            qb = qb.repeat_interleave(pb, 0)
        q4 = _rnd(qb * _scale(hd, dtype), dtype).reshape(bp, m, nh, hd)
        ds4 = ds_rows.float().reshape(bp, m, nh, T_PAD)[..., :n_tok]
        p4 = p_rows.float().reshape(bp, m, nh, T_PAD)[..., :n_tok]
        do4 = dout_rows.float().reshape(bp, m, nh, hd)
        d_tok_k = torch.einsum("bmht,bmhd->bthd", ds4, q4).reshape(
            bp, n_tok, internal)
        d_tok_v = torch.einsum("bmht,bmhd->bthd", p4, do4).reshape(
            bp, n_tok, internal)
        d_pe = None
        if ctx.needs_input_grad[1]:
            d_pe = torch.einsum("bmi,ci->mc", dqpre.float(),
                                wq.float())[None].to(pe.dtype)
        if pb > 1:
            dkeys = dkeys_pair.float().reshape(bimg, pb, m, c).sum(1)
        else:
            dkeys = dkeys_pair
        return (dkeys.to(dtype), d_pe, d_tok_k.to(tok_k.dtype),
                d_tok_v.to(tok_v.dtype), dwq.to(wq.dtype), dbq,
                dwo.to(wo.dtype), dbo, dg, dbt, None, None, None)


def fused_i2t_ln(keys, pe, tok_k, tok_v, sd, prefix: str, *, nh: int,
                 pb: int = 1, eps: float = 1e-6):
    """keys = LN(keys + MHA(q=keys+pe, k=tok_k, v=tok_v)), fused per row.

    keys: (B_img, M, C), per IMAGE when pb > 1 (the shared first layer: the
    per-pair tensor first exists as this op's residual) or per pair with
    pb == 1; pe: (1, M, C); tok_k / tok_v: (B_img * pb, T <= 8, I), the
    token-side projections computed outside. ``prefix`` names the two-way
    layer in the HF state_dict ``sd`` (its ``cross_attn_image_to_token``
    q/out projections and ``layer_norm4``). Returns (B_img * pb, M, C) in
    keys' dtype. Weights are cast to keys' dtype, biases and LayerNorm
    parameters to f32, as the JAX package casts them."""
    dt, f32 = keys.dtype, torch.float32
    pf = f"{prefix}.cross_attn_image_to_token"
    # HF (out, in) weights -> the JAX package's (in, out) layout
    wq = sd[f"{pf}.q_proj.weight"].to(dt).t()
    wo = sd[f"{pf}.out_proj.weight"].to(dt).t()
    return _FusedI2T.apply(
        keys.contiguous(), pe.contiguous(), tok_k.contiguous(),
        tok_v.contiguous(), wq.contiguous(),
        sd[f"{pf}.q_proj.bias"].to(f32), wo.contiguous(),
        sd[f"{pf}.out_proj.bias"].to(f32),
        sd[f"{prefix}.layer_norm4.weight"].to(f32),
        sd[f"{prefix}.layer_norm4.bias"].to(f32), nh, pb, eps)
