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

  * K1 ``attn_global_kernel`` (``csrc/attention.cu``) for the global layers
    (N > WINDOW_MAX_TOKENS; N = 4096 at ViT-B), replacing the TPU
    ``_packed_kernel``;
  * K2 ``attn_windowed_kernel`` (same file) for the windowed layers
    (N <= 256; 14x14 windows at ViT-B), replacing the TPU
    ``_windowed_group_kernel``. With a gradient to take, K1 / K2 also write
    the rows' logsumexp (the TPU kernels' ``return_lse``);
  * K5 ``attn_bwd_dq_kernel`` and ``attn_bwd_dkv_kernel``
    (``csrc/attention_bwd.cu``) for the backward of either, replacing the
    TPU ``_flash_packed_bwd`` (``_packed_bwd_dq_kernel``,
    ``_packed_bwd_dkv_kernel``);
  * K6 ``attn_relpos_kernel`` (``csrc/attention_relpos.cu``) for every layer
    of a model off the packed route (ViT-H: 16 heads of 80), replacing the
    TPU ``_flash_kernel``. Forward only, as there.

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

import torch

from .. import kernels

# K1 / K2 / K5 / K6 / K7 launch counts; a plain integer each, reset by the
# caller
LAUNCHES = {"attn_global": 0, "attn_windowed": 0, "attn_bwd_dq": 0,
            "attn_bwd_dkv": 0, "attn_relpos": 0, "attn_windowed_image": 0}
WINDOW_MAX_TOKENS = 256  # K2 / K7 hold all keys of a window in shared memory
HEAD_DIM = 64            # K1 / K2 / K5 / K7
RELPOS_MAX_HEAD_DIM = 128  # K6 takes every multiple of 4 up to this

_BOUND = {"attention": False, "attention_bwd": False,
          "attention_relpos": False, "attention_winimg": False}


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


def packed_attention_plain(qkv, rel_h, rel_w, *, hw, num_heads: int,
                           return_lse: bool = False):
    """Plain PyTorch version: materialised (N, N) bias, f32 softmax, the
    output cast back to the input dtype (``attention_reference`` math on the
    packed qkv). ``return_lse=True`` also returns the rows' logsumexp of the
    scaled scores, (B, heads, N) f32, as K1 / K2 write it."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    _, _, v, s = _scores(qkv, rel_h, rel_w, hw, num_heads)
    out = _merge_heads(torch.matmul(torch.softmax(s, dim=-1), v))
    out = out.to(qkv.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def relpos_attention_plain(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Plain PyTorch version of K6, rounding where the TPU ``_flash_kernel``
    rounds: the scale multiplies the f32 score after the q.k product (not q
    before it), the un-normalised p = exp(s - max) is rounded to qkv's dtype
    for the p.v product while the denominator sums the f32 p, and the
    division comes last with one rounding of the output. Any head dim."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    bias = (rel_h.float().reshape(b, num_heads, n, hw[0], 1)
            + rel_w.float().reshape(b, num_heads, n, 1, hw[1]))
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s.add_(bias.reshape(b, num_heads, n, n))
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(_rnd(p, qkv.dtype), v) / denom
    return _merge_heads(out).to(qkv.dtype)


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
    ``partition_image_operands``, ``packed_attention_plain`` per window,
    un-partition and crop."""
    _check_image(qkv_img, rel, qkv_bias, ws, num_heads)
    _, h, w, c3 = qkv_img.shape
    win, rel_h, rel_w, padded_hw = partition_image_operands(qkv_img, rel,
                                                            qkv_bias, ws)
    out = packed_attention_plain(win, rel_h, rel_w, hw=(ws, ws),
                                 num_heads=num_heads)
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
        if name == "attention":
            fns = [(lib.dhoct_attn_global, [p] * 5 + [i] * 6 + [p]),
                   (lib.dhoct_attn_windowed, [p] * 5 + [i] * 6 + [p])]
        elif name == "attention_relpos":
            fns = [(lib.dhoct_attn_relpos, [p] * 4 + [i] * 7 + [p])]
        elif name == "attention_winimg":
            fns = [(lib.dhoct_attn_windowed_image, [p] * 4 + [i] * 6 + [p])]
        else:
            fns = [(lib.dhoct_attn_bwd_dq, [p] * 9 + [i] * 6 + [p]),
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
            "flash_attention_relpos has none: the JAX package trains such "
            "models through its XLA attention path, which is not ported yet")


def attention_fwd_cuda(qkv, rel_h, rel_w, *, hw, num_heads: int,
                       return_lse: bool = False):
    """Launch K1 (N > WINDOW_MAX_TOKENS) or K2; same contract as
    ``packed_attention_plain``."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, c3 = qkv.shape
    _kernel_dims(qkv, num_heads)
    kernels.check_operands("attention", (qkv, rel_h, rel_w), (qkv.dtype,) * 3)
    lib = _bind("attention")
    name = "attn_windowed" if n <= WINDOW_MAX_TOKENS else "attn_global"
    fn = getattr(lib, f"dhoct_{name}")
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, n), dtype=torch.float32,
                       device=qkv.device) if return_lse else None)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if return_lse else None, b, n,
                 num_heads, hw[0], hw[1], kernels.DTYPE_CODE[qkv.dtype],
                 stream)
    kernels.raise_on_error(err, lib.dhoct_error_string, name)
    LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def attention_relpos_cuda(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Launch K6; same contract as ``relpos_attention_plain``."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if d % 4 or d > RELPOS_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"K6 (attn_relpos) takes a head_dim that is a multiple of 4 up "
            f"to {RELPOS_MAX_HEAD_DIM}, got {d}")
    kernels.check_operands("attn_relpos", (qkv, rel_h, rel_w),
                           (qkv.dtype,) * 3)
    lib = _bind("attention_relpos")
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.dhoct_attn_relpos(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), b, n, num_heads, d, hw[0], hw[1],
            kernels.DTYPE_CODE[qkv.dtype], stream)
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
    """Check K5's operands; returns (the library, operand pointers, dims)."""
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
    dims = (b, n, num_heads, hw[0], hw[1], kernels.DTYPE_CODE[dt])
    return (_bind("attention_bwd"), [t.data_ptr() for t in args], dims,
            torch.cuda.current_stream(qkv.device).cuda_stream)


def attention_bwd_dq_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, *, hw,
                          num_heads: int):
    """Launch K5's dq kernel: writes dq into the q columns of ``dqkv``
    (B, N, 3C) and returns (drel_h, drel_w)."""
    lib, ptrs, dims, stream = _bwd_operands(qkv, rel_h, rel_w, g_out, lse,
                                            dvec, dqkv, hw, num_heads)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    with torch.cuda.device(qkv.device):
        err = lib.dhoct_attn_bwd_dq(*ptrs, drel_h.data_ptr(),
                                    drel_w.data_ptr(), *dims, stream)
    kernels.raise_on_error(err, lib.dhoct_error_string, "attn_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    return drel_h, drel_w


def attention_bwd_dkv_cuda(qkv, rel_h, rel_w, g_out, lse, dvec, dqkv, *, hw,
                           num_heads: int):
    """Launch K5's dk/dv kernel: writes dk and dv into the k and v columns
    of ``dqkv`` (B, N, 3C)."""
    lib, ptrs, dims, stream = _bwd_operands(qkv, rel_h, rel_w, g_out, lse,
                                            dvec, dqkv, hw, num_heads)
    with torch.cuda.device(qkv.device):
        err = lib.dhoct_attn_bwd_dkv(*ptrs, *dims, stream)
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
