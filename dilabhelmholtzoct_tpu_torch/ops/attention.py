"""Encoder self-attention over the fused qkv, with decomposed rel-pos bias.

``flash_attention_packed`` is the port of
``dilabhelmholtzoct_tpu/ops/attention.py::flash_attention_packed``: it reads
the raw qkv projection (B, N, 3C) and writes token-order (B, N, C). On a CUDA
tensor it launches a hand-written kernel (``csrc/attention.cu``):

  * K1 ``attn_global_kernel`` for the global layers (N > WINDOW_MAX_TOKENS;
    N = 4096 at ViT-B), replacing the TPU ``_packed_kernel``;
  * K2 ``attn_windowed_kernel`` for the windowed layers (N <= 256; 14x14
    windows at ViT-B), replacing the TPU ``_windowed_group_kernel``.

Their bounds on an H100 and what the design does about them are noted at
the top of the CUDA source. On a CPU tensor the wrapper runs
``packed_attention_plain``, the same function with a materialised bias and
an f32 softmax. A CUDA tensor never reaches the plain version: the kernel
launches or the wrapper raises.

``LAUNCHES`` counts kernel launches (one per wrapper call that launched), so
a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

# K1 / K2 launch counts; a plain integer each, reset by the caller
LAUNCHES = {"attn_global": 0, "attn_windowed": 0}
WINDOW_MAX_TOKENS = 256  # K2 holds all keys of a window in shared memory
HEAD_DIM = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BOUND = False


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


def packed_attention_plain(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Plain PyTorch version: materialised (N, N) bias, f32 softmax, the
    output cast back to the input dtype (``attention_reference`` math on the
    packed qkv)."""
    _check(qkv, rel_h, rel_w, hw, num_heads)
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    h, w = hw
    x = qkv.float().reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]  # (B, heads, N, d)
    logits = torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
    bias = (rel_h.float().reshape(b, num_heads, n, h, 1)
            + rel_w.float().reshape(b, num_heads, n, 1, w))
    attn = torch.softmax(logits + bias.reshape(b, num_heads, n, n), dim=-1)
    out = torch.matmul(attn, v)  # (B, heads, N, d)
    return out.permute(0, 2, 1, 3).reshape(b, n, c).to(qkv.dtype)


def _bind():
    global _BOUND
    lib = kernels.library("attention")
    if not _BOUND:
        sig = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for fn in (lib.dhoct_attn_global, lib.dhoct_attn_windowed):
            fn.argtypes = sig
            fn.restype = ctypes.c_int
        lib.dhoct_error_string.argtypes = [ctypes.c_int]
        lib.dhoct_error_string.restype = ctypes.c_char_p
        _BOUND = True
    return lib


def _launch(qkv, rel_h, rel_w, *, hw, num_heads):
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    if d != HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA attention kernels take head_dim {HEAD_DIM}, got {d}; "
            "the any-head_dim kernel (TPU flash_attention_relpos, K6) is not "
            "ported yet")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"qkv dtype {qkv.dtype} is not float32 or bfloat16")
    for t in (qkv, rel_h, rel_w):
        if t.device != qkv.device or t.dtype != qkv.dtype:
            raise ValueError("qkv, rel_h and rel_w must share device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qkv, rel_h and rel_w must be contiguous and "
                             "16-byte aligned")
    lib = _bind()
    windowed = n <= WINDOW_MAX_TOKENS
    fn = lib.dhoct_attn_windowed if windowed else lib.dhoct_attn_global
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = fn(qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 out.data_ptr(), b, n, num_heads, hw[0], hw[1],
                 _DTYPE_CODE[qkv.dtype], stream)
    if err:
        raise RuntimeError(
            f"{'attn_windowed' if windowed else 'attn_global'} launch failed: "
            f"{lib.dhoct_error_string(err).decode()} (cudaError {err})")
    LAUNCHES["attn_windowed" if windowed else "attn_global"] += 1
    return out


def flash_attention_packed(qkv, rel_h, rel_w, *, hw, num_heads: int):
    """Attention over the fused qkv projection.

    qkv:   (B, N, 3C), feature order (3, heads, head_dim)
    rel_h: (B, heads, N, hw[0]) bias factor over key rows
    rel_w: (B, heads, N, hw[1]) bias factor over key columns
    Returns (B, N, C) in token order, in qkv's dtype.

    CPU tensors take the plain version; CUDA tensors launch K1 (global) or
    K2 (windowed, N <= 256) and raise if the kernel cannot run."""
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, rel_h, rel_w, hw=hw,
                                      num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    _check(qkv, rel_h, rel_w, hw, num_heads)
    return _launch(qkv, rel_h, rel_w, hw=hw, num_heads=num_heads)
