"""Device choice and f32 numerics on the card."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A missing card is an error, never a silent move to the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


@contextlib.contextmanager
def full_fp32():
    """Full-f32 products inside the block.

    Both TF32 switches are set off and restored on exit:
    ``torch.backends.cuda.matmul.allow_tf32`` (cuBLAS; off by default) and
    ``torch.backends.cudnn.allow_tf32`` (cuDNN convolutions; ON by default,
    which would run the encoder neck's 3x3 conv at ~3 decimal digits). The
    mask postprocess needs full f32: boundary pixels flip at 0.5 otherwise.
    """
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
