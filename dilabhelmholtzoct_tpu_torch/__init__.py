"""dilabhelmholtzoct_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``dilabhelmholtzoct_tpu`` (the JAX reference). It
imports ``torch`` and numpy, never JAX or the JAX package. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``. The encoder's
attention (K1, K2) and, in the bf16 training path, the decoder's upscaler
(K3) and image->token attention (K4) run through hand-written CUDA kernels
(``csrc/``) on the card and through their plain PyTorch versions on the
host.
"""

__version__ = "0.1.0"
