"""dilabhelmholtzoct_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``dilabhelmholtzoct_tpu`` (the JAX reference). It
imports ``torch`` and numpy, never JAX or the JAX package. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; the encoder's
attention runs through hand-written CUDA kernels (``csrc/``) on the card and
through their plain PyTorch versions on the host.
"""

__version__ = "0.1.0"
