"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``. The
libraries go to ``build/kernels/`` beside the package (a directory git
ignores), named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. Building happens at first
use, never at import: the host that runs the CPU tests has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# one shared library per source; headers (*.cuh, and the *.h shared with the
# host library) are hashed into every library
SOURCES = {"attention_bwd": "attention_bwd.cu",
           "attention_bwd_wgmma_tf32": "attention_bwd_wgmma_tf32.cu",
           "attention_relpos_wgmma": "attention_relpos_wgmma.cu",
           "attention_relpos_wgmma_tf32": "attention_relpos_wgmma_tf32.cu",
           "attention_winimg": "attention_winimg.cu",
           "upscaler": "upscaler.cu", "decoder_attn": "decoder_attn.cu",
           "topology": "topology.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the dtype argument of every C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this process
BUILD_LOG: dict[str, str] = {}


def cuda_tool(name: str = "nvcc") -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / name) if home else None,
                 shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise FileNotFoundError(
        f"{name} not found (set CUDA_HOME); the CUDA kernels are built on the "
        "machine with the card")


def library_path(name: str) -> Path:
    """Where the library of ``SOURCES[name]`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h"))
    for p in headers + [CSRC / SOURCES[name]]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile the named sources (all by default) that are not built yet, one
    ``nvcc`` process each, all started together. Returns the wall seconds;
    raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, library_path(n))  # atomic: readers never see half
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``SOURCES[name]``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def check_operands(name: str, tensors, dtypes) -> None:
    """Raise unless every operand lies on the first one's device, has its
    expected dtype, and is contiguous and 16-byte aligned (the kernels' wide
    loads assume both)."""
    if tensors[0].dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} is not float32 or "
                        "bfloat16")
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: operand of dtype {t.dtype}, the kernel "
                            f"takes {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")


def row_chunks(rows: int, parts: int, align: int) -> list[tuple[int, int]]:
    """Split ``rows`` into at most ``parts`` consecutive ranges whose sizes
    are one multiple of ``align`` (the last range may be shorter): the row
    chunks of a weight-gradient pass, one partial sum each, added up in
    this order."""
    size = -(-rows // parts)
    size = -(-size // align) * align
    return [(lo, min(rows, lo + size)) for lo in range(0, rows, size)]


def pointers(tensors):
    """The tensors' device pointers as one ctypes array (a ``void* const*``
    argument of a C interface)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_device(device):
    """A context that makes ``device`` the current CUDA device for a launch,
    or nothing where it is current already (the usual case: one process
    per card), which spares a launch's host path the device switch."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raise_on_error(err: int, error_string, name: str) -> None:
    """Raise for a non-zero cudaError_t returned by a launch (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{error_string(err).decode()} (cudaError {err})")
