"""ctypes bindings of the host library of the topological loss.

Port of ``dilabhelmholtzoct_tpu/ops/native.py``'s persistence entries
(``cubical_pairs_batch``, ``wasserstein_match_batch``), over the port's own
sources: ``csrc/persistence_host.cc`` on the algorithm of
``csrc/persistence_core.h``. The card's kernels (``csrc/topology.cu``) run
the block-parallel phases of ``csrc/persistence_parallel.h``;
``cubical_pairs_parallel`` and ``wasserstein_match_parallel`` run those
phases here, over a virtual thread count, so the CPU tests can hold the
kernels' algorithm to the core's.

The library is built at first use with g++ into ``build/native/`` beside
the package (a directory git ignores), named by a hash of the sources and
flags; the compiler writes to a temporary name that is then renamed, so
processes that build at once never load a half-written file. Nothing else
is run. When the library cannot be built or loaded the call raises with the
compiler's output: there is no quiet fallback. The component labelling of
the JAX package's library is not here: the port labels with scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
SOURCES = ("persistence_host.cc", "persistence_core.h",
           "persistence_parallel.h")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-ffp-contract=off")

_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpersistence-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises with the
    compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-I", str(CSRC), "-o",
           str(tmp), str(CSRC / SOURCES[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the persistence library failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the persistence library failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: readers never see half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.cubical_pairs_batch.argtypes = [p, i, i, i, i] + [p] * 6
        lib.cubical_pairs_batch.restype = None
        lib.wasserstein_match_batch.argtypes = [p, i, i, p, p, p, p, p,
                                                ctypes.c_double, i, p, p, p]
        lib.wasserstein_match_batch.restype = None
        lib.cubical_pairs_parallel.argtypes = [p, i, i, i, i, i, i, p, p, p,
                                               p]
        lib.cubical_pairs_parallel.restype = None
        lib.wasserstein_match_parallel.argtypes = [
            p, i, i, p, p, p, p, p, i, ctypes.c_double, i, i, p, p, p, p]
        lib.wasserstein_match_parallel.restype = None
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def cubical_pairs_batch(grids, max_bars: int = 32) -> dict:
    """Batched H0 / H1 persistence pairing.

    grids: (N, H, W) float32. Returns a dict of arrays:
      h0_birth / h0_death / h1_birth / h1_death: (N, max_bars) int32, -1
        padded;
      counts: (N, 2) int32, [n_h0 finite, n_h1];
      h0_essential: (N,) int32, the birth pixel of the essential H0 class.
    Beyond max_bars the least persistent bars are dropped, equal
    persistences in emission order (``persistence_core.h::kept_before``).
    """
    grids = np.ascontiguousarray(grids, np.float32)
    n, h, w = grids.shape
    out = {k: np.empty((n, max_bars), np.int32)
           for k in ("h0_birth", "h0_death", "h1_birth", "h1_death")}
    out["counts"] = np.empty((n, 2), np.int32)
    out["h0_essential"] = np.empty((n,), np.int32)
    if n == 0:
        return out
    library().cubical_pairs_batch(
        _ptr(grids), n, h, w, max_bars, _ptr(out["h0_birth"]),
        _ptr(out["h0_death"]), _ptr(out["h1_birth"]), _ptr(out["h1_death"]),
        _ptr(out["counts"]), _ptr(out["h0_essential"]))
    return out


def wasserstein_match_batch(grids, p_birth, p_death, p_count, true_diagrams,
                            q: float, max_bars: int):
    """Batched reduced-assignment Wasserstein matching.

    grids: (n, H, W) or (n, HW) f32 pred grids; p_birth / p_death: (n, K)
    int32 flat indices (-1 padding); p_count: (n,) int32; true_diagrams: n
    arrays of (cnt_i, 2) true bar values. Returns (matched (n, K) int8,
    target (n, K, 2) f32, const_term (n,) f32)."""
    grids = np.ascontiguousarray(grids, np.float32)
    n = grids.shape[0]
    grids = grids.reshape(n, -1)
    p_birth = np.ascontiguousarray(p_birth, np.int32)
    p_death = np.ascontiguousarray(p_death, np.int32)
    p_count = np.ascontiguousarray(p_count, np.int32)
    t_off = np.zeros(n + 1, np.int64)
    t_off[1:] = np.cumsum([len(d) for d in true_diagrams])
    if t_off[-1]:
        true_bars = np.ascontiguousarray(np.concatenate(
            [np.asarray(d, np.float32).reshape(-1, 2) for d in true_diagrams]))
    else:
        true_bars = np.zeros((1, 2), np.float32)  # a non-null pointer
    matched = np.zeros((n, max_bars), np.int8)
    target = np.zeros((n, max_bars, 2), np.float32)
    const_term = np.zeros((n,), np.float32)
    if n:
        library().wasserstein_match_batch(
            _ptr(grids), n, grids.shape[1], _ptr(p_birth), _ptr(p_death),
            _ptr(p_count), _ptr(true_bars), _ptr(t_off), float(q), max_bars,
            _ptr(matched), _ptr(target), _ptr(const_term))
    return matched, target, const_term


def cubical_pairs_parallel(grids, feat_d: int, max_bars: int = 32,
                           threads: int = 256):
    """T1's algorithm (``csrc/topology.cu::cubical_pairs_kernel``'s phases)
    on the host, over ``threads`` virtual threads: the ``feat_d`` pass (0:
    H0, 1: H1, bars swapped) of (N, H, W) f32 grids. Returns (birth, death
    (N, max_bars) int32, -1 padded; count (N,) int32; merges (N,) int32,
    the merge pixels its walk visited)."""
    grids = np.ascontiguousarray(grids, np.float32)
    n, h, w = grids.shape
    if h * w >= 1 << 15:  # the phases keep pixel indices in 16 bits
        raise ValueError(f"a {h}x{w} grid has 2^15 pixels or more")
    birth = np.empty((n, max_bars), np.int32)
    death = np.empty((n, max_bars), np.int32)
    count = np.empty((n,), np.int32)
    merges = np.empty((n,), np.int32)
    if n:
        library().cubical_pairs_parallel(
            _ptr(grids), n, h, w, feat_d, max_bars, threads, _ptr(birth),
            _ptr(death), _ptr(count), _ptr(merges))
    return birth, death, count, merges


def wasserstein_match_parallel(grids, p_birth, p_death, p_count, true_bars,
                               t_count, q: float, threads: int = 256):
    """T2's algorithm (``csrc/topology.cu::wasserstein_match_kernel``'s
    phases) on the host, over ``threads`` virtual threads, in the kernel's
    layout: grids (n, HW) f32; p_birth / p_death (n, K) int32; p_count (n,)
    int32; true_bars (n, T, 2) f32; t_count (n,) int32. Returns (matched
    (n, K) int8, target (n, K, 2) f32, const_term (n,) f32, steps (n,)
    int32, the Dijkstra steps of each row)."""
    grids = np.ascontiguousarray(grids, np.float32)
    n = grids.shape[0]
    grids = grids.reshape(n, -1)
    p_birth = np.ascontiguousarray(p_birth, np.int32)
    p_death = np.ascontiguousarray(p_death, np.int32)
    p_count = np.ascontiguousarray(p_count, np.int32)
    true_bars = np.ascontiguousarray(true_bars, np.float32)
    t_count = np.ascontiguousarray(t_count, np.int32)
    k = p_birth.shape[1]
    matched = np.empty((n, k), np.int8)
    target = np.empty((n, k, 2), np.float32)
    const_term = np.empty((n,), np.float32)
    steps = np.empty((n,), np.int32)
    if n:
        library().wasserstein_match_parallel(
            _ptr(grids), n, grids.shape[1], _ptr(p_birth), _ptr(p_death),
            _ptr(p_count), _ptr(true_bars), _ptr(t_count),
            true_bars.shape[1], float(q), k, threads, _ptr(matched),
            _ptr(target), _ptr(const_term), _ptr(steps))
    return matched, target, const_term, steps
