"""ctypes bindings of the port's host library: the topological loss's
pairing and matching, and the component engine of prompt extraction.

Port of ``dilabhelmholtzoct_tpu/ops/native.py`` (``cubical_pairs_batch``,
``wasserstein_match_batch``, ``label_components_8``, ``extract_components``,
``component_pixel_at``), over the port's own sources:
``csrc/persistence_host.cc`` on the algorithm of ``csrc/persistence_core.h``,
and ``csrc/components_host.cc``. The card's kernels (``csrc/topology.cu``) run
the block-parallel phases of ``csrc/persistence_parallel.h``;
``cubical_pairs_parallel`` and ``wasserstein_match_parallel`` run those
phases here, over a virtual thread count, so the CPU tests can hold the
kernels' algorithm to the core's.

The library is built at first use with g++ into ``build/native/`` beside
the package (a directory git ignores), named by a hash of the sources and
flags; the compiler writes to a name of its own process and thread that is
then renamed, so processes that build at once never load a half-written
file, and one lock lets a single thread of a process build and load it (the
data loader's threads reach the component engine at once). Nothing else is
run. When the library cannot be built or loaded the call raises with the
compiler's output: there is no quiet fallback (the JAX package falls back
to scipy; the port's scipy versions are plain twins for the tests, in
``data/sampling.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
SOURCES = ("persistence_host.cc", "components_host.cc", "persistence_core.h",
           "persistence_parallel.h")
# JAX's device pairing packs a cell id in 16 bits beside two reserved ids
# (dilabhelmholtzoct_tpu/ops/topology_device.py:_MAXCELLS); the port's T1
# and its phases take the same grids
MAX_CELLS = (1 << 16) - 2
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-ffp-contract=off")

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libhost-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; raises with the
    compiler's output when the build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-I", str(CSRC), "-o",
           str(tmp), *(str(CSRC / s) for s in SOURCES if s.endswith(".cc"))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the host library failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the host library failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: readers never see half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; safe to call from many
    threads at once."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load(build())
    return _LIB


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.cubical_pairs_batch.argtypes = [p, i, i, i, i] + [p] * 6
    lib.cubical_pairs_batch.restype = None
    lib.wasserstein_match_batch.argtypes = [p, i, i, p, p, p, p, p,
                                            ctypes.c_double, i, p, p, p]
    lib.wasserstein_match_batch.restype = None
    lib.cubical_pairs_parallel.argtypes = [p, i, i, i, i, i, i, p, p, p, p]
    lib.cubical_pairs_parallel.restype = None
    lib.wasserstein_match_parallel.argtypes = [
        p, i, i, p, p, p, p, p, i, ctypes.c_double, i, i, p, p, p, p]
    lib.wasserstein_match_parallel.restype = None
    lib.label_components_8.argtypes = [p, i, i, p]
    lib.label_components_8.restype = ctypes.c_int32
    lib.extract_components.argtypes = [p, i, i, i, p, p, p, p]
    lib.extract_components.restype = ctypes.c_int32
    lib.component_pixel_at.argtypes = [p, i, i, i, p, p]
    lib.component_pixel_at.restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def check_cells(h: int, w: int) -> None:
    """Raise ValueError for a grid of more than ``MAX_CELLS`` cells."""
    if h * w > MAX_CELLS:
        raise ValueError(f"grid {h}x{w} exceeds the pairing capacity "
                         f"({MAX_CELLS} cells)")


def label_components_8(mask: np.ndarray):
    """8-connected components of a (H, W) mask (nonzero: foreground), as
    ``scipy.ndimage.label(mask, np.ones((3, 3)))`` labels them: (labels
    (H, W) int32, 1..n in raster order of each component's first pixel;
    n)."""
    mask8 = np.ascontiguousarray(mask != 0, np.uint8)
    out = np.empty(mask8.shape, np.int32)
    n = library().label_components_8(_ptr(mask8), *mask8.shape, _ptr(out))
    return out, int(n)


def extract_components(label: np.ndarray, max_comps: int):
    """The components of a (H, W) uint8 class map: per class value present,
    ascending, its 8-connected components in raster order of their first
    pixels. Returns (comp_map (H, W) int32 slots 1..n, 0 past the cap;
    values (n,) int32; boxes (n, 4) int32 x0, y0, x1, y1 inclusive; sizes
    (n,) int32; the total found), n = min(total, max_comps)."""
    lab = np.ascontiguousarray(label, np.uint8)
    comp_map = np.empty(lab.shape, np.int32)
    values = np.empty((max_comps,), np.int32)
    boxes = np.empty((max_comps, 4), np.int32)
    sizes = np.empty((max_comps,), np.int32)
    total = int(library().extract_components(
        _ptr(lab), *lab.shape, max_comps, _ptr(comp_map), _ptr(values),
        _ptr(boxes), _ptr(sizes)))
    n = min(total, max_comps)
    return comp_map, values[:n], boxes[:n], sizes[:n], total


def component_pixel_at(comp_map: np.ndarray, ranks) -> np.ndarray:
    """(n, 2) int32: the (x, y) of the ``ranks[s]``-th pixel, in raster
    order, of slot s + 1 of a (H, W) int32 ``comp_map``; each rank below its
    slot's size."""
    cm = np.ascontiguousarray(comp_map, np.int32)
    r = np.ascontiguousarray(ranks, np.int64)
    out = np.zeros((len(r), 2), np.int32)
    library().component_pixel_at(_ptr(cm), *cm.shape, len(r), _ptr(r),
                                 _ptr(out))
    return out


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
    check_cells(h, w)
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
