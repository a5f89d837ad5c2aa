"""Cubical persistence and Wasserstein matching on the card (T1, T2).

Port of ``dilabhelmholtzoct_tpu/ops/topology_device.py``: the topological
loss with its pairing and matching on the device, so the step needs no
host round trip and no pipelining. Same names and contracts:
``device_cubical_pairs`` (:305), ``device_wasserstein_match`` (:333),
``device_pairing`` (:487) and ``topo_loss_device`` (:526).

On a CUDA tensor the two combinatorial functions launch the hand-written
kernels of ``csrc/topology.cu``, which run the block-parallel phases of
``csrc/persistence_parallel.h``:

  * ``cubical_pairs`` (T1, ``cubical_pairs_kernel``): one block per grid,
    its arrays in shared memory where they fit (up to 76x76 in H0, 84x84
    in H1), else in the grid's slice of a global scratch buffer that the
    wrapper allocates through PyTorch's caching allocator (the global route,
    up to ``native.MAX_CELLS`` = 65534 cells, JAX's capacity: ~3.5 MB a
    grid at 255x255 in H0, ~450 MB for 128 grids): steepest-descent
    basins by pointer jumping, the merge pixels (those whose earlier
    neighbours lie in two basins or more) compacted and sorted, a walk
    over them that finds their basins' roots in parallel rounds and
    replays the union-find's elder rule one merge pixel after another, the
    bar cap;
  * ``wasserstein_match`` (T2, ``wasserstein_match_kernel``): one block per
    row, the reduced Jonker-Volgenant assignment (f64 duals) with each
    Dijkstra step's column loops spread over the block.

Their results equal the host library's (``ops/native.py`` on
``csrc/persistence_core.h``'s sequential union-find and assignment): the
same bars in the same order, the same matchings. The JAX module's device
pairing uses the same basin idea but emits its bars in another order; the
port's contract is the host's order. ``native.cubical_pairs_parallel`` /
``native.wasserstein_match_parallel`` run the kernels' phases on the host
for the CPU tests. ``device_pairing`` launches T1 once for the pred and the
true grids together and T2 once.

On a CPU tensor the same functions run the plain twin,
``ops/topology_ref.py`` (numpy + scipy): the same bars in the same order
(ties by index, the cap's order ``kept_before``), and an optimal matching
of the same cost (scipy may pick another of equal cost). A CUDA tensor
never reaches the twin: the kernel launches or the wrapper raises. All
combinatorial outputs are integers or detached; the loss gathers the bar
values from the pred grid, so the gradient flows through those pixels only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from . import native, topology_ref
from .topology import (MAX_BARS, _gather, _reduce_topo,
                       _wasserstein_per_diagram, resize_align_corners)

# launch counts of T1 / T2; a plain integer each, reset by the caller
LAUNCHES = {"cubical_pairs": 0, "wasserstein_match": 0}
# T1's launches by route: its arrays in shared memory, or in global scratch
T1_ROUTES = {"shared": 0, "global": 0}
# csrc/topology.cu's code for operands that need more shared memory than
# one block has
ERR_SMEM = 1000

_BOUND = False


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, T1_ROUTES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain twins (numpy + scipy, on the host)
# ---------------------------------------------------------------------------


def cubical_pairs_plain(grids: torch.Tensor, feat_d: int,
                        max_bars: int = MAX_BARS):
    """Plain twin of T1: ``topology_ref``'s union-find per grid, the bars
    in emission order, capped to the ``max_bars`` most persistent (equal
    persistences in emission order). Returns (birth, death (N, max_bars)
    int32, -1 padded; count (N,) int32) on the CPU."""
    g = grids.detach().cpu().float().numpy()
    n, h, w = g.shape
    birth = np.full((n, max_bars), -1, np.int32)
    death = np.full((n, max_bars), -1, np.int32)
    count = np.zeros((n,), np.int32)
    for i in range(n):
        flat = g[i].reshape(-1)
        vals = flat if feat_d == 0 else -flat
        bars, _ = topology_ref._sublevel_h0(
            vals.astype(np.float64).reshape(h, w), eight_connect=feat_d == 0,
            outside_node=feat_d == 1)
        bars = np.asarray(bars, np.int64).reshape(-1, 2)
        if len(bars) > max_bars:
            pers = np.abs(vals[bars[:, 1]] - vals[bars[:, 0]])
            bars = bars[np.argsort(-pers, kind="stable")[:max_bars]]
        if feat_d == 1:  # superlevel bar (q, p) -> H1 bar (p, q)
            bars = bars[:, ::-1]
        count[i] = len(bars)
        birth[i, :len(bars)] = bars[:, 0]
        death[i, :len(bars)] = bars[:, 1]
    return (torch.from_numpy(birth), torch.from_numpy(death),
            torch.from_numpy(count))


def wasserstein_match_plain(flat_pred, p_birth, p_death, p_count, true_bars,
                            t_count, q: float):
    """Plain twin of T2: ``topology_ref.wasserstein_match`` (the reduced
    assignment through scipy) per row. Returns (matched (N, K) int8, target
    (N, K, 2) f32, const_term (N,) f32) on the CPU."""
    flat = flat_pred.detach().cpu().float().numpy()
    pb, pd = p_birth.cpu().numpy(), p_death.cpu().numpy()
    pc, tc = p_count.cpu().numpy(), t_count.cpu().numpy()
    tbars = true_bars.detach().cpu().float().numpy()
    n, k = pb.shape
    matched = np.zeros((n, k), np.int8)
    target = np.zeros((n, k, 2), np.float32)
    const_term = np.zeros((n,), np.float32)
    for i in range(n):
        nb = int(pc[i])
        d1 = np.stack([flat[i, pb[i, :nb]], flat[i, pd[i, :nb]]], 1)
        d2 = tbars[i, :int(tc[i])]
        m, _, un2 = topology_ref.wasserstein_match(d1, d2, q)
        for r, c in m:
            matched[i, r] = 1
            target[i, r] = d2[c]
        if len(un2):
            const_term[i] = np.sum(
                (np.abs(d2[un2, 1] - d2[un2, 0]) / np.float32(2.0))
                ** np.float32(q))
    return (torch.from_numpy(matched), torch.from_numpy(target),
            torch.from_numpy(const_term))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _bind():
    global _BOUND
    lib = kernels.library("topology")
    if not _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dhoct_cubical_pairs.argtypes = [p, i, i, i, i, i, p, p, p, p,
                                            ctypes.c_int64, p]
        lib.dhoct_t1_scratch_bytes.argtypes = [i, i, i, p]
        lib.dhoct_t1_scratch_bytes.restype = ctypes.c_int
        lib.dhoct_wasserstein_match.argtypes = (
            [p, i, i, p, p, p, p, p, i, ctypes.c_float, i, p, p, p, p])
        for fn in (lib.dhoct_cubical_pairs, lib.dhoct_wasserstein_match):
            fn.restype = ctypes.c_int
        lib.dhoct_topology_error_string.argtypes = [ctypes.c_int]
        lib.dhoct_topology_error_string.restype = ctypes.c_char_p
        _BOUND = True
    return lib


def _raise_on_error(err: int, lib, name: str, too_large: str) -> None:
    if err == ERR_SMEM:
        raise NotImplementedError(f"{name}: {too_large}")
    kernels.raise_on_error(err, lib.dhoct_topology_error_string, name)


@functools.lru_cache(maxsize=None)
def t1_scratch_bytes(h: int, w: int, feat_d: int) -> int:
    """T1's route for one (h, w) grid of the ``feat_d`` pass: 0 when the
    grid takes the shared-memory route, else the bytes of its slice of the
    global scratch. Loads (builds) the kernel library."""
    lib = _bind()
    stride = ctypes.c_int64(0)
    err = lib.dhoct_t1_scratch_bytes(h, w, feat_d, ctypes.byref(stride))
    kernels.raise_on_error(err, lib.dhoct_topology_error_string,
                           "cubical_pairs")
    return stride.value


def cubical_pairs_cuda(grids: torch.Tensor, feat_d: int,
                       max_bars: int = MAX_BARS):
    """Launch T1 (``cubical_pairs_kernel``) on (N, H, W) f32 grids on the
    card; same contract as ``cubical_pairs_plain``. Grids past one block's
    shared memory take the global route, with N slices of
    ``t1_scratch_bytes`` allocated here on the grids' device (up to
    ``native.MAX_CELLS`` cells, which ``device_cubical_pairs`` checks; the
    C entry refuses more before any launch)."""
    n, h, w = grids.shape
    kernels.check_operands("cubical_pairs", (grids,), (torch.float32,))
    lib = _bind()
    dev = grids.device
    birth = torch.empty((n, max_bars), dtype=torch.int32, device=dev)
    death = torch.empty_like(birth)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stride = t1_scratch_bytes(h, w, feat_d)
        scratch = (torch.empty((n * stride,), dtype=torch.uint8, device=dev)
                   if stride else None)
        err = lib.dhoct_cubical_pairs(
            grids.data_ptr(), n, h, w, feat_d, max_bars, birth.data_ptr(),
            death.data_ptr(), count.data_ptr(),
            scratch.data_ptr() if stride else None, stride,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on_error(err, lib.dhoct_topology_error_string,
                           "cubical_pairs")
    LAUNCHES["cubical_pairs"] += 1
    T1_ROUTES["global" if stride else "shared"] += 1
    return birth, death, count


def wasserstein_match_cuda(flat_pred, p_birth, p_death, p_count, true_bars,
                           t_count, q: float):
    """Launch T2 (``wasserstein_match_kernel``) on the card; same contract
    as ``wasserstein_match_plain``. flat_pred (N, HW) f32; p_birth / p_death
    (N, K) int32; p_count (N,) int32; true_bars (N, T, 2) f32; t_count (N,)
    int32."""
    n, k = p_birth.shape
    t = true_bars.shape[1]
    i32, f32 = torch.int32, torch.float32
    kernels.check_operands(
        "wasserstein_match",
        (flat_pred, p_birth, p_death, p_count, true_bars, t_count),
        (f32, i32, i32, i32, f32, i32))
    lib = _bind()
    dev = flat_pred.device
    matched = torch.empty((n, k), dtype=torch.int8, device=dev)
    target = torch.empty((n, k, 2), dtype=f32, device=dev)
    const_term = torch.empty((n,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dhoct_wasserstein_match(
            flat_pred.data_ptr(), n, flat_pred.shape[1], p_birth.data_ptr(),
            p_death.data_ptr(), p_count.data_ptr(), true_bars.data_ptr(),
            t_count.data_ptr(), t, float(q), k, matched.data_ptr(),
            target.data_ptr(), const_term.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(err, lib, "wasserstein_match",
                    f"{k} pred and {t} true bars a row need more shared "
                    "memory than one block has")
    LAUNCHES["wasserstein_match"] += 1
    return matched, target, const_term


# ---------------------------------------------------------------------------
# The module's functions
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous and 16-byte aligned (a copy
    for a slice that starts elsewhere, such as the true rows' counts)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on(device_type: str, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} kernel for device {device_type}")
    return device_type == "cuda"


def device_cubical_pairs(grids: torch.Tensor, feat_d: int,
                         max_bars: int = MAX_BARS):
    """Persistence pairing of homology dimension ``feat_d`` of (N, H, W)
    grids (H0: sublevel, 8-connected; H1 by Alexander duality: superlevel,
    4-connected, with the outside node, bars swapped). Returns (birth, death
    (N, max_bars) int32 flat pixel indices, -1 padded; count (N,) int32) on
    the grids' device; empty for feat_d not in {0, 1} (no 2-dimensional
    features on a 2-D grid). Grids of more than ``native.MAX_CELLS``
    cells raise ValueError, on any device."""
    n = grids.shape[0]
    native.check_cells(*grids.shape[1:])
    if feat_d not in (0, 1) or n == 0:
        empty = torch.full((n, max_bars), -1, dtype=torch.int32,
                           device=grids.device)
        return empty, empty.clone(), torch.zeros(
            (n,), dtype=torch.int32, device=grids.device)
    grids = _aligned(grids.detach().float())
    if _on(grids.device.type, "cubical_pairs"):
        return cubical_pairs_cuda(grids, feat_d, max_bars)
    return cubical_pairs_plain(grids, feat_d, max_bars)


def device_wasserstein_match(flat_pred, p_birth, p_death, t_b, t_d, t_cnt,
                             q: float, p_count=None):
    """Reduced-assignment optimal partial matching of each row's pred bars
    (p_birth / p_death (N, K) into flat_pred (N, HW)) with its true bars
    (values t_b / t_d (N, T), t_cnt (N,) of them). Returns (matched (N, K)
    bool, target (N, K, 2) f32, const_term (N,) f32). Equal-cost matchings
    may differ between the kernel and the twin; their cost cannot."""
    if p_count is None:
        p_count = (p_birth >= 0).sum(1)
    args = tuple(_aligned(t) for t in (
        flat_pred.detach().float(), p_birth.to(torch.int32),
        p_death.to(torch.int32), p_count.to(torch.int32),
        torch.stack([t_b, t_d], -1).detach().float(),
        t_cnt.to(torch.int32)))
    if p_birth.shape[0] == 0 or p_birth.shape[1] == 0:
        matched, target, const_term = (
            torch.zeros(p_birth.shape, dtype=torch.int8),
            torch.zeros((*p_birth.shape, 2)), torch.zeros(p_birth.shape[:1]))
    elif _on(flat_pred.device.type, "wasserstein_match"):
        matched, target, const_term = wasserstein_match_cuda(*args, q)
    else:
        matched, target, const_term = wasserstein_match_plain(*args, q)
    dev = flat_pred.device
    return matched.to(dev).bool(), target.to(dev), const_term.to(dev)


def device_pairing(pred_g, true_g, feat_d: int, q: float,
                   max_bars: int = MAX_BARS) -> dict:
    """The pairing and matching of (N, h, w) downsampled grids on their
    device: the dict of ``ops.topology.host_pairing`` (tensors). One T1
    launch pairs the pred and the true grids together, one T2 launch
    matches them."""
    sp = pred_g.detach().float()
    st = true_g.detach().float()
    n = sp.shape[0]
    b, d, c = device_cubical_pairs(torch.cat([sp, st]), feat_d, max_bars)
    pb, pd, p_cnt = b[:n], d[:n], c[:n]
    t_flat = st.reshape(n, -1)
    t_b = _gather(t_flat, b[n:])
    t_d = _gather(t_flat, d[n:])
    matched, target, const_term = device_wasserstein_match(
        sp.reshape(n, -1), pb, pd, t_b, t_d, c[n:], q, p_count=p_cnt)
    return {"p_birth": pb, "p_death": pd,
            "matched": matched.to(torch.int8), "target": target,
            "const_term": const_term}


def topo_loss_device(pred_obj, true_obj, lamda: float, interp: int = 0,
                     feat_d: int = 2, loss_q: int = 2, loss_r: bool = False,
                     channel_mask=None, max_bars: int = MAX_BARS):
    """The topological loss with its pairing and matching on the tensors'
    device (``ops.topology.topo_loss``'s signature and value)."""
    if lamda == 0.0:
        return 0.0
    b, c = pred_obj.shape[:2]
    pred = pred_obj.float()
    true = true_obj.float()
    if interp:
        pred = resize_align_corners(pred, (interp, interp))
        true = resize_align_corners(true, (interp, interp))
    h, w = pred.shape[-2], pred.shape[-1]
    n = b * c
    pred_g = pred.reshape(n, h, w)
    true_g = true.reshape(n, h, w)
    pred_pair_g = pred_g
    if channel_mask is not None:
        # bucket-padding rows zeroed before the pairing: a constant grid has
        # an empty diagram, and their loss is masked by channel_mask anyway
        rows = channel_mask.reshape(n).bool()[:, None, None]
        pred_pair_g = torch.where(rows, pred_g, 0.0)
        true_g = torch.where(rows, true_g, 0.0)
    pairing = device_pairing(pred_pair_g, true_g, feat_d, float(loss_q),
                             max_bars)
    w_per = _wasserstein_per_diagram(
        pred_g, pairing["p_birth"], pairing["p_death"], pairing["matched"],
        pairing["target"], pairing["const_term"], float(loss_q)).reshape(b, c)
    return _reduce_topo(w_per, pred_g, pairing, lamda, loss_q, loss_r,
                        channel_mask, b, c)
