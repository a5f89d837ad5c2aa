"""Differentiable topological loss: cubical persistence + Wasserstein.

Port of ``dilabhelmholtzoct_tpu/ops/topology.py`` (the reference's
``octsam/models/topological_loss.py``): early exit when lambda is 0;
align-corners bilinear downsample of pred and true to ``interp``^2; cubical
sublevel persistence diagrams of homology dimension ``feat_d``; a
q-Wasserstein distance per (sample, channel) between the pred and true
diagrams; summed over channels, averaged over the batch, times lambda; an
optional total-persistence term (``loss_r``).

The combinatorial part -- the persistence pairing and the optimal matching
-- is piecewise constant in the input and carries no gradient. Here it runs
on the host, in the port's C++ library (``ops/native.py``), on detached
grids copied to the host: JAX's ``pure_callback`` becomes detach -> host ->
pairing -> loss. Everything that carries a gradient -- the resize, the
gathered birth / death values, the matched costs -- is torch on the input's
device, so the gradient flows only through the pixel values at the paired
indices, as in torch_topological. ``ops/topology_device.py`` computes the
same pairing on the card. Under data parallelism the batch mean is over the
global batch (``parallel/distributed.py``), as in the losses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.distributed import global_count, mean_share
from .native import cubical_pairs_batch, wasserstein_match_batch

# Bar capacity per diagram. Uniform sigmoid noise on 50x50 grids -- the
# worst realistic early-training input -- gives up to ~310 H0 and ~490 H1
# bars, so 512 loses nothing in practice; beyond it the least persistent
# bars are dropped (the error is bounded by the smallest persistences).
MAX_BARS = 512

PAIRING_KEYS = ("p_birth", "p_death", "matched", "target", "const_term")


def _axis(n_in: int, n_out: int):
    """Source rows of an align-corners resize: (i0, i1, weight)."""
    if n_out == 1:
        coords = np.zeros(1, np.float32)
    else:
        coords = np.arange(n_out, dtype=np.float32) * ((n_in - 1) / (n_out - 1))
    i0 = np.clip(np.floor(coords).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, (coords - i0).astype(np.float32)


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Differentiable bilinear resize with align_corners=True: (..., H, W)
    -> (..., out_h, out_w), as torch ``F.interpolate(..., align_corners=True)``
    computes it, in the JAX package's gather-and-lerp form (so values and
    gradients match it to f32 rounding)."""
    h, w = x.shape[-2], x.shape[-1]
    y0, y1, wy = _axis(h, out_hw[0])
    x0, x1, wx = _axis(w, out_hw[1])

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=x.device)

    wy = torch.as_tensor(wy, device=x.device)
    wx = torch.as_tensor(wx, device=x.device)
    top = x.index_select(-2, idx(y0))
    bot = x.index_select(-2, idx(y1))
    rows = top + wy[:, None] * (bot - top)
    left = rows.index_select(-1, idx(x0))
    right = rows.index_select(-1, idx(x1))
    return left + wx * (right - left)


def true_diagrams_from_grids(true, feat_d: int = 1, max_bars: int = MAX_BARS):
    """Per-row persistence diagram values (birth, death) of target grids
    (N, H, W): a list of (cnt_i, 2) f32 arrays. The targets are constant
    across epochs, so the trainer caches these; only the values matter
    downstream (the gradient flows through the pred side only)."""
    true = np.asarray(true, np.float32)
    n = true.shape[0]
    empty = np.zeros((0, 2), np.float32)
    if feat_d not in (0, 1):  # no 2-dim features on a 2-D grid
        return [empty] * n
    tp = cubical_pairs_batch(true, max_bars)
    out = []
    for i in range(n):
        cnt = int(tp["counts"][i, feat_d])
        flat = true[i].reshape(-1)
        tb = tp[f"h{feat_d}_birth"][i, :cnt]
        td = tp[f"h{feat_d}_death"][i, :cnt]
        out.append(np.stack([flat[tb], flat[td]], 1).astype(np.float32)
                   if cnt else empty)
    return out


def host_pairing(pred, true, feat_d: int = 1, q: float = 2.0,
                 max_bars: int = MAX_BARS, true_diagrams=None,
                 row_mask=None) -> dict:
    """The pairing and matching of (N, H, W) host grids, as a dict of numpy
    arrays (``PAIRING_KEYS``): p_birth / p_death (N, K) int32 flat pixel
    indices (-1 padding), matched (N, K) int8, target (N, K, 2) f32 (the
    matched true bar), const_term (N,) f32 (the diagonal costs^q of the
    unmatched true bars).

    true_diagrams: optional per-row true diagram values
    (``true_diagrams_from_grids``); with them ``true`` may be None (the
    trainer's cross-epoch cache). row_mask: optional (N,) 0/1; rows with 0
    (bucket padding, zeroed by channel_mask downstream) are skipped and keep
    empty entries."""
    pred = np.asarray(pred, np.float32)
    n = pred.shape[0]
    k = max_bars
    dim = int(feat_d)
    if row_mask is not None:
        active = np.nonzero(np.asarray(row_mask).reshape(-1) > 0)[0]
    else:
        active = np.arange(n)
    if true_diagrams is None:
        empty = np.zeros((0, 2), np.float32)
        true_diagrams = [empty] * n
        if len(active):
            diags = true_diagrams_from_grids(
                np.asarray(true, np.float32)[active], dim, k)
            for j, i in enumerate(active):
                true_diagrams[i] = diags[j]

    pairing = {"p_birth": np.full((n, k), -1, np.int32),
               "p_death": np.full((n, k), -1, np.int32),
               "matched": np.zeros((n, k), np.int8),
               "target": np.zeros((n, k, 2), np.float32),
               "const_term": np.zeros((n,), np.float32)}
    if len(active) == 0:
        return pairing
    if dim in (0, 1):
        pp = cubical_pairs_batch(pred[active], k)
        pb_a, pd_a = pp[f"h{dim}_birth"], pp[f"h{dim}_death"]
        counts_a = np.ascontiguousarray(pp["counts"][:, dim])
    else:  # no 2-dimensional features on a 2-D grid
        pb_a = np.full((len(active), k), -1, np.int32)
        pd_a = np.full((len(active), k), -1, np.int32)
        counts_a = np.zeros((len(active),), np.int32)
    m_a, t_a, c_a = wasserstein_match_batch(
        pred[active], pb_a, pd_a, counts_a,
        [true_diagrams[i] for i in active], q, k)
    for key, rows in zip(PAIRING_KEYS, (pb_a, pd_a, m_a, t_a, c_a)):
        pairing[key][active] = rows
    return pairing


def pairing_to(pairing: dict, device) -> dict:
    """A pairing's arrays (numpy, or tensors anywhere) as tensors on
    ``device``."""
    return {k: torch.as_tensor(pairing[k], device=device)
            for k in PAIRING_KEYS}


def _gather(flat, idx):
    return torch.gather(flat, 1, idx.clamp(min=0).long())


def _wasserstein_per_diagram(grids, p_birth, p_death, matched, target,
                             const_term, q: float):
    """Differentiable per-diagram W_q from a given pairing and matching;
    grids (N, H, W), the only input that carries a gradient."""
    flat = grids.reshape(grids.shape[0], -1)
    valid = p_birth >= 0
    b = _gather(flat, p_birth)
    d = _gather(flat, p_death)
    cost_matched = torch.maximum((b - target[..., 0]).abs(),
                                 (d - target[..., 1]).abs()) ** q
    cost_diag = ((d - b).abs() / 2.0) ** q
    cost = torch.where(matched.bool(), cost_matched, cost_diag)
    total = torch.where(valid, cost, 0.0).sum(1) + const_term
    return total.clamp(min=1e-12) ** (1.0 / q)


def downsample_grid(x, interp: int):
    """The reference's align-corners downsample of one tensor, in f32."""
    x = x.float()
    return resize_align_corners(x, (interp, interp)) if interp else x


def downsample_for_topo(pred_obj, true_obj, interp: int):
    return downsample_grid(pred_obj, interp), downsample_grid(true_obj, interp)


def topo_loss_from_pairing(pred_obj, pairing: dict, lamda: float,
                           interp: int = 0, loss_q: int = 2,
                           loss_r: bool = False, channel_mask=None):
    """The loss from a given ``host_pairing`` (numpy arrays or tensors);
    pred_obj: (B, C, H, W) sigmoid probabilities before the downsample."""
    b, c = pred_obj.shape[:2]
    pred = downsample_grid(pred_obj, interp)
    pred_g = pred.reshape(b * c, pred.shape[-2], pred.shape[-1])
    pairing = pairing_to(pairing, pred_g.device)
    w_per = _wasserstein_per_diagram(
        pred_g, pairing["p_birth"], pairing["p_death"], pairing["matched"],
        pairing["target"], pairing["const_term"], float(loss_q)).reshape(b, c)
    return _reduce_topo(w_per, pred_g, pairing, lamda, loss_q, loss_r,
                        channel_mask, b, c)


def _reduce_topo(w_per, pred_g, pairing, lamda, loss_q, loss_r, channel_mask,
                 b, c):
    if channel_mask is not None:
        cm = channel_mask.float()
        w_per = w_per * cm
        row_valid = (cm.sum(1) > 0).float()
        n_valid = global_count(row_valid.sum()).clamp(min=1.0)
        loss = (w_per.sum(1) * row_valid).sum() / n_valid
    else:
        loss = mean_share(w_per.sum(1))
    if loss_r:
        # the total-persistence term (topological_loss.py:88-94), reduced
        # over the same channels as the main term
        flat = pred_g.reshape(b * c, -1)
        valid = pairing["p_birth"] >= 0
        bvals = _gather(flat, pairing["p_birth"])
        dvals = _gather(flat, pairing["p_death"])
        pers = torch.where(valid, (dvals - bvals).abs() ** float(loss_q), 0.0)
        pers_row = pers.sum(1).reshape(b, c)
        if channel_mask is not None:
            loss = loss + ((pers_row * cm).sum(1) * row_valid).sum() / n_valid
        else:
            loss = loss + mean_share(pers_row.sum(1))
    return lamda * loss


def topo_loss(pred_obj, true_obj, lamda: float, interp: int = 0,
              feat_d: int = 2, loss_q: int = 2, loss_r: bool = False,
              channel_mask=None, max_bars: int = MAX_BARS):
    """The topological regularizer (the reference's signature,
    topological_loss.py:11-12). pred_obj / true_obj: (B, C, H, W);
    channel_mask (B, C) keeps the channels the reference's ragged batch would
    hold (bucket padding). The pairing runs on the host."""
    if lamda == 0.0:
        return 0.0
    b, c = pred_obj.shape[:2]
    with torch.no_grad():
        pred, true = downsample_for_topo(pred_obj, true_obj, interp)
    h, w = pred.shape[-2], pred.shape[-1]
    row_mask = (None if channel_mask is None
                else channel_mask.reshape(-1).float().cpu().numpy())
    pairing = host_pairing(
        pred.reshape(b * c, h, w).cpu().numpy(),
        true.reshape(b * c, h, w).cpu().numpy(), feat_d=feat_d,
        q=float(loss_q), max_bars=max_bars, row_mask=row_mask)
    return topo_loss_from_pairing(pred_obj, pairing, lamda, interp=interp,
                                  loss_q=loss_q, loss_r=loss_r,
                                  channel_mask=channel_mask)
