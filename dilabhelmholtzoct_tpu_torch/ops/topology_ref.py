"""Cubical persistent homology of 2D images — reference implementation.

A copy of ``dilabhelmholtzoct_tpu/ops/topology_ref.py`` (numpy + scipy). In
the port it is the plain twin of both topology kernels
(``ops/topology_device.py``): a union-find has no tensor formulation worth
writing, so the plain version of ``csrc/topology.cu`` is this module. Only
what the twins run is copied: ``_sublevel_h0`` and ``wasserstein_match``.

Computes the H0/H1 persistence pairing of the sublevel-set filtration of a
2D grayscale image under the T-construction (pixels are TOP cells: lower-
dimensional cells take the min of their cofaces), the construction gudhi
uses for ``CubicalComplex(top_dimensional_cells=...)`` and hence what the
reference's ``torch_topological.nn.CubicalComplex`` computes
(octsam/models/topological_loss.py:55-63). Under the T-construction two
squares sharing only a vertex are connected through that vertex (its value
is the min of its cofaces), so the sublevel set is **8-connected** and its
Alexander-dual complement is **4-connected**.

Algorithms (union-find, standard for images):

  * **H0**: process pixels in increasing value; union 8-neighbors; when two
    components merge, the younger (larger birth) dies → bar
    (birth_pixel, merge_pixel). One essential component (global min).
  * **H1** by Alexander duality: a sublevel hole is a bounded component of
    the superlevel complement. Run the same union-find on the NEGATED image
    with 4-connectivity plus a virtual "outside" node (elder than
    everything, connected to all border pixels). Each finite superlevel bar
    (born at enclosed-region max q, merged at saddle p) is the H1 bar
    (value(p), value(q)) with gradient locations (p, q). The essential
    class is the outside — no H1 bar. 2D sublevel complexes have no
    essential H1 (the full rectangle is contractible).

Returns *index pairs*: the pairing is piecewise-constant in the input, so
gradients flow purely through gathered pixel values (exactly how
``torch_topological`` backpropagates). Zero-persistence pairs are dropped
(they contribute nothing to any Wasserstein distance).

This is the correctness reference; the production paths are the host
library (``csrc/persistence_host.cc``) and the card's kernels
(``csrc/topology.cu``), both on ``csrc/persistence_core.h`` (same
algorithm, same outputs), validated against this module in
tests/test_torch_topology.py.
"""

from __future__ import annotations

import numpy as np

# imported at module level on purpose: importing scipy.optimize lazily
# inside the first wasserstein_match call costs ~2 s on a single-core
# host (measured with cProfile) and would land inside the first
# topological train step; this module is itself only imported on the
# topological path, so plain imports stay fast
from scipy.optimize import linear_sum_assignment


def _sublevel_h0(
    values: np.ndarray, *, eight_connect: bool, outside_node: bool
):
    """Union-find sublevel H0 pairing.

    Returns (bars, essential_birth_idx) where bars is a list of
    (birth_idx, death_idx) flat pixel indices; the essential component's
    birth index is returned separately (or None if the essential is the
    virtual outside node).
    """
    h, w = values.shape
    n = h * w
    flat = values.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)

    OUTSIDE = n
    parent = np.full(n + 1, -1, np.int64)  # -1 = not yet activated
    birth = np.full(n + 1, -1, np.int64)  # root → birth pixel (-1: outside)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    if outside_node:
        parent[OUTSIDE] = OUTSIDE

    if eight_connect:
        neigh = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
                 (0, 1), (1, -1), (1, 0), (1, 1)]
    else:
        neigh = [(-1, 0), (1, 0), (0, -1), (0, 1)]

    bars = []
    for p in order:
        parent[p] = p
        birth[p] = p
        y, x = divmod(int(p), w)
        if outside_node and (y == 0 or x == 0 or y == h - 1 or x == w - 1):
            # border pixel: its complement region touches the outer face
            rp = find(p)
            ro = find(OUTSIDE)
            if rp != ro:
                if birth[rp] != -1 and flat[birth[rp]] != flat[p]:
                    bars.append((int(birth[rp]), int(p)))
                parent[rp] = ro
        for dy, dx in neigh:
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w):
                continue
            q = ny * w + nx
            if parent[q] == -1:
                continue  # not yet in the filtration
            r1, r2 = find(p), find(q)
            if r1 == r2:
                continue
            if r1 == OUTSIDE or r2 == OUTSIDE:
                elder, younger = (r1, r2) if r1 == OUTSIDE else (r2, r1)
            elif rank[birth[r1]] < rank[birth[r2]]:
                elder, younger = r1, r2
            else:
                elder, younger = r2, r1
            # younger component dies at p (drop zero-persistence bars)
            if birth[younger] != -1 and flat[birth[younger]] != flat[p]:
                bars.append((int(birth[younger]), int(p)))
            parent[younger] = elder

    # essential component
    essential = None
    if not outside_node:
        essential = int(birth[find(int(order[0]))])
    return bars, essential


def wasserstein_match(d1: np.ndarray, d2: np.ndarray, q: float = 2.0):
    """Optimal partial matching between two persistence diagrams.

    Ground metric L∞; unmatched points pay the distance to their diagonal
    projection ((d-b)/2). Exact, via a REDUCED rectangular assignment:
    every bar of the larger diagram pays its diagonal cost by default, and
    matching it to a bar of the smaller diagram swaps that for the pair
    cost — so only ``min(n1,n2)`` rows need assigning, against
    ``max(n1,n2) + min(n1,n2)`` columns (bars ∪ own-diagonal slots). This
    makes noisy-image diagrams (hundreds of bars, tests measured ~460 H1
    bars on 50² sigmoid noise) vs tiny ground-truth diagrams cost
    O(min² · max) instead of O((n1+n2)³). Verified equivalent to the dense
    Hungarian oracle in the JAX package's tests.

    Returns (matches, unmatched1, unmatched2): matches is (m, 2) index
    pairs into d1/d2; unmatched* are index arrays paired to the diagonal.
    """

    n1, n2 = len(d1), len(d2)
    if n1 == 0 and n2 == 0:
        return (np.zeros((0, 2), np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))

    swapped = n1 < n2
    small, big = (d1, d2) if swapped else (d2, d1)
    ns, nb = len(small), len(big)

    if ns == 0:
        m = np.zeros((0, 2), np.int64)
        un_small = np.zeros(0, np.int64)
        un_big = np.arange(nb, dtype=np.int64)
    else:
        diag_b = (np.abs(big[:, 1] - big[:, 0]) / 2.0) ** q  # (nb,)
        diag_s = (np.abs(small[:, 1] - small[:, 0]) / 2.0) ** q
        pair = np.maximum(
            np.abs(small[:, None, 0] - big[None, :, 0]),
            np.abs(small[:, None, 1] - big[None, :, 1]),
        ) ** q  # (ns, nb)
        # net benefit of matching small j to big i vs both to diagonal
        net = pair - diag_b[None, :]
        cost = np.concatenate(
            [net, np.full((ns, ns), np.inf)], axis=1
        )
        cost[np.arange(ns), nb + np.arange(ns)] = diag_s
        rows, cols = linear_sum_assignment(cost)
        matched_small = []
        matched_big = []
        for r, c in zip(rows, cols):
            if c < nb:
                matched_small.append(r)
                matched_big.append(c)
        matched_small = np.asarray(matched_small, np.int64)
        matched_big = np.asarray(matched_big, np.int64)
        un_small = np.setdiff1d(np.arange(ns, dtype=np.int64), matched_small)
        un_big = np.setdiff1d(np.arange(nb, dtype=np.int64), matched_big)
        m = np.stack([matched_small, matched_big], axis=1)

    if swapped:  # small == d1, big == d2
        matches = m
        un1, un2 = un_small, un_big
    else:        # small == d2, big == d1
        matches = m[:, ::-1] if len(m) else np.zeros((0, 2), np.int64)
        un1, un2 = un_big, un_small
    return (np.asarray(matches, np.int64).reshape(-1, 2),
            np.asarray(un1, np.int64), np.asarray(un2, np.int64))
