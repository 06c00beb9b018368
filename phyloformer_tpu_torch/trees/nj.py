"""Neighbour-joining tree construction (Saitou & Nei 1987, Studier & Keppler),
used by ``pf-infer --trees``.  The production tree builder (BME + NNI/SPR)
is the native toolkit bound in :mod:`.native`."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..data.newick import Node


def neighbor_joining(dist: np.ndarray, ids: Sequence[str]) -> Node:
    """Build an unrooted NJ tree from a symmetric distance matrix.

    Returns the root :class:`Node` (trifurcating root, standard NJ shape).
    Negative branch lengths are clamped to 0.
    """
    n = len(ids)
    if dist.shape != (n, n):
        raise ValueError(f"distance matrix shape {dist.shape} != ({n},{n})")
    if n < 2:
        raise ValueError("need at least 2 taxa")
    if n == 2:
        root = Node()
        half = float(dist[0, 1]) / 2.0
        root.add_child(Node(ids[0], half))
        root.add_child(Node(ids[1], half))
        return root

    d = dist.astype(np.float64).copy()
    nodes: List[Node] = [Node(name) for name in ids]
    active = list(range(n))

    while len(active) > 2:
        m = len(active)
        sub = d[np.ix_(active, active)]
        totals = sub.sum(axis=1)
        q = (m - 2) * sub - totals[:, None] - totals[None, :]
        np.fill_diagonal(q, np.inf)
        a, b = np.unravel_index(np.argmin(q), q.shape)
        if a > b:
            a, b = b, a
        ia, ib = active[a], active[b]

        dij = sub[a, b]
        la = 0.5 * dij + (totals[a] - totals[b]) / (2.0 * (m - 2))
        lb = dij - la
        la, lb = max(la, 0.0), max(lb, 0.0)

        parent = Node()
        na, nb = nodes[ia], nodes[ib]
        na.length, nb.length = float(la), float(lb)
        parent.add_child(na)
        parent.add_child(nb)

        # distances from the new node to every other active node; it takes
        # slot ia
        du = 0.5 * (d[ia, :] + d[ib, :] - dij)
        d[ia, :] = du
        d[:, ia] = du
        d[ia, ia] = 0.0
        nodes[ia] = parent
        active.remove(active[b])

    # join the last two into a root
    ia, ib = active
    root = Node()
    na, nb = nodes[ia], nodes[ib]
    half = max(float(d[ia, ib]), 0.0)
    if na.children and not nb.children:
        na.add_child(nb)
        nb.length = half
        return na
    if nb.children and not na.children:
        nb.add_child(na)
        na.length = half
        return nb
    na.length = half / 2.0
    nb.length = half / 2.0
    root.add_child(na)
    root.add_child(nb)
    return root
