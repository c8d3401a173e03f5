"""Classic k-d tree (Bentley 1975) — the paper's actual index structure.

Kept as the CPU reference/oracle: semantics tests assert the blocked
zone-map index (index.py) returns exactly the same id sets. Median-split,
contiguous-leaf layout (points are reordered so every subtree is a slice,
which is also how a production CPU implementation would lay memory out).

A copy of ``repro.core.kdtree`` (numpy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class KDTree:
    points: np.ndarray            # [N, d'] reordered
    ids: np.ndarray               # [N] original row ids (same order)
    split_dim: np.ndarray         # [n_nodes] (-1 for leaf)
    split_val: np.ndarray         # [n_nodes]
    left: np.ndarray              # [n_nodes] child node (or -1)
    right: np.ndarray
    lo_idx: np.ndarray            # [n_nodes] slice bounds into points
    hi_idx: np.ndarray
    leaf_size: int


def build_kdtree(x: np.ndarray, leaf_size: int = 64) -> KDTree:
    x = np.asarray(x, np.float32)
    n, d = x.shape
    ids = np.arange(n)
    nodes: List[Tuple[int, float, int, int, int, int]] = []

    order = np.arange(n)

    def rec(lo: int, hi: int, depth: int) -> int:
        me = len(nodes)
        nodes.append(None)  # placeholder
        if hi - lo <= leaf_size:
            nodes[me] = (-1, 0.0, -1, -1, lo, hi)
            return me
        seg = order[lo:hi]
        # split on the widest dim (better than cycling for clustered data)
        seg_pts = x[seg]
        dim = int(np.argmax(seg_pts.max(0) - seg_pts.min(0)))
        vals = seg_pts[:, dim]
        mid = (hi - lo) // 2
        part = np.argpartition(vals, mid)
        order[lo:hi] = seg[part]
        split = float(x[order[lo + mid], dim])
        l = rec(lo, lo + mid, depth + 1)
        r = rec(lo + mid, hi, depth + 1)
        nodes[me] = (dim, split, l, r, lo, hi)
        return me

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, n, 0)
    finally:
        sys.setrecursionlimit(old)

    arr = np.array(nodes, dtype=object)
    return KDTree(
        points=x[order],
        ids=ids[order],
        split_dim=np.array([a[0] for a in nodes], np.int32),
        split_val=np.array([a[1] for a in nodes], np.float32),
        left=np.array([a[2] for a in nodes], np.int32),
        right=np.array([a[3] for a in nodes], np.int32),
        lo_idx=np.array([a[4] for a in nodes], np.int32),
        hi_idx=np.array([a[5] for a in nodes], np.int32),
        leaf_size=leaf_size,
    )


def range_query(tree: KDTree, lo: np.ndarray, hi: np.ndarray
                ) -> Tuple[np.ndarray, int]:
    """Ids of points with lo < x <= hi (all dims). Also returns the
    number of points *touched* (scanned in visited leaves) — the paper's
    efficiency metric vs. a full scan."""
    out: List[np.ndarray] = []
    touched = 0
    stack = [0]
    # track per-node valid interval implicitly by pruning on split planes
    bounds = {0: (np.full(lo.shape, -np.inf), np.full(hi.shape, np.inf))}
    while stack:
        node = stack.pop()
        nlo, nhi = bounds.pop(node)
        dim = tree.split_dim[node]
        if dim < 0:
            s, e = tree.lo_idx[node], tree.hi_idx[node]
            pts = tree.points[s:e]
            touched += e - s
            m = ((pts > lo[None]) & (pts <= hi[None])).all(1)
            if m.any():
                out.append(tree.ids[s:e][m])
            continue
        sv = tree.split_val[node]
        # left: x[dim] < sv (plus points == sv may sit either side of the
        # median partition -> conservative overlap test on both children)
        if lo[dim] <= sv:   # query interval may reach left side
            l_lo, l_hi = nlo.copy(), nhi.copy()
            l_hi[dim] = min(l_hi[dim], sv)
            bounds[tree.left[node]] = (l_lo, l_hi)
            stack.append(tree.left[node])
        if hi[dim] >= sv:
            r_lo, r_hi = nlo.copy(), nhi.copy()
            r_lo[dim] = max(r_lo[dim], sv)
            bounds[tree.right[node]] = (r_lo, r_hi)
            stack.append(tree.right[node])
    ids = (np.concatenate(out) if out else np.empty(0, np.int64))
    return np.sort(ids), touched
