"""k-nearest-neighbour baseline (the engine's 5th search model) — the
static part of ``repro.core.knn``.

The paper's kNN runs on a small feature subset so it can reuse the
pre-built per-subset index; here the analogue is the Morton-ordered rows
of a ZoneMapIndex — brute force over the subset dims through the l2dist
kernel, then top-k. A full-feature variant is also provided for accuracy
comparisons.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.index import ZoneMapIndex, to_device_f32
from repro_torch.kernels import ops as kops


def knn_subset(index, queries_full: np.ndarray, k: int = 1000
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k over the index's subset dims. queries_full: [Q, D_full].
    Returns (ids [Q, k] original row ids, dists [Q, k]).

    The rows come from the resident rows3 mirror: padding sits only at
    its tail, so its first n_rows rows are the real ones in Morton order,
    and ``perm`` maps their positions back to row ids. Segmented (live)
    and sharded indexes are ROADMAP A7/A11."""
    if not isinstance(index, ZoneMapIndex):
        raise NotImplementedError(
            "knn_subset over a segmented or sharded index is not ported to "
            "repro_torch yet (ROADMAP A7/A11)")
    rows3, _, _ = index.device_arrays()
    rows = rows3.reshape(-1, rows3.shape[-1])[: index.n_rows]
    q = to_device_f32(np.asarray(queries_full)[:, index.dims], index.device)
    k = min(k, index.n_rows)
    d, idx = kops.knn_topk(rows, q, k)
    ids = index.perm[idx.cpu().numpy()]
    return ids, d.cpu().numpy()


def knn_full(x: torch.Tensor, queries: np.ndarray, k: int = 1000
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k over all dims of x ([N, D] on the device the search runs
    on). Returns (indices [Q, k], dists [Q, k])."""
    q = to_device_f32(queries, x.device)
    d, idx = kops.knn_topk(x, q, min(k, x.shape[0]))
    return idx.cpu().numpy(), d.cpu().numpy()


def knn_vote(ids: np.ndarray, n_rows: int) -> np.ndarray:
    """Merge per-query neighbour lists into per-row vote counts."""
    votes = np.zeros(n_rows, np.int32)
    np.add.at(votes, ids.reshape(-1), 1)
    return votes
