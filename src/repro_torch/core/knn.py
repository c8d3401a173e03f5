"""k-nearest-neighbour baseline (the engine's 5th search model) — the
single-device part of ``repro.core.knn`` (static and live indexes).

The paper's kNN runs on a small feature subset so it can reuse the
pre-built per-subset index; here the analogue is the Morton-ordered rows
of a ZoneMapIndex — brute force over the subset dims through the l2dist
kernel, then top-k. A full-feature variant is also provided for accuracy
comparisons.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import ZoneMapIndex, to_device_f32
from repro_torch.core.segments import SegmentedZoneMapIndex
from repro_torch.device import to_device_async
from repro_torch.kernels import ops as kops


def knn_subset(index, queries_full: np.ndarray, k: int = 1000,
               live: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k over the index's subset dims. queries_full: [Q, D_full].
    Returns (ids [Q, k] original row ids, dists [Q, k]).

    The rows come from the resident rows3 mirror: padding sits only at
    its tail, so its first n_rows rows are the real ones in Morton order,
    and ``perm`` maps their positions back to row ids.

    A SegmentedZoneMapIndex (live catalog) searches each segment's LIVE
    rows only (``live``: the snapshot's [n] bool validity mask) and merges
    the per-segment lists by (distance, global id), so the result is that
    of a search over the concatenated surviving rows. Sharded indexes are
    ROADMAP A11."""
    if isinstance(index, SegmentedZoneMapIndex):
        return _knn_segmented(index, queries_full, k, live)
    if not isinstance(index, ZoneMapIndex):
        raise NotImplementedError(
            "knn_subset over a sharded index is not ported to repro_torch "
            "yet (ROADMAP A11)")
    rows3, _, _ = index.device_arrays()
    rows = rows3.reshape(-1, rows3.shape[-1])[: index.n_rows]
    q = to_device_f32(np.asarray(queries_full)[:, index.dims], index.device)
    k = min(k, index.n_rows)
    d, idx = kops.knn_topk(rows, q, k)
    ids = index.perm[idx.cpu().numpy()]
    return ids, d.cpu().numpy()


def _knn_segmented(index, queries_full, k: int, live):
    """Per segment: l2dist + top-k over its live rows, read from the
    segment's rows3 mirror by positions picked on the host (from ``live``
    and ``perm``: no device-side mask, so no sync), then one host merge."""
    q = to_device_f32(np.asarray(queries_full, np.float32)[:, index.dims],
                      index.device)
    per_ids, per_d, n_live = [], [], 0
    for seg, off in zip(index.segs, index.offsets[:-1]):
        loc = seg.perm[:seg.n_rows]             # Morton position -> local id
        rows3, _, _ = seg.device_arrays()
        rows = rows3.reshape(-1, rows3.shape[-1])[:seg.n_rows]
        if live is not None:
            keep = live[loc + int(off)]
            if not keep.all():
                pos = np.nonzero(keep)[0]
                loc = loc[pos]
                rows = rows.index_select(0, to_device_async(pos,
                                                            rows.device))
        if len(loc) == 0:
            continue
        n_live += len(loc)
        d, idx = kops.knn_topk(rows, q, min(k, len(loc)))
        per_ids.append(loc[idx.cpu().numpy()] + int(off))
        per_d.append(d.cpu().numpy())
    if not per_ids:
        nq = q.shape[0]
        return np.empty((nq, 0), np.int64), np.empty((nq, 0))
    all_ids = np.concatenate(per_ids, axis=1)
    all_d = np.concatenate(per_d, axis=1)
    order = np.lexsort((all_ids, all_d), axis=1)[:, :min(k, n_live)]
    return (np.take_along_axis(all_ids, order, 1),
            np.take_along_axis(all_d, order, 1))


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
