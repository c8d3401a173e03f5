"""k-nearest-neighbour baseline (the engine's 5th search model) — the
port of ``repro.core.knn`` (static, sharded and live indexes).

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

from repro_torch.core.index import (ShardedZoneMapIndex, resolve_mesh,
                                    to_device_f32)
from repro_torch.core.segments import SegmentedZoneMapIndex
from repro_torch.device import to_device_async
from repro_torch.kernels import ops as kops


def knn_subset(index, queries_full: np.ndarray, k: int = 1000,
               live: Optional[np.ndarray] = None, mesh=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k over the index's subset dims. queries_full: [Q, D_full].
    Returns (ids [Q, k] original row ids, dists [Q, k]).

    The rows are the index's real rows in Morton order
    (``ZoneMapIndex.device_rows``: the resident rows3 mirror, or the host
    rows for this call on an index that serves from its quantized mirror
    alone), and ``perm`` maps their positions back to row ids.

    A SegmentedZoneMapIndex (live catalog) searches each segment's LIVE
    rows only (``live``: the snapshot's [n] bool validity mask) and merges
    the per-segment lists by (distance, global id), so the result is that
    of a search over the concatenated surviving rows.

    A ShardedZoneMapIndex runs the same local top-k -> merge: per shard
    l2dist + top-k over its rows in the stacked mirror (on the shard's
    device of ``mesh``, the engine's shard_mesh), local ids offset to
    global, then a (distance, global id) merge, so duplicate distances
    come out the same for every shard count."""
    if isinstance(index, SegmentedZoneMapIndex):
        return _knn_segmented(index, queries_full, k, live)
    if isinstance(index, ShardedZoneMapIndex):
        return _knn_sharded(index, queries_full, k, mesh)
    rows = index.device_rows()
    q = to_device_f32(np.asarray(queries_full)[:, index.dims], index.device)
    k = min(k, index.n_rows)
    d, idx = kops.knn_topk(rows, q, k)
    ids = index.perm[idx.cpu().numpy()]
    return ids, d.cpu().numpy()


def _merge(per_ids, per_d, k: int):
    """Merge per-part [Q, k_i] lists by (distance, global id)."""
    all_ids = np.concatenate(per_ids, axis=1)
    all_d = np.concatenate(per_d, axis=1)
    order = np.lexsort((all_ids, all_d), axis=1)[:, :k]
    return (np.take_along_axis(all_ids, order, 1),
            np.take_along_axis(all_d, order, 1))


def _knn_sharded(index, queries_full, k: int, mesh):
    """Per shard: l2dist + top-k over its real rows, read from the
    shard's slice of the stacked rows mirror; then one host merge."""
    q = np.asarray(queries_full, np.float32)[:, index.dims]
    rows4, _, _ = index.device_arrays(resolve_mesh(mesh))
    k = min(k, index.n_rows)
    per_ids, per_d = [], []
    for i, (sh, off) in enumerate(zip(index.shards, index.offsets[:-1])):
        if sh.n_rows == 0:
            continue
        rows = rows4[i].reshape(-1, rows4[i].shape[-1])[:sh.n_rows]
        d, idx = kops.knn_topk(rows, to_device_f32(q, rows.device),
                               min(k, sh.n_rows))
        per_ids.append(sh.perm[idx.cpu().numpy()] + int(off))
        per_d.append(d.cpu().numpy())
    return _merge(per_ids, per_d, k)


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
    return _merge(per_ids, per_d, min(k, n_live))


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
