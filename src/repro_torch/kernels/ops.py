"""Device ops of the engine's main path — counterpart of the main-path
part of ``repro.kernels.ops``.

Dispatch follows the tensors: on CUDA tensors the two kernel stages launch
the hand-written CUDA kernels (``kernels/zone_prune.py``,
``kernels/box_scan.py``) or raise; only tensors on the CPU take the plain
PyTorch versions in ``kernels/ref.py``. No TPU padding: the CUDA kernels
take d' = 6 and ragged N as they are.

Nothing here synchronises with the host. ``jnp.nonzero(size=capacity,
fill_value=0)`` becomes a prefix-sum compaction (``_compact``), and the
out-of-range ``mode="fill"``/``mode="drop"`` gathers and scatters become
clamped or sentinel-slot writes, so a whole probe is queued without one
device->host read. Integers stay int32 as under JAX's x64-off default.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import box_scan as _box_scan
from repro_torch.kernels import ref as kref
from repro_torch.kernels import zone_prune as _zone_prune

TILE_INVALID = np.int32(2 ** 31 - 1)     # padding key; sorts past all ids


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def zone_prune(zlo, zhi, blo, bhi) -> torch.Tensor:
    """Overlap mask [NZ, B] bool."""
    if _on_cpu(zlo):
        return kref.zone_prune_ref(zlo, zhi, blo, bhi)
    return _zone_prune.zone_prune(zlo, zhi, blo, bhi)


def zone_hits(zlo, zhi, blo, bhi) -> torch.Tensor:
    """[NZ] bool: zone_prune(...).any(1)."""
    if _on_cpu(zlo):
        return kref.zone_hits_ref(zlo, zhi, blo, bhi)
    return _zone_prune.zone_hits(zlo, zhi, blo, bhi)


def box_scan_seg(x, lo, hi, onehot) -> torch.Tensor:
    """Per-segment membership counts [N, Q] int32: counts[i, q] = number
    of boxes b with onehot[b, q] == 1 that contain row i."""
    if _on_cpu(x):
        return kref.box_scan_seg_ref(x, lo, hi, onehot)
    return _box_scan.box_scan_seg(x, lo, hi, onehot)


def box_scan_seg_gather(rows3, cand, n_hit, lo, hi, onehot) -> torch.Tensor:
    """box_scan_seg over rows3[cand] -> [C * block, Q] int32, zero on
    every slot >= n_hit."""
    if _on_cpu(rows3):
        return kref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot)
    return _box_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi, onehot)


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` set entries of the 1-d ``mask``,
    ascending, 0-filled past the set count — ``jnp.nonzero(mask,
    size=size, fill_value=0)`` without a host sync. Set entries past
    ``size`` and all unset entries write to a dump slot that is cut off."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < size), pos,
                       torch.full_like(pos, size))
    out = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return out[:size]


def fused_query(rows3, zlo, zhi, blo, bhi, onehot, *, capacity: int):
    """Device-resident prune -> gather -> segmented refine.

    rows3: [NB, block, d'] Morton-ordered index rows; zlo/zhi: [NB, d']
    zone maps; blo/bhi: [B, d'] boxes; onehot: [B, Q] f32 box->query
    ownership map. ``capacity`` bounds the surviving-block gather;
    survivors beyond it are dropped and callers detect overflow via n_hit.

    Returns (counts [capacity, block, Q] int32 — slot i holds block
             cand[i]'s counts, slots >= n_hit zeroed,
             cand [capacity] int32 — gathered block ids in zone order,
             0-filled past n_hit,
             n_hit [] int32 — TOTAL surviving blocks, pre-capacity)."""
    _, block, _ = rows3.shape
    hit = zone_hits(zlo, zhi, blo, bhi)                      # [NB]
    n_hit = hit.sum(dtype=torch.int32)
    cand = _compact(hit, capacity)                           # [C]
    counts = box_scan_seg_gather(rows3, cand, n_hit, blo, bhi, onehot)
    return counts.reshape(capacity, block, -1), cand, n_hit


# ----------------------------------------------------------------------
# Survivor-sparse score tiles (see repro.kernels.ops for the design)
# ----------------------------------------------------------------------

def tile_candidates(counts, cand, gids_blocks):
    """Label fused_query's gathered tiles with global row ids.

    counts: [C, block, Q]; cand: [C] gathered block ids (always in range:
    fused_query 0-fills); gids_blocks: [NB, block] int32 global row id per
    (block, slot), -1 on padding slots. Returns (gids [C, block] int32,
    ok [C, block] bool) — ok marks real rows with a nonzero count in at
    least one query."""
    gids = gids_blocks.index_select(0, cand.long())
    ok = (counts != 0).any(-1) & (gids >= 0)
    return gids, ok


def _tile_rows(counts, gids, ok, rcap: int, val_dtype):
    c, block, q = counts.shape
    okf = ok.reshape(c * block)
    idx = _compact(okf, rcap).long()
    n_rows = okf.sum(dtype=torch.int32)
    live = torch.arange(rcap, device=okf.device) < n_rows
    keys = torch.where(live, gids.reshape(-1)[idx],
                       torch.full_like(idx, int(TILE_INVALID),
                                       dtype=torch.int32))
    vals = (counts.reshape(c * block, q)[idx] * live[:, None]).to(val_dtype)
    return keys.to(torch.int32), vals, n_rows


def survivor_tiles(counts, gids, ok, *, row_capacity: int,
                   val_dtype=torch.int32):
    """Compact one subset's surviving rows into a fixed-size score tile.

    Returns (keys [row_capacity] int32 global row ids, TILE_INVALID past
    the live prefix; vals [row_capacity, Q] in ``val_dtype``, zeroed past
    the live prefix; n_rows [] int32 — true survivor count)."""
    return _tile_rows(counts, gids, ok, int(row_capacity), val_dtype)


def packed_survivor_tiles(parts, *, row_capacities, val_dtype=torch.int32):
    """Compact MANY subsets' survivors into one preallocated merged tile,
    each subset writing its slice in place. Layout equals a concatenation
    of survivor_tiles calls."""
    total = int(sum(row_capacities))
    counts0 = parts[0][0]
    q = counts0.shape[-1]
    dev = counts0.device
    out_k = torch.full((total,), int(TILE_INVALID), dtype=torch.int32,
                       device=dev)
    out_v = torch.zeros((total, q), dtype=val_dtype, device=dev)
    off = 0
    for (counts, gids, ok), rcap in zip(parts, row_capacities):
        keys, vals, _ = _tile_rows(counts, gids, ok, int(rcap), val_dtype)
        out_k[off:off + rcap] = keys
        out_v[off:off + rcap] = vals
        off += rcap
    return out_k, out_v


def sparse_topk(keys, vals, train_ids, *, k: int):
    """Rank survivor-sparse score tiles: merge duplicate keys, mask
    training rows, return the top-k.

    keys: [R] int32 global row ids (TILE_INVALID padding); vals: [R, Q]
    int32 or int16 counts (upcast before any sum); train_ids: [Q, T]
    int32 GLOBAL ids to exclude (padded with the catalog size, never a
    key); k: results per query. Order: descending score, ascending global
    id; score <= 0 invalid (id -1, score 0). The ranking sorts one int64
    composed key (-score) * 2^31 + id, so ties order by id with no
    reliance on sort stability.

    Returns (ids [Q, k] int32, scores [Q, k] int32, n_valid [Q] int32)."""
    r, nq = vals.shape
    dev = keys.device
    inval = int(TILE_INVALID)
    sk, order = torch.sort(keys, stable=True)                # ascending
    sv = vals.index_select(0, order).to(torch.int32)
    first = torch.ones(r, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1                         # [R] int64
    # unique keys stay ascending; the tail keeps TILE_INVALID
    uk = torch.full((r,), inval, dtype=torch.int32, device=dev)
    uk.scatter_(0, seg, sk)
    uv = torch.zeros((r, nq), dtype=torch.int32, device=dev)
    uv.index_add_(0, seg, sv)
    # training mask: locate each train id among the unique keys; misses
    # (and positions past the end) go to a dump column that is cut off
    tr = train_ids.to(torch.int32)
    pos = torch.searchsorted(uk, tr)                         # [Q, T]
    uk_ext = torch.cat([uk, torch.full((1,), inval, dtype=torch.int32,
                                       device=dev)])
    hit = uk_ext[pos] == tr
    posx = torch.where(hit, pos, torch.full_like(pos, r))
    sc = torch.cat([uv.T, torch.zeros((nq, 1), dtype=torch.int32,
                                      device=dev)], 1)       # [Q, R + 1]
    sc.scatter_(1, posx, torch.zeros_like(posx, dtype=torch.int32))
    sc = sc[:, :r]
    key_id = torch.where(sc > 0, uk[None, :],
                         torch.full_like(sc, inval))
    composed = (-sc.to(torch.int64)) * (1 << 31) + key_id.to(torch.int64)
    kk = min(int(k), r)
    top, _ = torch.topk(composed, kk, dim=-1, largest=False, sorted=True)
    out_scores = (-(top >> 31)).to(torch.int32)
    out_ids = torch.where(out_scores > 0, (top & inval).to(torch.int32),
                          torch.full_like(out_scores, -1))
    if kk < k:                                   # static pad to [Q, k]
        out_ids = torch.cat([out_ids, torch.full((nq, k - kk), -1,
                                                 dtype=torch.int32,
                                                 device=dev)], 1)
        out_scores = torch.cat([out_scores, torch.zeros(
            (nq, k - kk), dtype=torch.int32, device=dev)], 1)
    return (out_ids, out_scores,
            (out_scores > 0).sum(1, dtype=torch.int32))
