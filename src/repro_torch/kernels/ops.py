"""Device ops of the engine's main path — counterpart of the main-path
part of ``repro.kernels.ops``.

Dispatch follows the tensors: on CUDA tensors the kernel stages launch
the hand-written CUDA kernels (``kernels/zone_prune.py``,
``kernels/box_scan.py``, ``kernels/l2dist.py``,
``kernels/flash_attention.py``) or raise; only tensors on
the CPU take the plain PyTorch versions in ``kernels/ref.py``. No TPU
padding to 128 lanes or 1024-row tiles: the CUDA kernels take ragged N
and D as they are.

Nothing here synchronises with the host. ``jnp.nonzero(size=capacity,
fill_value=0)`` becomes a prefix-sum compaction (``_compact``; fused into
the zone prune's one launch as ``zone_candidates`` in the probe), and the
out-of-range ``mode="fill"``/``mode="drop"`` gathers and scatters become
clamped or sentinel-slot writes, so a whole probe is queued without one
device->host read. Integers stay int32 as under JAX's x64-off default.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import box_scan as _box_scan
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import l2dist as _l2dist
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


def zone_candidates(zlo, zhi, blo, bhi, capacity: int):
    """(cand [capacity] int32, n_hit [] int32): the first ``capacity``
    zones that overlap any box, ascending, 0-filled past n_hit, and their
    count before the cut (one launch on the card)."""
    if _on_cpu(zlo):
        return kref.zone_candidates_ref(zlo, zhi, blo, bhi, capacity)
    return _zone_prune.zone_candidates(zlo, zhi, blo, bhi, capacity)


def box_scan(x, lo, hi) -> torch.Tensor:
    """Membership counts [N] int32 for rows x against boxes (lo, hi]."""
    if _on_cpu(x):
        return kref.box_scan_ref(x, lo, hi)
    return _box_scan.box_scan(x, lo, hi)


def l2dist(x, q) -> torch.Tensor:
    """Squared L2 distance matrix [N, Q] f32."""
    if _on_cpu(x):
        return kref.l2dist_ref(x, q)
    return _l2dist.l2dist(x, q)


def kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Model layout q [B, S, Hq, D], k/v [B, S, Hkv, D] -> the kernel's
    contiguous q [B*Hkv, S, G, D], k/v [B*Hkv, S, D] (G = Hq / Hkv; query
    head h belongs to kv head h // G)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads do not group "
                         f"over {hkv} kv heads")
    g = hq // hkv
    qk = q.reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4)
    qk = qk.reshape(b * hkv, s, g, d).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(b * hkv, s, d).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(b * hkv, s, d).contiguous()
    return qk, kk, vk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """GQA attention in model layout: q [B, S, Hq, D]; k/v [B, S, Hkv, D]
    -> [B, S, Hq, D]. Repacks to the kernel's layout and back, as the
    reference wrapper does; the kernel takes any S (no chunk sizes, no
    padding)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qk, kk, vk = kernel_layout(q, k, v)
    if _on_cpu(qk):
        out = kref.flash_attention_ref(qk, kk, vk, causal=causal)
    else:
        out = _flash.flash_attention(qk, kk, vk, causal=causal)
    out = out.reshape(b, hkv, s, hq // hkv, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, d)


def knn_topk(x, q, k: int):
    """(distances [Q, k] f32, indices [Q, k] int32): the k nearest rows of
    x per query, in the order ``lax.top_k(-d.T, k)`` gives — the total
    order of the f32 bits of the distance, ascending (-NaN < -inf < ... <
    +inf < +NaN), the lower row position first on ties. The bits b map to
    the signed int32 b ^ ((b >> 31) & 0x7FFFFFFF), which orders as that
    total order does, and one int64 key per (query, row), that int32
    times 2^32 plus the position, makes every key distinct, so the
    selection needs no tie rule of its own. A distance that is the
    negative NaN of an ``inf - inf`` (kernels/ref.l2dist_ref) ranks first,
    as in the reference. The distances come back with d's bits unchanged
    (the map is its own inverse)."""
    d = l2dist(x, q)                                         # [N, Q]
    n = d.shape[0]
    bits = d.T.view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(n, dtype=torch.int64, device=d.device)
    top, _ = torch.topk(key.to(torch.int64) * (1 << 32) + pos[None],
                        int(k), dim=1, largest=False, sorted=True)
    kb = (top >> 32).to(torch.int32)
    dist = (kb ^ ((kb >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return dist, (top & 0xFFFFFFFF).to(torch.int32)


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


# the prefix-sum compaction (jnp.nonzero(size=, fill_value=0)); the tile
# stages use it, the probe's zone_candidates has it fused
_compact = kref.compact_ref


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
    cand, n_hit = zone_candidates(zlo, zhi, blo, bhi, capacity)
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
