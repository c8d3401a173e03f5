"""Blocked zone-map index — the static part of ``repro.core.index``.

Per feature subset: rows are ordered by a Morton (bit-interleaved) code
over the quantised subset dims, partitioned into fixed blocks, and each
block keeps per-dim [min, max] *zone maps*. A range query runs two dense
stages, both CUDA kernels on the card:

  prune : zone_prune(zones, boxes) -> surviving-block mask   (tiny)
  refine: box_scan_seg / box_scan(rows of surviving blocks, boxes) -> counts

``sparse_probe`` is the engine's fused device path and
``query_index_fused`` / ``query_index_fused_multi`` the per-index fused
query (DESIGN.md §6); ``query_index`` the host oracle (use_fused=False),
and ``full_scan`` the scan of the tree models.

The build is the reference's numpy code, so ``perm``, ``rows``, ``zlo``
and ``zhi`` are byte-equal to it; the device mirrors are torch tensors
uploaded once to the index's device.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boxes import BoxSet
from repro_torch.core.capacity import pow2above, quantum_bucket
from repro_torch.device import resolve_device, to_device_async
from repro_torch.kernels import ops as kops


# ----------------------------------------------------------------------
# Morton codes
# ----------------------------------------------------------------------

def _part_bits(v: np.ndarray, ndims: int, nbits: int) -> np.ndarray:
    """Spread the low ``nbits`` of v so consecutive bits are ndims apart."""
    out = np.zeros_like(v, dtype=np.uint64)
    for b in range(nbits):
        out |= ((v >> b) & 1).astype(np.uint64) << (b * ndims)
    return out


def morton_code(x: np.ndarray, nbits: int = 8) -> np.ndarray:
    """x: [N, d'] floats -> [N] uint64 Morton codes of per-dim quantiles.

    Quantile (rank) quantisation equalises bucket occupancy, which keeps
    zone maps tight even for skewed feature marginals."""
    n, d = x.shape
    nbits = min(nbits, 64 // max(d, 1))
    code = np.zeros(n, np.uint64)
    levels = 1 << nbits
    ranks = np.empty(n, np.int64)
    for j in range(d):
        # rank = inverse of the sort permutation; one argsort + scatter
        order = np.argsort(x[:, j], kind="stable")
        ranks[order] = np.arange(n, dtype=np.int64)
        q = (ranks * levels // max(n, 1)).astype(np.uint64)
        code |= _part_bits(q, d, nbits) << j
    return code


# ----------------------------------------------------------------------
# index
# ----------------------------------------------------------------------

@dataclass
class ZoneMapIndex:
    dims: np.ndarray              # [d'] feature ids this index covers
    perm: np.ndarray              # [Np] row permutation (Morton order, padded)
    rows: np.ndarray              # [Np, d'] permuted subset features (padded)
    zlo: np.ndarray               # [NB, d'] per-block min
    zhi: np.ndarray               # [NB, d'] per-block max
    block: int
    n_rows: int                   # real (unpadded) rows
    subset_id: int = -1
    device: torch.device = field(kw_only=True)   # where the mirrors go
    # lazily-populated device mirror: (rows3 [NB, block, d'], zlo, zhi)
    _dev: Optional[Tuple[torch.Tensor, ...]] = field(
        default=None, repr=False, compare=False)
    # lazily-populated inverse-permutation mirror [n_rows] int32
    _dev_inv_perm: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)
    # lazily-populated global-row-id mirror [NB, block] int32 (-1 padding)
    _dev_gids: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)
    # lazily-populated host inverse permutation [n_rows] int32
    _inv_host: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False)
    # lazily-populated quantized mirror (mirror="quantized"):
    # (qrows3 int8, c0 f32, scale f32, zlo16 f16, zhi16 f16)
    _dev_quant: Optional[Tuple[torch.Tensor, ...]] = field(
        default=None, repr=False, compare=False)

    @property
    def n_blocks(self) -> int:
        return int(self.zlo.shape[0])

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(rows3 [NB, block, d'], zlo [NB, d'], zhi [NB, d']) on the
        index's device, uploaded ONCE and cached — no index bytes cross
        host<->device on the online path (only the tiny boxes do). The
        uploads are pinned and non-blocking: no host sync."""
        if self._dev is None:
            rows3, zlo, zhi = (
                to_device_async(np.asarray(a, np.float32), self.device)
                for a in (self.rows, self.zlo, self.zhi))
            self._dev = (rows3.reshape(self.n_blocks, self.block, -1),
                         zlo, zhi)
        return self._dev

    def device_rows(self) -> torch.Tensor:
        """[n_rows, d'] f32 real rows in Morton order on the index's
        device: a view of the rows3 mirror where it is resident (padding
        sits only at its tail), else the host rows uploaded for this call
        only, as the reference's knn does — so a knn query makes no f32
        mirror resident (a quantized engine never holds one)."""
        if self._dev is None:
            return to_device_f32(self.rows[: self.n_rows], self.device)
        rows3, _, _ = self.device_arrays()
        return rows3.reshape(-1, rows3.shape[-1])[: self.n_rows]

    def device_inv_perm(self) -> torch.Tensor:
        """[n_rows] int32 inverse permutation (ORIGINAL row id -> Morton
        position), uploaded once and cached: the dense accumulation
        (kernels/ops.accumulate_scores) gathers through it. Padded Morton
        slots never appear (only the n_rows real rows do)."""
        if self._dev_inv_perm is None:
            self._dev_inv_perm = to_device_async(self.inv_perm(),
                                                 self.device)
        return self._dev_inv_perm

    def inv_perm(self) -> np.ndarray:
        """[n_rows] int32 inverse permutation on the host (ORIGINAL row id
        -> Morton position), cached: ``rows[inv_perm()[i]]`` is row i's
        subset features."""
        if self._inv_host is None:
            valid = self.perm >= 0
            inv = np.empty(self.n_rows, np.int32)
            inv[self.perm[valid]] = np.nonzero(valid)[0].astype(np.int32)
            self._inv_host = inv
        return self._inv_host

    def device_gids(self) -> torch.Tensor:
        """[NB, block] int32 GLOBAL row id per (block, slot) — the
        permutation reshaped to the block grid, -1 on padding slots;
        uploaded once and cached like the other mirrors."""
        if self._dev_gids is None:
            g = np.ascontiguousarray(self.perm.astype(np.int32).reshape(
                self.n_blocks, self.block))
            self._dev_gids = to_device_async(g, self.device)
        return self._dev_gids

    def device_quantized(self) -> Tuple[torch.Tensor, ...]:
        """Compressed device mirror of the quantized serving path:
        (qrows3 [NB, block, d'] int8, c0 [d'] f32, scale [d'] f32,
         zlo16 [NB, d'] f16, zhi16 [NB, d'] f16).

        Built on the host op for op as the reference builds it: per-dim
        affine codes t = round((x - c0) / scale) in [0, 254] (numpy's
        half-to-even round), stored as int8 t - 127, padding rows at code
        254; the zone maps cast to f16 and widened outward by one f16 ulp
        wherever the nearest cast rounded inward. Both halves keep the
        quantized prune conservative: it may keep false candidates, never
        drop a true survivor, and the exact f32 re-check restores the
        counts. Uploaded once (pinned, non-blocking) and cached: one byte
        a row value and two a zone value, against four."""
        if self._dev_quant is None:
            real = self.perm >= 0
            rows = self.rows
            rr = rows[real]
            if rr.size:
                c0 = rr.min(0).astype(np.float32)
                s = np.maximum((rr.max(0) - c0) / 254.0,
                               1e-12).astype(np.float32)
            else:
                c0 = np.zeros(rows.shape[1], np.float32)
                s = np.full(rows.shape[1], 1e-12, np.float32)
            t = np.full(rows.shape, 254.0, np.float32)   # padding: inert
            t[real] = np.clip(np.round((rr - c0) / s), 0.0, 254.0)
            q = (t - 127.0).astype(np.int8).reshape(
                self.n_blocks, self.block, -1)
            zlo16 = self.zlo.astype(np.float16)
            zhi16 = self.zhi.astype(np.float16)
            zlo16 = np.where(zlo16.astype(np.float32) > self.zlo,
                             np.nextafter(zlo16, np.float16(-np.inf)),
                             zlo16)
            zhi16 = np.where(zhi16.astype(np.float32) < self.zhi,
                             np.nextafter(zhi16, np.float16(np.inf)),
                             zhi16)
            self._dev_quant = tuple(to_device_async(a, self.device)
                                    for a in (q, c0, s, zlo16, zhi16))
        return self._dev_quant

    def device_bytes(self) -> dict:
        """Actual RESIDENT device-mirror bytes by kind (0 for mirrors not
        yet uploaded)."""
        out = {"rows": 0, "zones": 0, "gids": 0, "inv_perm": 0,
               "quantized": 0}
        if self._dev is not None:
            rows3, zlo, zhi = self._dev
            out["rows"] = int(rows3.nbytes)
            out["zones"] = int(zlo.nbytes) + int(zhi.nbytes)
        if self._dev_gids is not None:
            out["gids"] = int(self._dev_gids.nbytes)
        if self._dev_inv_perm is not None:
            out["inv_perm"] = int(self._dev_inv_perm.nbytes)
        if self._dev_quant is not None:
            out["quantized"] = int(sum(a.nbytes for a in self._dev_quant))
        return out

    def stats(self) -> dict:
        return {"blocks": self.n_blocks, "block_rows": self.block,
                "rows": self.n_rows, "dims": self.dims.tolist(),
                "bytes": int(self.rows.nbytes)}


def build_index(x: np.ndarray, dims: np.ndarray, block: int = 1024,
                subset_id: int = -1, device=None) -> ZoneMapIndex:
    """x: [N, D] full features; dims: subset feature ids; ``device``
    (default CUDA) is where the mirrors go."""
    device = resolve_device(device)
    sub = np.ascontiguousarray(np.asarray(x, np.float32)[:, dims])
    n = sub.shape[0]
    code = morton_code(sub)
    perm = np.argsort(code, kind="stable")
    rows = sub[perm]
    pad = (-n) % block
    if pad:
        rows = np.concatenate(
            [rows, np.full((pad, rows.shape[1]), np.inf, np.float32)])
        perm = np.concatenate([perm, np.full(pad, -1, perm.dtype)])
    nb = rows.shape[0] // block
    blocks = rows.reshape(nb, block, sub.shape[1])
    # zone maps over REAL rows only: padded +inf rows would otherwise leak
    # into the tail block's zhi, making it overlap every box
    real = (np.arange(rows.shape[0]) < n).reshape(nb, block, 1)
    zlo = np.where(real, blocks, np.inf).min(1)
    zhi = np.where(real, blocks, -np.inf).max(1)
    return ZoneMapIndex(np.asarray(dims), perm, rows, zlo, zhi, block, n,
                        subset_id, device=device)


def build_indexes(x: np.ndarray, subsets, block: int = 1024,
                  device=None) -> list:
    """build_index for every subset (subset_id = its row), the subsets
    built at once on a thread pool: numpy's sorts, gathers and bit ops
    release the interpreter lock, and each index is the same as when
    built alone."""
    device = resolve_device(device)
    subsets = list(subsets)
    workers = max(1, min(len(subsets), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(
            lambda kd: build_index(x, kd[1], block=block, subset_id=kd[0],
                                   device=device), enumerate(subsets)))


def shard_offsets(n: int, n_shards: int) -> np.ndarray:
    """[S + 1] global row offsets of an even ceil-split partition: every
    shard owns ceil(n / S) rows except a RAGGED tail (tiny catalogs may
    leave trailing shards empty; the stacked device mirrors make empty
    shards inert rather than illegal)."""
    per = -(-max(int(n), 1) // n_shards)
    return np.minimum(np.arange(n_shards + 1, dtype=np.int64) * per, n)


def to_device_f32(a, device: torch.device) -> torch.Tensor:
    """A contiguous f32 tensor of ``a`` (numpy array or tensor) on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def query_index(index: ZoneMapIndex, boxes: BoxSet) -> Tuple[np.ndarray,
                                                              dict]:
    """The host range-query oracle. Returns (counts [n_rows] int32 in
    ORIGINAL row order, stats).

    The [NB, B] zone_prune mask is brought to the host (a sync by
    design: this is the oracle), the hit blocks are gathered from the
    resident rows3 mirror, box_scan runs over them on the device, and
    the counts are scattered back on the host exactly as the reference
    does. stats reports blocks_touched / rows_touched / bytes_touched —
    the quantities the paper's speedup comes from."""
    assert np.array_equal(index.dims, boxes.dims), "box subset != index subset"
    rows3, zlo, zhi = index.device_arrays()
    blo = to_device_f32(boxes.lo, index.device)
    bhi = to_device_f32(boxes.hi, index.device)
    mask = kops.zone_prune(zlo, zhi, blo, bhi).cpu().numpy()      # [NB, B]
    hit_ids = np.nonzero(mask.any(1))[0]
    n_hit = len(hit_ids)
    counts = np.zeros((index.n_blocks, index.block), np.int32)
    if n_hit:
        sel = torch.from_numpy(hit_ids).to(index.device)
        rows = rows3.index_select(0, sel).reshape(-1, rows3.shape[-1])
        c = kops.box_scan(rows, blo, bhi).cpu().numpy()
        counts[hit_ids] = c.reshape(n_hit, index.block)
    counts = counts.reshape(-1)
    # back to original order
    out = np.zeros(index.n_rows, np.int32)
    valid = index.perm >= 0
    out[index.perm[valid]] = counts[valid]
    stats = {
        "blocks_touched": int(n_hit),
        "blocks_total": index.n_blocks,
        "rows_touched": int(n_hit * index.block),
        "bytes_touched": int(n_hit * index.block * index.rows.shape[1] * 4),
        "bytes_total": int(index.rows.nbytes),
        "prune_fraction": 1.0 - n_hit / max(index.n_blocks, 1),
    }
    return out, stats


def full_scan(x: torch.Tensor, lo, hi) -> np.ndarray:
    """Scan over the FULL feature matrix (what DT/RF must do): x is the
    [N, D] features as a tensor on the device the scan runs on; lo/hi
    [B, D] full-width boxes. Returns [N] int32 counts on the host."""
    return kops.box_scan(x, to_device_f32(lo, x.device),
                         to_device_f32(hi, x.device)).cpu().numpy()


# ----------------------------------------------------------------------
# fused device-resident query path
# ----------------------------------------------------------------------

_BOX_BUCKET = 8   # boxes padded to a multiple of this (the reference's jit
                  # bucket; kept so shapes, and so stats, stay equal)


def pad_boxes(lo, hi, owner: Optional[np.ndarray]):
    """Pad the box count to a _BOX_BUCKET multiple with impossible boxes
    (lo=+inf > hi=-inf): they survive no zone and contain no row, so
    results are unchanged. Device-resident boxes (torch tensors) are
    padded on their device; the owner map is always host-side."""
    b = lo.shape[0]
    pad = quantum_bucket(b, _BOX_BUCKET) - b
    if pad == 0:
        return lo, hi, owner
    d = lo.shape[1]
    if isinstance(lo, torch.Tensor):
        # made on the boxes' device: an upload would be a blocking copy
        lo = torch.cat([lo, lo.new_full((pad, d), float("inf"))])
        hi = torch.cat([hi, hi.new_full((pad, d), float("-inf"))])
    else:
        lo = np.concatenate([lo, np.full((pad, d), np.inf, np.float32)])
        hi = np.concatenate([hi, np.full((pad, d), -np.inf, np.float32)])
    if owner is not None:
        owner = np.concatenate([owner, np.zeros(pad, owner.dtype)])
    return lo, hi, owner


def fused_stats(index: ZoneMapIndex, n_hit: int, capacity: int,
                n_boxes: int) -> dict:
    """blocks_touched counts surviving blocks actually refined; the
    bytes/rows figures price the CAPACITY-sized gather the device really
    performs."""
    touched = min(n_hit, capacity)
    return {
        "blocks_touched": touched,
        "blocks_gathered": capacity,
        "blocks_total": index.n_blocks,
        "rows_touched": int(capacity * index.block),
        "bytes_touched": int(capacity * index.block * index.rows.shape[1] * 4),
        "bytes_total": int(index.rows.nbytes),
        "prune_fraction": 1.0 - capacity / max(index.n_blocks, 1),
        "capacity": capacity,
        "survivors": n_hit,
        "overflowed": n_hit > capacity,
        "n_boxes": n_boxes,
    }


def _scatter_fused(index: ZoneMapIndex, counts: np.ndarray,
                   cand: np.ndarray, n_hit: int, capacity: int,
                   n_queries: int) -> np.ndarray:
    """Host-side de-mux of the fused result: counts [C, block, Q] for the
    gathered blocks -> [n_queries, n_rows] in ORIGINAL row order. Only the
    capacity-sized slice crosses device->host; all untouched blocks are
    zero by construction."""
    out = np.zeros((n_queries, index.n_rows), np.int32)
    k = min(n_hit, capacity)
    if k:
        perm_blocks = index.perm.reshape(index.n_blocks, index.block)[cand[:k]]
        flat_perm = perm_blocks.reshape(-1)                  # [k * block]
        flat_counts = counts[:k].reshape(k * index.block, -1)
        real = flat_perm >= 0
        out[:, flat_perm[real]] = flat_counts[real].T
    return out


def _resolve_capacity(index: ZoneMapIndex, capacity: Optional[int]) -> int:
    if capacity is None:
        capacity = index.n_blocks            # always-exact default
    return int(min(max(capacity, 1), index.n_blocks))


def _fused_call(index: ZoneMapIndex, boxes: BoxSet, owner: np.ndarray,
                n_queries: int, capacity: int) -> Tuple[np.ndarray, dict]:
    """kops.fused_query on the index's device mirror (one zone_candidates
    and one box_scan_seg launch on the card), n_hit read back, then the
    capacity-sized counts and block ids, scattered on the host."""
    rows3, zlo, zhi = index.device_arrays()
    lo, hi, owner_p = pad_boxes(boxes.lo, boxes.hi, owner)
    # pad boxes are impossible (contain nothing), so their owner-0 rows in
    # the one-hot contribute zero counts
    onehot = (owner_p[:, None] == np.arange(n_queries)[None]).astype(
        np.float32)
    # host arrays go up pinned and non-blocking (no host sync), device
    # boxes stay where they are
    lo, hi, onehot = (
        to_device_f32(a, index.device) if isinstance(a, torch.Tensor)
        else to_device_async(np.asarray(a, np.float32), index.device)
        for a in (lo, hi, onehot))
    counts, cand, n_hit = kops.fused_query(rows3, zlo, zhi, lo, hi, onehot,
                                           capacity=capacity)
    # three host syncs, as the reference's three reads
    n_hit = int(n_hit)
    counts = counts.cpu().numpy()
    cand = cand.cpu().numpy()
    out = _scatter_fused(index, counts, cand, n_hit, capacity, n_queries)
    return out, fused_stats(index, n_hit, capacity, boxes.n_boxes)


def query_index_fused(index: ZoneMapIndex, boxes: BoxSet, *,
                      capacity: Optional[int] = None
                      ) -> Tuple[np.ndarray, dict]:
    """Device-resident counterpart of query_index: zone-prune -> bounded
    block gather -> refine as one fused device call (kops.fused_query)
    over the cached device mirror of the index, on the index's device.
    Identical counts to query_index whenever ``capacity`` covers the
    survivors (default: n_blocks, i.e. always); with a smaller capacity,
    survivors past the bound are dropped in zone order and
    stats["overflowed"] is set."""
    assert np.array_equal(index.dims, boxes.dims), "box subset != index subset"
    capacity = _resolve_capacity(index, capacity)
    owner = np.zeros(boxes.n_boxes, np.int32)
    out, stats = _fused_call(index, boxes, owner, 1, capacity)
    return out[0], stats


def query_index_fused_multi(index: ZoneMapIndex, boxes: BoxSet,
                            owner: np.ndarray, n_queries: int, *,
                            capacity: Optional[int] = None
                            ) -> Tuple[np.ndarray, dict]:
    """Answer MANY concurrent queries' boxes on one index with ONE fused
    device call. ``owner[b]`` maps box b to its query; the box->query
    one-hot rides into the refine kernel, which de-muxes membership into
    per-query counts on the device (box_scan_seg). Returns
    (counts [n_queries, n_rows] int32 in ORIGINAL row order, stats).

    Each query's counts are bitwise-identical to running query_index on
    its own boxes, provided capacity covers the UNION's survivors."""
    assert np.array_equal(index.dims, boxes.dims), "box subset != index subset"
    assert owner.shape == (boxes.n_boxes,)
    capacity = _resolve_capacity(index, capacity)
    return _fused_call(index, boxes, np.asarray(owner, np.int32), n_queries,
                       capacity)


# ----------------------------------------------------------------------
# survivor-sparse scoring path (DESIGN.md §13)
# ----------------------------------------------------------------------

def sparse_probe(index: ZoneMapIndex, blo: torch.Tensor, bhi: torch.Tensor,
                 onehot: torch.Tensor, *, capacity: int):
    """Phase A of the monolithic survivor-sparse path: queued on the
    device with no host sync. The caller syncs st (batched across
    subsets), then compacts tiles via kernels/ops.survivor_tiles at an
    exact capacity.

    Returns (counts [C, block, Q], gids [C, block], ok [C, block],
             st [2] int32 = (n_hit, n_match))."""
    rows3, zlo, zhi = index.device_arrays()
    counts, cand, n_hit = kops.fused_query(rows3, zlo, zhi, blo, bhi, onehot,
                                           capacity=int(capacity))
    gids, ok = kops.tile_candidates(counts, cand, index.device_gids())
    st = torch.stack([n_hit, ok.sum(dtype=torch.int32)])
    return counts, gids, ok, st


# ----------------------------------------------------------------------
# quantized-mirror probe (conservative prune + exact re-check)
# ----------------------------------------------------------------------

def code_thresholds(lo: torch.Tensor, hi: torch.Tensor, c0: torch.Tensor,
                    scale: torch.Tensor):
    """The quantized probe's code-space box bounds [B, d']: TLO =
    floor((lo - c0)/s) - 1 and THI = ceil((hi - c0)/s) + 1 in f32, one
    correctly rounded op at a time (no fused multiply-add, no
    reciprocal), as the reference computes them."""
    tlo = torch.floor((lo - c0[None]) / scale[None]) - 1.0
    thi = torch.ceil((hi - c0[None]) / scale[None]) + 1.0
    return tlo, thi


def quantized_probe(index: ZoneMapIndex, blo: torch.Tensor,
                    bhi: torch.Tensor, *, capacity: int):
    """Phase A of the quantized path (static monolithic indexes): the
    widened-f16 zone prune -> bounded int8 block gather -> per-row
    code-space box test, queued on the device with no host sync.

    The prune is zone_candidates over the f16 zones cast to f32 (the
    reference's zone_prune_ref, any(1) and nonzero(size=capacity)). A row
    x inside box (lo, hi] has code t with |x - (c0 + t*s)| <= s/2, so with
    code_thresholds' TLO and THI the test TLO < t <= THI on every dim can
    only over-select (+-inf bounds give +-inf thresholds, never NaN: s >=
    1e-12). That test is box_scan_seg's half-open predicate over the
    codes, so it runs there with an all-ones [B, 1] one-hot: a count > 0
    is the reference's all(-1).any(-1), without its [C*block, B, d']
    boolean.

    Returns (gids [C, block] int32, cmask [C, block] bool,
             st [2] int32 = (n_hit, n_cand))."""
    qrows3, c0, scale, zlo16, zhi16 = index.device_quantized()
    capacity = int(capacity)
    cand, n_hit = kops.zone_candidates(zlo16.float(), zhi16.float(),
                                       blo, bhi, capacity)
    _, block, d = qrows3.shape
    qf = (qrows3.index_select(0, cand.long()).float() + 127.0).reshape(
        capacity * block, d)                             # codes [0, 254]
    tlo, thi = code_thresholds(blo, bhi, c0, scale)
    ones = torch.ones((blo.shape[0], 1), dtype=torch.float32,
                      device=blo.device)
    m = (kops.box_scan_seg(qf, tlo, thi, ones) > 0).reshape(capacity, block)
    valid = torch.arange(capacity, device=cand.device) < n_hit
    gids = index.device_gids().index_select(0, cand.long())
    cmask = m & (gids >= 0) & valid[:, None]
    return gids, cmask, torch.stack([n_hit, cmask.sum(dtype=torch.int32)])


def quantized_compact(gids: torch.Tensor, cmask: torch.Tensor, *,
                      row_capacity: int):
    """Compact the candidate mask into a dense [row_capacity] int32
    global-id list (-1 past the live prefix) and its count — the only
    quantity that crosses to the host between prune and re-check."""
    rcap = int(row_capacity)
    flat_ok = cmask.reshape(-1)
    idx = kops._compact(flat_ok, rcap).long()
    nr = flat_ok.sum(dtype=torch.int32)
    live = torch.arange(rcap, device=flat_ok.device) < nr
    return torch.where(live, gids.reshape(-1)[idx], -1), nr


def quantized_recheck(xsub: torch.Tensor, cgids: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor,
                      onehot: torch.Tensor):
    """Exact f32 re-check of the staged candidate rows ``xsub`` [rcap, d']
    (+inf on pad rows) by box_scan_seg — the dense refine's predicate on
    the same floats, so the same integer counts — emitted as a survivor
    tile: keys [rcap] int32 (TILE_INVALID past the live prefix), vals
    [rcap, Q] int32 (zero there). Candidates the exact test rejects keep
    their key with all-zero vals, which every later stage ignores."""
    counts = kops.box_scan_seg(xsub, lo, hi, onehot)
    live = cgids >= 0
    keys = torch.where(live, cgids, int(kops.TILE_INVALID))
    return keys, counts * live[:, None]


# ----------------------------------------------------------------------
# sharded index: the catalog row-space partitioned into shards
# ----------------------------------------------------------------------
# ``mesh`` is None (the flat single-device formulation, on the index's
# device) or a tuple of torch devices, one a shard: the stand-in for the
# reference's shard_map. Each shard's step then runs on its own device
# and its small outputs (stat scalars, [Q, k] lists, survivor tiles) are
# gathered to the first. A list may name one device several times.

def resolve_mesh(mesh) -> Optional[Tuple[torch.device, ...]]:
    """None stays None; a sequence of devices becomes a tuple of
    resolved torch devices."""
    return None if mesh is None else tuple(resolve_device(d) for d in mesh)


def _nbytes(t) -> int:
    return int(sum(x.nbytes for x in t) if isinstance(t, list)
               else t.nbytes)


@dataclass
class ShardedZoneMapIndex:
    """One feature subset's index, row-range-partitioned into shards.

    Shard s owns global rows [offsets[s], offsets[s+1]) and holds its OWN
    ZoneMapIndex over them (Morton order is shard-local; a row's global
    id is its shard offset + local id). The device mirror stacks every
    shard to one padded geometry — [S, NBmax, block, d'] rows, [S, NBmax,
    d'] zones, [S, Nloc_max] inverse permutations: padded zones are empty
    intervals that survive no prune, padded rows are +inf and inside no
    box, padded inverse-permutation slots point past every gathered block
    and read 0. Results are bitwise independent of the shard count. On a
    mesh the stack is a list, shard s's slice on mesh[s]."""
    dims: np.ndarray
    shards: List[ZoneMapIndex]    # per-shard local indexes
    offsets: np.ndarray           # [S + 1] global row offsets
    block: int
    n_rows: int
    subset_id: int = -1
    device: torch.device = field(kw_only=True)   # the flat mirror's device
    _dev: Optional[Tuple] = field(default=None, repr=False, compare=False)
    _dev_inv_perm: object = field(default=None, repr=False, compare=False)
    _dev_gids: object = field(default=None, repr=False, compare=False)
    # the mesh the cached mirrors were placed for (None: flat)
    _dev_mesh: object = field(default=None, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def nb_max(self) -> int:
        """Per-shard block-count bound — the stacked mirror's NBmax."""
        return max(max(sh.n_blocks for sh in self.shards), 1)

    @property
    def n_blocks(self) -> int:
        """PER-SHARD blocks (== nb_max), as the reference reports them."""
        return self.nb_max

    @property
    def total_blocks(self) -> int:
        return sum(sh.n_blocks for sh in self.shards)

    @property
    def n_loc_max(self) -> int:
        """Rows of the widest shard — the stacked score-buffer width."""
        return max(max(sh.n_rows for sh in self.shards), 1)

    @property
    def shard_rows(self) -> np.ndarray:
        return np.asarray([sh.n_rows for sh in self.shards], np.int64)

    @property
    def rows_nbytes(self) -> int:
        return int(sum(sh.rows.nbytes for sh in self.shards))

    def _put(self, arr: np.ndarray, mesh):
        """Upload the stacked host array: whole to the index's device
        (flat), or shard s's slice to mesh[s]."""
        if mesh is None:
            return to_device_async(arr, self.device)
        return [to_device_async(arr[i], dev) for i, dev in enumerate(mesh)]

    def device_arrays(self, mesh=None) -> Tuple:
        """(rows4 [S, NBmax, block, d'], zlo3, zhi3 [S, NBmax, d']),
        uploaded ONCE for the given placement and cached."""
        mesh = resolve_mesh(mesh)
        if self._dev is None or self._dev_mesh != mesh:
            s, nbm, d = self.n_shards, self.nb_max, len(self.dims)
            rows4 = np.full((s, nbm, self.block, d), np.inf, np.float32)
            zlo3 = np.full((s, nbm, d), np.inf, np.float32)
            zhi3 = np.full((s, nbm, d), -np.inf, np.float32)
            for i, sh in enumerate(self.shards):
                nb = sh.n_blocks
                rows4[i, :nb] = sh.rows.reshape(nb, self.block, d)
                zlo3[i, :nb] = sh.zlo
                zhi3[i, :nb] = sh.zhi
            self._dev = (self._put(rows4, mesh), self._put(zlo3, mesh),
                         self._put(zhi3, mesh))
            self._dev_mesh = mesh
            self._dev_inv_perm = None      # re-placed alongside
            self._dev_gids = None
        return self._dev

    def device_inv_perm(self, mesh=None):
        """[S, Nloc_max] int32 inverse permutations. On a mesh each shard's
        is local, padded with ``NBmax * block``; flat (mesh None) it is the
        VIRTUAL one: each shard's Morton positions offset by its block
        range in the [S * NBmax] block space, padded with ``S * NBmax *
        block``. Either pad maps to a zero gather in accumulate_scores."""
        mesh = resolve_mesh(mesh)
        if self._dev_inv_perm is None or self._dev_mesh != mesh:
            s, nbm = self.n_shards, self.nb_max
            pad = (s if mesh is None else 1) * nbm * self.block
            inv = np.full((s, self.n_loc_max), pad, np.int32)
            for i, sh in enumerate(self.shards):
                if sh.n_rows:
                    base = i * nbm * self.block if mesh is None else 0
                    inv[i, :sh.n_rows] = sh.inv_perm() + base
            self.device_arrays(mesh)       # one placement for the mirror
            self._dev_inv_perm = self._put(inv, mesh)
        return self._dev_inv_perm

    def device_gids(self, mesh=None):
        """[S, NBmax, block] int32 GLOBAL row ids per (shard, block, slot),
        -1 on padding slots and padding blocks (the same content flat and
        on a mesh: global ids do not depend on placement)."""
        mesh = resolve_mesh(mesh)
        if self._dev_gids is None or self._dev_mesh != mesh:
            s, nbm = self.n_shards, self.nb_max
            g = np.full((s, nbm, self.block), -1, np.int32)
            for i, sh in enumerate(self.shards):
                if sh.n_rows:
                    loc = sh.perm.astype(np.int32).reshape(
                        sh.n_blocks, self.block)
                    g[i, :sh.n_blocks] = np.where(
                        loc >= 0, loc + np.int32(self.offsets[i]), -1)
            self.device_arrays(mesh)       # one placement for the mirror
            self._dev_gids = self._put(g, mesh)
        return self._dev_gids

    def device_bytes(self) -> dict:
        """Resident device-mirror bytes by kind: the stacked mirrors, plus
        whatever the per-shard indexes uploaded themselves (the host
        oracle's query_index reads their own mirrors)."""
        out = {"rows": 0, "zones": 0, "gids": 0, "inv_perm": 0,
               "quantized": 0}
        for sh in self.shards:
            for k, v in sh.device_bytes().items():
                out[k] += v
        if self._dev is not None:
            rows4, zlo3, zhi3 = self._dev
            out["rows"] += _nbytes(rows4)
            out["zones"] += _nbytes(zlo3) + _nbytes(zhi3)
        if self._dev_inv_perm is not None:
            out["inv_perm"] += _nbytes(self._dev_inv_perm)
        if self._dev_gids is not None:
            out["gids"] += _nbytes(self._dev_gids)
        return out

    def stats(self) -> dict:
        return {"n_shards": self.n_shards, "blocks": self.total_blocks,
                "blocks_per_shard_max": self.nb_max,
                "block_rows": self.block, "rows": self.n_rows,
                "shard_rows": self.shard_rows.tolist(),
                "dims": self.dims.tolist(), "bytes": self.rows_nbytes}


def build_sharded_index(x: np.ndarray, dims: np.ndarray, n_shards: int,
                        block: int = 1024, subset_id: int = -1,
                        device=None) -> ShardedZoneMapIndex:
    """Partition the catalog row-space into ``n_shards`` contiguous
    ranges and build one ZoneMapIndex per range. Global ids are offset +
    local id, so the partition IS the id map."""
    device = resolve_device(device)
    x = np.asarray(x)
    offs = shard_offsets(x.shape[0], n_shards)
    shards = [build_index(x[offs[s]:offs[s + 1]], dims, block=block,
                          subset_id=subset_id, device=device)
              for s in range(n_shards)]
    return ShardedZoneMapIndex(np.asarray(dims), shards, offs, block,
                               x.shape[0], subset_id, device=device)


def build_sharded_indexes(x: np.ndarray, subsets, n_shards: int,
                          block: int = 1024, device=None) -> list:
    """build_sharded_index for every subset, on a thread pool as
    build_indexes does."""
    device = resolve_device(device)
    subsets = list(subsets)
    workers = max(1, min(len(subsets), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(
            lambda kd: build_sharded_index(x, kd[1], n_shards, block=block,
                                           subset_id=kd[0], device=device),
            enumerate(subsets)))


def query_index_sharded(sindex: ShardedZoneMapIndex,
                        boxes: BoxSet) -> Tuple[np.ndarray, dict]:
    """Host-oracle query_index over a sharded index: per-shard
    query_index, counts reassembled into GLOBAL row order (bitwise those
    of the unsharded index: membership is a per-row predicate)."""
    out = np.zeros(sindex.n_rows, np.int32)
    agg = {"blocks_touched": 0, "blocks_total": 0, "rows_touched": 0,
           "bytes_touched": 0, "bytes_total": 0}
    for sh, o0 in zip(sindex.shards, sindex.offsets[:-1]):
        if sh.n_rows == 0:
            continue
        c, st = query_index(sh, boxes)
        out[o0:o0 + sh.n_rows] = c
        for k in agg:
            agg[k] += st[k]
    agg["prune_fraction"] = 1.0 - agg["blocks_touched"] / max(
        agg["blocks_total"], 1)
    agg["n_shards"] = sindex.n_shards
    return out, agg


def _flat(rows4, zlo3, zhi3):
    """The stacked shard mirrors as ONE index over the [S * NBmax]
    virtual block space (views, no copy)."""
    s, nbm, block, d = rows4.shape
    return (rows4.reshape(s * nbm, block, d), zlo3.reshape(s * nbm, d),
            zhi3.reshape(s * nbm, d))


def _hit_stats(n_hit: List[torch.Tensor], capacity: int, dev):
    """The per-shard survivor counts, gathered to ``dev`` and reduced to
    (max, sum of min(n_hit, capacity), sum) int32."""
    h = torch.stack([t.to(dev) for t in n_hit])
    return (h.max(), h.clamp(max=capacity).sum(dtype=torch.int32),
            h.sum(dtype=torch.int32))


def sharded_query_accumulate(sindex: ShardedZoneMapIndex, scores,
                             blo: torch.Tensor, bhi: torch.Tensor,
                             onehot: torch.Tensor, *, capacity: int,
                             mesh=None):
    """One subset's boxes against every shard, accumulated into the
    [S, Nloc_max, Q] score buffer (a list of per-shard [Nloc_max, Q]
    buffers on a mesh), queued with no host sync.

    Flat (mesh None): the stacked mirrors run as ONE fused_query over the
    virtual block space — ``capacity`` is the GLOBAL gather bound — and
    the virtual inverse permutation folds the counts into the buffer's
    flat view; the [3] stats carry the global survivor count in every
    slot. On a mesh each shard runs the same fused_query + accumulate on
    its device with ``capacity`` per shard, and the stats are (max n_hit,
    sum of min(n_hit, C), sum n_hit). Either way an overflow keeps the
    buffer as it was (the caller retries the subset).

    Returns (scores', hit_stats [3] int32)."""
    mesh = resolve_mesh(mesh)
    capacity = int(capacity)
    rows4, zlo3, zhi3 = sindex.device_arrays(mesh)
    inv = sindex.device_inv_perm(mesh)
    if mesh is None:
        s, nlm, q = scores.shape
        counts, cand, n_hit = kops.fused_query(
            *_flat(rows4, zlo3, zhi3), blo, bhi, onehot, capacity=capacity)
        flat = scores.reshape(s * nlm, q)
        acc = kops.accumulate_scores(flat, counts, cand,
                                     inv.reshape(s * nlm),
                                     nb=s * sindex.nb_max)
        st3 = torch.stack([n_hit, n_hit.clamp(max=capacity), n_hit])
        return torch.where(n_hit <= capacity, acc, flat).reshape(
            scores.shape), st3
    acc, hits = [], []
    for i, dev in enumerate(mesh):
        counts, cand, n_hit = kops.fused_query(
            rows4[i], zlo3[i], zhi3[i], blo.to(dev), bhi.to(dev),
            onehot.to(dev), capacity=capacity)
        acc.append(kops.accumulate_scores(scores[i], counts, cand, inv[i],
                                          nb=sindex.nb_max))
        hits.append(n_hit)
    st3 = torch.stack(_hit_stats(hits, capacity, mesh[0]))
    ok = st3[0] <= capacity
    return ([torch.where(ok.to(dev), a, sc)
             for a, sc, dev in zip(acc, scores, mesh)], st3)


def sharded_sparse_probe(sindex: ShardedZoneMapIndex, blo: torch.Tensor,
                         bhi: torch.Tensor, onehot: torch.Tensor, *,
                         capacity: int, mesh=None):
    """Phase A of the sharded survivor-sparse path, queued with no host
    sync. Flat (mesh None): one fused_query + tile labelling over the
    virtual block space, ``capacity`` GLOBAL, flat tiles (counts [C,
    block, Q], gids/ok [C, block]). On a mesh: the same per shard on its
    device, per-shard tiles in lists, ``capacity`` per shard. Both return
    the same [5] int32 stat vector — (max n_hit, sum min(n_hit, C), sum
    n_hit, max n_match, sum n_match), global figures in every slot when
    flat — so the batched host sync is flat in shard count."""
    mesh = resolve_mesh(mesh)
    capacity = int(capacity)
    rows4, zlo3, zhi3 = sindex.device_arrays(mesh)
    gids3 = sindex.device_gids(mesh)
    if mesh is None:
        s, nbm, block, _ = rows4.shape
        counts, cand, n_hit = kops.fused_query(
            *_flat(rows4, zlo3, zhi3), blo, bhi, onehot, capacity=capacity)
        gids, ok = kops.tile_candidates(counts, cand,
                                        gids3.reshape(s * nbm, block))
        nm = ok.sum(dtype=torch.int32)
        st = torch.stack([n_hit, n_hit.clamp(max=capacity), n_hit, nm, nm])
        return counts, gids, ok, st
    counts, gids, ok, hits, nms = [], [], [], [], []
    for i, dev in enumerate(mesh):
        c, cand, n_hit = kops.fused_query(
            rows4[i], zlo3[i], zhi3[i], blo.to(dev), bhi.to(dev),
            onehot.to(dev), capacity=capacity)
        g, o = kops.tile_candidates(c, cand, gids3[i])
        counts.append(c)
        gids.append(g)
        ok.append(o)
        hits.append(n_hit)
        nms.append(o.sum(dtype=torch.int32).to(mesh[0]))
    nm = torch.stack(nms)
    st = torch.stack([*_hit_stats(hits, capacity, mesh[0]), nm.max(),
                      nm.sum(dtype=torch.int32)])
    return counts, gids, ok, st


def sharded_survivor_tiles(counts, gids, ok, *, row_capacity: int,
                           mesh=None):
    """Phase B of the mesh sparse path: compact each shard's survivors
    (survivor_tiles at ``row_capacity`` rows per shard) and gather them
    to the first device as ([S * rcap] keys, [S * rcap, Q] int32 vals).
    Keys carry GLOBAL ids, so the flattened tiles need no offset fixup."""
    mesh = resolve_mesh(mesh)
    dev0 = mesh[0] if mesh is not None else counts[0].device
    keys, vals = [], []
    for c, g, o in zip(counts, gids, ok):
        k, v, _ = kops.survivor_tiles(c, g, o, row_capacity=row_capacity)
        keys.append(k.to(dev0))
        vals.append(v.to(dev0))
    return torch.cat(keys), torch.cat(vals)


def sharded_rank_merge(sindex: ShardedZoneMapIndex, scores,
                       train_ids: torch.Tensor, *, k: int,
                       score_bound: Optional[int] = None, mesh=None,
                       method: Optional[str] = None):
    """Device ranking of the [S, Nloc_max, Q] score buffer with the
    pinned tie-break — descending score, ascending GLOBAL id — so the
    result is bitwise the single-device ranking; only [Q, k] needs to
    reach the host. ``train_ids``: [Q, T] GLOBAL ids to exclude.

    Flat with the standard ceil-split offsets, virtual position (shard *
    Nloc_max + local) IS the global id (padding rows score 0 and sit past
    n), so one rank_topk over the reshaped buffer is the per-shard top-k
    plus merge. Otherwise (a mesh, or other offsets) each shard runs
    ops.shard_local_topk on its device and ops.merge_topk merges the
    [S, Q, k] lists on the first. ``score_bound`` is pow2-bucketed as in
    the reference (a looser bound is always valid)."""
    mesh = resolve_mesh(mesh)
    sb = None if score_bound is None else pow2above(score_bound)
    nlm = sindex.n_loc_max
    flat = mesh is None and bool(np.array_equal(
        sindex.offsets[:-1],
        np.minimum(np.arange(sindex.n_shards, dtype=np.int64) * nlm,
                   sindex.n_rows)))
    if flat:
        s, _, q = scores.shape
        return kops.rank_topk(scores.reshape(s * nlm, q), train_ids,
                              k=min(int(k), s * nlm), score_bound=sb,
                              method=method, scores_transposed=True)
    per = [kops.shard_local_topk(sc, train_ids.to(sc.device), int(off),
                                 int(nl), k=k, score_bound=sb, method=method)
           for sc, off, nl in zip(scores, sindex.offsets[:-1],
                                  sindex.shard_rows)]
    dev0 = mesh[0] if mesh is not None else scores.device
    return kops.merge_topk(torch.stack([g.to(dev0) for g, _, _ in per]),
                           torch.stack([c.to(dev0) for _, c, _ in per]),
                           k=k)


def sharded_fused_stats(sindex: ShardedZoneMapIndex, max_hit: int,
                        sum_min_hit: int, capacity: int, n_boxes: int,
                        flat: bool = False) -> dict:
    """fused_stats for the sharded path: every shard gathers ``capacity``
    blocks on a mesh (``flat`` gathers ``capacity`` globally);
    ``survivors`` is what the retry capacity must cover (the per-shard
    max, or the global count flat), ``blocks_touched`` the refined
    survivor blocks summed."""
    s, d = sindex.n_shards, len(sindex.dims)
    gathered = capacity if flat else s * capacity
    return {
        "blocks_touched": int(sum_min_hit),
        "blocks_gathered": gathered,
        "blocks_total": sindex.total_blocks,
        "rows_touched": int(gathered * sindex.block),
        "bytes_touched": int(gathered * sindex.block * d * 4),
        "bytes_total": sindex.rows_nbytes,
        "prune_fraction": 1.0 - gathered / max(sindex.total_blocks, 1),
        "capacity": capacity,
        "survivors": int(max_hit),
        "overflowed": int(max_hit) > capacity,
        "n_boxes": n_boxes,
        "n_shards": s,
    }


# ----------------------------------------------------------------------
# distributed query: rows range-partitioned over a device list
# ----------------------------------------------------------------------

def _data_split(mesh, *arrays):
    """Split each [NB, ...] array into len(mesh) equal row ranges, the
    i-th on mesh[i] (the reference's P("data") placement)."""
    devs = resolve_mesh(mesh)
    nb = arrays[0].shape[0]
    if nb % len(devs):
        raise ValueError(f"{nb} blocks do not split over {len(devs)} "
                         f"devices")
    per = nb // len(devs)
    return devs, [[a[i * per:(i + 1) * per].to(dev).contiguous()
                   for a in arrays] for i, dev in enumerate(devs)]


def distributed_query(index_rows: torch.Tensor, zlo: torch.Tensor,
                      zhi: torch.Tensor, blo: torch.Tensor,
                      bhi: torch.Tensor, mesh, block: int) -> torch.Tensor:
    """Sharded prune + refine over a device list: rows/zones
    range-partitioned over ``mesh`` (index_rows [NB, block, d'], zlo/zhi
    [NB, d']); the tiny boxes go to every device. Each device prunes its
    own zones (zone_hits) and scans its rows (box_scan), keeping the
    counts of surviving blocks. Returns [NB * block] int32 counts in
    Morton order on the first device."""
    devs, parts = _data_split(mesh, index_rows, zlo, zhi)
    out = []
    for dev, (rows, lo_z, hi_z) in zip(devs, parts):
        lo_b, hi_b = blo.to(dev), bhi.to(dev)
        m = kops.zone_hits(lo_z, hi_z, lo_b, hi_b)
        counts = kops.box_scan(rows.reshape(-1, rows.shape[-1]), lo_b, hi_b)
        out.append(torch.where(m.repeat_interleave(block), counts, 0)
                   .to(devs[0]))
    return torch.cat(out)


def pruned_local_step(block: int, capacity: int):
    """The per-shard step of the pruned distributed query: zone-prune the
    local zones and compact the survivors (zone_candidates), then scan
    the <= ``capacity`` surviving blocks where they lie and write every
    block's counts once, 0 where no survivor is (box_scan_pruned: on the
    CPU the reference's gather, scan and scatter-max, as it is). Returns
    ``local(rows [nb_loc, block, d'], zlo, zhi, blo, bhi) -> [nb_loc *
    block] int32``."""

    def local(rows, lo_z, hi_z, lo_b, hi_b):
        cand, n_hit = kops.zone_candidates(lo_z, hi_z, lo_b, hi_b, capacity)
        return kops.box_scan_pruned(rows, cand, n_hit, lo_b, hi_b)

    return local


def distributed_query_pruned(index_rows: torch.Tensor, zlo: torch.Tensor,
                             zhi: torch.Tensor, blo: torch.Tensor,
                             bhi: torch.Tensor, mesh, block: int,
                             capacity: int) -> torch.Tensor:
    """The performance formulation of distributed_query: each device
    scans only its surviving blocks (pruned_local_step);
    ``capacity`` bounds the surviving blocks per device, and survivors
    past it are dropped. Returns [NB * block] int32 Morton-order counts
    on the first device."""
    local = pruned_local_step(block, capacity)
    devs, parts = _data_split(mesh, index_rows, zlo, zhi)
    return torch.cat([local(rows, lo_z, hi_z, blo.to(dev), bhi.to(dev))
                      .to(devs[0])
                      for dev, (rows, lo_z, hi_z) in zip(devs, parts)])
