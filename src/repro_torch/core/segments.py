"""Live catalog ingestion — the non-durable, single-shard part of
``repro.core.segments``: a segmented, LSM-style index with an
append / delete / compact lifecycle.

  append   Morton-orders ONLY the new rows into a sealed delta segment
           (per feature subset). Global ids are append-ordered and
           stable forever: a segment starting at ``offset`` owns global
           rows [offset, offset + n_rows).
  delete   tombstones rows in a validity mask; geometry is untouched and
           dead rows carry score 0 (``kernels/ops.accumulate_scores`` and
           ``tile_candidates`` mask them), so ranking never surfaces them.
  compact  merges every sealed segment into ONE re-sorted segment off the
           serving thread and swaps it in atomically. Tombstoned rows
           stay physically present, so every segment keeps covering a
           contiguous id range.

Queries run base + deltas as one fused probe a subset: every segment's
blocks are concatenated into a ragged virtual block space, the
per-segment inverse permutations and global-id grids are offset into it,
and the probe (``zone_candidates`` -> ``box_scan_seg`` -> tile labelling)
runs over it exactly as over a monolithic index.

Snapshot discipline: every mutation builds a new immutable Snapshot and
swaps one reference under a lock; a query binds the snapshot once and
keeps it. ``epoch`` counts mutations, ``geom`` compactions (the capacity
hints' generation tag).

The correctness contract: at every point of a schedule, ranked ids,
scores and integer stats are bitwise those of the reference's live
engine on the same schedule, and of a monolithic engine over the
surviving rows (ids mapped through the monotone live-id list).

The device mirrors are lazy, built on the query path's device: an append
uploads only the new segment's mirrors (pinned, ``non_blocking``: no host
sync), a delete uploads only the mask, and the concatenation is a
device-to-device copy. Nothing here launches on the card outside a
query, so a background compaction does host work only. Durability
(``persist_dir``, ``checkpoint``, ``open``) is ROADMAP A8 and raises.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import unported
from repro_torch.core.index import ZoneMapIndex, build_indexes
from repro_torch.device import resolve_device, to_device_async
from repro_torch.kernels import ops as kops


def shard_offsets(n: int, n_shards: int) -> np.ndarray:
    """[S + 1] global row offsets of an even ceil-split partition (a copy
    of ``repro.core.index.shard_offsets``)."""
    per = -(-max(int(n), 1) // n_shards)
    return np.minimum(np.arange(n_shards + 1, dtype=np.int64) * per, n)


# ----------------------------------------------------------------------
# segments
# ----------------------------------------------------------------------

@dataclass
class Segment:
    """One sealed, immutable run of catalog rows: global ids
    [offset, offset + n_rows), one ZoneMapIndex per feature subset over
    exactly those rows. ``shard`` is the owning shard in an n_shards
    composition (host bookkeeping only)."""
    offset: int
    n_rows: int
    shard: int
    indexes: List[ZoneMapIndex]        # aligned with the engine's subsets

    def stats(self, live_host: Optional[np.ndarray] = None) -> dict:
        live = (int(live_host[self.offset:self.offset + self.n_rows].sum())
                if live_host is not None else self.n_rows)
        return {"offset": self.offset, "rows": self.n_rows,
                "rows_live": live, "rows_tombstoned": self.n_rows - live,
                "shard": self.shard,
                "blocks": sum(ix.n_blocks for ix in self.indexes),
                "bytes": int(sum(ix.rows.nbytes for ix in self.indexes))}


@dataclass
class SegmentedZoneMapIndex:
    """One feature subset's view of every segment, concatenated into the
    virtual block space. Its inverse permutation is virtual: global row g
    maps to its segment's Morton position offset by the segment's block
    range. Pure geometry — validity lives on the Snapshot, so delete
    epochs share these objects and their cached device mirrors."""
    dims: np.ndarray
    segs: List[ZoneMapIndex]           # per-segment indexes, offset order
    offsets: np.ndarray                # [S + 1] global row offsets
    block: int
    subset_id: int = -1
    _dev: Optional[Tuple[torch.Tensor, ...]] = field(
        default=None, repr=False, compare=False)
    _inv_virt: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)
    _seg_blocks_dev: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)
    _gids_virt: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.segs[0].device

    @property
    def n_segments(self) -> int:
        return len(self.segs)

    @property
    def n_rows(self) -> int:
        return int(self.offsets[-1])

    @functools.cached_property
    def seg_blocks(self) -> np.ndarray:
        """[S + 1] block offsets of each segment in the virtual space:
        ragged cumulative sums, so a small delta costs its own blocks."""
        return np.concatenate(
            [[0], np.cumsum([s.n_blocks for s in self.segs])]).astype(np.int64)

    @property
    def n_blocks(self) -> int:
        return int(self.seg_blocks[-1])

    @property
    def rows_nbytes(self) -> int:
        return int(sum(s.rows.nbytes for s in self.segs))

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(rows3 [NB_total, block, d'], zlo, zhi [NB_total, d']): the
        per-segment cached mirrors concatenated on the device, lazily.
        Sealed segments keep their mirrors across epochs, so an append
        uploads only the new delta; a one-segment view shares the
        segment's mirror."""
        if self._dev is None:
            if len(self.segs) == 1:
                self._dev = self.segs[0].device_arrays()
            else:
                parts = [s.device_arrays() for s in self.segs]
                self._dev = tuple(torch.cat([p[i] for p in parts])
                                  for i in range(3))
        return self._dev

    def device_inv_virt(self) -> torch.Tensor:
        """[N_total] int32: global row id -> virtual Morton position
        (segment-local position + the segment's block offset * block)."""
        if self._inv_virt is None:
            parts = [s.device_inv_perm() + int(b * self.block)
                     for s, b in zip(self.segs, self.seg_blocks[:-1])]
            self._inv_virt = (parts[0] if len(parts) == 1
                              else torch.cat(parts))
        return self._inv_virt

    def device_seg_blocks(self) -> torch.Tensor:
        """[S + 1] int32 block offsets on the device."""
        if self._seg_blocks_dev is None:
            self._seg_blocks_dev = to_device_async(
                self.seg_blocks.astype(np.int32), self.device)
        return self._seg_blocks_dev

    def device_gids(self) -> torch.Tensor:
        """[NB_total, block] int32 GLOBAL row id per virtual (block, slot),
        -1 on padding slots: each segment's permutation grid offset by its
        global row offset, concatenated in virtual block order."""
        if self._gids_virt is None:
            parts = []
            for s, o in zip(self.segs, self.offsets[:-1]):
                g = s.device_gids()
                parts.append(torch.where(g >= 0, g + int(o), -1)
                             .to(torch.int32))
            self._gids_virt = (parts[0] if len(parts) == 1
                               else torch.cat(parts))
        return self._gids_virt

    def device_bytes(self) -> dict:
        """Resident device-mirror bytes by kind: the per-segment cached
        mirrors plus this view's own concatenated copies (counted only
        when they are distinct tensors — a one-segment view shares the
        segment's rows and zones)."""
        out = {"rows": 0, "zones": 0, "gids": 0, "inv_perm": 0}
        for s in self.segs:
            for k, v in s.device_bytes().items():
                out[k] += v
        if self._dev is not None and len(self.segs) > 1:
            rows3, zlo, zhi = self._dev
            out["rows"] += int(rows3.nbytes)
            out["zones"] += int(zlo.nbytes) + int(zhi.nbytes)
        if self._inv_virt is not None:
            out["inv_perm"] += int(self._inv_virt.nbytes)
        if self._gids_virt is not None:
            out["gids"] += int(self._gids_virt.nbytes)
        return out

    def stats(self) -> dict:
        return {"n_segments": self.n_segments, "blocks": self.n_blocks,
                "block_rows": self.block, "rows": self.n_rows,
                "dims": self.dims.tolist(), "bytes": self.rows_nbytes,
                "seg_blocks": self.seg_blocks.tolist()}


# ----------------------------------------------------------------------
# the fused probe over the virtual block space
# ----------------------------------------------------------------------

def _per_segment(cand, n_hit, seg_boff, capacity: int) -> torch.Tensor:
    """[S] int32 refined blocks per segment: each gathered block is
    attributed to its segment by the boundary table, fill slots past the
    refined count masked out, so the figures sum to blocks_touched."""
    seg_of = torch.searchsorted(seg_boff, cand, right=True) - 1
    refined = (torch.arange(capacity, device=cand.device)
               < torch.clamp(n_hit, max=capacity)).to(torch.int32)
    per_seg = torch.zeros(seg_boff.shape[0] - 1, dtype=torch.int32,
                          device=cand.device)
    return per_seg.scatter_add_(0, seg_of, refined)


def segmented_query_accumulate(segx: SegmentedZoneMapIndex, scores,
                               blo, bhi, onehot, valid, *, capacity: int):
    """The dense oracle over every segment: one fused probe over the
    virtual block space, counts folded into the global [N_total, Q] score
    buffer through the virtual inverse permutation with tombstoned rows
    masked to 0. The no-overflow case is speculated on the device (the
    buffer is left as it was where n_hit > capacity; the caller retries).

    Returns (scores', st [1 + S] int32 = (survivors, refined blocks per
    segment)) — device values; the caller batches the sync."""
    rows3, zlo, zhi = segx.device_arrays()
    capacity = int(capacity)
    counts, cand, n_hit = kops.fused_query(rows3, zlo, zhi, blo, bhi,
                                           onehot, capacity=capacity)
    acc = kops.accumulate_scores(scores, counts, cand, segx.device_inv_virt(),
                                 valid, nb=segx.n_blocks)
    per_seg = _per_segment(cand, n_hit, segx.device_seg_blocks(), capacity)
    out = torch.where(n_hit <= capacity, acc, scores)
    return out, torch.cat([n_hit.reshape(1), per_seg])


def segmented_sparse_probe(segx: SegmentedZoneMapIndex, blo, bhi, onehot,
                           valid, *, capacity: int):
    """The survivor-sparse probe over the virtual block space, with the
    tombstone mask applied per tile row (tile_candidates drops dead rows),
    queued on the device with no host sync.

    Returns (counts [C, block, Q], gids [C, block], ok [C, block],
             st [2 + S] int32 = (n_hit, n_match, refined per segment))."""
    rows3, zlo, zhi = segx.device_arrays()
    capacity = int(capacity)
    counts, cand, n_hit = kops.fused_query(rows3, zlo, zhi, blo, bhi,
                                           onehot, capacity=capacity)
    gids, ok = kops.tile_candidates(counts, cand, segx.device_gids(),
                                    valid=valid)
    per_seg = _per_segment(cand, n_hit, segx.device_seg_blocks(), capacity)
    st = torch.cat([n_hit.reshape(1),
                    ok.sum(dtype=torch.int32).reshape(1), per_seg])
    return counts, gids, ok, st


def segmented_fused_stats(segx: SegmentedZoneMapIndex, n_hit: int,
                          per_seg, capacity: int, n_boxes: int,
                          live_rows: int) -> dict:
    """fused_stats for the segmented path: the global figures price the
    ONE capacity-sized gather over the virtual block space;
    ``per_segment_blocks_touched`` partitions the refined blocks by
    segment and sums to ``blocks_touched``."""
    d = len(segx.dims)
    nb = segx.n_blocks
    per_seg = [int(v) for v in per_seg]
    return {
        "blocks_touched": int(min(n_hit, capacity)),
        "blocks_gathered": capacity,
        "blocks_total": nb,
        "rows_touched": int(capacity * segx.block),
        "bytes_touched": int(capacity * segx.block * d * 4),
        "bytes_total": segx.rows_nbytes,
        "prune_fraction": 1.0 - capacity / max(nb, 1),
        "capacity": capacity,
        "survivors": int(n_hit),
        "overflowed": int(n_hit) > capacity,
        "n_boxes": n_boxes,
        "n_segments": segx.n_segments,
        "per_segment_blocks_touched": per_seg,
        "per_segment_bytes_touched": [v * segx.block * d * 4
                                      for v in per_seg],
        "rows_live": int(live_rows),
        "rows_tombstoned": segx.n_rows - int(live_rows),
    }


# ----------------------------------------------------------------------
# the catalog: snapshots + the append/delete/compact lifecycle
# ----------------------------------------------------------------------

@dataclass
class Snapshot:
    """One immutable epoch of the catalog: features, the live feature
    range (box expansion must see the surviving rows' spread), the
    per-subset segment views and the validity mask (host bool; the int32
    device mirror is built on first use). ``x`` and ``valid_host`` are
    length-n views of the catalog's growable buffers; appends write past
    n, so older views never change."""
    epoch: int
    x: np.ndarray
    frange: Tuple[np.ndarray, np.ndarray]
    segments: Tuple[Segment, ...]
    indexes: Tuple[SegmentedZoneMapIndex, ...]
    valid_host: np.ndarray             # [n] bool
    n: int
    live_rows: int
    device: torch.device
    geom: int = 0                      # compaction generation
    _valid_dev: Optional[torch.Tensor] = field(default=None, repr=False)
    # the parent's already-built device mask when this epoch only appended
    # rows (or compacted): extended on the device instead of re-uploaded
    _valid_base: Optional[torch.Tensor] = field(default=None, repr=False)

    def valid_device(self) -> torch.Tensor:
        """[n] int32 device mask (1 live, 0 tombstoned), built once: the
        parent's mask extended by ones on the device after an append, a
        pinned non-blocking upload otherwise (delete epochs, or a parent
        whose mask was never built)."""
        if self._valid_dev is None:
            base = self._valid_base
            if base is not None and base.shape[0] == self.n:
                self._valid_dev = base
            elif base is not None and base.shape[0] < self.n:
                self._valid_dev = torch.cat([base, torch.ones(
                    self.n - base.shape[0], dtype=torch.int32,
                    device=base.device)])
            else:
                self._valid_dev = to_device_async(
                    self.valid_host.astype(np.int32), self.device)
        return self._valid_dev


class SegmentedCatalog:
    """The mutable handle: owns the current Snapshot and the mutation
    lifecycle. Mutations serialise on one lock and swap the snapshot
    reference; readers never lock. ``device`` is where the segments'
    mirrors go (default CUDA)."""

    # spare buffer rows beyond the catalog size, as a fraction (plus a
    # floor): steady appends write into the tail without a regrow copy
    _HEADROOM_FRAC = 4      # 1/4 = 25%
    _HEADROOM_MIN = 4096

    def __init__(self, features: np.ndarray, subsets: np.ndarray, *,
                 block: int = 1024, n_shards: int = 1, faults=None,
                 persist_dir=None, device=None):
        if persist_dir is not None:
            raise unported("persist_dir (durable catalogs)", "A8")
        if faults is not None:
            raise unported("faults (fault-injection seams)", "A9")
        x = np.ascontiguousarray(np.asarray(features, np.float32))
        self._init_state(subsets, block, n_shards, device, geom=0)
        n = x.shape[0]
        self._alloc(n, x.shape[1])
        self._xbuf[:n] = x
        # the base: one segment per shard (the ceil-split row partition)
        offs = shard_offsets(n, self.n_shards)
        segments = []
        for s in range(self.n_shards):
            o0, o1 = int(offs[s]), int(offs[s + 1])
            if o1 > o0:
                segments.append(self._build_segment(x[o0:o1], o0, shard=s))
        self._next_shard = len(segments) % self.n_shards
        frange = (x.min(0), x.max(0))
        self._make_snapshot(0, self._xbuf[:n], frange, tuple(segments),
                            self._vbuf[:n], n)

    def _init_state(self, subsets, block, n_shards, device, geom) -> None:
        self.subsets = np.asarray(subsets)
        self.block = int(block)
        self.n_shards = max(int(n_shards), 1)
        self.device = resolve_device(device)
        self.faults = None
        self.persist = None
        self._lock = threading.Lock()          # mutation serialisation
        self._compact_lock = threading.Lock()  # one compaction at a time
        self._geom = int(geom)                 # compaction generation

    def _alloc(self, n: int, d: int) -> None:
        cap = n + max(n // self._HEADROOM_FRAC, self._HEADROOM_MIN)
        self._xbuf = np.empty((cap, d), np.float32)
        self._vbuf = np.ones(cap, bool)

    @classmethod
    def _from_state(cls, x, subsets, segments, valid, frange, *, block: int,
                    epoch: int, geom: int, n_shards: int, next_shard: int,
                    device=None) -> "SegmentedCatalog":
        """A catalog over sealed segments built elsewhere (core/convert.
        catalog_from_arrays): ``segments`` are (offset, n_rows, shard,
        [ZoneMapIndex per subset]) in offset order."""
        self = cls.__new__(cls)
        self._init_state(subsets, block, n_shards, device, geom)
        self._next_shard = int(next_shard)
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        self._alloc(n, x.shape[1])
        self._xbuf[:n] = x
        self._vbuf[:n] = np.asarray(valid, bool)
        segs = tuple(Segment(int(o), int(m), int(sh), list(ixs))
                     for o, m, sh, ixs in segments)
        self._make_snapshot(int(epoch), self._xbuf[:n],
                            (np.asarray(frange[0], np.float32),
                             np.asarray(frange[1], np.float32)),
                            segs, self._vbuf[:n], int(self._vbuf[:n].sum()))
        return self

    def _reserve(self, n_rows: int) -> None:
        """Grow the feature/validity buffers to hold ``n_rows`` (under the
        mutation lock). Old snapshots keep their views of the old ones."""
        if n_rows <= self._xbuf.shape[0]:
            return
        cur = self._snap.n
        cap = n_rows + max(n_rows // self._HEADROOM_FRAC,
                           self._HEADROOM_MIN)
        xb = np.empty((cap, self._xbuf.shape[1]), np.float32)
        xb[:cur] = self._xbuf[:cur]
        vb = np.ones(cap, bool)
        vb[:cur] = self._vbuf[:cur]
        self._xbuf, self._vbuf = xb, vb

    # ------------------------------------------------------------------
    def _build_segment(self, xseg: np.ndarray, offset: int,
                       shard: int) -> Segment:
        idxs = build_indexes(xseg, self.subsets, block=self.block,
                             device=self.device)
        return Segment(int(offset), int(xseg.shape[0]), int(shard), idxs)

    def _make_snapshot(self, epoch, x, frange, segments, valid_host,
                       live_rows, prev_indexes=None,
                       valid_base=None) -> Snapshot:
        """``prev_indexes`` is reused when geometry is unchanged (delete
        epochs) so cached device mirrors survive the swap; ``valid_base``
        is the parent's device mask when this epoch only appends."""
        if prev_indexes is None:
            n = x.shape[0]
            offsets = np.asarray([s.offset for s in segments] + [n],
                                 np.int64)
            prev_indexes = tuple(
                SegmentedZoneMapIndex(
                    dims=np.asarray(dims),
                    segs=[s.indexes[k] for s in segments],
                    offsets=offsets, block=self.block, subset_id=k)
                for k, dims in enumerate(self.subsets))
        snap = Snapshot(epoch, x, frange, tuple(segments), prev_indexes,
                        valid_host, x.shape[0], int(live_rows), self.device,
                        geom=self._geom, _valid_base=valid_base)
        self._snap = snap
        return snap

    # ------------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        return self._snap

    @property
    def epoch(self) -> int:
        return self._snap.epoch

    def durability_snapshot(self):
        raise unported("durability_snapshot (durable catalogs)", "A8")

    def append(self, features: np.ndarray) -> np.ndarray:
        """Seal ``features`` into a new delta segment; returns the new
        rows' global ids (the tail range — append order IS id order).
        O(new rows): no existing segment is touched or re-uploaded."""
        xnew = np.ascontiguousarray(np.asarray(features, np.float32))
        if xnew.ndim != 2:
            raise ValueError("append expects [m, D] features")
        with self._lock:
            snap = self._snap
            if xnew.shape[1] != snap.x.shape[1]:
                raise ValueError(
                    f"append width {xnew.shape[1]} != catalog width "
                    f"{snap.x.shape[1]}")
            m = xnew.shape[0]
            if m == 0:
                return np.empty(0, np.int64)
            n = snap.n
            seg = self._build_segment(xnew, n, shard=self._next_shard)
            self._next_shard = (self._next_shard + 1) % self.n_shards
            self._reserve(n + m)
            self._xbuf[n:n + m] = xnew
            self._vbuf[n:n + m] = True
            # appended rows are live: the live range only widens, so the
            # elementwise min/max stays exact (a rebuild's full reduction)
            frange = (np.minimum(snap.frange[0], xnew.min(0)),
                      np.maximum(snap.frange[1], xnew.max(0)))
            self._make_snapshot(snap.epoch + 1, self._xbuf[:n + m], frange,
                                snap.segments + (seg,),
                                self._vbuf[:n + m], snap.live_rows + m,
                                valid_base=snap._valid_dev)
            return np.arange(n, n + m, dtype=np.int64)

    def delete(self, ids) -> int:
        """Tombstone global ids; returns how many rows went from live to
        dead (re-deletes are idempotent). Geometry and device mirrors are
        untouched — only the validity mask changes."""
        ids = np.unique(np.asarray(list(ids), np.int64))
        with self._lock:
            snap = self._snap
            if len(ids) and (ids[0] < 0 or ids[-1] >= snap.n):
                raise ValueError(f"delete ids out of range [0, {snap.n})")
            newly = ids[snap.valid_host[ids]] if len(ids) else ids
            if len(newly) == 0:
                return 0
            # a new validity buffer: older snapshots keep viewing theirs
            vb = self._vbuf.copy()
            vb[newly] = False
            self._vbuf = vb
            valid_host = vb[:snap.n]
            live = snap.live_rows - len(newly)
            # a tombstoned row may have held a column extreme: only then
            # is the live range recomputed over the survivors
            frange = snap.frange
            xd = snap.x[newly]
            if ((xd == snap.frange[0]).any() or
                    (xd == snap.frange[1]).any()):
                lv = snap.x[valid_host]
                if len(lv):
                    frange = (lv.min(0), lv.max(0))
            self._make_snapshot(snap.epoch + 1, snap.x, frange,
                                snap.segments, valid_host,
                                live, prev_indexes=snap.indexes)
            return int(len(newly))

    def compact(self) -> dict:
        """Merge every sealed segment into ONE re-sorted segment and swap
        it in atomically. The build runs outside the mutation lock against
        a fixed snapshot, and on the host only (the new mirrors are lazy):
        appends, deletes and queries go on meanwhile. At the swap the
        merged segment replaces the segments it covered; any delta
        appended during the build survives as the new tail. Only one
        compaction runs at a time; a concurrent call returns
        ``{"skipped": True}``."""
        if not self._compact_lock.acquire(blocking=False):
            return {"skipped": True, "reason": "compaction in progress"}
        try:
            t0 = time.perf_counter()
            snap0 = self._snap
            if len(snap0.segments) <= 1:
                return {"skipped": True, "reason": "single segment",
                        "epoch": snap0.epoch}
            n0 = snap0.n
            merged = self._build_segment(snap0.x[:n0], 0, shard=0)
            with self._lock:
                cur = self._snap
                tail = tuple(s for s in cur.segments if s.offset >= n0)
                self._geom += 1        # old geometries' hints are void
                snap = self._make_snapshot(
                    cur.epoch + 1, cur.x, cur.frange, (merged,) + tail,
                    cur.valid_host, cur.live_rows,
                    valid_base=cur._valid_dev)
            return {"skipped": False, "epoch": snap.epoch,
                    "merged_segments": len(snap0.segments),
                    "merged_rows": n0, "tail_segments": len(tail),
                    "compact_s": time.perf_counter() - t0}
        finally:
            self._compact_lock.release()

    # ------------------------------------------------------------------
    # durability is ROADMAP A8
    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        raise unported("checkpoint (durable catalogs)", "A8")

    def close(self) -> None:
        """Nothing to flush: the catalog is not durable."""

    @classmethod
    def open(cls, path, **kw):
        raise unported("SegmentedCatalog.open (recovery)", "A8")

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        snap = self._snap
        return {
            "epoch": snap.epoch,
            "geom": snap.geom,
            "n_segments": len(snap.segments),
            "rows": snap.n,
            "rows_live": snap.live_rows,
            "rows_tombstoned": snap.n - snap.live_rows,
            "n_shards": self.n_shards,
            "shard_tail_segments": [
                sum(1 for s in snap.segments if s.shard == sh)
                for sh in range(self.n_shards)],
            "segments": [s.stats(snap.valid_host) for s in snap.segments],
            "durable": None,
        }
