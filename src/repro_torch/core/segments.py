"""Live catalog ingestion — ``repro.core.segments`` on the port: a
segmented, LSM-style index with an append / delete / compact lifecycle,
durable when given a ``persist_dir``.

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
query, so a background compaction does host work only (its durable
checkpoint is file I/O).

Durability (DESIGN.md §15): with ``persist_dir`` set, every effective
mutation is write-ahead-logged (checksummed, fsync policy per ``sync``)
BEFORE the snapshot swap, ``checkpoint()`` commits the sealed segment
set through a two-phase manifest flip, and ``SegmentedCatalog.open()``
recovers crash-consistently: the WAL tail replays through the real
append / delete paths, so the recovered catalog keeps the bitwise
contract. The machinery is ``core/persist.py``, whose file format is the
reference's, so a directory written by either package recovers in the
other. The fault seams (``faults``: ``append``, ``delete``, ``compact``,
``wal_commit``, and the durability layer's) fire before any state
changes, as in the reference.
"""
from __future__ import annotations

import copy
import functools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import persist as persistmod
from repro_torch.core.errors import PersistenceError, RecoveryError
from repro_torch.core.index import ZoneMapIndex, build_indexes, shard_offsets
from repro_torch.device import resolve_device, to_device_async
from repro_torch.kernels import ops as kops


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
        out = {"rows": 0, "zones": 0, "gids": 0, "inv_perm": 0,
               "quantized": 0}
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


def _rows_from_perm(feats: np.ndarray, dims: np.ndarray,
                    perm: np.ndarray) -> np.ndarray:
    """One subset's Morton-ordered rows rebuilt from a segment's features
    and the subset's permutation, bitwise build_index's ``sub[perm]``
    with +inf on the padding slots (perm -1)."""
    real = perm >= 0
    rows = np.ascontiguousarray(feats[:, dims]).take(
        np.where(real, perm, 0), axis=0)
    rows[~real] = np.inf
    return rows


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
    mirrors go (default CUDA). ``persist_dir`` makes the catalog durable
    (``sync``: "always", "batch" or "none", core/persist.py); ``faults``
    is a fault injector (serve/faults.py) or None."""

    # spare buffer rows beyond the catalog size, as a fraction (plus a
    # floor): steady appends write into the tail without a regrow copy
    _HEADROOM_FRAC = 4      # 1/4 = 25%
    _HEADROOM_MIN = 4096

    def __init__(self, features: np.ndarray, subsets: np.ndarray, *,
                 block: int = 1024, n_shards: int = 1, faults=None,
                 persist_dir=None, sync: str = "batch", device=None):
        x = np.ascontiguousarray(np.asarray(features, np.float32))
        self._init_state(subsets, block, n_shards, device, geom=0)
        # duck-typed fault injector: the seams fire BEFORE any state
        # change, so a fired fault leaves the catalog bitwise untouched
        self.faults = faults
        if persist_dir is not None:
            if persistmod.has_state(persist_dir):
                raise PersistenceError(
                    f"{persist_dir} already holds a durable catalog — "
                    "use SegmentedCatalog.open() to recover it instead "
                    "of silently overwriting")
            self.persist = persistmod.Persistence(persist_dir, sync=sync,
                                                  faults=faults)
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
        # genesis checkpoint: the manifest carries the config recovery
        # needs (subsets, block, shards), so a durable catalog is
        # reopenable from its very first mutation onward
        if self.persist is not None:
            self.checkpoint()

    def _init_state(self, subsets, block, n_shards, device, geom) -> None:
        self.subsets = np.asarray(subsets)
        self.block = int(block)
        self.n_shards = max(int(n_shards), 1)
        self.device = resolve_device(device)
        self.faults = None
        self.persist = None
        self.recovery = None                   # RecoveryReport after open()
        self._lock = threading.Lock()          # mutation serialisation
        self._compact_lock = threading.Lock()  # one compaction at a time
        self._ckpt_lock = threading.Lock()     # one checkpoint at a time
        self._geom = int(geom)                 # compaction generation
        self._lsn = 0                          # last assigned WAL lsn

    def _alloc(self, n: int, d: int) -> None:
        cap = n + max(n // self._HEADROOM_FRAC, self._HEADROOM_MIN)
        self._xbuf = np.empty((cap, d), np.float32)
        self._vbuf = np.ones(cap, bool)

    @classmethod
    def _from_state(cls, x, subsets, segments, valid, frange, *, block: int,
                    epoch: int, geom: int, n_shards: int, next_shard: int,
                    device=None) -> "SegmentedCatalog":
        """A catalog over sealed segments built elsewhere (core/convert.
        catalog_from_arrays, or recovery from disk): ``segments`` are
        (offset, n_rows, shard, [ZoneMapIndex per subset]) in offset
        order."""
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
    def _fault(self, site: str) -> None:
        if self.faults is not None:
            self.faults.check(site)

    def snapshot(self) -> Snapshot:
        return self._snap

    @property
    def epoch(self) -> int:
        return self._snap.epoch

    def durability_snapshot(self) -> Optional[dict]:
        """Consistent durability ledger: (lsn, WAL/checkpoint stats)
        read under the mutation lock, where appends and deletes assign
        the LSN and write the WAL record, so the pair is never torn. None
        for a non-durable catalog. The caller owns the copy."""
        with self._lock:
            if self.persist is None:
                return None
            return {"sync": self.persist.sync, "lsn": self._lsn,
                    **copy.deepcopy(self.persist.stats)}

    def _log(self, op: str, payload) -> None:
        """Assign the next LSN and write its WAL record (under the
        mutation lock) BEFORE any in-memory state changes: one record is
        one epoch, the invariant recovery's epoch arithmetic rests on. A
        rolled-back record releases its LSN (no gap for recovery to
        refuse); the ``wal_commit`` seam is the crash point between the
        durable record and the snapshot swap."""
        self._lsn += 1
        if self.persist is None:
            return
        write = (self.persist.log_append if op == "append"
                 else self.persist.log_delete)
        try:
            write(self._lsn, payload)
        except Exception:
            self._lsn -= 1
            raise
        self._fault("wal_commit")

    def append(self, features: np.ndarray) -> np.ndarray:
        """Seal ``features`` into a new delta segment; returns the new
        rows' global ids (the tail range — append order IS id order).
        O(new rows): no existing segment is touched or re-uploaded."""
        xnew = np.ascontiguousarray(np.asarray(features, np.float32))
        if xnew.ndim != 2:
            raise ValueError("append expects [m, D] features")
        self._fault("append")   # before any state change: atomic failure
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
            # durability first; the m == 0 no-op above takes no LSN
            self._log("append", xnew)
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
        self._fault("delete")   # before any state change: atomic failure
        with self._lock:
            snap = self._snap
            if len(ids) and (ids[0] < 0 or ids[-1] >= snap.n):
                raise ValueError(f"delete ids out of range [0, {snap.n})")
            newly = ids[snap.valid_host[ids]] if len(ids) else ids
            if len(newly) == 0:
                return 0
            # log only the effective deletions: replay re-applies exactly
            # the live -> dead transitions, and re-deletes take no LSN
            self._log("delete", newly)
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
        ``{"skipped": True}``. A durable catalog then checkpoints the new
        segment set (file I/O only, on the calling thread)."""
        if not self._compact_lock.acquire(blocking=False):
            return {"skipped": True, "reason": "compaction in progress"}
        try:
            t0 = time.perf_counter()
            snap0 = self._snap
            if len(snap0.segments) <= 1:
                return {"skipped": True, "reason": "single segment",
                        "epoch": snap0.epoch}
            n0 = snap0.n
            # fault seam BEFORE the merge build: a fired fault aborts the
            # attempt with the old snapshot serving and ``_geom`` as it was
            self._fault("compact")
            merged = self._build_segment(snap0.x[:n0], 0, shard=0)
            with self._lock:
                cur = self._snap
                tail = tuple(s for s in cur.segments if s.offset >= n0)
                self._geom += 1        # old geometries' hints are void
                snap = self._make_snapshot(
                    cur.epoch + 1, cur.x, cur.frange, (merged,) + tail,
                    cur.valid_host, cur.live_rows,
                    valid_base=cur._valid_dev)
            if self.persist is not None:
                # the two-phase commit: phase 1 lands the merged and tail
                # segments' column files, phase 2 flips the manifest. A
                # crash at either phase recovers the pre-compaction state
                # from the previous manifest and the whole WAL tail —
                # query-identical, results do not depend on segmentation
                # — and phase-1 orphans are removed on reopen
                self.checkpoint()
            return {"skipped": False, "epoch": snap.epoch,
                    "merged_segments": len(snap0.segments),
                    "merged_rows": n0, "tail_segments": len(tail),
                    "compact_s": time.perf_counter() - t0}
        finally:
            self._compact_lock.release()

    # ------------------------------------------------------------------
    # durability: checkpoint / close / open
    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        """Write the current snapshot as a durable checkpoint: every
        sealed segment's column files (phase 1), then the manifest naming
        that segment set, epoch and WAL horizon (phase 2, the atomic
        commit point). It runs against a (snapshot, lsn) pair read under
        the mutation lock, so mutations meanwhile land in the WAL past the
        horizon and replay on recovery."""
        if self.persist is None:
            raise PersistenceError(
                "catalog has no persist_dir — nothing to checkpoint to")
        with self._ckpt_lock:
            t0 = time.perf_counter()
            with self._lock:
                snap = self._snap
                lsn = self._lsn
                next_shard = self._next_shard
            entries = [self.persist.write_segment(
                snap.x[s.offset:s.offset + s.n_rows], s.indexes,
                offset=s.offset, rows=s.n_rows, shard=s.shard,
                block=self.block) for s in snap.segments]
            config = {"d": int(self._xbuf.shape[1]),
                      "block": self.block, "n_shards": self.n_shards,
                      "subsets": np.asarray(self.subsets).tolist()}
            mid = self.persist.commit_manifest(
                epoch=snap.epoch, geom=snap.geom, lsn=lsn,
                next_shard=next_shard, n_rows=snap.n,
                live_rows=snap.live_rows, frange=snap.frange,
                valid=snap.valid_host, config=config, segments=entries)
            self.persist.stats["checkpoints"] += 1
            return {"manifest_id": mid, "epoch": snap.epoch, "lsn": lsn,
                    "segments": len(entries),
                    "checkpoint_s": time.perf_counter() - t0}

    def close(self) -> None:
        """Flush and fsync the WAL and release the directory: a
        ``sync="none"`` catalog becomes durable here, the other modes
        already were. Nothing to do for a catalog without persist_dir."""
        if self.persist is not None:
            self.persist.close()

    @classmethod
    def open(cls, path, *, faults=None, sync: str = "batch",
             strict: bool = True, device=None) -> "SegmentedCatalog":
        """Crash-consistent recovery onto ``device`` (default CUDA): load
        the newest valid manifest, rebuild its segments bitwise from the
        column files, replay the WAL tail through the real append /
        delete paths, then re-arm durability and the fault seams. The
        device mirrors stay lazy: the first query uploads them.

        Damage (torn or corrupt bytes) is quarantined and the salvaged
        prefix recovered; with ``strict=True`` it raises ``RecoveryError``
        carrying the salvaged catalog (``err.catalog``) and the report
        (``err.report``), never folding corruption silently into
        results."""
        # hold the single-writer lock across recover -> replay -> re-arm
        # (reentrant in-process: recover() and the new Persistence share
        # this hold)
        with persistmod.DirLock(path):
            state = persistmod.recover(path, faults=faults)
            cat = cls._from_recovered(path, state, sync=sync, faults=faults,
                                      device=device)
        if strict and not state.report.clean:
            raise RecoveryError(
                f"recovered {path} with damage: "
                + "; ".join(state.report.errors),
                report=state.report, catalog=cat)
        return cat

    @classmethod
    def _from_recovered(cls, path, state, *, sync: str, faults=None,
                        device=None) -> "SegmentedCatalog":
        cfg = state.config
        subsets = np.asarray(cfg["subsets"])
        block = int(cfg["block"])
        device = resolve_device(device)
        x = np.empty((int(state.n_rows), int(cfg["d"])), np.float32)
        segments = []
        workers = max(1, min(len(subsets), os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as pool:
            for entry, feats, cols in sorted(state.segments,
                                             key=lambda t: t[0]["offset"]):
                o, m = int(entry["offset"]), int(entry["rows"])
                x[o:o + m] = feats

                def rebuild(k, feats=feats, cols=cols, m=m):
                    perm, zlo, zhi = cols[k]
                    dims = np.asarray(subsets[k])
                    return ZoneMapIndex(
                        dims, np.asarray(perm),
                        _rows_from_perm(feats, dims, perm),
                        np.asarray(zlo, np.float32),
                        np.asarray(zhi, np.float32), block, m, k,
                        device=device)
                # the subsets at once, as build_indexes builds them: the
                # gathers release the interpreter lock
                idxs = list(pool.map(rebuild, range(len(cols))))
                segments.append((o, m, int(entry["shard"]), idxs))
        self = cls._from_state(
            x, subsets, segments, state.valid,
            (state.frange_lo, state.frange_hi), block=block,
            epoch=int(state.epoch), geom=int(state.geom),
            n_shards=int(cfg["n_shards"]),
            next_shard=int(state.next_shard), device=device)
        self.recovery = state.report
        self._lsn = int(state.lsn)
        # replay the WAL tail through the real mutation paths, with
        # durability and the seams off (the records are durable already,
        # and replay must be deterministic): each record bumps the epoch
        # and moves frange / validity exactly as the original did
        for rec in state.tail:
            if rec.op == "append":
                self.append(rec.features)
            else:
                self.delete(rec.ids)
        # re-arm for live operation: new records continue at the next
        # LSN in a fresh file
        self.persist = persistmod.Persistence(path, sync=sync,
                                              faults=faults)
        self.faults = faults
        return self

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
            "durable": (None if self.persist is None else
                        {"sync": self.persist.sync, "lsn": self._lsn,
                         **self.persist.stats}),
        }
