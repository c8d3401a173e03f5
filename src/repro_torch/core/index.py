"""Blocked zone-map index — the static part of ``repro.core.index``.

Per feature subset: rows are ordered by a Morton (bit-interleaved) code
over the quantised subset dims, partitioned into fixed blocks, and each
block keeps per-dim [min, max] *zone maps*. A range query runs two dense
stages, both CUDA kernels on the card:

  prune : zone_prune(zones, boxes) -> surviving-block mask   (tiny)
  refine: box_scan_seg(rows of surviving blocks, boxes) -> counts

The build is the reference's numpy code, so ``perm``, ``rows``, ``zlo``
and ``zhi`` are byte-equal to it; the device mirrors are torch tensors
uploaded once to the index's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boxes import concat_box_arrays
from repro_torch.core.capacity import quantum_bucket
from repro_torch.device import resolve_device
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
    # lazily-populated global-row-id mirror [NB, block] int32 (-1 padding)
    _dev_gids: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)

    @property
    def n_blocks(self) -> int:
        return int(self.zlo.shape[0])

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(rows3 [NB, block, d'], zlo [NB, d'], zhi [NB, d']) on the
        index's device, uploaded ONCE and cached — no index bytes cross
        host<->device on the online path (only the tiny boxes do)."""
        if self._dev is None:
            rows3, zlo, zhi = (
                torch.from_numpy(np.ascontiguousarray(a, np.float32))
                for a in (self.rows, self.zlo, self.zhi))
            self._dev = (
                rows3.reshape(self.n_blocks, self.block, -1).to(self.device),
                zlo.to(self.device), zhi.to(self.device))
        return self._dev

    def device_gids(self) -> torch.Tensor:
        """[NB, block] int32 GLOBAL row id per (block, slot) — the
        permutation reshaped to the block grid, -1 on padding slots;
        uploaded once and cached like the other mirrors."""
        if self._dev_gids is None:
            g = np.ascontiguousarray(self.perm.astype(np.int32).reshape(
                self.n_blocks, self.block))
            self._dev_gids = torch.from_numpy(g).to(self.device)
        return self._dev_gids

    def device_bytes(self) -> dict:
        """Actual RESIDENT device-mirror bytes by kind (0 for mirrors not
        yet uploaded)."""
        out = {"rows": 0, "zones": 0, "gids": 0}
        if self._dev is not None:
            rows3, zlo, zhi = self._dev
            out["rows"] = int(rows3.nbytes)
            out["zones"] = int(zlo.nbytes) + int(zhi.nbytes)
        if self._dev_gids is not None:
            out["gids"] = int(self._dev_gids.nbytes)
        return out


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
    lo = concat_box_arrays([lo, np.full((pad, d), np.inf, np.float32)])
    hi = concat_box_arrays([hi, np.full((pad, d), -np.inf, np.float32)])
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
