"""Device ops of the engine's main path — counterpart of the main-path
part of ``repro.kernels.ops``.

Dispatch follows the tensors: on CUDA tensors the kernel stages launch
the hand-written CUDA kernels (``kernels/zone_prune.py``,
``kernels/box_scan.py``, ``kernels/l2dist.py``,
``kernels/flash_attention.py``) or raise; only tensors on
the CPU take the plain PyTorch versions in ``kernels/ref.py``, and
tensors on the ``meta`` device (a dry run) the kernels' shape-only
operators in ``kernels/meta.py``. No TPU
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
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import ref as kref
from repro_torch.kernels import zone_prune as _zone_prune

TILE_INVALID = np.int32(2 ** 31 - 1)     # padding key; sorts past all ids


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def zone_prune(zlo, zhi, blo, bhi) -> torch.Tensor:
    """Overlap mask [NZ, B] bool."""
    if _on_cpu(zlo):
        return kref.zone_prune_ref(zlo, zhi, blo, bhi)
    if _on_meta(zlo):
        return _meta.call("zone_prune", zlo, zhi, blo, bhi)
    return _zone_prune.zone_prune(zlo, zhi, blo, bhi)


def zone_hits(zlo, zhi, blo, bhi) -> torch.Tensor:
    """[NZ] bool: zone_prune(...).any(1)."""
    if _on_cpu(zlo):
        return kref.zone_hits_ref(zlo, zhi, blo, bhi)
    if _on_meta(zlo):
        return _meta.call("zone_hits", zlo, zhi, blo, bhi)
    return _zone_prune.zone_hits(zlo, zhi, blo, bhi)


def zone_candidates(zlo, zhi, blo, bhi, capacity: int):
    """(cand [capacity] int32, n_hit [] int32): the first ``capacity``
    zones that overlap any box, ascending, 0-filled past n_hit, and their
    count before the cut (one launch on the card)."""
    if _on_cpu(zlo):
        return kref.zone_candidates_ref(zlo, zhi, blo, bhi, capacity)
    if _on_meta(zlo):
        return _meta.call("zone_candidates", zlo, zhi, blo, bhi,
                          int(capacity))
    return _zone_prune.zone_candidates(zlo, zhi, blo, bhi, capacity)


def box_scan(x, lo, hi) -> torch.Tensor:
    """Membership counts [N] int32 for rows x against boxes (lo, hi]."""
    if _on_cpu(x):
        return kref.box_scan_ref(x, lo, hi)
    if _on_meta(x):
        return _meta.call("box_scan", x, lo, hi)
    return _box_scan.box_scan(x, lo, hi)


def box_scan_pruned(rows3, cand, n_hit, lo, hi) -> torch.Tensor:
    """[NB * block] int32: the box counts of the blocks rows3[cand[s]],
    s < min(n_hit, C), read where they lie; 0 in every other block."""
    if _on_cpu(rows3):
        return kref.box_scan_pruned_ref(rows3, cand, n_hit, lo, hi)
    if _on_meta(rows3):
        return _meta.call("box_scan_pruned", rows3, cand, n_hit, lo, hi)
    return _box_scan.box_scan_pruned(rows3, cand, n_hit, lo, hi)


def l2dist(x, q) -> torch.Tensor:
    """Squared L2 distance matrix [N, Q] f32."""
    if _on_cpu(x):
        return kref.l2dist_ref(x, q)
    if _on_meta(x):
        return _meta.call("l2dist", x, q)
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


def _flash_forward(q, k, v, causal: bool) -> torch.Tensor:
    """Kernel-layout attention: the CUDA kernel, or on the CPU its plain
    version."""
    if _on_cpu(q):
        return kref.flash_attention_ref(q, k, v, causal=causal)
    if _on_meta(q):
        return _meta.flash_forward(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def _flash_forward_lse(q, k, v, causal: bool):
    """``_flash_forward`` that also returns each row's log-sum-exp, lse
    [BH, S * G] float32 (the forward kernel's epilogue writes it)."""
    if _on_cpu(q):
        return kref.flash_attention_ref(q, k, v, causal=causal,
                                        return_lse=True)
    if _on_meta(q):
        return _meta.flash_forward(q, k, v, causal, return_lse=True)
    return _flash.flash_attention(q, k, v, causal=causal, return_lse=True)


def _flash_backward(q, k, v, out, lse, dout, causal: bool):
    """Kernel-layout attention gradients (dq, dk, dv) from the forward's
    out and lse: the CUDA backward kernel, or on the CPU its plain
    version."""
    if _on_cpu(q):
        return kref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            causal=causal)
    if _on_meta(q):
        return _meta.call("flash_attention_bwd", q, k, v, out, lse, dout,
                          bool(causal))
    return _flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                      causal=causal)


class _FlashAttention(torch.autograd.Function):
    """Kernel-layout attention with a backward: the forward is
    ``_flash_forward_lse`` (the CUDA kernel on the card), run without
    grad, saving q, k, v, out and lse (O(S), the reference's custom VJP's
    residuals); the backward is ``_flash_backward`` (the CUDA backward
    kernel on the card), which recomputes the scores, and counts
    ``_flash.backward_calls``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _flash_forward_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, dout.contiguous(),
                                     ctx.causal)
        _flash.backward_calls += 1
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """GQA attention in model layout: q [B, S, Hq, D]; k/v [B, S, Hkv, D]
    -> [B, S, Hq, D]. Repacks to the kernel's layout and back, as the
    reference wrapper does; the kernel takes any S (no chunk sizes, no
    padding). Where autograd records (grad enabled and an input requires
    grad) it runs through ``_FlashAttention``, so the repacking
    differentiates by itself; otherwise it is one forward call that saves
    nothing."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qk, kk, vk = kernel_layout(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (qk, kk, vk)):
        out = _FlashAttention.apply(qk, kk, vk, causal)
    else:
        out = _flash_forward(qk, kk, vk, causal)
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
    if _on_meta(x):
        return _meta.call("box_scan_seg", x, lo, hi, onehot)
    return _box_scan.box_scan_seg(x, lo, hi, onehot)


def box_scan_seg_gather(rows3, cand, n_hit, lo, hi, onehot) -> torch.Tensor:
    """box_scan_seg over rows3[cand] -> [C * block, Q] int32, zero on
    every slot >= n_hit."""
    if _on_cpu(rows3):
        return kref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot)
    if _on_meta(rows3):
        return _meta.call("box_scan_seg_gather", rows3, cand, n_hit, lo,
                          hi, onehot)
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


def batch_box_membership(x, lo, hi, valid) -> torch.Tensor:
    """Per-set membership counts [T, N] int32: counts[t, i] = number of
    valid boxes of set t containing row i of sample batch t.

    x: [T, N, d']; lo/hi: [T, B, d'] half-open boxes; valid: [T, B] bool
    (invalid slots never match). The same membership predicate as
    box_scan, batched over T: the batched trainer's selection stage scores
    every candidate model on its own training samples with it."""
    inside = ((x[:, :, None, :] > lo[:, None, :, :])
              & (x[:, :, None, :] <= hi[:, None, :, :]))   # [T, N, B, d']
    return (inside.all(-1) & valid[:, None, :]).sum(-1, dtype=torch.int32)


def accumulate_scores(scores, counts, cand, inv_perm, valid=None, *,
                      nb: int):
    """Add one subset's fused counts into the dense [N, Q] int32 score
    buffer, in ORIGINAL row order (the dense oracle's accumulation).

    counts: [C, block, Q] from fused_query (overflow slots zeroed); cand:
    [C] gathered block ids; inv_perm: [N] int32 original-row -> Morton
    position (ZoneMapIndex.device_inv_perm); nb: the index's block count;
    valid: optional [N] int32/bool row-liveness mask — a tombstoned row's
    increment is zeroed here, so it carries score 0 into every later stage.
    A gather, not a scatter: a [nb + 1] block->slot table (the lowest
    slot holding each block: ``.at[cand].min`` as an "amin" scatter, so a
    genuine survivor beats the zero-count fill slots that alias block 0)
    lets every row pull its count through the inverse permutation. Rows
    of blocks absent from ``cand`` index past the counts and take 0 (the
    reference's ``mode="fill"``, here an explicit in-range mask)."""
    c, block, q = counts.shape
    dev = counts.device
    slot = torch.full((nb + 1,), c, dtype=torch.int32, device=dev)
    slot = slot.scatter_reduce(0, cand.long(), torch.arange(
        c, dtype=torch.int32, device=dev), "amin")
    idx = slot[(inv_perm // block).long()] * block + inv_perm % block
    inside = idx < c * block
    inc = counts.reshape(c * block, q)[
        torch.where(inside, idx, 0).long()]
    inc = inc * inside[:, None].to(inc.dtype)
    if valid is not None:
        inc = inc * valid[:, None].to(inc.dtype)
    return scores + inc


# ----------------------------------------------------------------------
# Survivor-sparse score tiles (see repro.kernels.ops for the design)
# ----------------------------------------------------------------------

def tile_candidates(counts, cand, gids_blocks, valid=None):
    """Label fused_query's gathered tiles with global row ids.

    counts: [C, block, Q]; cand: [C] gathered block ids (always in range:
    fused_query 0-fills); gids_blocks: [NB, block] int32 global row id per
    (block, slot), -1 on padding slots; valid: optional [N] row-liveness
    mask in global id space (tombstoned rows are dropped here, the sparse
    form of accumulate_scores' masked increment). Returns (gids [C, block]
    int32, ok [C, block] bool) — ok marks real, live rows with a nonzero
    count in at least one query."""
    gids = gids_blocks.index_select(0, cand.long())
    real = gids >= 0
    ok = (counts != 0).any(-1) & real
    if valid is not None:
        # padding slots (-1) read row 0 and are already dropped by ``real``
        ok &= valid[torch.where(real, gids, 0).long()].to(torch.bool)
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


# ----------------------------------------------------------------------
# Dense device ranking (the dense oracle's rank stage)
# ----------------------------------------------------------------------

# rank_topk's method on CUDA tensors when the caller names none: the
# fastest of the three on an H100 at the main path's [1,048,576, 8]
# buffer, k = 128 (chip_smoke.py's dense phase, rank_topk; PERF.md);
# "topk" falls back to "sort" where its composed key would overflow int32
CUDA_RANK_METHOD = "topk"


def rank_topk(scores, train_ids, *, k: int, score_bound=None,
              method=None, scores_transposed: bool = False):
    """Device ranking of a dense score buffer: mask training rows, take
    the top-k scoring rows; only [Q, k] needs to reach the host.

    scores: [Q, N] int32 ([N, Q] with ``scores_transposed``); train_ids:
    [Q, T] int32 rows to exclude per query (padded with N, which is
    dropped); score_bound: a host-known upper bound on any score (the
    query's total box count). Order: descending score, ascending row id,
    ties across the k boundary included — the host oracle's stable sort
    of -score. Three methods give the same result:

    * "topk": key = score * N + (N - 1 - id), unique per row, through one
      ``torch.topk``; needs (score_bound + 1) * N < 2**31.
    * "sort": a stable sort of -score over rows in id order (the
      reference's two-key sort), the first k columns.
    * "threshold": binary-search the k-th largest score in ``sbits``
      count passes, extract the rows above and at it by a two-level
      cumsum + searchsorted compaction (ascending id), then order the
      <= 2k candidates.

    The CPU default is "threshold" (the reference's off-TPU default), the
    CUDA default ``CUDA_RANK_METHOD``. Rows with score <= 0 are invalid:
    id -1, score 0, not counted in n_valid.

    Returns (ids [Q, k] int32, scores [Q, k] int32, n_valid [Q] int32)."""
    n = scores.shape[0] if scores_transposed else scores.shape[1]
    k = min(int(k), n)
    topk_ok = score_bound is not None and (score_bound + 1) * n < 2 ** 31
    if method is None:
        method = "threshold" if _on_cpu(scores) else CUDA_RANK_METHOD
        if method == "topk" and not topk_ok:
            method = "sort"
    if scores_transposed:
        scores = scores.T
    if method == "threshold":
        # 2**sbits must exceed any score; without a bound assume 30 bits
        sbits = int(score_bound).bit_length() if score_bound else 30
        return _rank_threshold(scores, train_ids, k=k,
                               sbits=min(max(sbits, 1), 30))
    if method == "topk":
        if not topk_ok:
            raise ValueError("rank_topk: 'topk' needs an int32-safe "
                             "composed key; use 'sort' or 'threshold'")
        return _rank_topk_compose(scores, train_ids, k=k)
    if method != "sort":
        raise ValueError(f"unknown rank method {method!r}")
    return _rank_sort(scores, train_ids, k=k)


def shard_local_topk(scores, train_ids, offset: int, n_local: int, *,
                     k: int, score_bound=None, method=None):
    """Shard-local ranking stage of the sharded path: rank ONE shard's
    [Nloc, Q] score buffer (rows past ``n_local`` score 0) with rank_topk
    and remap the winners to GLOBAL ids. train_ids: [Q, T] GLOBAL ids to
    exclude; those in [offset, offset + n_local) map to local ids by
    subtraction, every other one to Nloc, which rank_topk drops. Returns
    (global ids [Q, k'] int32, -1 invalid; scores [Q, k']; n_valid [Q]),
    k' = min(k, Nloc), so merge_topk orders score ties by global id."""
    nloc = scores.shape[0]
    t = torch.where((train_ids >= offset) & (train_ids < offset + n_local),
                    train_ids - offset, nloc).to(torch.int32)
    ids, sc, nv = rank_topk(scores, t, k=k, score_bound=score_bound,
                            method=method, scores_transposed=True)
    gids = torch.where(ids >= 0, ids + int(offset), -1)
    return gids.to(torch.int32), sc, nv


def merge_topk(ids, scores, *, k: int):
    """Cross-shard merge of per-shard top-k lists on the device.

    ids: [S, Q, ks] int32 GLOBAL ids (-1 invalid); scores: [S, Q, ks]
    int32 (> 0 valid, 0 invalid). Returns (ids [Q, k'], scores [Q, k'],
    n_valid [Q]) int32 with k' = min(k, S * ks), in the pinned order:
    descending score, ascending global id on ties (ties at the global
    k-th score included). One int64 key (-score) * 2^32 + id sorts it;
    invalid slots take the id 2^31 - 1 and score 0, so they sort past
    every valid candidate and come back as id -1."""
    s, q, ks = ids.shape
    fids = ids.transpose(0, 1).reshape(q, s * ks)
    fsc = scores.transpose(0, 1).reshape(q, s * ks)
    key_id = torch.where(fsc > 0, fids, int(TILE_INVALID))
    key = (-fsc.to(torch.int64)) * (1 << 32) + key_id.to(torch.int64)
    kk = min(int(k), s * ks)
    top = torch.sort(key, dim=1).values[:, :kk]
    out_scores = (-(top >> 32)).to(torch.int32)
    out_ids = torch.where(out_scores > 0, (top & 0xFFFFFFFF).to(torch.int32),
                          -1)
    return (out_ids, out_scores,
            (out_scores > 0).sum(1, dtype=torch.int32))


def _mask_training(scores, train_ids):
    """scores [Q, N] with each query's training rows set to 0; ids >= N
    (the padding) go to a dump column that is cut off."""
    nq, n = scores.shape
    tid = train_ids.long()
    tid = torch.where((tid >= 0) & (tid < n), tid, n)
    out = torch.cat([scores, torch.zeros((nq, 1), dtype=scores.dtype,
                                         device=scores.device)], 1)
    out.scatter_(1, tid, 0)
    return out[:, :n]


def _rank_topk_compose(scores, train_ids, *, k: int):
    n = scores.shape[1]
    masked = _mask_training(scores, train_ids)
    ids = torch.arange(n, dtype=torch.int32, device=scores.device)
    # score > 0  <=>  key >= n, so zero rows never rank as valid
    key = masked * n + (n - 1 - ids)[None, :]
    top = torch.topk(key, k, dim=1, largest=True, sorted=True).values
    valid = top >= n
    out_scores = torch.where(valid, top // n, 0)
    out_ids = torch.where(valid, (n - 1) - top % n, -1)
    return (out_ids.to(torch.int32), out_scores.to(torch.int32),
            valid.sum(1, dtype=torch.int32))


def _rank_sort(scores, train_ids, *, k: int):
    masked = _mask_training(scores, train_ids)
    # rows arrive in id order, so a stable sort of -score is the two-key
    # (-score, id) sort
    sneg, sids = torch.sort(-masked, dim=1, stable=True)
    out_scores, out_ids = -sneg[:, :k], sids[:, :k]
    valid = out_scores > 0
    out_ids = torch.where(valid, out_ids, -1)
    return (out_ids.to(torch.int32), out_scores.to(torch.int32),
            valid.sum(1, dtype=torch.int32))


_RANK_CHUNK = 64     # rows per extraction chunk (see _first_k_set_rows)


def _first_k_set_rows(mask, k: int):
    """ids of the first k set rows of mask [Q, n], ascending; n where
    exhausted. Per-chunk counts place each of the k targets in its chunk
    by a binary search over their cumsum, then a short cumsum over only
    the k gathered chunks finds the offset inside it."""
    nq, n = mask.shape
    ch = _RANK_CHUNK
    g = -(-n // ch)
    dev = mask.device
    mp = torch.cat([mask, torch.zeros((nq, g * ch - n), dtype=mask.dtype,
                                      device=dev)], 1)
    mc = mp.reshape(nq, g, ch)
    cnt = mc.sum(-1, dtype=torch.int32)                       # [Q, g]
    cum = torch.cumsum(cnt, -1, dtype=torch.int32)            # [Q, g]
    tgt = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    cj = torch.searchsorted(cum, tgt[None].expand(nq, k).contiguous()
                            ).to(torch.int32)                 # [Q, k]
    prev = torch.where(cj > 0, torch.gather(
        cum, 1, (cj - 1).clamp(min=0).long()), 0)
    r = tgt[None] - prev                                      # rank in chunk
    sel = torch.gather(mc, 1, cj.clamp(max=g - 1).long()[..., None]
                       .expand(nq, k, ch))                    # [Q, k, ch]
    hit = torch.cumsum(sel, -1, dtype=torch.int32) >= r[..., None]
    loc = torch.argmax(hit.to(torch.uint8), -1).to(torch.int32)
    return torch.where(cj < g, cj * ch + loc, n)


def _rank_threshold(scores, train_ids, *, k: int, sbits: int):
    nq, n = scores.shape
    dev = scores.device
    masked = _mask_training(scores, train_ids)
    npos = (masked > 0).sum(1, dtype=torch.int32)
    kq = npos.clamp(max=k)                     # results this query yields
    # binary search the k-th largest positive score t:
    # invariant count(masked >= lo) >= kq > count(masked >= hi)
    lo = torch.ones(nq, dtype=torch.int32, device=dev)
    hi = torch.full((nq,), 1 << sbits, dtype=torch.int32, device=dev)
    for _ in range(sbits):
        mid = (lo + hi) // 2
        ok = (masked >= mid[:, None]).sum(1, dtype=torch.int32) >= kq
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    t = lo
    gt = masked > t[:, None]
    eq = masked == t[:, None]
    i_gt = _first_k_set_rows(gt, k)            # all above-threshold rows
    i_eq = _first_k_set_rows(eq, k)            # threshold ties, id order
    m_cnt = gt.sum(1, dtype=torch.int32)       # < kq by threshold choice
    keep_eq = (torch.arange(k, dtype=torch.int32, device=dev)[None, :]
               < (kq - m_cnt)[:, None])
    cand_ids = torch.cat([i_gt, torch.where(keep_eq, i_eq, n)], 1)
    valid = cand_ids < n
    cs = torch.where(valid, torch.gather(
        masked, 1, cand_ids.clamp(max=n - 1).long()), -1)
    # order the <= 2k candidates by (-score, id) as one int64 key
    key = ((-cs).to(torch.int64) * (1 << 32)
           + torch.where(valid, cand_ids, n))
    sk = torch.sort(key, dim=1).values[:, :k]
    out_scores = (-(sk >> 32)).clamp(min=0).to(torch.int32)
    out_ids = torch.where(out_scores > 0, (sk & 0xFFFFFFFF).to(torch.int32),
                          -1)
    return out_ids, out_scores, kq
