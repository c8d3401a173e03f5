"""Decision branches (DBranch / DBEns) — the paper's classifier.

A decision branch model is a *union of boxes*: only root->positive-leaf
paths of a CART-style tree are materialised, each path's conjunction of
orthogonal splits being one box. Index-awareness restricts every box to
the dims of ONE pre-built feature subset, so inference is a handful of
range queries against that subset's index (paper §2 / VLDB'23 [8]).

Two trainers, same algorithm, as in ``repro.core.dbranch``:
  * fit_dbranch — numpy, recursive: a copy of the reference's
    (``_best_split`` through ``fit_dbens``), the correctness oracle and
    the ``use_jax_fit=False`` trainer.
  * fit_dbranch_dev / fit_select — the fixed-shape worklist trainer of
    ``fit_dbranch_jax`` / ``fit_select_jax`` in eager torch ops on the
    engine's device, batched over a leading lane axis where the
    reference vmaps. A whole batch window trains as one program with two
    host syncs, and each model's winning subset is picked on the device.

Both share the exact float32 split/expansion arithmetic, so their boxes
match bitwise. The device trainer must stay eager torch: every score,
midpoint and nudge is one IEEE f32 op (torch's eager division is
correctly rounded; no ``addcdiv``/``addcmul``, no compiler that could
contract ``a*b + c`` into an FMA).

Box expansion: positive-leaf boxes are tightened to the positive bounding
box, then each face is pushed halfway toward the nearest excluded
negative (or to the node region / feature range). This recovers the
recall-friendly behaviour the engine needs to *discover* new objects.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.boxes import BoxSet
from repro_torch.device import to_device_async
from repro_torch.kernels import ops as kops

# DBEns draws this many candidate subsets per ensemble member
DBENS_SUBSET_CANDIDATES = 5

# ======================================================================
# numpy reference trainer
# ======================================================================


def _best_split(x: np.ndarray, y: np.ndarray) -> Tuple[int, float, float]:
    """x: [n, d'] node samples; y: [n] 0/1. Returns (dim, thresh, gain).

    Prefix-sum Gini: per dim, one stable sort + cumulative label counts
    give every candidate threshold's split stats at once — O(n log n · d)
    instead of recomputing the full gain per threshold (O(n² · d)).
    Thresholds are midpoints 0.5 * (xv[i] + xv[i+1]) between consecutive
    distinct values. The maximised score is h = pl²/nl + pr²/nr — an
    affine transform of the negated weighted child Gini, so the argmax is
    the classic CART split — and ``gain = h - p²/n`` is positive iff the
    split improves on the parent. All comparisons run on float32 values
    built from two exact integer-valued multiplies, two divisions and one
    add (no fusable mul+add, so XLA cannot FMA-contract them), which lets
    the JAX trainer reproduce the scores bitwise and parity tests compare
    boxes, not just predictions. Tie-break: highest h, then lowest dim,
    then lowest threshold — the order a strict-improvement scan visits.
    """
    n, nd = x.shape
    if n < 2:
        return -1, 0.0, 0.0
    yf = np.asarray(y, np.float32)
    n_tot = np.float32(n)
    p_tot = np.float32(yf.sum(dtype=np.float32))
    parent = p_tot * p_tot / n_tot
    half = np.float32(0.5)
    nl = np.arange(1, n, dtype=np.float32)
    nr = n_tot - nl
    best_dim, best_t, best_h = -1, np.float32(0.0), -np.inf
    for dd in range(nd):
        order = np.argsort(x[:, dd], kind="stable")
        xv = x[order, dd]
        pl = np.cumsum(yf[order], dtype=np.float32)[:-1]
        pr = p_tot - pl
        h = pl * pl / nl + pr * pr / nr
        h = np.where(xv[1:] > xv[:-1], h, -np.inf)
        i = int(np.argmax(h))
        if h[i] > best_h:
            best_dim, best_t, best_h = dd, half * (xv[i] + xv[i + 1]), h[i]
    if best_dim < 0 or not np.isfinite(best_h):
        return -1, 0.0, 0.0
    return best_dim, float(best_t), float(best_h - parent)


def _expand_box(plo, phi, neg, rlo, rhi, frange):
    """Push each face halfway toward the nearest excluded negative.

    plo/phi: positive bbox [d']; neg: [m, d'] node negatives; rlo/rhi:
    node region; frange: (lo, hi) feature range on the subset dims, [d']
    each. Faces expand sequentially — face j sees bounds already expanded
    for faces < j — and all arithmetic is float32 so the JAX trainer's
    expansion is bitwise-identical."""
    d = plo.shape[0]
    lo = np.asarray(plo, np.float32).copy()
    hi = np.asarray(phi, np.float32).copy()
    neg = np.asarray(neg, np.float32).reshape(-1, d)
    rlo = np.asarray(rlo, np.float32)
    rhi = np.asarray(rhi, np.float32)
    flo = np.asarray(frange[0], np.float32)
    fhi = np.asarray(frange[1], np.float32)
    half = np.float32(0.5)
    dims = np.arange(d)
    for j in range(d):
        # negatives that the box (on other dims) would contain
        if len(neg):
            inside = (neg > lo[None]) & (neg <= hi[None])
            others = np.where(dims[None] != j, inside, True).all(1)
            below = neg[others & (neg[:, j] <= plo[j]), j]
            above = neg[others & (neg[:, j] > phi[j]), j]
        else:
            below = above = np.empty((0,), np.float32)
        b = below.max() if len(below) else np.float32(-np.inf)
        a = above.min() if len(above) else np.float32(np.inf)
        lo_lim = np.maximum(np.maximum(b, rlo[j]), flo[j])
        hi_lim = np.minimum(np.minimum(a, rhi[j]), fhi[j])
        if np.isfinite(lo_lim):
            lo[j] = half * (plo[j] + lo_lim)
        if np.isfinite(hi_lim):
            hi[j] = half * (phi[j] + hi_lim)
    return lo, hi


def fit_dbranch(
    x_pos: np.ndarray,
    x_neg: np.ndarray,
    dims: np.ndarray,
    *,
    max_depth: int = 12,
    expand: bool = True,
    feature_range: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    subset_id: int = -1,
) -> BoxSet:
    """Grow decision branches on the subset ``dims``; return the box union.

    ``feature_range`` is the FULL-width (lo [D], hi [D]) per-dim range of
    the catalog (e.g. SearchEngine.frange); it is sliced to ``dims`` here.
    When None the range is recomputed from the (tiny) training sample,
    which under-expands boxes — the engine always plumbs its own."""
    xp = np.asarray(x_pos, np.float32)[:, dims]
    xn = np.asarray(x_neg, np.float32)[:, dims]
    d = len(dims)
    if feature_range is None:
        allx = np.concatenate([xp, xn]) if len(xn) else xp
        frange = (allx.min(0), allx.max(0))
    else:
        frange = (np.asarray(feature_range[0], np.float32)[dims],
                  np.asarray(feature_range[1], np.float32)[dims])
    boxes_lo: List[np.ndarray] = []
    boxes_hi: List[np.ndarray] = []

    def emit(p, n, rlo, rhi):
        plo, phi = p.min(0), p.max(0)
        # half-open boxes: nudge lo below the smallest positive
        plo = plo - 1e-6 * (np.abs(plo) + 1.0)
        if expand:
            lo, hi = _expand_box(plo, phi, n, rlo, rhi, frange)
        else:
            lo, hi = plo, phi
        boxes_lo.append(lo)
        boxes_hi.append(hi)

    def grow(p, n, rlo, rhi, depth):
        if len(p) == 0:
            return
        # drop negatives already outside the positive bounding region
        if len(n):
            plo, phi = p.min(0), p.max(0)
            keep = ((n > plo[None] - 1e-6) & (n <= phi[None])).all(1)
            n_in = n[keep]
        else:
            n_in = n
        if len(n_in) == 0 or depth >= max_depth:
            emit(p, n, rlo, rhi)
            return
        x = np.concatenate([p, n_in])
        y = np.concatenate([np.ones(len(p)), np.zeros(len(n_in))])
        dim, t, gain = _best_split(x, y)
        if dim < 0 or gain <= 0:
            emit(p, n, rlo, rhi)
            return
        # children keep ALL region negatives (not just bbox-interior ones):
        # a negative dropped here could otherwise be swallowed by a
        # descendant's expanded box
        lmask_p, lmask_n = p[:, dim] <= t, n[:, dim] <= t
        llo, lhi = rlo.copy(), rhi.copy()
        lhi[dim] = min(lhi[dim], t)
        rlo2, rhi2 = rlo.copy(), rhi.copy()
        rlo2[dim] = max(rlo2[dim], t)
        grow(p[lmask_p], n[lmask_n], llo, lhi, depth + 1)
        grow(p[~lmask_p], n[~lmask_n], rlo2, rhi2, depth + 1)

    grow(xp, xn, np.full(d, -np.inf, np.float32),
         np.full(d, np.inf, np.float32), 0)
    if not boxes_lo:
        return BoxSet(np.zeros((0, d), np.float32), np.zeros((0, d), np.float32),
                      np.asarray(dims), subset_id)
    return BoxSet(np.stack(boxes_lo).astype(np.float32),
                  np.stack(boxes_hi).astype(np.float32),
                  np.asarray(dims), subset_id)


def fit_dbranch_best_subset(
    x_pos: np.ndarray,
    x_neg: np.ndarray,
    subsets: np.ndarray,
    *,
    max_depth: int = 12,
    expand: bool = True,
    candidates: Optional[Sequence[int]] = None,
    feature_range: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> BoxSet:
    """Index-awareness: try candidate subsets, keep the best model.

    Score: fewest training positives missed (false negatives), tie-broken
    by fewest boxes (simplest consistent hypothesis); earlier candidate
    wins remaining ties."""
    cand = list(candidates) if candidates is not None else range(len(subsets))
    best: Optional[BoxSet] = None
    best_score = None
    for k in cand:
        bs = fit_dbranch(x_pos, x_neg, subsets[k], max_depth=max_depth,
                         expand=expand, subset_id=k,
                         feature_range=feature_range)
        if bs.n_boxes == 0:
            continue
        tr_counts = bs.contains(np.asarray(x_pos, np.float32))
        fn = int((tr_counts == 0).sum())          # training positives missed
        score = (fn, bs.n_boxes)
        if best_score is None or score < best_score:
            best, best_score = bs, score
    assert best is not None, "no subset produced boxes"
    return best


def dbens_draws(n_pos: int, n_neg: int, n_subsets: int, n_models: int,
                subset_candidates: int, seed: int):
    """Bootstrap + candidate-subset draws for DBEns.

    Shared by the numpy trainer and the engine's batched JAX fit so both
    paths train literally the same ensemble from the same seed. Returns
    [(ip [n_pos], ineg [n_neg], cand [subset_candidates])] per member."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(n_models):
        ip = rng.integers(0, n_pos, n_pos)
        ineg = (rng.integers(0, n_neg, n_neg) if n_neg
                else np.zeros(0, np.int64))
        cand = rng.choice(n_subsets, size=min(subset_candidates, n_subsets),
                          replace=False)
        draws.append((ip, ineg, cand))
    return draws


def fit_dbens(
    x_pos: np.ndarray,
    x_neg: np.ndarray,
    subsets: np.ndarray,
    *,
    n_models: int = 25,
    subset_candidates: int = DBENS_SUBSET_CANDIDATES,
    max_depth: int = 12,
    expand: bool = True,
    seed: int = 0,
    feature_range: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> List[BoxSet]:
    """DBEns: bootstrapped positives/negatives + random subset candidates."""
    models = []
    for ip, ineg, cand in dbens_draws(len(x_pos), len(x_neg), len(subsets),
                                      n_models, subset_candidates, seed):
        models.append(fit_dbranch_best_subset(
            x_pos[ip], x_neg[ineg] if len(x_neg) else x_neg, subsets,
            max_depth=max_depth, expand=expand, candidates=cand,
            feature_range=feature_range))
    return models


# ======================================================================
# device trainer (fixed shapes; one call trains a whole batch window)
# ======================================================================

# the reference's float32 sentinels, as exact python floats
_NEG_BIG = float(np.float32(-3e38))
_POS_BIG = float(np.float32(3e38))
_INT32_MAX = int(np.iinfo(np.int32).max)


def split_tables(x_all: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split-search tables for fit_dbranch_dev (a copy of
    ``repro.core.dbranch.split_tables``).

    x_all: [..., n, d'] = concat(positives, negatives) on the subset
    dims, optionally with leading batch axes (the batched trainer passes
    the whole [T, n, d'] lane stack at once). Returns (sort_idx — per-dim
    argsort along the sample axis — and run_end — for each sorted
    position, the last position of its equal-value run), both int32 of
    x_all's shape. numpy sorts the lane stack in one shot, so the device
    program never sorts."""
    x_all = np.asarray(x_all, np.float32)
    n = x_all.shape[-2]
    # unstable introsort on purpose: only prefix aggregates AT RUN
    # BOUNDARIES are ever read from the sorted order, and those are
    # invariant to how equal values are arranged
    sort_idx = np.argsort(x_all, axis=-2).astype(np.int32)
    xs = np.take_along_axis(x_all, sort_idx, -2)
    # run_end[i] = min{ j >= i : boundary[j] } via a reversed cumulative
    # min over boundary positions
    pos = np.arange(n, dtype=np.int32).reshape(
        (1,) * (x_all.ndim - 2) + (n, 1))
    boundary_pos = np.where(
        np.concatenate([xs[..., 1:, :] > xs[..., :-1, :],
                        np.ones(xs[..., :1, :].shape, bool)], axis=-2),
        pos, np.int32(n - 1))
    run_end = np.flip(np.minimum.accumulate(
        np.flip(boundary_pos, axis=-2), axis=-2), axis=-2)
    return sort_idx, run_end


def _grow_state(p_mask: torch.Tensor, n_mask: torch.Tensor, max_nodes: int,
                d: int) -> Tuple[torch.Tensor, ...]:
    """Initial worklist state of ``_grow_state`` for lanes [T]:
    (node_of_pos [T, P] int32, node_of_neg [T, Ng] int32,
     wl_rlo [T, M, d'], wl_rhi [T, M, d'], wl_depth [T, M] int32,
     wl_live [T, M] bool, out_lo [T, M, d'], out_hi [T, M, d'],
     out_valid [T, M] bool, n_alloc [T] int32), M = max_nodes. Growth runs
    in ROUNDS over it (fit_select)."""
    t = p_mask.shape[0]
    dev = p_mask.device
    f32, i32 = torch.float32, torch.int32
    live = torch.zeros((t, max_nodes), dtype=torch.bool, device=dev)
    live[:, 0] = True
    return (
        torch.where(p_mask, 0, -1).to(i32),
        torch.where(n_mask, 0, -1).to(i32),
        torch.full((t, max_nodes, d), _NEG_BIG, dtype=f32, device=dev),
        torch.full((t, max_nodes, d), _POS_BIG, dtype=f32, device=dev),
        torch.zeros((t, max_nodes), dtype=i32, device=dev),
        live,
        torch.zeros((t, max_nodes, d), dtype=f32, device=dev),
        torch.zeros((t, max_nodes, d), dtype=f32, device=dev),
        torch.zeros((t, max_nodes), dtype=torch.bool, device=dev),
        torch.ones((t,), dtype=i32, device=dev),
    )


def _put(at: torch.Tensor, val: torch.Tensor, a: torch.Tensor):
    """a with row ``at`` of each lane set to ``val`` ([T, M] one-hot
    ``at``; [T] or [T, d'] ``val``). A slot index past the end matches no
    slot, so the write drops, as JAX drops an out-of-range
    ``.at[idx].set`` (torch indexing would raise, or assert on CUDA)."""
    if a.dim() == 3:
        return torch.where(at[..., None], val[:, None, :], a)
    return torch.where(at, val[:, None], a)


def _grow_lanes(x_all: torch.Tensor, tables: Optional[torch.Tensor],
                state: Tuple[torch.Tensor, ...], *, p_cnt: int,
                max_nodes: int, max_depth: int,
                max_iters: int) -> Tuple[torch.Tensor, ...]:
    """Resumable worklist tree-grower (``_grow_lane``), batched over the
    leading lane axis where the reference vmaps one lane.

    x_all: [T, n, d'] = positives rows [:p_cnt] ++ negative rows
    [p_cnt:]; tables: [T, n, 2d'] int32 packed (sort_idx | run_end) from
    split_tables, or None to derive them here. Each iteration pops every
    lane's lowest live node and either emits its UNEXPANDED box (nudged
    positive bbox) or splits it, for ``max_iters`` iterations. The
    reference's vmapped while_loop runs while ANY lane is live and leaves
    a lane whose own condition is false unchanged; here every write is
    gated on ``active`` (the lane still has a live node), and the loop
    runs its ``max_iters`` masked iterations with no host sync. Row
    validity lives in the state (node -1), as in the reference. A write
    to one worklist slot a lane is a one-hot select over the slots, so a
    child slot past ``max_nodes`` drops as in JAX. Returns the new
    state."""
    t, n, d = x_all.shape
    dev = x_all.device
    i32 = torch.int32
    xp, xn = x_all[:, :p_cnt], x_all[:, p_cnt:]
    if tables is None:
        sort_idx = torch.sort(x_all, dim=1, stable=True).indices
        x_sorted = torch.gather(x_all, 1, sort_idx)
        boundary = torch.cat(
            [x_sorted[:, 1:] > x_sorted[:, :-1],
             torch.ones((t, 1, d), dtype=torch.bool, device=dev)], 1)
        pos = torch.arange(n, dtype=i32, device=dev)[None, :, None]
        run_end = torch.flip(torch.cummin(torch.flip(
            torch.where(boundary, pos, n - 1), [1]), 1).values, [1]).long()
    else:
        sort_idx, run_end = tables[..., :d].long(), tables[..., d:].long()
        x_sorted = torch.gather(x_all, 1, sort_idx)
    y_sorted = (sort_idx < p_cnt).to(torch.float32)         # y_all[sort_idx]
    dim_ids = torch.arange(d, dtype=i32, device=dev)[None, None, :]
    row_ids = torch.arange(n, dtype=i32, device=dev)[None, :, None]
    slot_ids = torch.arange(max_nodes, dtype=i32, device=dev)[None, :]
    lanes = torch.arange(t, device=dev)

    def gini_best_split(m_node, p_tot):
        """Midpoint CART split via masked prefix sums, per lane: maximise
        h = pl²/nl + pr²/nr in f32, op by op; tie-break lowest dim, then
        lowest threshold; split only if h beats the parent's p²/n."""
        m_sorted = torch.gather(m_node[:, :, None].expand(t, n, d), 1,
                                sort_idx)                    # [T, n, d]
        mf = m_sorted.to(torch.float32)
        # one packed cumsum gives both masked counts and label counts
        cs = torch.cumsum(torch.cat([mf, mf * y_sorted], 2), 1)
        nl, pl = cs[..., :d], cs[..., d:]
        n_tot = m_node.sum(1).to(torch.float32)[:, None, None]
        # a candidate = last masked position of its equal-value run, with
        # a masked element strictly after it
        ok = (m_sorted & (nl == torch.gather(nl, 1, run_end))
              & (nl < n_tot))
        nr = n_tot - nl
        pr = p_tot[:, None, None] - pl
        h = pl * pl / nl.clamp_min(1.0) + pr * pr / nr.clamp_min(1.0)
        h = torch.where(ok, h, _NEG_BIG)
        hmax = h.amax((1, 2))
        elig = ok & (h == hmax[:, None, None])
        dim = torch.where(elig, dim_ids, d).amin((1, 2))
        dim_c = dim.clamp(max=d - 1)
        # winner position: thresholds ascend within a dim, so min position
        # == min threshold; the midpoint needs just the winner's column
        ipos = torch.where(elig & (dim_ids == dim[:, None, None]), row_ids,
                           n - 1).amin((1, 2))
        col = dim_c.long()[:, None, None].expand(t, n, 1)
        xcol = torch.gather(x_sorted, 2, col)[..., 0]          # [T, n]
        mcol = torch.gather(m_sorted, 2, col)[..., 0]
        xi = torch.gather(xcol, 1, ipos.long()[:, None])[:, 0]
        nxt = torch.where(mcol & (xcol > xi[:, None]), xcol,
                          _POS_BIG).amin(1)
        thr = 0.5 * (xi + nxt)
        n_t = n_tot[:, 0, 0]
        parent = p_tot * p_tot / n_t.clamp_min(1.0)
        improves = ok.any(2).any(1) & (hmax > parent)
        return dim_c, thr, improves

    (node_of_pos, node_of_neg, wl_rlo, wl_rhi, wl_depth, wl_live,
     out_lo, out_hi, out_valid, n_alloc) = state
    for _ in range(max_iters):
        active = wl_live.any(1)
        node = torch.argmax(wl_live.to(torch.uint8), 1)      # pop first live
        node32 = node.to(i32)
        at_node = slot_ids == node32[:, None]                 # [T, M]
        pmask = node_of_pos == node32[:, None]
        nmask_all = node_of_neg == node32[:, None]
        rlo, rhi = wl_rlo[lanes, node], wl_rhi[lanes, node]
        depth = wl_depth[lanes, node]
        wl_live = wl_live & ~at_node      # a finished lane has none live

        # positive bbox + negatives inside it only
        plo = torch.where(pmask[..., None], xp, _POS_BIG).amin(1)
        phi = torch.where(pmask[..., None], xp, _NEG_BIG).amax(1)
        n_in = nmask_all & ((xn > (plo - 1e-6)[:, None])
                            & (xn <= phi[:, None])).all(2)
        has_pos = pmask.any(1) & active
        pure = ~n_in.any(1)
        full = n_alloc + 2 > max_nodes
        do_emit = has_pos & (pure | (depth >= max_depth) | full)

        p_tot = pmask.sum(1).to(torch.float32)
        dim, thr, improves = gini_best_split(torch.cat([pmask, n_in], 1),
                                             p_tot)
        can_split = has_pos & ~do_emit & improves
        do_emit = has_pos & ~can_split

        # emit the UNEXPANDED box: nudged positive bbox (half-open lo)
        lo_e = plo - 1e-6 * (plo.abs() + 1.0)
        emit = at_node & do_emit[:, None]
        out_lo = _put(emit, lo_e, out_lo)
        out_hi = _put(emit, phi, out_hi)
        out_valid = out_valid | emit

        # split into children at slots (n_alloc, n_alloc+1): reassign the
        # node's samples elementwise (children keep ALL region negatives)
        la, ra = n_alloc, n_alloc + 1
        dcol = dim.long()
        goes_left_p = torch.gather(
            xp, 2, dcol[:, None, None].expand(t, xp.shape[1], 1))[..., 0] \
            <= thr[:, None]
        goes_left_n = torch.gather(
            xn, 2, dcol[:, None, None].expand(t, xn.shape[1], 1))[..., 0] \
            <= thr[:, None]
        node_of_pos = torch.where(
            can_split[:, None] & pmask,
            torch.where(goes_left_p, la[:, None], ra[:, None]), node_of_pos)
        node_of_neg = torch.where(
            can_split[:, None] & nmask_all,
            torch.where(goes_left_n, la[:, None], ra[:, None]), node_of_neg)
        cur = dcol[:, None]
        lrhi = rhi.scatter(1, cur, torch.minimum(rhi.gather(1, cur),
                                                 thr[:, None]))
        rrlo = rlo.scatter(1, cur, torch.maximum(rlo.gather(1, cur),
                                                 thr[:, None]))
        at_la = slot_ids == la[:, None]
        at_ra = slot_ids == ra[:, None]
        put_l = at_la & can_split[:, None]
        put_r = at_ra & can_split[:, None]
        wl_rlo = _put(put_r, rrlo, _put(put_l, rlo, wl_rlo))
        wl_rhi = _put(put_r, rhi, _put(put_l, lrhi, wl_rhi))
        # the reference writes depth and liveness unconditionally (only
        # an out-of-range slot drops); a finished lane keeps its state
        at_la = at_la & active[:, None]
        at_ra = at_ra & active[:, None]
        wl_depth = _put(at_la | at_ra, depth + 1, wl_depth)
        wl_live = _put(at_ra, can_split & (pmask & ~goes_left_p).any(1),
                       _put(at_la, can_split & (pmask & goes_left_p).any(1),
                            wl_live))
        n_alloc = torch.where(can_split, n_alloc + 2, n_alloc)
    return (node_of_pos, node_of_neg, wl_rlo, wl_rhi, wl_depth, wl_live,
            out_lo, out_hi, out_valid, n_alloc)


def _grow_round(x_all, m_all, tables, state=None, *, p_cnt: int,
                max_nodes: int, max_depth: int, max_iters: int):
    """One batched growth round (``_grow_round``): every lane advances
    up to max_iters; state=None builds the initial state."""
    if state is None:
        state = _grow_state(m_all[:, :p_cnt], m_all[:, p_cnt:], max_nodes,
                            x_all.shape[-1])
    return _grow_lanes(x_all, tables, state, p_cnt=p_cnt,
                       max_nodes=max_nodes, max_depth=max_depth,
                       max_iters=max_iters)


def _gather_state(state, idx: torch.Tensor):
    """Compact surviving lanes' state rows (``_gather_state``)."""
    return tuple(a[idx] for a in state)


def _scatter_state(state, sub, idx: torch.Tensor, *, n_real: int):
    """Scatter finished survivors back into the full batch, in place
    (``_scatter_state``)."""
    for a, b in zip(state, sub):
        a[idx] = b[:n_real]
    return state


def _expand_boxes(xn, n_mask, node_of_neg, slots, plo, phi, rlo, rhi,
                  frange_lo, frange_hi):
    """Expand S boxes of each of G trees (``_expand_boxes``, batched over
    the leading axis): push each face halfway toward the nearest
    excluded negative (or the node region / feature range).

    xn: [G, Ng, d']; n_mask/node_of_neg: [G, Ng]; slots: [G, S] emitted
    node slots (max_nodes marks padding); plo/phi/rlo/rhi: [G, S, d'];
    frange_lo/hi: [G, d']. Mirrors _expand_box bitwise — sequential
    per-face expansion with an incrementally-maintained containment
    count."""
    d = plo.shape[-1]
    neg_half, pos_half = _NEG_BIG / 2, _POS_BIG / 2
    nmask = ((node_of_neg[:, None, :] == slots[:, :, None])
             & n_mask[:, None, :])                            # [G, S, Ng]
    lo, hi = plo.clone(), phi.clone()
    xe = xn[:, None]                                          # [G, 1, Ng, d]
    inside = (xe > lo[:, :, None, :]) & (xe <= hi[:, :, None, :])
    cnt = inside.sum(3)                                       # [G, S, Ng]
    for j in range(d):
        xj = xe[..., j]                                       # [G, 1, Ng]
        others = nmask & (cnt - inside[..., j].to(cnt.dtype) == d - 1)
        below = torch.where(others & (xj <= plo[:, :, j, None]), xj,
                            _NEG_BIG).amax(2)
        above = torch.where(others & (xj > phi[:, :, j, None]), xj,
                            _POS_BIG).amin(2)
        lo_lim = torch.maximum(torch.maximum(below, rlo[:, :, j]),
                               frange_lo[:, None, j])
        hi_lim = torch.minimum(torch.minimum(above, rhi[:, :, j]),
                               frange_hi[:, None, j])
        newlo = torch.where(lo_lim > neg_half, 0.5 * (plo[:, :, j] + lo_lim),
                            plo[:, :, j])
        newhi = torch.where(hi_lim < pos_half, 0.5 * (phi[:, :, j] + hi_lim),
                            phi[:, :, j])
        lo[:, :, j] = newlo
        hi[:, :, j] = newhi
        newcol = (xj > newlo[..., None]) & (xj <= newhi[..., None])
        cnt = cnt + newcol.to(cnt.dtype) - inside[..., j].to(cnt.dtype)
        inside[..., j] = newcol
    return lo, hi


def fit_dbranch_dev(
    xp: torch.Tensor,                 # [P, d'] positives (on subset dims)
    xn: torch.Tensor,                 # [Ng, d'] negatives
    frange_lo: torch.Tensor,          # [d'] feature min on the subset dims
    frange_hi: torch.Tensor,          # [d'] feature max on the subset dims
    p_mask: Optional[torch.Tensor] = None,   # [P] bool row validity
    n_mask: Optional[torch.Tensor] = None,   # [Ng] bool row validity
    sort_idx: Optional[torch.Tensor] = None,  # [P+Ng, d'] split_tables
    run_end: Optional[torch.Tensor] = None,   # [P+Ng, d'] split_tables
    *,
    max_nodes: int = 64,
    max_depth: int = 12,
    expand: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fit_dbranch_jax`` on the tensors' device. Returns (lo
    [max_nodes, d'], hi, valid [max_nodes] bool).

    Same growth rule as fit_dbranch, as a bounded worklist (_grow_lanes
    with one lane) followed by box expansion of the emitted leaves.
    ``p_mask``/``n_mask`` mark the REAL rows of padded label sets;
    ``sort_idx``/``run_end`` from split_tables keep the sort on the host
    (derived here when omitted)."""
    p_cnt, d = xp.shape
    dev = xp.device
    if p_mask is None:
        p_mask = torch.ones((p_cnt,), dtype=torch.bool, device=dev)
    if n_mask is None:
        n_mask = torch.ones((xn.shape[0],), dtype=torch.bool, device=dev)
    x_all = torch.cat([xp, xn], 0)[None]
    tables = (None if sort_idx is None
              else torch.cat([sort_idx, run_end], 1)[None])
    state = _grow_state(p_mask[None], n_mask[None], max_nodes, d)
    state = _grow_lanes(x_all, tables, state, p_cnt=p_cnt,
                        max_nodes=max_nodes, max_depth=max_depth,
                        max_iters=max_nodes)
    plo, phi, valid = state[6][0], state[7][0], state[8][0]
    if not expand:
        return plo, phi, valid
    slots = torch.where(valid, torch.arange(max_nodes, dtype=torch.int32,
                                            device=dev), max_nodes)
    lo, hi = _expand_boxes(xn[None], n_mask[None], state[1], slots[None],
                           plo[None], phi[None], state[2], state[3],
                           frange_lo[None], frange_hi[None])
    return lo[0], hi[0], valid


def _segment_min(vals: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """``jax.ops.segment_min`` of int32 values: INT32_MAX for a segment
    with no entries."""
    out = torch.full((n_seg,), _INT32_MAX, dtype=torch.int32,
                     device=vals.device)
    return out.scatter_reduce(0, seg.long(), vals, "amin")


def _select_expand(x_all, m_all, frange, group_ids, plo, phi, valid,
                   node_of_neg, rlo, rhi, *, p_cnt: int, n_groups: int,
                   max_nodes: int):
    """Device selection + winners-only expansion (``_select_expand``;
    see fit_select)."""
    t = x_all.shape[0]
    dev = x_all.device
    xp, xn = x_all[:, :p_cnt], x_all[:, p_cnt:]
    p_mask, n_mask = m_all[:, :p_cnt], m_all[:, p_cnt:]
    counts = kops.batch_box_membership(xp, plo, phi, valid)   # [T, P]
    fn = ((counts == 0) & p_mask).sum(1).to(torch.int32)
    nb = valid.sum(1).to(torch.int32)
    key = torch.where(nb > 0, fn * (max_nodes + 1) + nb, _INT32_MAX)
    best = _segment_min(key, group_ids, n_groups)
    elig = key == best[group_ids.long()]
    lanes = torch.arange(t, dtype=torch.int32, device=dev)
    win = _segment_min(torch.where(elig, lanes, t), group_ids, n_groups)
    win_c = win.clamp(0, t - 1).long()

    # compact the winners' emitted slots to a prefix (jnp.nonzero with
    # size/fill_value, as a sort of the slot ids with max_nodes past the
    # emitted ones: no host sync), then expand ONLY those boxes
    s_max = min(max_nodes, p_cnt)
    valid_w = valid[win_c]                                    # [G, M]
    slot_ids = torch.arange(max_nodes, dtype=torch.int32, device=dev)
    slots = torch.sort(torch.where(valid_w, slot_ids, max_nodes),
                       dim=1).values[:, :s_max]               # [G, S]
    keep = slots < max_nodes
    slots_c = slots.clamp(max=max_nodes - 1).long()

    def gather(a):
        return torch.gather(a[win_c], 1,
                            slots_c[..., None].expand(-1, -1, a.shape[-1]))

    lo_x, hi_x = _expand_boxes(
        xn[win_c], n_mask[win_c], node_of_neg[win_c], slots,
        gather(plo), gather(phi), gather(rlo), gather(rhi),
        frange[win_c, 0], frange[win_c, 1])
    lo_c = torch.where(keep[..., None], lo_x, float("inf"))
    hi_c = torch.where(keep[..., None], hi_x, float("-inf"))
    # meta stacked on the device: the caller's single host sync reads it
    return lo_c, hi_c, torch.stack([win, nb[win_c]])


def fit_select(
    x_all: torch.Tensor,           # [T, P+Ng, d'] per-lane samples
    m_all: torch.Tensor,           # [T, P+Ng] bool row validity
    frange: torch.Tensor,          # [T, 2, d'] per-lane (lo, hi) range
    group_ids: torch.Tensor,       # [T] int32 lane -> model group
    tables: Optional[torch.Tensor] = None,  # [T, P+Ng, 2d'] split_tables
    *,
    p_cnt: int,
    n_groups: int,
    max_nodes: int = 64,
    max_depth: int = 12,
    round1_iters: int = 1,
):
    """``fit_select_jax``: train EVERY lane and pick each group's winning
    subset on the device.

    A *lane* is one (candidate subset x ensemble member x request)
    trainer — rows [:p_cnt] of ``x_all`` are its (padded) positives, the
    rest its negatives; a *group* is one model to be selected (a dbranch
    query, or one dbens bootstrap member).

    Growth runs in TWO rounds: ``round1_iters`` masked iterations over
    all lanes (they finish the lanes whose tree is a single emitted
    root), then — after ONE host sync of the [T] still-live flags — only
    the surviving lanes, host-compacted to a pow2 bucket, run
    ``max_nodes`` iterations. Selection scores each lane's UNEXPANDED
    boxes on its own positives (kops.batch_box_membership) and takes the
    per-group argmin of (false negatives, n_boxes), composed into one
    int32 key, earliest lane winning ties, zero-box lanes excluded; the
    face expansion then runs on the winners only.

    Returns (lo [G, S, d'], hi [G, S, d'], meta [2, G] int32 — (winner
    lane | INT32_MAX for a group with no lanes, winner box count) — the
    caller's one result sync reads it), S = min(max_nodes, P)."""
    state = _grow_round(x_all, m_all, tables, p_cnt=p_cnt,
                        max_nodes=max_nodes, max_depth=max_depth,
                        max_iters=round1_iters)
    live = state[5].any(1).cpu().numpy()          # the one [T] round sync
    if live.any():
        idx = np.nonzero(live)[0]
        pad = 1 << max(len(idx) - 1, 0).bit_length()
        idx_p = to_device_async(np.concatenate(
            [idx, np.zeros(pad - len(idx), np.int64)]), x_all.device)
        extras = (x_all, m_all) + (() if tables is None else (tables,))
        sub = _gather_state(tuple(state) + extras, idx_p)
        sub_tables = sub[12] if tables is not None else None
        sub = _grow_round(sub[10], sub[11], sub_tables, sub[:10],
                          p_cnt=p_cnt, max_nodes=max_nodes,
                          max_depth=max_depth, max_iters=max_nodes)
        state = _scatter_state(state, sub, idx_p[:len(idx)],
                               n_real=len(idx))
    return _select_expand(
        x_all, m_all, frange, group_ids,
        state[6], state[7], state[8], state[1], state[2], state[3],
        p_cnt=p_cnt, n_groups=n_groups, max_nodes=max_nodes)


def predict_boxes(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Membership counts for fixed-shape device boxes
    (``predict_boxes_jax``; invalid boxes never match)."""
    inside = (x[:, None, :] > lo[None]) & (x[:, None, :] <= hi[None])
    return (inside.all(-1) & valid[None]).sum(-1)
