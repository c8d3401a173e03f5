"""Decision branches (DBranch / DBEns) — the paper's classifier, numpy
trainers only.

A decision branch model is a *union of boxes*: only root->positive-leaf
paths of a CART-style tree are materialised, each path's conjunction of
orthogonal splits being one box. Index-awareness restricts every box to
the dims of ONE pre-built feature subset, so inference is a handful of
range queries against that subset's index (paper §2 / VLDB'23 [8]).

A copy of the numpy trainers of ``repro.core.dbranch`` (``_best_split``
through ``fit_dbens``), so the port trains bitwise the reference's boxes
from the same labels and seed. The batched device trainer
(``fit_select_jax``) is ROADMAP item A5.

Box expansion: positive-leaf boxes are tightened to the positive bounding
box, then each face is pushed halfway toward the nearest excluded
negative (or to the node region / feature range). This recovers the
recall-friendly behaviour the engine needs to *discover* new objects.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.boxes import BoxSet

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
