"""Decision tree / random forest baselines (the paper's scan-based rivals).

CART with gini, grown on ALL feature dims (no index-awareness — that is
the point of the comparison). Positive leaves are extracted as full-width
boxes so prediction over the database reuses the same box_scan kernel as
DBranch; the efficiency difference is purely *which bytes* each model
must touch: DT/RF boxes constrain arbitrary dims, so no single pre-built
subset index can answer them and the whole feature matrix is scanned.

A copy of ``repro.core.trees`` (numpy), so the trees fitted here are
byte-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.boxes import BoxSet
from repro_torch.core.dbranch import _best_split


@dataclass
class DecisionTree:
    lo: np.ndarray                # [n_pos_leaves, D] full-width boxes
    hi: np.ndarray
    n_features: int

    def predict_counts(self, x: np.ndarray) -> np.ndarray:
        from repro_torch.core.boxes import boxes_contain
        return boxes_contain(np.asarray(x, np.float32), self.lo, self.hi)


def fit_decision_tree(
    x: np.ndarray, y: np.ndarray, *,
    max_depth: int = 20, min_leaf: int = 1,
    feature_subsample: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> DecisionTree:
    """x: [n, D]; y: [n] 0/1. Returns positive leaves as boxes."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    n, d = x.shape
    los: List[np.ndarray] = []
    his: List[np.ndarray] = []

    def rec(idx, lo, hi, depth):
        yy = y[idx]
        if len(idx) == 0:
            return
        if yy.all() or depth >= max_depth or len(idx) <= min_leaf or (~yy.any()):
            if yy.mean() > 0.5:
                los.append(lo.copy())
                his.append(hi.copy())
            return
        if feature_subsample is not None and rng is not None:
            k = max(1, int(d * feature_subsample))
            dims = np.sort(rng.choice(d, k, replace=False))
        else:
            dims = np.arange(d)
        dim_l, t, gain = _best_split(x[np.ix_(idx, dims)], yy.astype(float))
        if dim_l < 0 or gain <= 0:
            if yy.mean() > 0.5:
                los.append(lo.copy())
                his.append(hi.copy())
            return
        dim = dims[dim_l]
        mask = x[idx, dim] <= t
        llo, lhi = lo.copy(), hi.copy()
        lhi[dim] = min(lhi[dim], t)
        rlo, rhi = lo.copy(), hi.copy()
        rlo[dim] = max(rlo[dim], t)
        rec(idx[mask], llo, lhi, depth + 1)
        rec(idx[~mask], rlo, rhi, depth + 1)

    rec(np.arange(n), np.full(d, -np.inf, np.float32),
        np.full(d, np.inf, np.float32), 0)
    if los:
        lo = np.stack(los)
        hi = np.stack(his)
    else:
        lo = np.zeros((0, d), np.float32)
        hi = np.zeros((0, d), np.float32)
    return DecisionTree(lo, hi, d)


@dataclass
class RandomForest:
    trees: List[DecisionTree]

    def predict_counts(self, x: np.ndarray) -> np.ndarray:
        """Number of trees voting positive per row."""
        votes = np.zeros(len(x), np.int32)
        for t in self.trees:
            votes += (t.predict_counts(x) > 0).astype(np.int32)
        return votes

    def boxes(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.concatenate([t.lo for t in self.trees])
        hi = np.concatenate([t.hi for t in self.trees])
        return lo, hi


def fit_random_forest(
    x: np.ndarray, y: np.ndarray, *,
    n_trees: int = 25, max_depth: int = 20,
    feature_subsample: float = 0.7, seed: int = 0,
) -> RandomForest:
    rng = np.random.default_rng(seed)
    n = len(x)
    trees = []
    for _ in range(n_trees):
        idx = rng.integers(0, n, n)
        trees.append(fit_decision_tree(
            x[idx], y[idx], max_depth=max_depth,
            feature_subsample=feature_subsample, rng=rng))
    return RandomForest(trees)
