"""Feature subsets — the "index-awareness" contract.

K random d'-dim subsets of the D-dim feature space are drawn offline;
one multidimensional index is built per subset. A DBranch box may only
constrain dims of a single subset, so every box is answerable by exactly
one pre-built index (paper §2). d' << D keeps each index low-dimensional
(k-d trees and zone maps both degrade with dimensionality).

A copy of ``repro.core.subsets``: the same numpy draws from the same seed.
"""
from __future__ import annotations

from typing import List

import numpy as np


def make_subsets(n_features: int, n_subsets: int, subset_dim: int,
                 seed: int = 0) -> np.ndarray:
    """[K, d'] int32, each row sorted, rows distinct, coverage-balanced:
    dims are drawn without replacement globally until exhausted so every
    feature appears in ~K*d'/D subsets."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    pool = rng.permutation(n_features)
    used = 0
    for _ in range(n_subsets):
        if used + subset_dim > len(pool):
            pool = rng.permutation(n_features)
            used = 0
        out.append(np.sort(pool[used:used + subset_dim]))
        used += subset_dim
    return np.stack(out).astype(np.int32)
