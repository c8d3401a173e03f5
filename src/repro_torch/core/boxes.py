"""Multidimensional boxes — the common currency of the whole engine.

A box is a conjunction of half-open interval predicates
``lo[d] < x[d] <= hi[d]`` over a feature subset (unconstrained dims use
(-inf, +inf)). Counterpart of ``repro.core.boxes``: BoxSet coordinates
may be numpy arrays or torch tensors, and device-resident boxes are
merged on their device rather than bounced through the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def concat_box_arrays(arrs: Sequence):
    """Concatenate box coordinate arrays, staying on the device of the
    first torch tensor among them whenever there is one."""
    dev = next((a.device for a in arrs if isinstance(a, torch.Tensor)), None)
    if dev is not None:
        return torch.cat([torch.as_tensor(a, device=dev) for a in arrs])
    return np.concatenate(arrs)


@dataclass
class BoxSet:
    """boxes on a feature subset: lo/hi [n_boxes, d'], dims [d'] global ids."""
    lo: np.ndarray
    hi: np.ndarray
    dims: np.ndarray          # indices into the full feature space
    subset_id: int = -1       # which pre-built index answers these boxes

    @property
    def n_boxes(self) -> int:
        return int(self.lo.shape[0])

    def to_full(self, n_features: int) -> Tuple[np.ndarray, np.ndarray]:
        """Expand to full-width (lo, hi) with open bounds elsewhere."""
        lo = np.full((self.n_boxes, n_features), -np.inf, np.float32)
        hi = np.full((self.n_boxes, n_features), np.inf, np.float32)
        lo[:, self.dims] = _host(self.lo)
        hi[:, self.dims] = _host(self.hi)
        return lo, hi

    def contains(self, x: np.ndarray) -> np.ndarray:
        """x: [N, D_full] -> [N] membership counts."""
        xs = np.asarray(x)[:, self.dims]                      # [N, d']
        lo, hi = _host(self.lo), _host(self.hi)
        inside = (xs[:, None, :] > lo[None]) & (xs[:, None, :] <= hi[None])
        return inside.all(-1).sum(-1)

    def concatenate(self, other: "BoxSet") -> "BoxSet":
        assert np.array_equal(self.dims, other.dims)
        return BoxSet(concat_box_arrays([self.lo, other.lo]),
                      concat_box_arrays([self.hi, other.hi]),
                      self.dims, self.subset_id)


def boxes_contain(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Full-width membership counts (numpy oracle used by tests)."""
    inside = (x[:, None, :] > lo[None]) & (x[:, None, :] <= hi[None])
    return inside.all(-1).sum(-1)


def merge_boxsets(sets: Sequence[BoxSet], n_features: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Union of heterogeneous-subset box sets as full-width (lo, hi)."""
    los, his = [], []
    for s in sets:
        lo, hi = s.to_full(n_features)
        los.append(lo)
        his.append(hi)
    return np.concatenate(los), np.concatenate(his)
