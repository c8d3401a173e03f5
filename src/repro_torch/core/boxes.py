"""Multidimensional boxes — the common currency of the whole engine.

A box is a conjunction of half-open interval predicates
``lo[d] < x[d] <= hi[d]`` over a feature subset (unconstrained dims use
(-inf, +inf)). Counterpart of ``repro.core.boxes``: BoxSet coordinates
may be numpy arrays or torch tensors, and device-resident boxes are
merged on their device rather than bounced through the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

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

    def contains(self, x: np.ndarray) -> np.ndarray:
        """x: [N, D_full] -> [N] membership counts."""
        xs = np.asarray(x)[:, self.dims]                      # [N, d']
        lo, hi = _host(self.lo), _host(self.hi)
        inside = (xs[:, None, :] > lo[None]) & (xs[:, None, :] <= hi[None])
        return inside.all(-1).sum(-1)
