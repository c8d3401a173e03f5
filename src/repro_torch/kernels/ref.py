"""Plain PyTorch versions of the kernels on the engine's main path.

Counterparts of ``repro.kernels.ref`` (the same comparisons, the same f32
0/1 matmul), plus the two entry points the CUDA kernels add: the per-zone
hit vector and the in-place gathered box scan. The kernel wrappers use
these for tensors on the CPU, and the chip checks hold every kernel
against them on the card.
"""
from __future__ import annotations

import torch


def zone_prune_ref(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
                   bhi: torch.Tensor) -> torch.Tensor:
    """[NZ, D] zones x [B, D] boxes -> [NZ, B] bool interval overlap."""
    ov = (zhi[:, None, :] > blo[None]) & (zlo[:, None, :] <= bhi[None])
    return ov.all(-1)


def zone_hits_ref(zlo, zhi, blo, bhi) -> torch.Tensor:
    """[NZ] bool: does zone z overlap any box."""
    return zone_prune_ref(zlo, zhi, blo, bhi).any(1)


def box_scan_seg_ref(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """x: [N, D]; lo/hi: [B, D]; onehot: [B, Q] box->segment map ->
    [N, Q] int32 per-segment membership counts."""
    inside = (x[:, None, :] > lo[None]) & (x[:, None, :] <= hi[None])
    member = inside.all(-1).to(torch.float32)                   # [N, B]
    return (member @ onehot.to(torch.float32)).to(torch.int32)


def box_scan_seg_gather_ref(rows3: torch.Tensor, cand: torch.Tensor,
                            n_hit: torch.Tensor, lo, hi,
                            onehot) -> torch.Tensor:
    """box_scan_seg over the gathered blocks rows3[cand] -> [C * block, Q]
    int32, with every row of a slot >= n_hit zeroed."""
    c = cand.shape[0]
    _, block, d = rows3.shape
    x = rows3[cand.long()].reshape(c * block, d)
    counts = box_scan_seg_ref(x, lo, hi, onehot).reshape(c, block, -1)
    valid = torch.arange(c, device=cand.device) < n_hit
    return (counts * valid[:, None, None]).reshape(c * block, -1)
