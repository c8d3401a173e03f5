"""The box scans as CUDA kernels: ``box_scan`` and ``box_scan_pruned``
(csrc/box_scan.cu) and the segmented refine stage ``box_scan_seg``
(csrc/box_scan_seg.cu).

Counterparts of ``repro.kernels.box_scan``. ``box_scan`` counts, per
row, the boxes that contain it (the full scan of the dtree/rforest models
and the refine stage of the host ``query_index`` oracle; at D <= 8 it is
box_scan_pruned's one-block case). ``box_scan_pruned`` scans the
surviving blocks rows3[cand] of a pruned index where they lie and writes
every block's counts once, zeros where no live slot holds the block (the
per-shard step ``core/index.pruned_local_step``). The segmented kernel
reads the surviving blocks rows3[cand] in place and zeroes the slots >=
n_hit (``box_scan_seg_gather``, what ``ops.fused_query`` runs);
``box_scan_seg`` scans given rows x [N, D] (the Pallas kernel's
contract) as the one-block case rows3 = x[None], cand = [0], n_hit = 1.
All take CUDA tensors only; the CPU dispatch to the plain versions lives
in ``kernels/ops.py``.

``scan_launches`` counts calls of the box_scan entry that launch,
``pruned_launches`` those of box_scan_pruned, and ``seg_launches`` those
of box_scan_seg (both of its entry points launch in
``box_scan_seg_gather``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

scan_launches = 0
pruned_launches = 0
seg_launches = 0


def _check(name: str, t: torch.Tensor, dtype, shape, device,
           kernel: str = "box_scan_seg") -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.device != device:
        raise ValueError(f"{kernel}: all inputs must be on one device")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def box_scan(x: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """x: [N, D] f32; lo/hi: [B, D] f32 -> [N] int32 box-membership
    counts (CUDA). Ragged N and any D are taken as they are; B = 0
    returns zeros without a launch."""
    global scan_launches
    if x.dim() != 2 or lo.dim() != 2:
        raise ValueError("box_scan: x must be [N, D] and boxes [B, D]")
    n, d = x.shape
    nb = lo.shape[0]
    dev = x.device
    _check("x", x, torch.float32, (n, d), dev, "box_scan")
    _check("lo", lo, torch.float32, (nb, d), dev, "box_scan")
    _check("hi", hi, torch.float32, (nb, d), dev, "box_scan")
    if nb == 0 or n == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = launch_fn("box_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), lo.data_ptr(), hi.data_ptr(), n, d, nb,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"box_scan kernel launch failed: CUDA error {err}")
    scan_launches += 1
    return out


def box_scan_pruned(rows3: torch.Tensor, cand: torch.Tensor,
                    n_hit: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """rows3: [NB, block, D] f32 index rows; cand: [C] int32 block ids;
    n_hit: [] int32 survivor count -> [NB * block] int32: the box counts
    of the blocks the first min(n_hit, C) slots hold, 0 in every other
    block (CUDA). Those slots must hold ascending, unique ids in [0, NB),
    as zone_candidates' (cand, n_hit) do: the kernel zeroes the gaps
    between them. One launch, boxes or none."""
    global pruned_launches
    kernel = "box_scan_pruned"
    if rows3.dim() != 3 or cand.dim() != 1 or lo.dim() != 2:
        raise ValueError("box_scan_pruned: rows3 must be [NB, block, D], "
                         "cand [C] and boxes [B, D]")
    nb_rows, block, d = rows3.shape
    nb = lo.shape[0]
    dev = rows3.device
    _check("rows3", rows3, torch.float32, rows3.shape, dev, kernel)
    _check("cand", cand, torch.int32, cand.shape, dev, kernel)
    _check("n_hit", n_hit, torch.int32, (), dev, kernel)
    _check("lo", lo, torch.float32, (nb, d), dev, kernel)
    _check("hi", hi, torch.float32, (nb, d), dev, kernel)
    if max(nb_rows, block, cand.shape[0], nb) >= 2 ** 31:
        raise ValueError("box_scan_pruned: a dimension past 2^31 - 1")
    out = torch.empty(nb_rows * block, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    fn = launch_fn("box_scan", "box_scan_pruned_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows3.data_ptr(), cand.data_ptr(), n_hit.data_ptr(),
                 nb_rows, block, cand.shape[0], d, lo.data_ptr(),
                 hi.data_ptr(), nb, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"box_scan_pruned kernel launch failed: CUDA "
                           f"error {err}")
    pruned_launches += 1
    return out


def box_scan_seg(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 onehot: torch.Tensor) -> torch.Tensor:
    """x: [N, D] f32; lo/hi: [B, D] f32; onehot: [B, Q] f32 -> [N, Q]
    int32 per-segment membership counts (CUDA)."""
    if x.dim() != 2:
        raise ValueError("box_scan_seg: x must be [N, D]")
    _check("x", x, torch.float32, x.shape, x.device)
    return box_scan_seg_gather(
        x[None], torch.zeros(1, dtype=torch.int32, device=x.device),
        torch.ones((), dtype=torch.int32, device=x.device), lo, hi, onehot)


def box_scan_seg_gather(rows3: torch.Tensor, cand: torch.Tensor,
                        n_hit: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, onehot: torch.Tensor
                        ) -> torch.Tensor:
    """rows3: [NB, block, D] f32 index rows; cand: [C] int32 block ids
    (each in [0, NB)); n_hit: [] int32 survivor count -> [C * block, Q]
    int32 counts of rows3[cand], zero on every slot >= n_hit (CUDA)."""
    if rows3.dim() != 3 or cand.dim() != 1:
        raise ValueError("box_scan_seg_gather: rows3 must be [NB, block, D] "
                         "and cand [C]")
    dev = rows3.device
    _check("rows3", rows3, torch.float32, rows3.shape, dev)
    _check("cand", cand, torch.int32, cand.shape, dev)
    global seg_launches
    if lo.dim() != 2 or onehot.dim() != 2:
        raise ValueError("box_scan_seg: boxes must be [B, D] and onehot "
                         "[B, Q]")
    nb, d = lo.shape
    nq = onehot.shape[1]
    block = rows3.shape[1]
    n = cand.shape[0] * block
    _check("n_hit", n_hit, torch.int32, (), dev)
    _check("lo", lo, torch.float32, (nb, d), dev)
    _check("hi", hi, torch.float32, (nb, d), dev)
    _check("onehot", onehot, torch.float32, (nb, nq), dev)
    if rows3.shape[2] != d:
        raise ValueError("box_scan_seg: rows and boxes differ in D")
    if n >= 2 ** 31:
        raise ValueError("box_scan_seg: too many rows for one launch")
    out = torch.empty((n, nq), dtype=torch.int32, device=dev)
    fn = launch_fn("box_scan_seg")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows3.data_ptr(), cand.data_ptr(), n_hit.data_ptr(),
                 block, lo.data_ptr(), hi.data_ptr(), onehot.data_ptr(),
                 n, nb, d, nq, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"box_scan_seg kernel launch failed: CUDA error "
                           f"{err}")
    seg_launches += 1
    return out
