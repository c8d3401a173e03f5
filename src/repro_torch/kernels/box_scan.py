"""box_scan_seg — the segmented refine stage as a CUDA kernel
(csrc/box_scan_seg.cu).

Counterpart of the ``box_scan_seg`` half of ``repro.kernels.box_scan``.
The kernel reads the surviving blocks rows3[cand] in place and zeroes the
slots >= n_hit (``box_scan_seg_gather``, what ``ops.fused_query`` runs);
``box_scan_seg`` scans given rows x [N, D] (the Pallas kernel's
contract) as the one-block case rows3 = x[None], cand = [0], n_hit = 1.
Both take CUDA tensors only; the CPU dispatch to the plain versions lives
in ``kernels/ops.py``.

``launches`` counts kernel launches (both entry points launch in
``box_scan_seg_gather``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"box_scan_seg: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.device != device:
        raise ValueError("box_scan_seg: all inputs must be on one device")
    if t.dtype != dtype:
        raise TypeError(f"box_scan_seg: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"box_scan_seg: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"box_scan_seg: {name} must be contiguous")


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
    global launches
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
    launches += 1
    return out
