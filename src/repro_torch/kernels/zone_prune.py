"""zone_prune — the index prune stage as a CUDA kernel (csrc/zone_prune.cu).

Counterpart of ``repro.kernels.zone_prune``. Two entry points over one
kernel: ``zone_prune`` returns the full [NZ, B] overlap mask (the Pallas
kernel's output, kept for the kernel tests) and ``zone_hits`` the [NZ]
any-overlap vector the engine path needs. Both take CUDA tensors only;
the CPU dispatch to the plain versions lives in ``kernels/ops.py``.

``launches`` counts kernel launches made by either entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"zone_prune: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"zone_prune: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"zone_prune: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"zone_prune: {name} must be contiguous")


def _launch(zlo, zhi, blo, bhi, with_mask: bool):
    global launches
    if zlo.dim() != 2 or blo.dim() != 2:
        raise ValueError("zone_prune: zones and boxes must be 2-d [*, D]")
    nz, d = zlo.shape
    nb = blo.shape[0]
    _check("zlo", zlo, (nz, d))
    _check("zhi", zhi, (nz, d))
    _check("blo", blo, (nb, d))
    _check("bhi", bhi, (nb, d))
    if len({t.device for t in (zlo, zhi, blo, bhi)}) != 1:
        raise ValueError("zone_prune: all inputs must be on one device")
    hit = torch.empty(nz, dtype=torch.bool, device=zlo.device)
    mask = (torch.empty((nz, nb), dtype=torch.bool, device=zlo.device)
            if with_mask else None)
    fn = launch_fn("zone_prune")
    with torch.cuda.device(zlo.device):
        stream = torch.cuda.current_stream(zlo.device).cuda_stream
        err = fn(zlo.data_ptr(), zhi.data_ptr(), blo.data_ptr(),
                 bhi.data_ptr(), nz, nb, d,
                 mask.data_ptr() if mask is not None else None,
                 hit.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zone_prune kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return mask, hit


def zone_prune(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
               bhi: torch.Tensor) -> torch.Tensor:
    """[NZ, D] zones x [B, D] boxes -> [NZ, B] bool overlap (CUDA)."""
    return _launch(zlo, zhi, blo, bhi, True)[0]


def zone_hits(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
              bhi: torch.Tensor) -> torch.Tensor:
    """[NZ] bool: does zone z overlap any box (CUDA; stops at a zone's
    first overlapping box)."""
    return _launch(zlo, zhi, blo, bhi, False)[1]
