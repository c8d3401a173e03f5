"""zone_prune — the index prune stage as a CUDA kernel (csrc/zone_prune.cu).

Counterpart of ``repro.kernels.zone_prune``. Three entry points:
``zone_prune`` returns the full [NZ, B] overlap mask (the Pallas kernel's
output, kept for the kernel tests and the use_fused=False host oracle),
``zone_hits`` the [NZ] any-overlap vector, and ``zone_candidates`` the
fused probe's front end in one launch: the candidate list and the hit
count that ``jnp.nonzero(hit, size=capacity, fill_value=0)`` and
``hit.sum()`` give in the reference's ``fused_query``. All take CUDA
tensors only; the CPU dispatch to the plain versions lives in
``kernels/ops.py``.

``launches`` counts kernel launches made by any entry point,
``candidates_launches`` those of ``zone_candidates`` alone.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.kernels.build import launch_fn

launches = 0
candidates_launches = 0
# zone_candidates' scratch words (ticket, done counter, one status word a
# tile), zero between launches: one buffer per device, replaced by a larger
# one where a larger NZ needs it. A replaced buffer is kept alive, since a
# CUDA graph captured earlier may still point at it
_scratch: Dict[int, torch.Tensor] = {}
_retired: List[torch.Tensor] = []

def _check_inputs(zlo, zhi, blo, bhi):
    """(NZ, B, D) of zones [NZ, D] and boxes [B, D]: contiguous f32 CUDA
    tensors on one device, else a ValueError / TypeError."""
    if zlo.dim() != 2 or blo.dim() != 2:
        raise ValueError("zone_prune: zones and boxes must be 2-d [*, D]")
    nz, d = zlo.shape
    nb = blo.shape[0]
    dev = zlo.device
    for name, t, shape in (("zlo", zlo, (nz, d)), ("zhi", zhi, (nz, d)),
                           ("blo", blo, (nb, d)), ("bhi", bhi, (nb, d))):
        if t.device.type != "cuda":
            raise ValueError(f"zone_prune: {name} must be a CUDA tensor, "
                             f"got device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"zone_prune: {name} must be float32, got "
                            f"{t.dtype}")
        if t.shape != shape:
            raise ValueError(f"zone_prune: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"zone_prune: {name} must be contiguous")
        if t.device != dev:
            raise ValueError("zone_prune: all inputs must be on one device")
    return nz, nb, d


def _launch(zlo, zhi, blo, bhi, with_mask: bool) -> torch.Tensor:
    """The [NZ, B] mask (``with_mask``) or the [NZ] hit vector."""
    global launches
    nz, nb, d = _check_inputs(zlo, zhi, blo, bhi)
    dev = zlo.device
    out = torch.empty((nz, nb) if with_mask else (nz,), dtype=torch.bool,
                      device=dev)
    fn = launch_fn("zone_prune")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(zlo.data_ptr(), zhi.data_ptr(), blo.data_ptr(),
                 bhi.data_ptr(), nz, nb, d,
                 out.data_ptr() if with_mask else None,
                 None if with_mask else out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zone_prune kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def zone_prune(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
               bhi: torch.Tensor) -> torch.Tensor:
    """[NZ, D] zones x [B, D] boxes -> [NZ, B] bool overlap (CUDA)."""
    return _launch(zlo, zhi, blo, bhi, True)


def zone_hits(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
              bhi: torch.Tensor) -> torch.Tensor:
    """[NZ] bool: does zone z overlap any box (CUDA; stops at a zone's
    first overlapping box)."""
    return _launch(zlo, zhi, blo, bhi, False)


def _scratch_for(device: torch.device, nz: int) -> torch.Tensor:
    # at most ceil(nz / 1,024) tiles (csrc/zone_prune.cu), rounded up to a
    # power of two so that few buffers are ever retired
    words = 1 << (1 + -(-nz // 1024)).bit_length()
    buf = _scratch.get(device.index)
    if buf is None or buf.numel() < words:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _scratch[device.index] = buf
    return buf


def zone_candidates(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
                    bhi: torch.Tensor, capacity: int):
    """(cand [capacity] int32, n_hit [] int32) in one launch (CUDA): the
    ascending ids of the first ``capacity`` zones that overlap any box,
    0-filled past n_hit, and the number of such zones before the cut.
    Nothing is read back to the host. Above 1,024 zones the launch spans
    several CTAs that share the device's one scratch buffer, so calls on
    two streams of one device must not run at once; the first call at a
    larger NZ allocates that buffer and must not be captured in a graph."""
    global launches, candidates_launches
    nz, nb, d = _check_inputs(zlo, zhi, blo, bhi)
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError("zone_prune: capacity must be >= 0")
    dev = zlo.device
    cand = torch.empty(capacity, dtype=torch.int32, device=dev)
    n_hit = torch.empty((), dtype=torch.int32, device=dev)
    fn = launch_fn("zone_prune", "zone_candidates_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch_for(dev, nz)
        err = fn(zlo.data_ptr(), zhi.data_ptr(), blo.data_ptr(),
                 bhi.data_ptr(), nz, nb, d, capacity, cand.data_ptr(),
                 n_hit.data_ptr(), scratch.data_ptr(), scratch.numel(),
                 stream)
    if err != 0:
        raise RuntimeError(f"zone_candidates kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    candidates_launches += 1
    return cand, n_hit
