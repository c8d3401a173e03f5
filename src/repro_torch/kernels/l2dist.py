"""l2dist — the kNN model's squared-L2 distance matrix as a CUDA kernel
(csrc/l2dist.cu).

Counterpart of ``repro.kernels.l2dist``. The kernel sums the squared
differences directly, dims in ascending order, with round-to-nearest
intrinsics, so it equals the plain version ``kernels/ref.l2dist_ref``
bitwise. It takes CUDA tensors only; the CPU dispatch to the plain
version lives in ``kernels/ops.py``.

``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0
MAX_QUERIES = 12 * 1024        # one staged dim of every query fits 48 KB


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"l2dist: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.device != device:
        raise ValueError("l2dist: all inputs must be on one device")
    if t.dtype != torch.float32:
        raise TypeError(f"l2dist: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"l2dist: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"l2dist: {name} must be contiguous")


def l2dist(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x: [N, D] f32; q: [Q, D] f32 -> [N, Q] f32 squared L2 distances
    (CUDA). Ragged N and D are taken as they are."""
    global launches
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError("l2dist: x must be [N, D] and q [Q, D]")
    n, d = x.shape
    nq = q.shape[0]
    _check("x", x, (n, d), x.device)
    _check("q", q, (nq, d), x.device)
    if nq > MAX_QUERIES:
        raise ValueError(f"l2dist: at most {MAX_QUERIES} queries per call, "
                         f"got {nq}")
    out = torch.empty((n, nq), dtype=torch.float32, device=x.device)
    if n == 0 or nq == 0:
        return out
    fn = launch_fn("l2dist")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), q.data_ptr(), n, d, nq, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"l2dist kernel launch failed: CUDA error {err}")
    launches += 1
    return out
