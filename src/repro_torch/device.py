"""Device resolution for the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without CUDA raises: the port
    never carries on quietly on the CPU — pass ``device="cpu"`` for the
    plain PyTorch versions. ``"meta"`` (shapes and dtypes only, nothing
    allocated) is taken for the specs of ``launch.specs``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch supports 'cuda' and 'cpu' devices "
                         f"(and 'meta' for shapes), got {dev}")
    return dev


def to_device_async(a, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` with no host sync: on CUDA
    it is staged in pinned memory and copied with ``non_blocking`` (a
    blocking copy from pageable memory waits for the stream to drain,
    which is a host sync); on the CPU it is a view of the array."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
