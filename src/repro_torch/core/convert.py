"""Carry index state built elsewhere into the port.

``index_from_arrays`` wraps the fields of a zone-map index, given as numpy
arrays (for instance read off the reference engine's indexes), in the
port's ``ZoneMapIndex`` on a chosen device; ``SearchEngine.from_arrays``
assembles a whole engine from such state. An engine built this way
answers exactly as one that built the same state itself.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.index import ZoneMapIndex
from repro_torch.device import resolve_device


def index_from_arrays(dims, perm, rows, zlo, zhi, block: int, n_rows: int,
                      subset_id: int = -1, device=None) -> ZoneMapIndex:
    """A ZoneMapIndex over the given fields; the device mirrors upload to
    ``device`` (default CUDA) at first use."""
    rows = np.ascontiguousarray(rows, np.float32)
    zlo = np.ascontiguousarray(zlo, np.float32)
    zhi = np.ascontiguousarray(zhi, np.float32)
    perm = np.asarray(perm)
    block = int(block)
    if rows.shape[0] % block or perm.shape[0] != rows.shape[0]:
        raise ValueError("rows and perm must cover whole blocks")
    if zlo.shape != (rows.shape[0] // block, rows.shape[1]) \
            or zhi.shape != zlo.shape:
        raise ValueError("zone maps must be [n_blocks, d']")
    return ZoneMapIndex(np.asarray(dims), perm, rows, zlo, zhi, block,
                        int(n_rows), int(subset_id),
                        device=resolve_device(device))
