"""torch version-compatibility shims for the mesh — counterpart of
``repro.compat`` (the reference's ``shard_map`` shim).

The port's mesh runs on two torch versions: 2.11 on the card, 2.13 on
the CPU test box. What differs between them, and so goes through here:

  * the name of the collective that gathers into one tensor: 2.13 calls
    it ``all_gather_single`` and deprecates ``all_gather_into_tensor``,
    2.11 has only the latter.

The mesh's types are imported from here too, at the paths both versions
share: ``DeviceMesh`` from ``torch.distributed.device_mesh``, ``DTensor`` / ``Shard`` /
``Replicate`` from ``torch.distributed.tensor`` (public since 2.4).

The port computes on local shards with explicit collectives, so it needs
no ``local_map``. A DTensor holds a placed tensor's shard and placements
only: the port calls none of DTensor's collectives (``redistribute``,
``full_tensor``), since their functional collectives crash the process
under gloo on CUDA tensors with torch 2.11. Both backends it runs on do every collective it calls on
the tensors it hands them: gloo on the CPU, and gloo on CUDA tensors too
(``chip_smoke.py``'s ``lm_mesh`` phase checks all_reduce (sum, max;
float32 and bfloat16), all_gather, all_gather_into_tensor (float32 and
bfloat16), reduce_scatter_tensor, all_to_all_single and broadcast on an
H100 with torch 2.11 on every run, and fails if one the mesh uses,
``MESH_COLLECTIVES`` there, is missing), so no collective is rebuilt
from others.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["DTensor", "DeviceMesh", "Replicate", "Shard",
           "all_gather_single"]

_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` [n * len(x), ...] <- the ``n`` ranks' ``x`` concatenated
    along dim 0 in group-rank order (``all_gather_single`` on torch >=
    2.13, ``all_gather_into_tensor`` before)."""
    _GATHER(out, x, group=group)
