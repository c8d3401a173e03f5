"""torch version-compatibility shims for the mesh — counterpart of
``repro.compat`` (the reference's ``shard_map`` shim).

The port's mesh runs on two torch versions: 2.11 on the card, 2.13 on
the CPU test box. What differs between them, and so goes through here:

  * the names of the collectives into and out of one tensor: 2.13 calls
    them ``all_gather_single`` / ``reduce_scatter_single`` and deprecates
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor``, 2.11 has only
    the latter;
  * what ``DTensor.to_local()`` returns without grad: 2.13 gives a
    parameter's local tensor as a fresh view, so the train step reads
    the local tensor itself (``local_tensor``), the leaf it
    differentiates against.

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
           "all_gather_single", "like_placed", "local_tensor",
           "reduce_scatter_single"]

_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` [n * len(x), ...] <- the ``n`` ranks' ``x`` concatenated
    along dim 0 in group-rank order (``all_gather_single`` on torch >=
    2.13, ``all_gather_into_tensor`` before)."""
    _GATHER(out, x, group=group)


def reduce_scatter_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` <- this rank's block along dim 0 of the sum over the ``n``
    ranks' ``x`` [n * len(out), ...] (``reduce_scatter_single`` on torch
    >= 2.13, ``reduce_scatter_tensor`` before)."""
    _SCATTER(out, x, group=group)


def local_tensor(t: DTensor) -> torch.Tensor:
    """The DTensor's local shard: the same tensor object on every call
    (its ``_local_tensor``), so a parameter's shard can be a leaf that
    requires grad and is written in place, where ``to_local()`` may hand
    out a new view of it."""
    return t._local_tensor


def like_placed(local: torch.Tensor, t: DTensor) -> DTensor:
    """A DTensor of ``t``'s global shape, mesh and placements whose shard
    on this rank is ``local`` (no communication)."""
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())
