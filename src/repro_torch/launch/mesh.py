"""Mesh construction — counterpart of ``repro.launch.mesh``.

The reference builds a ``jax.sharding.Mesh`` over the devices of one
controller. The port runs one process per mesh device (``torch.
distributed``) and builds a ``DeviceMesh`` over the initialised world,
its dims named as the reference's axes. Defined as functions (never
module-level constants), so importing this module touches no process
group.

``init_process_group`` starts a rank with the backend its caller names:
nothing is inferred. One card cannot hold two NCCL ranks, so a world on
one card (``chip_smoke.py``'s ``lm_mesh`` phase) uses gloo on CUDA
tensors; the CPU tests use gloo on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import DeviceMesh
from repro_torch.configs.base import MeshConfig


def init_process_group(backend: str, *, rank: int, world_size: int,
                       init_method: str, device=None) -> None:
    """Join the world as ``rank`` of ``world_size`` through
    ``init_method`` (``"tcp://localhost:<port>"`` or ``"file://<path>"``)
    on ``backend`` ("gloo" or "nccl", the caller's choice). ``device``: a
    CUDA device this rank computes on, made current before the group
    starts."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)


def mesh_of(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    """A DeviceMesh of ``shape`` over world ranks 0 .. prod(shape) - 1,
    row-major as ``jax.make_mesh`` lays out devices. Every rank of the
    world calls it (its sub-groups are made collectively); a rank outside
    the mesh gets a mesh whose ``get_coordinate()`` is None."""
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks single-pod; 2x16x16 = 512 ranks multi-pod.

    Axes: data (batch / FSDP), model (TP / EP / sequence), pod (outer
    data-parallel replica groups). Refuses a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if dist.get_world_size() != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, not {dist.get_world_size()}")
    return mesh_of(shape, axes, device_type)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``cfg.shape`` named ``cfg.axes`` over the world's first
    ``cfg.num_devices`` ranks."""
    return mesh_of(tuple(cfg.shape), tuple(cfg.axes), device_type)


def make_host_mesh(model_axis: int = 1,
                   device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A (data, model) mesh over the whole world (tests / examples).

    Returns None for a world of one rank (or no process group): models
    then run the unsharded path (ParallelCtx(mesh=None))."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return None
    if n % model_axis:
        raise ValueError(f"a world of {n} ranks has no (data, "
                         f"{model_axis}) mesh")
    return mesh_of((n // model_axis, model_axis), ("data", "model"),
                 device_type)


def elastic_mesh_shape(n_devices: int,
                       model_axis: int = 16) -> Tuple[int, ...]:
    """Largest (data, model) grid available from ``n_devices`` survivors —
    used by the elastic-restart path after node loss (train/elastic.py)."""
    while model_axis > 1 and n_devices % model_axis:
        model_axis //= 2
    return (n_devices // model_axis, model_axis)


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Every rank of ``mesh`` waits until each of its ranks has reached
    this call: a one-element all-reduce over each axis in turn (a rank
    leaves the last only after every rank entered the first). Every rank
    of the mesh calls it."""
    dev = "cpu" if mesh.device_type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    t = torch.zeros(1, device=dev)
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, group=mesh.get_group(name))


def any_rank(flag: bool, mesh: DeviceMesh) -> bool:
    """Whether ``flag`` holds on any rank of ``mesh`` (a max over each
    axis); every rank of the mesh calls it."""
    dev = "cpu" if mesh.device_type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    t = torch.tensor([float(flag)], device=dev)
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    return bool(t.item())
