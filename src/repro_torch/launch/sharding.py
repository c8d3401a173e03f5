"""Parameter / state / batch sharding rules for every architecture —
counterpart of ``repro.launch.sharding``.

One rule function maps (the reference's leaf path, its shape) to a spec,
a tuple with one entry a dim: None (replicated), an axis name, or a
tuple of axis names sharding that dim jointly (major first):

  * FSDP: the `data` axis shards one weight dim of every matrix (ZeRO-3
    style; the port all-gathers it around its use).
  * TP:   the `model` axis shards heads / d_ff / vocab / SSM-inner /
    LRU width / the expert dim of MoE banks.
  * Stacked block params (under "blocks/") get a leading None for the
    scan dimension.
  * Multi-pod: batch shards over ("pod","data"); weights FSDP only over
    "data".

``param_spec`` is the reference's rule verbatim, a pure function of
(path, shape, mesh axes, mode). The rule reads the reference's block-
stacked leaf (``blocks/slotN/...``, shape [nblocks, ...]); the port
holds one tensor a layer, so ``lm_param_specs`` maps each port tensor to
its reference leaf (``reference_leaf``) and drops the stack dim from the
spec. ``NamedSharding`` is the counterpart of jax's: a mesh and a spec,
read as DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh
dim); ``place`` cuts a rank's shard out of a full tensor (no
communication) and wraps it as a DTensor;
``models.common.gather_placed`` gathers one back.
A shard is the dim's ``ceil(n / parts)``-sized block at the rank's index
along the dim's axes, as GSPMD cuts it; the rules only shard dims their
axes divide, so parameters and caches split evenly.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compat import DeviceMesh, DTensor, Replicate, Shard
from repro_torch.configs.base import ModelConfig

FSDP_AXIS = "data"
TP_AXIS = "model"

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of any
    object with the reference's ``shape`` mapping and ``axis_names`` (the
    rules read nothing else of a mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes if a in ("pod", "data"))


def param_spec(path_str: str, shape: Tuple[int, ...], mesh,
               mode: str = "fsdp_tp") -> Spec:
    """Sharding rule for one parameter tensor (the reference's leaf path
    and shape; ``mesh`` anything ``axis_sizes`` reads).

    Modes:
      fsdp_tp — ZeRO-3 over `data` x tensor-parallel over `model`.
      zero3   — fully-sharded weights over ALL mesh axes, no TP: every
                matrix shards its largest divisible dim over
                ("pod","data","model") jointly.
    """
    sizes = axis_sizes(mesh)
    stacked = "blocks/" in path_str
    base = shape[1:] if stacked else shape
    name = path_str.rsplit("/", 1)[-1]

    def out(*spec):
        # drop sharding on non-divisible dims (safety: falls back to repl)
        fixed = []
        for dim, s in zip(base, spec):
            if s is None:
                fixed.append(None)
            else:
                axes = s if isinstance(s, tuple) else (s,)
                ok = True
                d = dim
                for a in axes:
                    if d % sizes[a]:
                        ok = False
                        break
                    d //= sizes[a]
                fixed.append(s if ok else None)
        if stacked:
            fixed = [None] + fixed
        return tuple(fixed)

    if len(base) == 1:
        return out(None)                       # norms / biases / diag gates

    if mode == "zero3":
        all_axes = tuple(sizes)
        total = math.prod(sizes.values())
        if name in ("embed", "unembed"):
            # shard the d_model dim, NEVER the vocab dim
            d_dim = 1 if name == "embed" else 0
            spec = [None] * len(base)
            if base[d_dim] % total == 0:
                spec[d_dim] = all_axes
            return out(*spec)
        # shard the largest dim divisible by the full device count
        order = sorted(range(len(base)), key=lambda i: -base[i])
        for i in order:
            if base[i] % total == 0:
                spec = [None] * len(base)
                spec[i] = all_axes
                return out(*spec)
        return out(*([None] * len(base)))      # tiny tensor: replicate

    # --- embeddings ---------------------------------------------------
    if name == "embed":
        return out(TP_AXIS, FSDP_AXIS)         # [V, d]
    if name == "unembed":
        return out(FSDP_AXIS, TP_AXIS)         # [d, V]

    # --- MoE expert banks [E, d, ff] / [E, ff, d] ----------------------
    # E shards over `model` (expert parallelism); of the two matrix dims
    # the LARGER shards over `data`
    if ("moe/" in path_str and len(base) == 3
            and name in ("w_in", "w_gate", "w_out")):
        if base[1] >= base[2]:
            return out(TP_AXIS, FSDP_AXIS, None)
        return out(TP_AXIS, None, FSDP_AXIS)
    if name == "router":
        return out(FSDP_AXIS, None)

    # --- attention ----------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return out(FSDP_AXIS, TP_AXIS)
    if name == "wo":
        return out(TP_AXIS, FSDP_AXIS)

    # --- SSM / LRU ------------------------------------------------------
    if name == "in_proj":
        return out(FSDP_AXIS, TP_AXIS)
    if name == "conv_w":
        return out(None, TP_AXIS)
    if name in ("w_in", "w_gate", "gate_a", "gate_x"):
        return out(FSDP_AXIS, TP_AXIS)
    if name == "out_proj":
        return out(TP_AXIS, FSDP_AXIS)

    # --- generic 2-d matmul weight -------------------------------------
    if len(base) == 2:
        return out(FSDP_AXIS, TP_AXIS)
    if len(base) == 3:
        return out(None, FSDP_AXIS, TP_AXIS)
    return out(*([None] * len(base)))


def reference_leaf(name: str, shape: Tuple[int, ...],
                   cfg: ModelConfig) -> Tuple[str, Tuple[int, ...], bool]:
    """(the reference's leaf path, its shape, stacked?) of the port's LM
    tensor ``name`` (a parameter name as ``LM.named_parameters`` gives it,
    or a cache leaf's ``layers.<i>.<field>``) of shape ``shape``: layer i
    of the scanned blocks is ``blocks/slot<i % n>`` of shape [nblocks,
    ...], a tail layer ``tail/layer<t>``; the top-level tensors are
    themselves."""
    if not name.startswith("layers."):
        return name.replace(".", "/"), tuple(shape), False
    _, i, path = name.split(".", 2)
    pattern, nblocks, tail = cfg.scan_pattern()
    n, i = len(pattern), int(i)
    path = path.replace(".", "/")
    if i < nblocks * n:
        return (f"blocks/slot{i % n}/{path}", (nblocks,) + tuple(shape),
                True)
    return f"tail/layer{i - nblocks * n}/{path}", tuple(shape), False


def lm_param_specs(named_shapes, cfg: ModelConfig, mesh,
                   mode: str = "fsdp_tp") -> Dict[str, Spec]:
    """{port tensor name: spec} for (name, shape) pairs (or a module's
    named parameters): the reference's rule on the reference's leaf, the
    stack dim's leading None dropped."""
    if isinstance(named_shapes, torch.nn.Module):
        named_shapes = [(k, p.shape) for k, p in
                        named_shapes.named_parameters()]
    specs = {}
    for name, shape in named_shapes:
        path, rshape, stacked = reference_leaf(name, tuple(shape), cfg)
        spec = param_spec(path, rshape, mesh, mode)
        specs[name] = spec[1:] if stacked else spec
    return specs


# ----------------------------------------------------------------------
# specs as placements
# ----------------------------------------------------------------------

def _axes_of(s: Axes) -> Tuple[str, ...]:
    return () if s is None else (s if isinstance(s, tuple) else (s,))


class NamedSharding(NamedTuple):
    """A spec on a mesh — the counterpart of ``jax.sharding.
    NamedSharding(mesh, PartitionSpec(*spec))``. ``mesh`` is a
    ``DeviceMesh`` (or, for the pure shape arithmetic, anything
    ``axis_sizes`` reads)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """One DTensor placement a mesh dim: ``Shard(d)`` where the spec
        shards tensor dim d over that dim's axis, else ``Replicate()``.
        A dim sharded jointly lists its axes in mesh order, which is the
        order DTensor nests them in."""
        names = tuple(axis_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for d, s in enumerate(self.spec):
            axes = _axes_of(s)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {self.spec}: the axes of dim {d} "
                                 f"are not in mesh order {names}")
            for a in axes:
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def shard_slices(self, shape, coord: Mapping[str, int]) -> tuple:
        """The slices of ``shape`` the mesh position ``coord`` ({axis:
        index}) holds."""
        sizes = axis_sizes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            s = self.spec[d] if d < len(self.spec) else None
            parts, idx = 1, 0
            for a in _axes_of(s):
                parts, idx = parts * sizes[a], idx * sizes[a] + coord[a]
            lo, hi = split(n, parts, idx)
            out.append(slice(lo, hi))
        return tuple(out)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shard shape at mesh position 0 (every position's, for the
        even splits the rules make)."""
        zero = {a: 0 for a in axis_sizes(self.mesh)}
        return tuple(s.stop - s.start
                     for s in self.shard_slices(shape, zero))


def split(n: int, parts: int, idx: int) -> Tuple[int, int]:
    """[lo, hi) of part ``idx`` when ``n`` is cut into ``parts`` blocks of
    ceil(n / parts) (the last ones shorter or empty)."""
    size = -(-n // parts) if parts else n
    lo = min(idx * size, n)
    return lo, min(lo + size, n)


def mesh_coord(mesh: DeviceMesh) -> Optional[Dict[str, int]]:
    """{axis: this rank's index} on ``mesh``, None off it."""
    c = mesh.get_coordinate()
    return None if c is None else dict(zip(mesh.mesh_dim_names, c))


def placed_slices(t: DTensor) -> Optional[tuple]:
    """The slices of ``t``'s global shape that this rank's shard holds,
    read off its placements (each dim's sharding axes in mesh order, major
    first, as ``NamedSharding.shard_slices`` cuts); None off its mesh."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    out = []
    for d, n in enumerate(t.shape):
        parts, idx = 1, 0
        for m, pl in enumerate(t.placements):
            if isinstance(pl, Shard) and pl.dim == d:
                parts, idx = parts * mesh.size(m), idx * mesh.size(m) \
                    + coord[m]
        lo, hi = split(n, parts, idx)
        out.append(slice(lo, hi))
    return tuple(out)


def from_local(local: torch.Tensor, sharding: NamedSharding,
               shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (no communication). The rules split every dim evenly, so
    the global shape is the shard's times its axes' sizes; a ``shape``
    that is not raises."""
    out = DTensor.from_local(local, sharding.mesh, sharding.placements,
                             run_check=False)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"a shard {tuple(local.shape)} under "
                         f"{sharding.spec} is not one of {tuple(shape)}")
    return out


def place(full, sharding: NamedSharding, device=None, dtype=None):
    """This rank's shard of ``full`` (a tensor, or a numpy array) as a
    DTensor on ``sharding.mesh``; only the shard is copied to ``device``
    (default: ``full``'s). None on a rank outside the mesh."""
    coord = mesh_coord(sharding.mesh)
    if coord is None:
        return None
    part = full[sharding.shard_slices(tuple(full.shape), coord)]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    part = part.to(device=device, dtype=dtype, copy=True).contiguous()
    return from_local(part, sharding, tuple(full.shape))


# ----------------------------------------------------------------------
# parameters / optimizer state
# ----------------------------------------------------------------------

def params_shardings(model, cfg: ModelConfig, mesh,
                     mode: str = "fsdp_tp") -> Dict[str, NamedSharding]:
    """{parameter name: NamedSharding} of an LM (or (name, shape) pairs)."""
    return {k: NamedSharding(mesh, s)
            for k, s in lm_param_specs(model, cfg, mesh, mode).items()}


def opt_shardings(opt_state, cfg: ModelConfig, mesh):
    """AdamW's moments mirror their parameters (the fsdp_tp rule, as the
    reference's); the step replicates. ``opt_state``: an ``AdamWState``
    (moments by parameter name)."""
    def tree(moments):
        return params_shardings([(k, t.shape) for k, t in moments.items()],
                                cfg, mesh)
    return type(opt_state)(tree(opt_state.m), tree(opt_state.v),
                           replicated(mesh))


# ----------------------------------------------------------------------
# activations / batch / caches
# ----------------------------------------------------------------------

def _dp_for(dim: int, mesh, mode: str = "fsdp_tp"):
    """Largest prefix of the batch axes that divides ``dim`` (handles
    global_batch=1 long-context cells: batch replicates)."""
    sizes = axis_sizes(mesh)
    dp = tuple(sizes) if mode == "zero3" else batch_axes(tuple(sizes))
    while dp and dim % math.prod(sizes[a] for a in dp):
        dp = dp[:-1]
    return dp or None


def batch_shardings(batch, mesh, mode: str = "fsdp_tp"):
    """A dict of [B, ...] arrays (shapes read) -> the same dict of
    NamedShardings: dim 0 over ``_dp_for``, the rest replicated."""
    def f(leaf):
        nd = len(leaf.shape)
        spec = ((_dp_for(leaf.shape[0], mesh, mode),) + (None,) * (nd - 1)
                if nd else ())
        return NamedSharding(mesh, spec)
    return {k: f(v) for k, v in batch.items()}


def _div(dim, mesh, axis):
    return dim % axis_sizes(mesh)[axis] == 0


def cache_spec(name: str, shape, mesh, seq_parallel: bool = True) -> Spec:
    """The rule of one per-layer cache leaf: KV ``k`` / ``v`` [B, S, kv,
    hd] -> (dp, model-on-S, None, None); SSM ``conv`` [B, W-1, C] / ``ssd``
    [B, nh, hd, N] and LRU ``h`` [B, w]: batch + inner-dim sharding."""
    dp = _dp_for(shape[0], mesh)
    if name in ("k", "v"):
        return (dp, TP_AXIS if (seq_parallel and _div(shape[1], mesh,
                                                      TP_AXIS)) else None,
                None, None)
    if name == "conv":
        return (dp, None, TP_AXIS if _div(shape[2], mesh, TP_AXIS) else None)
    if name == "ssd":
        return (dp, TP_AXIS if _div(shape[1], mesh, TP_AXIS) else None,
                None, None)
    if name == "h":
        return (dp, TP_AXIS if _div(shape[1], mesh, TP_AXIS) else None)
    return (dp,) + (None,) * (len(shape) - 1)


def cache_shardings(caches, cfg: ModelConfig, mesh,
                    seq_parallel: bool = True) -> list:
    """The port's per-layer caches (``{"k", "v"}``, ``SSMState``,
    ``LRUState``; tensors of any device, DTensors, or their shapes) ->
    the same structure of NamedShardings, ``cache_spec`` per leaf."""
    out = []
    for c in caches:
        leaves = c._asdict() if isinstance(c, tuple) else c
        specs = {k: NamedSharding(mesh, cache_spec(k, tuple(v.shape), mesh,
                                                   seq_parallel))
                 for k, v in leaves.items()}
        out.append(type(c)(**specs) if isinstance(c, tuple) else specs)
    return out


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
