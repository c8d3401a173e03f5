"""Shared model building blocks (counterpart of ``repro.models.common``):
the distribution context, the RMS norm, the MLP activations, RoPE and
the initialisers.

``ParallelCtx`` has the reference's fields, holding a ``DeviceMesh`` (one
process a mesh device, ``torch.distributed``) where the reference holds
a ``jax.sharding.Mesh``; the reference's ``moe_impl`` and
``moe_chunk_tokens`` are left out, since no layer of either package
reads them. The reference's layers run under GSPMD: ``mshard`` is
``with_sharding_constraint`` and XLA inserts the collectives, so a
sharded run returns the single-device result. The port's layers
compute on local shards with explicit collectives instead
(``all_reduce``, ``all_gather``, ``gather_placed``), which ``ctx.comm``
counts; ``mshard`` cuts this rank's shard out of a whole tensor. Without
a mesh every one of them is a no-op and the layers run their single-
device code.

Gradients on a mesh: the train step differentiates each rank's program
from its loss times ``loss_scale(ctx)`` (1 / the mesh's size), so that
the sum over the ranks of what they differentiate is the loss. A
tensor's gradient on a rank is then this rank's part of it: where a
tensor is alike on several ranks (a replica), each rank's gradient is
the part that flows through its own use of it, and the parts add up
where the replicas were made. Every collective's backward is its
adjoint under that sum: ``all_reduce``'s an all-reduce of the gradient,
an all-gather's (``all_gather``, ``gather_placed``) a reduce-scatter
(each rank keeps its block of the sum over the ranks), ``mshard``'s (a
narrow) the gradient in place with zeros around it. So a weight's FSDP
gather sums its rows' gradients over the data ranks into this rank's
block, an activation gathered over the model axis gives each rank back
the sum of its block's parts, and an input alike over the model axis
that enters a column- or row-parallel product gets its parts summed by
the all-reduce or reduce-scatter that made it alike. A parameter's
gradient is thus its shard's over the axes that shard it; over an axis
it is replicated on, the train step adds the replicas' parts
(``sum_replicas``). ``ctx.comm`` counts the backward's collectives apart
(``CommStats.backward``); a remat recompute's are forward ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.compat import (DeviceMesh, DTensor, Replicate, Shard,
                                all_gather_single, local_tensor,
                                reduce_scatter_single)
from repro_torch.launch import sharding


class CommStats:
    """Calls and bytes of the collectives a context made on this rank, by
    kind ("all_reduce", "all_gather", "reduce_scatter"), those of the
    backward apart (``backward``, a CommStats of its own). A collective's
    bytes are those of its larger buffer on this rank: all_reduce's
    tensor, all_gather's output, reduce_scatter's input."""

    def __init__(self, _backward: bool = False):
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.backward = None if _backward else CommStats(True)

    def add(self, kind: str, t: torch.Tensor, backward: bool = False) -> None:
        if backward:
            self.backward.add(kind, t)
            return
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) \
            + t.numel() * t.element_size()

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        if self.backward is not None:
            self.backward.reset()

    def snapshot(self) -> dict:
        out = {"calls": dict(self.calls), "bytes": dict(self.bytes),
               "total_bytes": sum(self.bytes.values())}
        if self.backward is not None:
            out["backward"] = self.backward.snapshot()
        return out


@dataclass(frozen=True)
class ParallelCtx:
    """Distribution context threaded through every model call.

    ``mesh is None`` means single-device: every collective and placement
    is a no-op and the layers run their unsharded code."""

    mesh: Optional[DeviceMesh] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"     # None => ZeRO-3 mode: the model
    #                                      axis joins dp_axes; no tensor
    #                                      parallelism, weights fully sharded
    sequence_parallel: bool = False      # Megatron-SP residual sharding (train)
    decode_seq_parallel: bool = True     # shard KV cache sequence over tp_axis
    seq_shard_acts: bool = False         # context-parallel serving: shard
    #                                      activations along SEQ over tp_axis
    comm: CommStats = field(default_factory=CommStats, compare=False,
                            repr=False)

    @property
    def dp(self) -> Optional[Tuple[str, ...]]:
        return self.dp_axes if self.mesh is not None else None

    @property
    def tp_degree(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.size(self.tp_axis)

    @property
    def seq_axis(self) -> Optional[str]:
        return self.tp_axis if self.seq_shard_acts else None

    def _axes(self, axes) -> Tuple[str, ...]:
        if axes is None or self.mesh is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in axes if a in self.mesh.mesh_dim_names)

    def size(self, axes) -> int:
        """Ranks along ``axes`` (an axis name, a tuple of them, or None)."""
        n = 1
        for a in self._axes(axes):
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        return n

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis major."""
        i = 0
        for a in self._axes(axes):
            m = self.mesh.mesh_dim_names.index(a)
            i = i * self.mesh.size(m) + self.mesh.get_local_rank(m)
        return i


class Layout(NamedTuple):
    """Where a [B, S, ...] activation lives on the mesh: its global batch
    ``b``, sharded over the axes ``bax`` (the largest prefix of the batch
    axes that divides it, as ``sharding.batch_shardings`` places a
    batch), its global length ``s``, sharded over ``seq_axis`` (or not)."""
    b: int
    bax: Tuple[str, ...]
    s: int
    seq_axis: Optional[str] = None


def layout(ctx: ParallelCtx, b: int, s: int,
           seq_axis: Optional[str] = None) -> Layout:
    """Under ZeRO-3 (no ``tp_axis``) the batch axes are every mesh axis,
    as ``sharding.batch_shardings(..., "zero3")`` places a batch."""
    mode = "zero3" if ctx.tp_axis is None else "fsdp_tp"
    bax = sharding._dp_for(b, ctx.mesh, mode) or ()
    return Layout(b, tuple(a for a in bax if a in ctx.dp_axes), s,
                  seq_axis if s > 1 else None)


def rows(ctx: ParallelCtx, n: int, axes) -> Tuple[int, int]:
    """[lo, hi) of this rank's block when ``n`` is split over ``axes``."""
    return sharding.split(n, ctx.size(axes), ctx.index(axes))


def mshard(x: torch.Tensor, ctx: ParallelCtx, *spec) -> torch.Tensor:
    """This rank's block of ``x`` (the whole tensor, alike on every rank)
    under ``spec`` (one entry a dim: None or the axes sharding it); ``x``
    itself without a mesh."""
    if ctx.mesh is None:
        return x
    for d, axes in enumerate(spec):
        if axes is not None and ctx.size(axes) > 1:
            lo, hi = rows(ctx, x.shape[d], axes)
            x = x.narrow(d, lo, hi - lo)
    return x


def _groups(ctx: ParallelCtx, axes) -> list:
    """The process groups of ``axes``' axes of more than one rank."""
    return [ctx.mesh.get_group(a) for a in ctx._axes(axes)
            if ctx.size(a) > 1]


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduce(torch.autograd.Function):
    """A sum over ``groups`` whose backward is the same sum of the
    gradient (the adjoint: every rank's input reaches every rank's
    output)."""

    @staticmethod
    def forward(fctx, x, groups, comm):
        fctx.groups, fctx.comm = groups, comm
        y = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
            comm.add("all_reduce", y)
        return y

    @staticmethod
    def backward(fctx, grad):
        grad = grad.contiguous().clone()
        for g in fctx.groups:
            dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=g)
            fctx.comm.add("all_reduce", grad, backward=True)
        return grad, None, None


def all_reduce(x: torch.Tensor, ctx: ParallelCtx, axes,
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced ("sum" or "max") over the ranks along ``axes``. A sum
    of a tensor that requires grad is differentiable (its backward an
    all-reduce of the gradient) and leaves ``x`` as it was; otherwise the
    reduction is in place. A max carries no gradient (the result is
    detached): it serves as a shift, as a log-sum-exp's."""
    groups = _groups(ctx, axes)
    if not groups:
        return x
    if op == "sum" and _differentiated(x):
        return _AllReduce.apply(x, groups, ctx.comm)
    x = x.detach().contiguous()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    for g in groups:
        dist.all_reduce(x, op=red, group=g)
        ctx.comm.add("all_reduce", x)
    return x


def _gather_plan(n: int, width: int, total: Optional[int]):
    """(block width, the blocks' true sizes or None) of an all-gather of
    ``n`` blocks of ``width``; ``total``: the whole length, where the
    blocks are of ``sharding.split``'s uneven sizes (each padded to the
    longest for the collective)."""
    if total is not None and total % n:
        sizes = [hi - lo for lo, hi in (sharding.split(total, n, r)
                                        for r in range(n))]
        return max(sizes), sizes
    return width, None


def _gather0(xt: torch.Tensor, n: int, width: int, sizes, group,
             comm: Optional[CommStats]) -> torch.Tensor:
    """The all-gather along dim 0 of ``xt`` (this rank's block), padded to
    ``width`` for the collective and the pads dropped after."""
    if xt.shape[0] < width:
        pad = xt.new_zeros((width - xt.shape[0],) + tuple(xt.shape[1:]))
        xt = torch.cat([xt, pad])
    xt = xt.contiguous()
    out = xt.new_empty((n * width,) + tuple(xt.shape[1:]))
    all_gather_single(out, xt, group)
    if comm is not None:
        comm.add("all_gather", out)
    if sizes:
        out = torch.cat([out[r * width:r * width + sizes[r]]
                         for r in range(n)])
    return out


class _GatherAxis(torch.autograd.Function):
    """``_gather0`` whose backward is the adjoint reduce-scatter: each rank
    keeps its block of the gradient summed over the ranks."""

    @staticmethod
    def forward(fctx, xt, n, width, sizes, group, comm):
        fctx.plan = (n, width, sizes, group, comm, xt.shape[0])
        return _gather0(xt, n, width, sizes, group, comm)

    @staticmethod
    def backward(fctx, grad):
        n, width, sizes, group, comm, own = fctx.plan
        if sizes:
            full = grad.new_zeros((n * width,) + tuple(grad.shape[1:]))
            off = 0
            for r in range(n):
                full[r * width:r * width + sizes[r]] = \
                    grad[off:off + sizes[r]]
                off += sizes[r]
            grad = full
        grad = grad.contiguous()
        out = grad.new_empty((width,) + tuple(grad.shape[1:]))
        reduce_scatter_single(out, grad, group)
        if comm is not None:
            comm.add("reduce_scatter", grad, backward=True)
        return out[:own], None, None, None, None, None


def _gather_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int,
                 total: Optional[int] = None,
                 comm: Optional[CommStats] = None) -> torch.Tensor:
    """The blocks of ``x`` of the ranks along mesh axis ``axis``
    concatenated along ``dim`` by one all-gather into a tensor;
    ``total``: the whole length, where the blocks are of
    ``sharding.split``'s uneven sizes (each padded to the longest for the
    collective, the pads dropped after). Differentiable (a reduce-scatter
    backward) where ``x`` requires grad."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    width, sizes = _gather_plan(n, x.shape[dim], total)
    xt = x.movedim(dim, 0)
    group = mesh.get_group(axis)
    if _differentiated(xt):
        out = _GatherAxis.apply(xt, n, width, sizes, group, comm)
    else:
        out = _gather0(xt, n, width, sizes, group, comm)
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, ctx: ParallelCtx, axes, dim: int,
               total: Optional[int] = None) -> torch.Tensor:
    """The blocks of the ranks along ``axes`` concatenated along ``dim``
    (the inverse of ``mshard``), minor axis first; ``total``: the whole
    length, where the blocks are of ``sharding.split``'s uneven sizes."""
    ax = [a for a in ctx._axes(axes) if ctx.size(a) > 1]
    for a in reversed(ax):
        x = _gather_axis(x, ctx.mesh, a, dim, total if len(ax) == 1
                         else None, ctx.comm)
    return x


def loss_scale(ctx: Optional[ParallelCtx]) -> float:
    """What each rank's loss is scaled by before its backward: 1 / the
    mesh's ranks, so the ranks' parts add up to the loss's gradient (the
    module's convention); 1 without a mesh."""
    if ctx is None or ctx.mesh is None:
        return 1.0
    return 1.0 / ctx.mesh.size()


def placed_axes(p, kind) -> Tuple[str, ...]:
    """The axes of more than one rank on which DTensor ``p``'s placement
    is of ``kind`` (``Shard`` or ``Replicate``); () for a plain tensor."""
    if not isinstance(p, DTensor):
        return ()
    mesh = p.device_mesh
    return tuple(a for m, a in enumerate(mesh.mesh_dim_names)
                 if isinstance(p.placements[m], kind) and mesh.size(m) > 1)


def sum_over(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axes,
             comm: Optional[CommStats] = None,
             backward: bool = False) -> None:
    """Each of ``tensors`` (one dtype and device) <- its sum over the ranks
    along ``axes``, in place, by one all-reduce an axis over the tensors
    laid end to end."""
    axes = [a for a in axes if mesh.size(mesh.mesh_dim_names.index(a)) > 1]
    if not tensors or not axes:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for a in axes:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        if comm is not None:
            comm.add("all_reduce", flat, backward)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def sum_replicas(grads: Dict[str, torch.Tensor], params,
                 comm: Optional[CommStats] = None) -> None:
    """Each gradient (of a DTensor parameter's local shard) <- the sum of
    its replicas' parts over the axes the parameter is replicated on, in
    place: one all-reduce an axis for the gradients of the same axes and
    dtype, counted as the backward's."""
    groups: Dict[tuple, list] = {}
    mesh = None
    for name, p in params.items():
        axes = placed_axes(p, Replicate)
        if axes:
            mesh = p.device_mesh
            groups.setdefault((axes, grads[name].dtype), []).append(
                grads[name])
    for (axes, _), ts in groups.items():
        sum_over(ts, mesh, axes, comm, backward=True)


def local(t) -> torch.Tensor:
    """A DTensor's shard on this rank, the same tensor object every call
    (``compat.local_tensor``: a parameter's shard is the leaf the train
    step differentiates against); a plain tensor as it is."""
    return local_tensor(t) if isinstance(t, DTensor) else t


def gather_placed(t, ctx: Optional[ParallelCtx] = None,
                  keep: Sequence[str] = ()) -> torch.Tensor:
    """A DTensor placed by the rules (a parameter, a cache leaf, the
    logits): its shard on this rank with the dims of every mesh axis not
    in ``keep`` gathered, minor axis first — the FSDP all-gather around a
    weight's use; with ``keep=()`` the whole tensor. ``ctx.comm`` (where
    given) counts the collectives. A plain tensor passes through.

    The gathers are the port's own all-gathers into a tensor, not
    DTensor's ``redistribute`` / ``full_tensor``: those wait on
    functional collectives, which crash the process under gloo on CUDA
    tensors (torch 2.11, the card's), the backend of a world on one
    card."""
    if not isinstance(t, DTensor):
        return t
    mesh, names = t.device_mesh, t.device_mesh.mesh_dim_names
    x = local(t)
    for m in reversed(range(len(names))):
        pl = t.placements[m]
        if names[m] in keep or not isinstance(pl, Shard):
            continue
        if any(names[k] in keep and t.placements[k] == pl
               for k in range(m + 1, len(names))):
            raise ValueError(f"cannot gather {names[m]} of dim {pl.dim} "
                             f"while keeping a minor axis of it sharded")
        x = _gather_axis(x, mesh, names[m], pl.dim,
                         comm=None if ctx is None else ctx.comm)
    return x


def sharded_dim(p, axis: Optional[str]) -> Optional[int]:
    """The tensor dim that mesh axis ``axis`` shards in DTensor ``p``
    (None: replicated over it, or a plain tensor)."""
    if not isinstance(p, DTensor) \
            or axis not in p.device_mesh.mesh_dim_names:
        return None
    m = p.device_mesh.mesh_dim_names.index(axis)
    pl = p.placements[m]
    return pl.dim if pl.is_shard() else None


def gathered(module: nn.Module, names: Sequence[str], ctx: ParallelCtx,
             keep: Sequence[str] = ()):
    """A stand-in for ``module`` whose attributes ``names`` are its
    parameters gathered by ``gather_placed`` (None stays None), for the
    layer functions that read ``p.<name>``."""
    from types import SimpleNamespace
    return SimpleNamespace(**{
        n: None if getattr(module, n) is None
        else gather_placed(getattr(module, n), ctx, keep) for n in names})


def matmul(x: torch.Tensor, w, ctx: ParallelCtx) -> torch.Tensor:
    """``x @ w`` for ``x`` alike on every rank of ``ctx.tp_axis`` and a
    weight [K, N] placed by the rules; the result alike on every rank.
    Where the rule shards w's columns over the model axis it is column-
    parallel (each rank its columns, then an all-gather), where it shards
    its rows row-parallel (each rank its rows of K, then an all-reduce);
    a weight replicated over the axis is used whole."""
    tp = ctx.tp_axis
    d = sharded_dim(w, tp)
    wl = gather_placed(w, ctx, keep=(tp,) if d is not None else ())
    if d == 1:
        return all_gather(x @ wl.to(x.dtype), ctx, tp, -1, w.shape[1])
    if d == 0:
        lo, hi = rows(ctx, w.shape[0], tp)
        return all_reduce(x[..., lo:hi] @ wl.to(x.dtype), ctx, tp)
    return x @ wl.to(x.dtype)


def row_out(h: torch.Tensor, w, ctx: ParallelCtx) -> torch.Tensor:
    """``h @ w`` for ``h`` [..., K] split along K over ``ctx.tp_axis``
    (``rows``' blocks, as a column-parallel product leaves it) and a
    weight [K, N] placed by the rules; the result alike on every rank.
    A weight whose rows the rule shards over the axis is row-parallel
    (an all-reduce). One whose columns it shards (the MLPs' ``w_out``) is
    used by whichever moves fewer bytes: with fewer tokens than N, ``h``
    is gathered and the product is column-parallel; else the weight is
    gathered whole and its rows for this rank's block of K taken."""
    tp = ctx.tp_axis
    d = sharded_dim(w, tp)
    k, n = w.shape
    if d == 0:
        wl = gather_placed(w, ctx, keep=(tp,))
        return all_reduce(h @ wl.to(h.dtype), ctx, tp)
    if d == 1 and h.numel() // h.shape[-1] < n:
        hf = all_gather(h, ctx, tp, -1, k)
        wl = gather_placed(w, ctx, keep=(tp,))
        return all_gather(hf @ wl.to(h.dtype), ctx, tp, -1, n)
    lo, hi = rows(ctx, k, tp)
    wf = gather_placed(w, ctx)
    return all_reduce(h @ wf[lo:hi].to(h.dtype), ctx, tp)


def to_cache(t: torch.Tensor, name: str, ctx: ParallelCtx, b: int,
             seq_parallel: bool = True) -> DTensor:
    """A cache leaf ``name`` (k, v, conv, ssd or h) that holds this rank's
    batch rows of a global batch ``b`` and is whole in every other dim, as
    the DTensor ``sharding.cache_spec`` places it: the leaf's model-axis
    block cut out."""
    shape = (b,) + tuple(t.shape[1:])
    spec = sharding.cache_spec(name, shape, ctx.mesh, seq_parallel)
    sh = sharding.NamedSharding(ctx.mesh, spec)
    for d in range(1, len(spec)):
        if spec[d] is not None:
            t = mshard(t, ctx, *([None] * d + [spec[d]]))
    return sharding.from_local(t.contiguous(), sh, shape)


def from_cache(t, ctx: ParallelCtx) -> torch.Tensor:
    """A cache leaf's rows of this rank's batch, whole in every other dim
    (``to_cache``'s inverse)."""
    return gather_placed(t, ctx, ctx.dp_axes)


# ----------------------------------------------------------------------
# numerics
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, computed in float32
    and cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's own
    default is the exact erf form, which differs by up to ~5e-4)."""
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return gelu
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """[head_dim / 2] float32 inverse frequencies theta^(-i / half)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [S] or [B, S] integers. Rotates the
    two halves of the head dim (half-split, not interleaved) in float32
    and casts back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs    # [..., S, D/2]
    if angles.dim() == 2:                # [S, D/2] -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]                     # [B, S, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis: int = 0) -> torch.Tensor:
    """N(0, 1/fan_in) float32 weights drawn on the CPU from
    ``generator``; fan_in is ``shape[in_axis]``."""
    std = shape[in_axis] ** -0.5
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32) * std


def normal_init(generator: torch.Generator, shape: Sequence[int],
                std: float) -> torch.Tensor:
    """N(0, std^2) float32 drawn on the CPU from ``generator``."""
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32) * std


# elements of one float32 draw in fill_normal_ / fill_uniform_: 1 GiB, so
# a full-width weight (llama4's 128 x 5120 x 8192 expert bank) is drawn
# with a transient of at most that size
DRAW_CHUNK_ELEMS = 1 << 28


def _fill_(t: torch.Tensor, draw) -> torch.Tensor:
    """Fill ``t`` in slices along its first dim, each at most
    DRAW_CHUNK_ELEMS elements, with ``draw(shape)`` float32 numbers drawn
    on the generator's device and cast to t's dtype and device. A meta
    tensor (a dry run's) holds no values, so nothing is drawn for it."""
    if t.device.type == "meta":
        return t
    if t.dim() == 0 or t.numel() == 0:
        t.copy_(draw(tuple(t.shape)))
        return t
    row = max(t[0].numel(), 1)
    step = max(1, DRAW_CHUNK_ELEMS // row)
    for r0 in range(0, t.shape[0], step):
        part = t[r0:r0 + step]
        part.copy_(draw(tuple(part.shape)))
    return t


def fill_normal_(t: torch.Tensor, generator: torch.Generator,
                 std: float) -> torch.Tensor:
    """``t`` <- N(0, std^2), drawn in float32 from ``generator`` (on its
    own device) chunk by chunk, cast to t's dtype."""
    dev = generator.device
    return _fill_(t, lambda shape: torch.randn(
        shape, generator=generator, dtype=torch.float32,
        device=dev).mul_(std))


def fill_uniform_(t: torch.Tensor, generator: torch.Generator, lo: float,
                  hi: float) -> torch.Tensor:
    """``t`` <- U(lo, hi), drawn in float32 from ``generator``."""
    dev = generator.device
    return _fill_(t, lambda shape: torch.rand(
        shape, generator=generator, dtype=torch.float32,
        device=dev).mul_(hi - lo).add_(lo))


def fill_dense_(t: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> torch.Tensor:
    """``t`` <- N(0, 1/fan_in), fan_in = t.shape[in_axis]: the
    reference's ``dense_init`` into an existing tensor."""
    return fill_normal_(t, generator, t.shape[in_axis] ** -0.5)


def param(shape: Sequence[int], dtype, device) -> nn.Parameter:
    """An uninitialised parameter without grad (the LM serves; its
    initialisers or ``core.convert.lm_from_numpy`` fill it)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                    device=device), requires_grad=False)


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]
