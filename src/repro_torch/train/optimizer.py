"""AdamW + Adafactor, the cosine schedule and global-norm clipping —
counterpart of ``repro.train.optimizer``.

The reference's optimizers are functional over pytrees; here the trees
are dicts {name: tensor} (for the LM, ``dict(model.named_parameters())``)
and ``update`` writes the new values into the parameters and the
optimizer state in place under ``torch.no_grad()`` (PyTorch's idiom: no
second copy of a 7.5 GB state). The arithmetic is the reference's in
float32 op by op: the schedule and the bias corrections are float32
scalars (``b1 ** step`` of a float32 step), ``mhat / (sqrt(vhat) +
eps)``, decoupled weight decay skipped for 1-d leaves, and every
result cast back to its tensor's dtype. ``state_dtype`` decides the
moments' dtype (bfloat16 for the >= 200 B archs, as the reference).

The reference's LM tree stacks each scanned block slot's layer leaves on
a leading [nblocks] axis, while the port keeps one tensor a layer.
``stacks`` ({leaf name: [tensor names]}, ``core.convert.lm_stacks``)
names the tensors that form one stacked leaf of the reference; a tensor
in no stack is a leaf of its own. The per-leaf rules read the leaf: its
rank (a stacked tensor's ``dim() + 1``) decides AdamW's weight decay and
Adafactor's factoring, and Adafactor's statistics and RMS clip run over
the whole stacked leaf.

On a mesh the parameters and moments are DTensors (the moments placed
as their parameters) and the gradients plain tensors of each rank's
shard (``launch.steps``' train step: the replicas' parts already summed).
Every update is elementwise on the local shards, written in place; a
reduction that spans a sharded dim sums the local shards and all-reduces
over the axes that shard it (never over an axis the tensor is replicated
on): the global norm (each element's square once over the world),
Adafactor's row and column means and its RMS clip. No DTensor op runs:
the collectives are the port's own (``models.common.sum_over``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.compat import DTensor, Shard, like_placed
from repro_torch.models.common import (CommStats, local, placed_axes,
                                       sum_over, torch_dtype)

Tree = Dict[str, torch.Tensor]
Stacks = Dict[str, List[str]]


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    step: int


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _stacked(stacks: Optional[Stacks]) -> set:
    return {n for names in (stacks or {}).values() for n in names}


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up to ``lr`` over ``warmup``
    steps, then a cosine to ``final_frac * lr`` at ``total``; computed in
    float32 as the reference's jnp expression (the value returned is that
    float32 number)."""
    def schedule(step) -> float:
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return float(torch.where(step < warmup, warm, cos))
    return schedule


def _mesh_of(like) -> Optional[object]:
    for t in (like or {}).values():
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def global_norm(tree: Tree, like: Optional[Tree] = None,
                comm: Optional[CommStats] = None) -> torch.Tensor:
    """sqrt of the sum of every tensor's float32 sum of squares: a 0-d
    float32 tensor on the tensors' device (no host sync). ``like``: the
    tensors' parameters ({name: DTensor}) where ``tree`` holds local
    shards: each shard's sum is all-reduced over the axes sharding its
    parameter, grouped by those axes, so each element counts once."""
    sums = {k: torch.sum(torch.square(x.to(torch.float32)))
            for k, x in tree.items()}
    mesh = _mesh_of(like)
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(list(sums.values()))))
    groups: Dict[tuple, list] = {}
    for k, v in sums.items():
        groups.setdefault(placed_axes(like[k], Shard), []).append(v)
    parts = []
    for axes, vals in groups.items():
        part = torch.sum(torch.stack(vals)).reshape(1)
        sum_over([part], mesh, axes, comm)
        parts.append(part)
    return torch.sqrt(torch.sum(torch.cat(parts)))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float,
                        like: Optional[Tree] = None,
                        comm: Optional[CommStats] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scales every gradient by min(1, max_norm / max(norm, 1e-9)) in
    float32, in place (cast back to its dtype). Returns (grads, norm).
    ``like``: as ``global_norm``'s."""
    norm = global_norm(grads, like, comm)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.to(torch.float32) * scale)
    return grads, norm


# elements of one slice of AdamW's update: its float32 temporaries (some
# eight a slice) stay within 2 GiB however large a tensor is; every op is
# elementwise, so the slices give the whole tensor's numbers
UPDATE_CHUNK_ELEMS = 1 << 26


def _chunks(t: torch.Tensor) -> list:
    """``t`` as views along its first dim, each at most UPDATE_CHUNK_ELEMS
    elements (``t`` itself where it is smaller, or 0-d)."""
    if t.dim() == 0 or t.numel() <= UPDATE_CHUNK_ELEMS:
        return [t]
    rows = max(1, UPDATE_CHUNK_ELEMS // max(t[0].numel(), 1))
    return list(torch.split(t, rows))


def _zeros_placed(p, dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype`` on its device; a DTensor
    placed as ``p`` where it is one."""
    z = torch.zeros(local(p).shape, dtype=dtype, device=p.device)
    return like_placed(z, p) if isinstance(p, DTensor) else z


class AdamW:
    """Decoupled weight decay Adam; ``update`` writes params and moments
    in place. ``stacks``: the reference's stacked leaves (module doc)."""

    def __init__(self, schedule: Callable, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, state_dtype="float32",
                 stacks: Optional[Stacks] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.wd = weight_decay
        self.state_dtype = torch_dtype(state_dtype)
        self.stacked = _stacked(stacks)

    def init(self, params: Tree) -> AdamWState:
        zeros = lambda p: _zeros_placed(p, self.state_dtype)
        return AdamWState(m={k: zeros(p) for k, p in params.items()},
                          v={k: zeros(p) for k, p in params.items()},
                          step=0)

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        stepf = _f32(step)
        bc1 = float(1 - _f32(b1) ** stepf)
        bc2 = float(1 - _f32(b2) ** stepf)
        for name, pp in params.items():
            # decoupled weight decay (skip 1-d leaves: unstacked norms,
            # biases)
            decay = pp.dim() + (name in self.stacked) >= 2
            for g, p, m, v in zip(*(_chunks(local(t)) for t in (
                    grads[name], pp, state.m[name], state.v[name]))):
                g32 = g.to(torch.float32)
                m32 = m.to(torch.float32) * b1 + g32 * (1 - b1)
                v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
                mhat = m32 / bc1
                vhat = v32 / bc2
                delta = mhat / (torch.sqrt(vhat) + self.eps)
                if decay:
                    delta = delta + self.wd * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr * delta)
                m.copy_(m32)
                v.copy_(v32)
        return params, AdamWState(state.m, state.v, step)


class Adafactor:
    """Factored second-moment optimizer (for memory-constrained archs).

    Matrices keep row/col factored v (O(n+m) instead of O(nm)); vectors
    fall back to full v. beta1=0 (no momentum) as in the paper defaults.
    The state is {"factored": {leaf: {"vr", "vc"} or {"v"}}, "step"}, a
    leaf being a stack's name (its statistics of the stacked shape) or
    a tensor's."""

    def __init__(self, schedule: Callable, decay=0.8, eps=1e-30, clip=1.0,
                 stacks: Optional[Stacks] = None):
        self.schedule = schedule
        self.decay, self.eps, self.clip = decay, eps, clip
        self.stacks = dict(stacks or {})

    def _leaves(self, params: Tree):
        """(leaf name, its tensor names): each stack, then every tensor
        in no stack."""
        stacked = _stacked(self.stacks)
        yield from self.stacks.items()
        yield from ((n, [n]) for n in params if n not in stacked)

    def _leaf(self, tree: Tree, key: str, names: List[str]) -> torch.Tensor:
        """The leaf's local tensor: a stack's layers' shards stacked."""
        return torch.stack([local(tree[n]) for n in names]) \
            if key in self.stacks else local(tree[key])

    def init(self, params: Tree) -> dict:
        def f(names, key):
            p = local(params[names[0]])
            shape = ((len(names),) if key in self.stacks else ()) + \
                tuple(p.shape)
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if len(shape) >= 2:
                return {"vr": z(shape[:-1]),
                        "vc": z(shape[:-2] + shape[-1:])}
            return {"v": z(shape)}
        return {"factored": {k: f(names, k)
                             for k, names in self._leaves(params)},
                "step": 0}

    @staticmethod
    def _reducer(first, stacked: bool, ndim: int):
        """(mean over a leaf dim, whole-leaf mean of a tensor's square) of
        the leaf whose first parameter is ``first``: a local mean where
        the dim is whole on this rank, else the local sums all-reduced
        over the axes sharding it, over its global length."""
        off = 1 if stacked else 0
        if not isinstance(first, DTensor):
            return (lambda x, d, leaf_dim=None, keepdim=False:
                    x.mean(d, keepdim=keepdim),
                    lambda x: torch.mean(torch.square(x)))
        mesh, names = first.device_mesh, first.device_mesh.mesh_dim_names
        shape = ((1,) if stacked else ()) + tuple(first.shape)

        def axes(d):
            d = d % ndim - off
            return tuple(a for m, a in enumerate(names)
                         if first.placements[m] == Shard(d)
                         and mesh.size(m) > 1) if d >= 0 else ()

        def mean(x, d, leaf_dim=None, keepdim=False):
            """x's mean over its dim d, which spans the leaf's dim
            ``leaf_dim`` (default d)."""
            ld = d if leaf_dim is None else leaf_dim
            ax = axes(ld)
            if not ax:
                return x.mean(d, keepdim=keepdim)
            t = x.sum(d, keepdim=keepdim)
            sum_over([t], mesh, ax)
            return t / shape[ld % ndim]

        def sq_mean(x):
            t = torch.sum(torch.square(x)).reshape(1)
            sum_over([t], mesh, placed_axes(first, Shard))
            n = x.shape[0] if stacked else 1
            return (t / (n * first.numel()))[0]
        return mean, sq_mean

    @torch.no_grad()
    def update(self, grads: Tree, state: dict, params: Tree):
        step = state["step"] + 1
        lr = self.schedule(step)
        beta = float(1.0 - _f32(step) ** -self.decay)
        for key, names in self._leaves(params):
            s = state["factored"][key]
            p = self._leaf(params, key, names)
            mean, sq_mean = self._reducer(params[names[0]],
                                          key in self.stacks, p.dim())
            g32 = torch.stack([grads[n] for n in names]).to(torch.float32) \
                if key in self.stacks else grads[key].to(torch.float32)
            g2 = torch.square(g32) + self.eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * mean(g2, -1)
                vc = beta * s["vc"] + (1 - beta) * mean(g2, -2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(mean(vr, -1, leaf_dim=-2,
                                       keepdim=True)[..., None],
                                  min=self.eps))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                s["v"].copy_(v)
            u = g32 / torch.clamp(denom, min=self.eps)
            rms = torch.sqrt(sq_mean(u))
            u = u / torch.clamp(rms / self.clip, min=1.0)
            newp = p.to(torch.float32) - lr * u
            if key in self.stacks:
                for n, row in zip(names, newp):
                    local(params[n]).copy_(row)
            else:
                local(params[key]).copy_(newp)
        return params, {"factored": state["factored"], "step": step}
