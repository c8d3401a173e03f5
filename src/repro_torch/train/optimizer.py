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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import torch_dtype

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


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every tensor's float32 sum of squares: a 0-d
    float32 tensor on the tensors' device (no host sync)."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scales every gradient by min(1, max_norm / max(norm, 1e-9)) in
    float32, in place (cast back to its dtype). Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.to(torch.float32) * scale)
    return grads, norm


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
        zeros = lambda p: torch.zeros(p.shape, dtype=self.state_dtype,
                                      device=p.device)
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
        for name, p in params.items():
            g32 = grads[name].to(torch.float32)
            m, v = state.m[name], state.v[name]
            m32 = m.to(torch.float32) * b1 + g32 * (1 - b1)
            v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            # decoupled weight decay (skip 1-d leaves: unstacked norms,
            # biases)
            if p.dim() + (name in self.stacked) >= 2:
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
        return torch.stack([tree[n] for n in names]) \
            if key in self.stacks else tree[key]

    def init(self, params: Tree) -> dict:
        def f(names, key):
            p = params[names[0]]
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

    @torch.no_grad()
    def update(self, grads: Tree, state: dict, params: Tree):
        step = state["step"] + 1
        lr = self.schedule(step)
        beta = float(1.0 - _f32(step) ** -self.decay)
        for key, names in self._leaves(params):
            s = state["factored"][key]
            p = self._leaf(params, key, names)
            g32 = self._leaf(grads, key, names).to(torch.float32)
            g2 = torch.square(g32) + self.eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                  min=self.eps))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                s["v"].copy_(v)
            u = g32 / torch.clamp(denom, min=self.eps)
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(rms / self.clip, min=1.0)
            newp = p.to(torch.float32) - lr * u
            if key in self.stacks:
                for n, row in zip(names, newp):
                    params[n].copy_(row)
            else:
                p.copy_(newp)
        return params, {"factored": state["factored"], "step": step}
