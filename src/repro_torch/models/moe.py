"""Mixture-of-Experts MLP: top-k routing, sort-based capacity dispatch —
counterpart of ``repro.models.moe``.

Token-choice top-k routing with a fixed per-expert capacity C =
ceil(T*k/E * capacity_factor), rounded up to 8 (at least 8); overflowing
tokens are dropped (their MoE output is 0, the residual passes through).
Dispatch is sort-based (stable sort by expert id, rank within the
expert), as the reference's, so the integers of a dispatch
(``expert_idx``, ``sorted_token``, ``safe_rank``, ``keep``) are the
reference's bit for bit: top-k takes the lower expert index on a tie, as
``lax.top_k`` does (a stable descending sort, where ``torch.topk``
promises no order), and segments start where ``searchsorted(side=
"left")`` puts them. Expert weights are [E, d, ff].

On a mesh (``ctx.mesh``) the expert banks are sharded over the model
axis (expert parallelism; the larger of their two matrix dims over the
data axis, gathered around use). Every rank routes the same tokens the
reference's group holds (a flat group of the whole batch is all-gathered
over the data axes first), so the dispatch's integers are the single-
device ones; each rank runs its own experts' buckets, and the combine
sums each rank's experts' contributions by an all-reduce over the model
axis. Banks the model axis does not divide run whole on every rank.

Router jitter (training only: ``lm.forward_train`` passes each layer its
own ``torch.Generator``; prefill and decode pass none and never draw)
adds ``router_jitter * N(0, 1)`` to the router logits, one [T, E] draw a
sequence chunk shared by the chunk's groups, as the reference's vmap
shares one key among the groups and splits it over chunks. The numbers
are torch's, not JAX's threefry draws; every config sets the jitter to
0.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.common import (Layout, ParallelCtx, activation,
                                       all_gather, all_reduce, fill_dense_,
                                       gathered, mshard, param, rows,
                                       sharded_dim)
from repro_torch.models.mlp import MLP, mlp as dense_mlp


class MoE(nn.Module):
    """``router`` [d, E] float32, expert banks ``w_in`` / ``w_gate`` [E, d,
    ff] and ``w_out`` [E, ff, d], and ``shared`` (an MLP of
    num_shared * ff) where the config has shared experts."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 num_shared: int, gated: bool, dtype, device):
        super().__init__()
        e = num_experts
        self.router = param((d_model, e), torch.float32, device)
        self.w_in = param((e, d_model, d_ff), dtype, device)
        self.w_out = param((e, d_ff, d_model), dtype, device)
        self.w_gate = param((e, d_model, d_ff), dtype, device) if gated \
            else None
        self.shared = MLP(d_model, num_shared * d_ff, gated, dtype,
                          device) if num_shared else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Router and shared expert N(0, 1/fan_in); each expert's
        matrices N(0, 1/fan_in) of its own [in, out] slice."""
        fill_dense_(self.router, generator)
        for w in (self.w_in, self.w_out, self.w_gate):
            if w is not None:
                fill_dense_(w, generator, in_axis=1)
        if self.shared is not None:
            self.shared.reset_parameters(generator)


def init_moe(d_model: int, d_ff: int, num_experts: int, num_shared: int,
             gated: bool, dtype, *, generator: torch.Generator,
             device) -> MoE:
    p = MoE(d_model, d_ff, num_experts, num_shared, gated, dtype, device)
    p.reset_parameters(generator)
    return p


def capacity(tokens: int, num_experts: int, k: int,
             factor: float = 1.25) -> int:
    c = math.ceil(tokens * k / num_experts * factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


class Dispatch(NamedTuple):
    """One token group's dispatch: the [E, C, d] buckets, the routing in
    sorted order (``sorted_expert``, ``sorted_token``, ``sorted_gate``,
    ``safe_rank``, ``keep``), ``expert_idx`` [T, k] and the group's
    load-balance and router-z statistics."""
    buckets: torch.Tensor
    sorted_expert: torch.Tensor
    sorted_token: torch.Tensor
    sorted_gate: torch.Tensor
    safe_rank: torch.Tensor
    keep: torch.Tensor
    expert_idx: torch.Tensor
    lb: torch.Tensor
    rz: torch.Tensor


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim,
    largest first, the lower index first among equal values — what
    ``lax.top_k`` returns."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(p: MoE, xt: torch.Tensor, *, k: int, c: int,
                    noise: Optional[torch.Tensor] = None) -> Dispatch:
    """Sort-based dispatch for ONE token group. xt: [T, d]; ``p``: the
    MoE (only its ``router`` [d, E] is read); ``noise``: the router
    jitter [T, E] added to the logits, or None."""
    t, d = xt.shape
    e = p.router.shape[1]
    dev = xt.device
    logits = xt.to(torch.float32) @ p.router                   # [T, E]
    if noise is not None:
        logits = logits + noise
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                    # [T, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # aux loss statistics (averaged over groups by the caller)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_idx.reshape(-1),
        torch.ones(t * k, dtype=torch.float32, device=dev)) / (t * k)
    lb = e * torch.sum(me * ce)
    rz = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    flat_expert = expert_idx.reshape(-1)                       # [T*k]
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(t * k, dtype=torch.int64, device=dev) // k
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(e, dtype=sorted_expert.dtype,
                                    device=dev), side="left")
    rank = torch.arange(t * k, device=dev) - seg_start[sorted_expert]
    keep = rank < c
    safe_rank = torch.where(keep, rank, c - 1)

    buckets = torch.zeros((e, c, d), dtype=xt.dtype, device=dev)
    buckets.index_put_((sorted_expert, safe_rank),
                       xt[sorted_token] * keep[:, None].to(xt.dtype),
                       accumulate=True)
    return Dispatch(buckets, sorted_expert, sorted_token, sorted_gate,
                    safe_rank, keep, expert_idx, lb, rz)


def _combine_group(out_b: torch.Tensor, disp: Dispatch, t: int,
                   e0: int = 0) -> torch.Tensor:
    """[E, C, d] expert outputs -> [T, d]: each kept (token, expert) pair
    weighted by its gate, summed per token in sorted order. ``e0``: out_b
    holds experts e0 .. e0 + len(out_b) - 1 only; the other experts'
    pairs add 0."""
    e = out_b.shape[0]
    mine = (disp.sorted_expert >= e0) & (disp.sorted_expert < e0 + e)
    idx = (disp.sorted_expert - e0).clamp(0, e - 1)
    contrib = out_b[idx, disp.safe_rank]                       # [T*k, d]
    contrib = contrib * (disp.sorted_gate * disp.keep * mine)[:, None].to(
        contrib.dtype)
    y = torch.zeros((t, out_b.shape[-1]), dtype=out_b.dtype,
                    device=out_b.device)
    return y.index_add_(0, disp.sorted_token, contrib)


# elements of one expert chunk's [e, C, ff] hidden activations in
# _experts: 2^28 (512 MiB in bf16), so qwen3's 128 experts at capacity
# factor 64 (C = 16,384) do not hold four 6.4 GB transients at once
EXPERT_CHUNK_ELEMS = 1 << 28


def _experts(p: MoE, buckets: torch.Tensor, act_name: str) -> torch.Tensor:
    """Every expert's MLP on its [C, d] bucket: [E, C, d] -> [E, C, d].
    Experts go in chunks that cap the hidden activations at
    EXPERT_CHUNK_ELEMS; each expert's products are the same whatever the
    chunk."""
    act = activation(act_name)
    dt = buckets.dtype
    e, c, _ = buckets.shape
    ff = p.w_in.shape[2]
    step = max(1, EXPERT_CHUNK_ELEMS // max(c * ff, 1))
    out = torch.empty_like(buckets)
    for e0 in range(0, e, step):
        sl = slice(e0, e0 + step)
        b = buckets[sl]
        h = torch.einsum("ecd,edf->ecf", b, p.w_in[sl].to(dt))
        if p.w_gate is not None:
            h = act(torch.einsum("ecd,edf->ecf", b, p.w_gate[sl].to(dt))) * h
        else:
            h = act(h)
        out[sl] = torch.einsum("ecf,efd->ecd", h.to(dt), p.w_out[sl].to(dt))
    return out


def moe_mlp(p: MoE, x: torch.Tensor, *, experts_per_token: int,
            act_name: str, capacity_factor: float = 1.25,
            router_jitter: float = 0.0, rng=None, seq_chunk: int = 4096,
            ctx: Optional[ParallelCtx] = None,
            lay: Optional[Layout] = None,
            global_aux: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: [B, S, d] -> (y [B, S, d], {"load_balance", "router_z"}).
    ``rng``: a torch.Generator on x's device, drawn from (one [T, E]
    draw a chunk, in chunk order) where ``router_jitter`` is non-zero.

    The reference's groups: one flat group of all B*S tokens where B*S
    <= 16384 or B == 1 (decode and short prefills), else one group per
    batch row with S cut into ``seq_chunk`` chunks where it divides S.
    The capacity is the group's (or chunk's) own; the statistics are
    means over groups and chunks.

    ``ctx`` / ``lay`` (a mesh): x is this rank's rows of a batch of
    ``lay.b`` (B above is the global batch); a flat group is gathered
    whole on every rank, the rows' own groups are routed where they
    are; each rank runs its experts of the bank. ``global_aux``
    (training): the statistics are the means over the global batch's
    groups on every rank (a rank's own groups' means averaged over the
    batch axes); a flat group's are so already."""
    b, s, d = x.shape
    mesh = ctx is not None and ctx.mesh is not None
    big_b = lay.b if mesh else b
    e = p.w_in.shape[0]
    k = experts_per_token
    banks, router, e0 = p, p, 0
    if mesh:
        tp = ctx.tp_axis
        names = ("w_in", "w_gate", "w_out")
        banks = gathered(p, names, ctx, keep=(tp,))
        if sharded_dim(p.w_in, tp) == 0:
            e0 = rows(ctx, e, tp)[0]
        router = gathered(p, ("router",), ctx)
    flat = big_b * s <= 16384 or big_b == 1
    if flat:
        xa = all_gather(x, ctx, lay.bax, 0) if mesh else x
        groups, gs, chunks = 1, big_b * s, 1
        xg = xa.reshape(1, big_b * s, d)
    else:
        groups, gs = b, s
        xg = x
        chunks = max(1, s // seq_chunk) \
            if s > seq_chunk and s % seq_chunk == 0 else 1
    c = capacity(gs // chunks, e, k, capacity_factor)
    tc = gs // chunks
    ys, lbs, rzs = [], [], []
    for ci in range(chunks):
        noise = None
        if router_jitter and rng is not None:
            noise = router_jitter * torch.randn(
                (tc, e), generator=rng, dtype=torch.float32,
                device=x.device)
        yc, lbc, rzc = [], [], []
        for gi in range(groups):
            xt = xg[gi, ci * tc:(ci + 1) * tc]
            disp = _dispatch_group(router, xt, k=k, c=c, noise=noise)
            el = banks.w_in.shape[0]
            out_b = _experts(banks, disp.buckets[e0:e0 + el], act_name)
            yc.append(_combine_group(out_b, disp, tc, e0))
            lbc.append(disp.lb)
            rzc.append(disp.rz)
        ys.append(torch.stack(yc))                            # [G, Tc, d]
        lbs.append(torch.stack(lbc).mean())
        rzs.append(torch.stack(rzc).mean())
    y = torch.cat(ys, dim=1) if chunks > 1 else ys[0]
    aux = {"load_balance": torch.stack(lbs).mean(),
           "router_z": torch.stack(rzs).mean()}
    if mesh and global_aux and not flat and ctx.size(lay.bax) > 1:
        n = ctx.size(lay.bax)
        aux = {k: all_reduce(v, ctx, lay.bax) / n for k, v in aux.items()}
    if mesh:
        if banks.w_in.shape[0] < e:
            y = all_reduce(y, ctx, ctx.tp_axis)
        if flat:
            y = mshard(y.reshape(big_b, s, d), ctx, lay.bax)
    y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + dense_mlp(p.shared, x, act_name, ctx)
    return y, aux


def moe_mlp_reference(p: MoE, x: torch.Tensor, *, experts_per_token: int,
                      act_name: str) -> torch.Tensor:
    """Dense no-drop oracle: every token through its top-k experts."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    logits = xt.to(torch.float32) @ p.router
    probs = torch.softmax(logits, -1)
    gate_vals, expert_idx = top_k(probs, experts_per_token)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    act = activation(act_name)
    y = torch.zeros_like(xt)
    for j in range(experts_per_token):
        w_in = p.w_in[expert_idx[:, j]]                        # [T, d, ff]
        w_out = p.w_out[expert_idx[:, j]]
        h = torch.einsum("td,tdf->tf", xt, w_in)
        if p.w_gate is not None:
            g = torch.einsum("td,tdf->tf", xt, p.w_gate[expert_idx[:, j]])
            h = act(g) * h
        else:
            h = act(h)
        y = y + torch.einsum("tf,tfd->td", h, w_out) \
            * gate_vals[:, j:j + 1].to(x.dtype)
    if p.shared is not None:
        y = y + dense_mlp(p.shared, xt, act_name)
    return y.reshape(b, s, d)
