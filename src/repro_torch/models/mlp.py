"""Dense MLP blocks, gated (SwiGLU-style) and classic 2-matmul
(counterpart of ``repro.models.mlp``).

On a mesh (``ctx.mesh``): tensor parallelism over the model axis, with
``w_in`` / ``w_gate`` column-parallel (each rank its d_ff columns, the
data-axis shards all-gathered) and ``w_out`` row-parallel
(``common.row_out``); under context parallelism (``seq_sharded``:
activations split along the sequence) the weights are gathered whole
and the products are local to each rank's rows, as the reference's
``seq_shard_acts`` form.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import (ParallelCtx, activation,
                                       fill_dense_, gather_placed, gathered,
                                       param, row_out)


class MLP(nn.Module):
    """``w_in`` [d, ff], ``w_out`` [ff, d] and, gated, ``w_gate`` [d, ff],
    in the reference's [in, out] layout."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, dtype,
                 device):
        super().__init__()
        self.w_in = param((d_model, d_ff), dtype, device)
        self.w_out = param((d_ff, d_model), dtype, device)
        self.w_gate = param((d_model, d_ff), dtype, device) if gated \
            else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every weight N(0, 1/fan_in)."""
        for w in (self.w_in, self.w_out, self.w_gate):
            if w is not None:
                fill_dense_(w, generator)


def init_mlp(d_model: int, d_ff: int, gated: bool, dtype, *,
             generator: torch.Generator, device) -> MLP:
    p = MLP(d_model, d_ff, gated, dtype, device)
    p.reset_parameters(generator)
    return p


def mlp(p: MLP, x: torch.Tensor, act_name: str,
        ctx: Optional[ParallelCtx] = None, *,
        seq_sharded: bool = False) -> torch.Tensor:
    """x: [..., d_model], weights cast to x's dtype. ``ctx``: on a mesh,
    x is this rank's batch rows (and, ``seq_sharded``, its sequence
    rows); the result is laid out as x."""
    act = activation(act_name)
    if ctx is not None and ctx.mesh is not None:
        if seq_sharded:
            p = gathered(p, ("w_in", "w_gate", "w_out"), ctx)
        else:
            keep = (ctx.tp_axis,)
            w_in = gather_placed(p.w_in, ctx, keep)
            h = x @ w_in.to(x.dtype)
            if p.w_gate is not None:
                w_gate = gather_placed(p.w_gate, ctx, keep)
                h = act(x @ w_gate.to(x.dtype)) * h
            else:
                h = act(h)
            if w_in.shape[1] == p.w_in.shape[1]:      # d_ff replicated
                return h @ gather_placed(p.w_out, ctx).to(x.dtype)
            return row_out(h, p.w_out, ctx)
    h = x @ p.w_in.to(x.dtype)
    if p.w_gate is not None:
        h = act(x @ p.w_gate.to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p.w_out.to(x.dtype)
