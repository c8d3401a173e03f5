"""Dense MLP blocks, gated (SwiGLU-style) and classic 2-matmul
(counterpart of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import activation, fill_dense_, param


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


def mlp(p: MLP, x: torch.Tensor, act_name: str) -> torch.Tensor:
    """x: [..., d_model], weights cast to x's dtype."""
    act = activation(act_name)
    h = x @ p.w_in.to(x.dtype)
    if p.w_gate is not None:
        h = act(x @ p.w_gate.to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p.w_out.to(x.dtype)
