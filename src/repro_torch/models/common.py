"""Shared model building blocks (counterpart of ``repro.models.common``):
the RMS norm, the MLP activations and the dense initialiser.

The reference's ``ParallelCtx`` and ``mshard`` are no-ops on one device
and are not ported; sharding comes with ROADMAP A11/A13.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F


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
