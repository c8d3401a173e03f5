"""Shared model building blocks (counterpart of ``repro.models.common``):
the RMS norm, the MLP activations, RoPE and the initialisers.

The reference's ``ParallelCtx`` and ``mshard`` are no-ops on one device
and are not ported: the port's LM runs on one device, and its mesh
(sharded layers, ``ParallelCtx``'s modes) is ROADMAP A13c.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


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
    on the generator's device and cast to t's dtype and device."""
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
