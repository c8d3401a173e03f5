"""The precision of a reference's products.

``rounder(name)`` gives the function applied to both inputs of every
product: ``float32`` leaves them as they are (the products run in
float32 with TF32 off), ``tf32`` rounds them to TF32's 10-bit mantissa
(what the tensor cores do to float32 inputs with TF32 on), and ``fp8``
to float8 e4m3 after scaling each tensor so its largest magnitude is
the format's largest finite value. The rounding is emulated in float32
arithmetic, so a control reads the same on the CPU and on the card.
Sums stay float32 in every case, as on the tensor cores.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

import torch

PRECISIONS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    low = (bits >> 13) & 1
    bits = (bits + 0xFFF + low) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _straight(fn: Callable) -> Callable:
    """``fn``'s rounding in the forward, the identity's gradient."""
    def rounded(x: torch.Tensor) -> torch.Tensor:
        return x + (fn(x.detach()) - x).detach()
    return rounded


def rounder(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "float32":
        return lambda x: x
    if name == "tf32":
        return _straight(_tf32)
    if name == "fp8":
        return _straight(_fp8)
    raise ValueError(f"precision {name!r}: one of {PRECISIONS}")


@contextmanager
def exact_float32():
    """float32 products in float32 on the card (TF32 off), restored on
    leaving."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
