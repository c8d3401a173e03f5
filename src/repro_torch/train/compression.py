"""Gradient compression for the slow inter-pod links — counterpart of
``repro.train.compression``.

int8 error-feedback quantisation [1-bit Adam / EF-SGD lineage]:
gradients are scaled per tensor, rounded to int8 (half to even, as
``jnp.round``), and the quantisation residual is fed back into the next
step's gradient — convergence stays unbiased while the payload is 4x
smaller than float32.

    comp = Int8ErrorFeedback()
    ef = comp.init(grads)
    grads_q, ef = comp.compress(grads, ef)
    grads = comp.decompress(grads_q)

Trees are dicts {name: tensor}. The cross-pod mean
(``compressed_cross_pod_mean``) reduces over a mesh axis and is ROADMAP
A13c: the port trains on one device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]
_INT8_MAX = 127.0


class Quantized(NamedTuple):
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # f32 per-tensor scale


def _quantize(x: torch.Tensor) -> Quantized:
    x32 = x.to(torch.float32)
    scale = torch.max(torch.abs(x32)) / _INT8_MAX
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -_INT8_MAX,
                    _INT8_MAX).to(torch.int8)
    return Quantized(q, scale)


def _dequantize(z: Quantized) -> torch.Tensor:
    return z.q.to(torch.float32) * z.scale


class Int8ErrorFeedback:
    """Per-tensor int8 quantisation with error feedback."""

    def init(self, grads: Tree) -> Tree:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    def compress(self, grads: Tree, ef: Tree) -> Tuple[dict, Tree]:
        """Returns ({name: Quantized}, new error feedback)."""
        qtree, etree = {}, {}
        for k, g in grads.items():
            corrected = g.to(torch.float32) + ef[k]
            z = _quantize(corrected)
            qtree[k] = z
            etree[k] = corrected - _dequantize(z)
        return qtree, etree

    def decompress(self, qtree: dict) -> Tree:
        return {k: _dequantize(z) for k, z in qtree.items()}


def compressed_cross_pod_mean(grads: Tree, ef: Tree, mesh,
                              axis: str = "pod"):
    """The reference's shard_map mean over the ``pod`` axis: a mesh,
    ROADMAP A13c."""
    raise NotImplementedError(
        "compressed_cross_pod_mean reduces over a mesh axis; the port "
        "trains on one device (the mesh is ROADMAP A13c)")


def compression_ratio(grads: Tree) -> float:
    """Bytes(int8 + scale) / bytes(f32) — reported by benchmarks."""
    tot = sum(g.numel() * 4 for g in grads.values())
    comp = sum(g.numel() * 1 + 4 for g in grads.values())
    return comp / max(tot, 1)
