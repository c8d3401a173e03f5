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

Trees are dicts {name: tensor}. ``compressed_cross_pod_mean`` is the
reference's shard_map body on a ``DeviceMesh``: each rank quantises its
tree, the dequantised values are all-reduced over the ``pod`` axis's
group and divided by its size. As in the reference, the train step does
not call it (``TrainConfig.grad_compression`` is read nowhere).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

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
                              axis: str = "pod") -> Tuple[Tree, Tree]:
    """Mean-reduce gradients across ``axis`` of ``mesh`` (a DeviceMesh)
    with int8 payloads: each rank quantises its tree with error feedback
    (``Int8ErrorFeedback.compress``), then the dequantised values are
    summed over the axis's ranks and divided by their number (the per-
    pod scales differ, so the reference reduces the values, not the
    payloads). Returns (the mean tree, float32, the new error feedback);
    every rank of the mesh calls it."""
    from repro_torch.compat import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh: a torch DeviceMesh, not "
                         f"{type(mesh).__name__}")
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no axis "
                         f"{axis!r}")
    comp = Int8ErrorFeedback()
    qtree, ef = comp.compress(grads, ef)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    out = {}
    for k, z in qtree.items():
        val = _dequantize(z)
        if n > 1:
            dist.all_reduce(val, op=dist.ReduceOp.SUM, group=group)
        out[k] = val / float(n)
    return out, ef


def compression_ratio(grads: Tree) -> float:
    """Bytes(int8 + scale) / bytes(f32) — reported by benchmarks."""
    tot = sum(g.numel() * 4 for g in grads.values())
    comp = sum(g.numel() * 1 + 4 for g in grads.values())
    return comp / max(tot, 1)
