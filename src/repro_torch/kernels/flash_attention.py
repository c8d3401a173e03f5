"""flash_attention — GQA online-softmax attention as a CUDA kernel
(csrc/flash_attention.cu).

Counterpart of ``repro.kernels.flash_attention``. In the kernel layout:
q [BH, S, G, D], k/v [BH, S, D] (BH = batch x kv heads), float32 or
bfloat16, D in {16, 32, 64, 128}, any S; the output is [BH, S, G, D] in
q's dtype. The kernel picks its own tiles, so S needs no padding; its
products run on the tensor cores (bf16, or 3xTF32 for float32) from
tiles that TMA loads, so every tensor must start on a 16-byte boundary.
It takes CUDA tensors only; the CPU dispatch to the plain version
(``kernels/ref.flash_attention_ref``) lives in ``kernels/ops.py``. This
entry is forward only, and an input that requires grad raises:
gradients go through ``ops.flash_attention``, whose autograd Function
launches this kernel forward and runs the plain backward
(``kernels/ref.flash_attention_bwd_ref``).

``launches`` counts kernel launches; ``backward_calls`` counts the
backward passes ``ops.flash_attention`` runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0
backward_calls = 0
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_inputs(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Shapes, dtypes, contiguity and the CUDA device of a launch; raises
    on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q must be [BH, S, G, D] and k, v "
                         "[BH, S, D]")
    bh, s, _, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bh, s, d):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(bh, s, d)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{tuple(DTYPE_CODES)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    named = (("q", q), ("k", k), ("v", v))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"tensor, got device {t.device}")
        if t.device != q.device:
            raise ValueError("flash_attention: all inputs must be on one "
                             "device")
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned (TMA), its data starts at "
                             f"{t.data_ptr():#x}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "kernels.flash_attention.flash_attention is forward only; for "
            "gradients call kernels.ops.flash_attention, which runs this "
            "kernel forward under an autograd Function")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q: [BH, S, G, D]; k/v: [BH, S, D] -> [BH, S, G, D] in q's dtype
    (CUDA)."""
    global launches
    _check_inputs(q, k, v)
    bh, s, g, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("flash_attention: out must be 16-byte aligned (TMA)")
    fn = launch_fn("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, g, d, DTYPE_CODES[q.dtype], int(bool(causal)),
                 d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
