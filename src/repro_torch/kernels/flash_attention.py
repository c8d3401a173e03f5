"""flash_attention — GQA online-softmax attention and its gradients as
CUDA kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu).

Counterpart of ``repro.kernels.flash_attention`` and of the custom VJP
of ``repro.models.attention._flash_core``. In the kernel layout:
q [BH, S, G, D], k/v [BH, S, D] (BH = batch x kv heads), float32 or
bfloat16, D in {16, 32, 64, 128}, any S; the output is [BH, S, G, D] in
q's dtype. The forward picks its own tiles, so S needs no padding; its
products run on the tensor cores (bf16, or 3xTF32 for float32) from
tiles that TMA loads, so every tensor must start on a 16-byte boundary.
``flash_attention_bwd`` takes dout shaped like q and returns (dq, dk, dv)
in their inputs' dtypes, recomputing the scores tile by tile (no S x S
buffer; its lse and delta rows are [BH, S * G] float32 scratch), on the
tensor cores by the same routes. Both take CUDA tensors only; the CPU
dispatch to the plain versions (``kernels/ref.flash_attention_ref`` and
``flash_attention_bwd_ref``) lives in ``kernels/ops.py``. The forward
entry refuses an input that requires grad: gradients go through
``ops.flash_attention``, whose autograd Function launches the forward
kernel and, on the card, the backward kernel.

``launches`` counts forward kernel launches, ``backward_launches``
backward kernel launches (one a call: its two kernels, dq and dk/dv,
launched together); ``backward_calls`` counts the backward passes
``ops.flash_attention`` runs, on the kernel or the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0
backward_launches = 0
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q: [BH, S, G, D]; k/v: [BH, S, D] -> [BH, S, G, D] in q's dtype
    (CUDA)."""
    global launches
    _check_inputs(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "kernels.flash_attention.flash_attention is forward only; for "
            "gradients call kernels.ops.flash_attention, whose autograd "
            "Function runs this kernel forward and flash_attention_bwd's "
            "kernel backward")
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True):
    """The gradients of ``flash_attention`` (CUDA): q, dout [BH, S, G, D];
    k/v [BH, S, D] -> (dq, dk, dv) in their inputs' dtypes, dk and dv
    summed over the G query heads of each kv head; delta is sum_k p dp,
    as in ``kernels/ref.flash_attention_bwd_ref``."""
    global backward_launches
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: dout must be q's shape "
                         f"{tuple(q.shape)} and dtype {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if not dout.is_contiguous():
        raise ValueError("flash_attention_bwd: dout must be contiguous")
    if dout.data_ptr() % 16:
        raise ValueError(f"flash_attention_bwd: dout must be 16-byte "
                         f"aligned, its data starts at {dout.data_ptr():#x}")
    _check_inputs(q, k, v)
    if dout.device != q.device:
        raise ValueError("flash_attention_bwd: dout must be on q's device")
    bh, s, g, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    lse = torch.empty(bh, s * g, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = launch_fn("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), bh, s, g, d, DTYPE_CODES[q.dtype],
                 int(bool(causal)), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    backward_launches += 1
    return dq, dk, dv
