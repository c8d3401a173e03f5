"""flash_attention — GQA online-softmax attention and its gradients as
CUDA kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu).

Counterpart of ``repro.kernels.flash_attention`` and of the custom VJP
of ``repro.models.attention._flash_core``. In the kernel layout:
q [BH, S, G, D], k/v [BH, S, D] (BH = batch x kv heads), float32 or
bfloat16, D in {16, 32, 64, 128}, any S; the output is [BH, S, G, D] in
q's dtype. The forward picks its own tiles, so S needs no padding; its
products run on the tensor cores (bf16, or 3xTF32 for float32) from
tiles that TMA loads, so every tensor must start on a 16-byte boundary.
Its float32 scratch (``fwd_scratch_numel``): for bfloat16 where BH times
the 128-row query tiles gives fewer CTAs than the card has SMs, each
query tile's keys split over ``fwd_splits`` CTAs whose partials
[splits, BH, S * G, D + 2] a second kernel combines; for float32 past
one 32-key tile, K and V split into TF32 hi and lo once a call,
[4, BH, S rounded up to 32, D].
Where asked (``return_lse``) the forward also returns each row's
log-sum-exp of its scaled scores, lse [BH, S * G] float32, the residual
the reference's custom VJP saves. ``flash_attention_bwd`` takes the
forward's inputs, its out and lse, and dout shaped like q, and returns
(dq, dk, dv) in their inputs' dtypes, recomputing the scores tile by tile
(no S x S buffer; its row scratch is [2, BH, S * G] float32, and where
BH is small its dk / dv partials [2, splits, BH, S, D] float32), on
the tensor cores (bf16 by wgmma from TMA-loaded tiles, float32 as 3xTF32
on mma.sync). Both take CUDA tensors only; the CPU
dispatch to the plain versions (``kernels/ref.flash_attention_ref`` and
``flash_attention_bwd_ref``) lives in ``kernels/ops.py``. The forward
entry refuses an input that requires grad: gradients go through
``ops.flash_attention``, whose autograd Function launches the forward
kernel and, on the card, the backward kernel.

``launches`` counts forward kernel launches (one a call: its kernels,
the pre-pass or the combine where it has one, launched together),
``backward_launches``
backward kernel launches (one a call: its kernels, dq, dk/dv and where it
splits the partials' sum, launched together); ``backward_calls`` counts
the backward passes ``ops.flash_attention`` runs, on the kernel or the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import launch_fn

launches = 0
backward_launches = 0
backward_calls = 0
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (device index, BH, S, G, dtype code) -> the backward's splits
_splits: dict = {}
# the same key -> the forward's key splits
_fwd_splits: dict = {}
# device index -> its SM count
_sms: dict = {}
# the forward's tiles: bfloat16 query rows and keys of a CTA's item,
# float32 keys of a tile
FWD_ROWS, FWD_KEYS, F32_KEYS = 128, 128, 32
# a forward grid below one CTA an SM splits each query tile's keys, to
# about FWD_SPLIT_WAVES CTAs an SM, at most FWD_MAX_SPLITS
FWD_SPLIT_WAVES, FWD_MAX_SPLITS = 1, 16


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


def _split_count(device: torch.device, bh: int, s: int, g: int,
                 code: int) -> int:
    """The dk / dv kernel's splits a key tile (flash_attention_bwd_splits,
    by the card's SM count), kept per device and shape."""
    key = (device.index, bh, s, g, code)
    n = _splits.get(key)
    if n is None:
        n = _splits[key] = launch_fn(
            "flash_attention_bwd", "flash_attention_bwd_splits")(
                bh, s, g, code, _sm_count(device))
    return n


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def fwd_splits(bh: int, s: int, g: int, code: int, sms: int) -> int:
    """The forward's key splits of each query tile, on a card of ``sms``
    SMs: 1 for float32, and for bfloat16 where BH times the 128-row query
    tiles gives a CTA an SM or more; else enough for FWD_SPLIT_WAVES CTAs
    an SM, at most FWD_MAX_SPLITS and the key tiles of S."""
    if code != DTYPE_CODES[torch.bfloat16]:
        return 1
    ctas = bh * -(-s * g // FWD_ROWS)
    if ctas >= sms:
        return 1
    return max(1, min(-(-FWD_SPLIT_WAVES * sms // ctas), -(-s // FWD_KEYS),
                      FWD_MAX_SPLITS))


def fwd_scratch_numel(bh: int, s: int, g: int, d: int, code: int,
                      splits: int) -> int:
    """Float32 elements of the forward's scratch: the splits' partials
    (O, then each row's max and sum) or the float32 pre-pass's K hi, K lo,
    V^T hi and V^T lo planes; 0 where it has none."""
    if code == DTYPE_CODES[torch.float32]:
        s_pad = -(-s // F32_KEYS) * F32_KEYS
        return 4 * bh * s_pad * d if s > F32_KEYS else 0
    return splits * bh * s * g * (d + 2) if splits > 1 else 0


def _fwd_split_count(device: torch.device, bh: int, s: int, g: int,
                     code: int) -> int:
    """``fwd_splits`` by the card's SM count, kept per device and shape."""
    key = (device.index, bh, s, g, code)
    n = _fwd_splits.get(key)
    if n is None:
        n = _fwd_splits[key] = fwd_splits(bh, s, g, code, _sm_count(device))
    return n


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, return_lse: bool = False):
    """q: [BH, S, G, D]; k/v: [BH, S, D] -> [BH, S, G, D] in q's dtype
    (CUDA); with ``return_lse`` also lse [BH, S * G] float32, each row's
    m + log(max(l, 1e-30)) in scaled-score units."""
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
    lse = (torch.empty(bh, s * g, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if out.data_ptr() % 16:
        raise ValueError("flash_attention: out must be 16-byte aligned (TMA)")
    code = DTYPE_CODES[q.dtype]
    splits = _fwd_split_count(q.device, bh, s, g, code)
    n = fwd_scratch_numel(bh, s, g, d, code, splits)
    scratch = (torch.empty(n, dtype=torch.float32, device=q.device)
               if n else None)
    fn = launch_fn("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 scratch.data_ptr() if n else None, bh, s, g, d, code,
                 int(bool(causal)), d ** -0.5, splits,
                 _sm_count(q.device), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True):
    """The gradients of ``flash_attention`` (CUDA): q, out, dout
    [BH, S, G, D]; k/v [BH, S, D]; lse [BH, S * G] float32 (the forward's,
    ``return_lse``) -> (dq, dk, dv) in their inputs' dtypes, dk and dv
    summed over the G query heads of each kv head; delta is sum_d dout
    out, as in ``kernels/ref.flash_attention_bwd_ref`` and the
    reference."""
    global backward_launches
    bh, s, g, d = q.shape
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("lse", lse, (bh, s * g), torch.float32),
                                  ("dout", dout, q.shape, q.dtype)):
        if t.shape != shape or t.dtype != dtype:
            want = (f"{shape} float32" if name == "lse" else
                    f"q's shape {tuple(shape)} and dtype {dtype}")
            raise ValueError(f"flash_attention_bwd: {name} must be {want}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be on q's "
                             f"device")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be 16-byte "
                             f"aligned, its data starts at {t.data_ptr():#x}")
    _check_inputs(q, k, v)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    code = DTYPE_CODES[q.dtype]
    splits = _split_count(q.device, bh, s, g, code)
    # each row's delta, then (float32) the backward's own lse
    rows = torch.empty(2, bh, s * g, dtype=torch.float32, device=q.device)
    part = (torch.empty(2 * splits * bh * s * d, dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = launch_fn("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), rows.data_ptr(),
                 part.data_ptr() if part is not None else None, bh, s, g, d,
                 code, int(bool(causal)), d ** -0.5, splits, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    backward_launches += 1
    return dq, dk, dv
