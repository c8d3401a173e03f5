"""The kernels on the ``meta`` device: what a dry run (``launch/dryrun.py``,
``launch/search_dryrun.py``) calls in place of a launch.

Each kernel entry of ``kernels/ops.py`` sends meta tensors here. Every
kernel is an operator of the ``repro_torch`` namespace with a Meta
implementation only: it returns the kernel's output shapes and dtypes and
computes nothing, and an op trace (``launch/hlo_analysis.OpTrace``) sees
it as one call, ``repro_torch.<kernel>``, with its inputs and outputs,
which ``hlo_analysis.analyze`` prices by the kernel's own model (the
flash forward by ``flash_flops``, its backward by ``flash_bwd_flops``).

The operators are registered at the first meta call, never at import,
and nothing here touches a card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_attention import (DTYPE_CODES, HEAD_DIMS,
                                                 fwd_scratch_numel,
                                                 fwd_splits)

NAMESPACE = "repro_torch"
# the card a dry run prices: an H100's SMs (the forward's key splits)
DRY_RUN_SMS = 132
# name -> schema (the kernels' entry points in kernels/ops.py)
SCHEMAS = {
    "zone_prune": "(Tensor zlo, Tensor zhi, Tensor blo, Tensor bhi) -> Tensor",
    "zone_hits": "(Tensor zlo, Tensor zhi, Tensor blo, Tensor bhi) -> Tensor",
    "zone_candidates": "(Tensor zlo, Tensor zhi, Tensor blo, Tensor bhi, "
                       "int capacity) -> (Tensor, Tensor)",
    "box_scan": "(Tensor x, Tensor lo, Tensor hi) -> Tensor",
    "box_scan_pruned": "(Tensor rows3, Tensor cand, Tensor n_hit, "
                       "Tensor lo, Tensor hi) -> Tensor",
    "box_scan_seg": "(Tensor x, Tensor lo, Tensor hi, Tensor onehot) "
                    "-> Tensor",
    "box_scan_seg_gather": "(Tensor rows3, Tensor cand, Tensor n_hit, "
                           "Tensor lo, Tensor hi, Tensor onehot) -> Tensor",
    "l2dist": "(Tensor x, Tensor q) -> Tensor",
    "flash_attention": "(Tensor q, Tensor k, Tensor v, bool causal) "
                       "-> Tensor",
    # the forward that also writes lse: one kernel, so an overload of it
    "flash_attention.lse": "(Tensor q, Tensor k, Tensor v, bool causal) "
                           "-> (Tensor, Tensor)",
    "flash_attention_bwd": "(Tensor q, Tensor k, Tensor v, Tensor out, "
                           "Tensor lse, Tensor dout, bool causal) "
                           "-> (Tensor, Tensor, Tensor)",
}


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _zone_prune(zlo, zhi, blo, bhi):
    return _empty((zlo.shape[0], blo.shape[0]), torch.bool)


def _zone_hits(zlo, zhi, blo, bhi):
    return _empty((zlo.shape[0],), torch.bool)


def _zone_candidates(zlo, zhi, blo, bhi, capacity):
    return _empty((capacity,), torch.int32), _empty((), torch.int32)


def _box_scan(x, lo, hi):
    return _empty((x.shape[0],), torch.int32)


def _box_scan_pruned(rows3, cand, n_hit, lo, hi):
    return _empty((rows3.shape[0] * rows3.shape[1],), torch.int32)


def _box_scan_seg(x, lo, hi, onehot):
    return _empty((x.shape[0], onehot.shape[1]), torch.int32)


def _box_scan_seg_gather(rows3, cand, n_hit, lo, hi, onehot):
    return _empty((cand.shape[0] * rows3.shape[1], onehot.shape[1]),
                  torch.int32)


def _l2dist(x, q):
    return _empty((x.shape[0], q.shape[0]), torch.float32)


def _flash_attention(q, k, v, causal):
    """Refuses what the kernel refuses (head dim, dtype), so a dry run of
    a cell the card cannot run fails as the card would."""
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    return _empty(q.shape, q.dtype)


def _flash_attention_lse(q, k, v, causal):
    """(out, lse [BH, S * G] float32); refuses as the forward does."""
    bh, s, g, _ = q.shape
    return (_flash_attention(q, k, v, causal),
            _empty((bh, s * g), torch.float32))


def flash_forward(q, k, v, causal: bool, return_lse: bool = False):
    """The forward's meta route: its float32 scratch, shaped as the
    wrapper allocates it on the card (``fwd_scratch_numel`` at
    DRY_RUN_SMS), allocated first and held across the call, so that an
    op trace counts it among the step's temporaries; then the forward's
    operator (``flash_attention.lse`` where ``return_lse``), which
    refuses what the kernel refuses."""
    code = DTYPE_CODES.get(q.dtype)
    scratch = None
    if code is not None:
        bh, s, g, d = q.shape
        n = fwd_scratch_numel(bh, s, g, d, code,
                              fwd_splits(bh, s, g, code, DRY_RUN_SMS))
        scratch = _empty((n,), torch.float32) if n else None
    out = call("flash_attention.lse" if return_lse else "flash_attention",
               q, k, v, bool(causal))
    del scratch        # held until the call is done, as on the card
    return out


def _flash_attention_bwd(q, k, v, out, lse, dout, causal):
    """(dq, dk, dv) shaped and typed as q, k and v; refuses what the
    kernel refuses, as the forward does, and an out, dout or lse unlike
    the forward's."""
    _flash_attention(q, k, v, causal)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype}, q "
                             f"{tuple(q.shape)} {q.dtype}")
    bh, s, g, _ = q.shape
    if tuple(lse.shape) != (bh, s * g) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, expected {(bh, s * g)} float32")
    return (_empty(q.shape, q.dtype), _empty(k.shape, k.dtype),
            _empty(v.shape, v.dtype))


_IMPLS = {"zone_prune": _zone_prune, "zone_hits": _zone_hits,
          "zone_candidates": _zone_candidates, "box_scan": _box_scan,
          "box_scan_pruned": _box_scan_pruned,
          "box_scan_seg": _box_scan_seg,
          "box_scan_seg_gather": _box_scan_seg_gather, "l2dist": _l2dist,
          "flash_attention": _flash_attention,
          "flash_attention.lse": _flash_attention_lse,
          "flash_attention_bwd": _flash_attention_bwd}


def flash_flops(q_shape, causal: bool = False) -> int:
    """FLOPs of one flash forward of q [BH, S, G, D]: 4·BH·G·D times the
    (query, key) pairs, S² (what the reference's HLO counts for its plain
    attention, causal or not) or, where ``causal``, the causal kernel's
    own S(S+1)/2."""
    bh, s, g, d = q_shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * bh * g * d * pairs


def flash_bwd_flops(q_shape, causal: bool = False) -> int:
    """FLOPs of one flash backward of q [BH, S, G, D], as the reference's
    ``_flash_core_bwd`` takes them: five products of 2·BH·G·D a (query,
    key) pair (the scores again, dv, dp, dq, dk), over S² or, where
    ``causal``, the causal kernel's own S(S+1)/2."""
    return 5 * flash_flops(q_shape, causal) // 2


_LIBRARY: list = []


@functools.lru_cache(maxsize=None)
def ops():
    """The ``repro_torch`` operators (registered once a process)."""
    lib = torch.library.Library(NAMESPACE, "FRAGMENT")
    for name, schema in SCHEMAS.items():
        lib.define(name + schema)
        lib.impl(name, _IMPLS[name], "Meta")
    _LIBRARY.append(lib)       # kept alive with its registrations
    return getattr(torch.ops, NAMESPACE)


def call(name: str, *args):
    """Kernel ``name`` (``op`` or ``op.overload``) on meta tensors: its
    outputs' shapes and dtypes."""
    fn = ops()
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn(*args)
