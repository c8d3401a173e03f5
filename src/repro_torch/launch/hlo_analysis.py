"""Op-trace cost analysis — counterpart of ``repro.launch.hlo_analysis``.

torch has no HLO. The reference parses the post-SPMD HLO text that XLA
compiles for one device and recovers each ``while``'s trip count; the
port records what one step dispatches instead. ``OpTrace`` is a
``TorchDispatchMode``: every aten op (and every kernel call of
``kernels/meta.py``, and every ``c10d`` collective) that a step runs on
this rank is one entry of the trace, with its inputs' and outputs' dtypes
and shapes and whether it ran in the backward. The port runs eagerly, so
an op is recorded each time it runs: the layer loop, the microbatches,
the loss chunks and the remat recompute are unrolled in the trace, and
there are no while bodies and no trip counts to recover.

``analyze(trace)`` returns the reference's keys, per rank:
  * dot_flops        — 2·M·N·K of every product (mm, bmm, addmm,
    baddbmm, ...; what ``torch.utils.flop_counter.FlopCounterMode``
    counts), the flop counter's own formula for the other ops it knows
    (convolutions), and 4·BH·G·S²·D for each flash kernel call and
    10·BH·G·S²·D for each flash backward call (the reference's
    ``_flash_core_bwd``: five products), the full S² as the reference's
    HLO counts its attention, causal or not; ``flash_causal_flops`` is
    the causal kernels' own S(S+1)/2 apart, forward and backward.
  * elementwise_flops — output elements of arithmetic ops (1 flop an
    element), plus the compares of the search kernels (3·rows·boxes·dims,
    the reference's kernel model).
  * hbm_bytes        — the reference's perfect-fusion model: bytes (inputs
    and outputs) only where a value must sit in memory: products,
    reductions, gathers and scatters, cat, copies, collectives and kernel
    calls; every elementwise chain is assumed fused into its consumer.
  * hbm_bytes_upper  — every op's inputs and outputs but views'.
  * collectives      — calls and link bytes by kind, from the step's
    ``ParallelCtx.comm`` (``models.common.CommStats``, forward and
    backward), in the reference's link-byte convention per rank:
    all-gather its output, all-reduce 2x its tensor (the reduce-scatter
    and all-gather phases), reduce-scatter its input (the output times
    the group). ``comm`` keeps the raw snapshot.

Memory: ``OpTrace`` follows the storages the step allocates (weak
references, as ``torch.distributed._tools.mem_tracker`` does) and gives
the reference's ``memory`` keys: ``argument_bytes`` (the storages of the
arguments it was given), ``output_bytes`` (those of the step's outputs),
``alias_bytes`` (outputs that are arguments: the train step updates its
state in place), ``temp_bytes`` (the peak of the storages the step
allocated, less the new outputs alive at its end), ``code_bytes`` 0, and
``peak_bytes_est`` = arguments + outputs + temps - aliases as in the
reference, which is here the traced peak of live bytes. Meta tensors
allocate nothing, so a full-size step is traced on the CPU in seconds.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.compat import DTensor, local_tensor
from repro_torch.kernels.meta import (NAMESPACE, flash_bwd_flops,
                                      flash_flops)

# bytes an element, by torch dtype name (the reference's table is by HLO
# type name)
_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8, "complex64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
}
# products: flops 2 * out elements * the contracted length (the last dim
# of the first matrix operand, which is input ``_PRODUCTS[op]``)
_PRODUCTS = {"mm": 0, "bmm": 0, "matmul": 0, "dot": 0, "mv": 0,
             "addmm": 1, "baddbmm": 1, "addbmm": 1, "addmv": 1}
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "exp", "exp2", "expm1", "tanh",
    "rsqrt", "sqrt", "pow", "neg", "log", "log1p", "log2", "sigmoid",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "abs", "reciprocal", "sin", "cos", "silu", "gelu",
    "softplus", "_to_copy", "masked_fill", "addcmul", "addcdiv", "lerp",
    "sign", "floor", "ceil", "round", "remainder", "fmod", "erf",
    "silu_backward", "gelu_backward", "tanh_backward", "sigmoid_backward",
    "threshold_backward", "softplus_backward", "isnan", "isinf", "__and__",
    "__or__", "__xor__", "__invert__"))
# ops whose operands and outputs sit in memory under perfect fusion
# (reductions, gathers / scatters, cat, copies); products, collectives
# and kernel calls are added by kind
_MATERIALIZE = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "cumsum", "cumprod", "var", "std", "var_mean", "linalg_vector_norm",
    "norm", "argmax", "argmin", "any", "all", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "topk", "sort",
    "nonzero", "index_select", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index", "index_put", "_index_put_impl", "index_add",
    "index_copy", "index_fill", "embedding", "embedding_dense_backward",
    "masked_scatter", "masked_select", "take", "repeat_interleave", "cat",
    "stack", "copy", "clone", "constant_pad_nd", "repeat", "flip", "roll",
    "convolution", "convolution_backward"))
# ops that move no bytes (views, and allocations without a write)
_VIEWS = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "as_strided",
    "expand", "permute", "transpose", "t", "slice", "select", "unsqueeze",
    "squeeze", "detach", "alias", "split", "split_with_sizes", "chunk",
    "unbind", "narrow", "diagonal", "unfold", "view_as", "view_as_real",
    "view_as_complex", "lift_fresh", "movedim", "unflatten", "flatten",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense"))
_COLLECTIVE_PREFIXES = ("c10d.", "_c10d_functional.")
# CommStats kind -> (the reference's kind, link bytes per counted byte)
LINK = {"all_reduce": ("all-reduce", 2), "all_gather": ("all-gather", 1),
        "reduce_scatter": ("reduce-scatter", 1)}
# the search kernels' compares an (input row, box, dim): lo < x, x <= hi
# and the and, as the reference's kernel model counts them
_KERNEL_COMPARES = 3


def _spec(t: torch.Tensor) -> list:
    if isinstance(t, DTensor):
        t = local_tensor(t)
    return [str(t.dtype).replace("torch.", ""), list(t.shape)]


def _tensors(tree) -> list:
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            out.append(local_tensor(x))
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _base(name: str) -> str:
    """"aten.add_.Tensor" -> "add"."""
    parts = name.split(".")
    op = parts[1] if len(parts) > 1 else parts[0]
    return op[:-1] if op.endswith("_") and not op.startswith("_") else op


class OpTrace(TorchDispatchMode):
    """Records every op dispatched while it is active (``with
    OpTrace(arguments) as tr: ...``) as ``tr.ops``: ``[name, inputs,
    outputs, backward, extra]`` with inputs and outputs as ``[dtype name,
    shape]`` (DTensors by their local shard), ``backward`` whether it ran
    in autograd's backward, ``extra`` the flop counter's count for ops it
    knows that are not plain products ({"flops": n}) or a kernel call's
    scalar arguments ({"args": [...]}). ``arguments``: the step's inputs,
    whose storages exist before it. ``finish(outputs)`` ends the memory
    account (``memory``)."""

    def __init__(self, arguments: Iterable = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.ops: list = []
        self._args = WeakIdKeyDictionary()
        self._new = WeakIdKeyDictionary()
        self._open = True
        self._finalizers: list = []
        self.argument_bytes = 0
        for t in _tensors(list(arguments)):
            st = t.untyped_storage()
            if st not in self._args:
                self._args[st] = st.nbytes()
                self.argument_bytes += st.nbytes()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.memory: Optional[dict] = None

    def _freed(self, nbytes: int) -> None:
        if self._open:
            self.live_bytes -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._args or st in self._new:
                continue
            n = st.nbytes()
            self._new[st] = n
            self._finalizers.append(weakref.finalize(st, self._freed, n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        extra = None
        if name.startswith(NAMESPACE + "."):
            extra = {"args": [a for a in tree_flatten((args, kwargs))[0]
                              if isinstance(a, (bool, int, float))]}
        elif (func._overloadpacket in self._flops
              and _base(name) not in _PRODUCTS):
            extra = {"flops": int(self._flops[func._overloadpacket](
                *args, **kwargs, out_val=out))}
        outs = _tensors(out)
        self.ops.append([name, [_spec(t) for t in _tensors((args, kwargs))],
                         [_spec(t) for t in outs],
                         torch._C._current_autograd_node() is not None,
                         extra])
        self._track(outs)
        return out

    def finish(self, outputs) -> dict:
        """The memory account, the step's ``outputs`` given."""
        self._open = False
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        seen, out_b, alias_b = set(), 0, 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            if st in self._args:
                alias_b += st.nbytes()
            out_b += st.nbytes()
        fresh = out_b - alias_b
        temp = max(self.peak_bytes - fresh, 0)
        self.memory = {
            "argument_bytes": self.argument_bytes,
            "output_bytes": out_b,
            "temp_bytes": temp,
            "alias_bytes": alias_b,
            "code_bytes": 0,
            "peak_bytes_est": self.argument_bytes + out_b + temp - alias_b,
        }
        return self.memory

    def trace(self, comm: Optional[dict] = None) -> dict:
        """The trace as ``analyze`` and the dry runs' files take it."""
        return {"ops": self.ops, "comm": comm, "memory": self.memory}


def _nbytes(spec) -> int:
    n = _DTYPE_BYTES.get(spec[0], 0)
    for d in spec[1]:
        n *= d
    return n


def _numel(spec) -> int:
    n = 1
    for d in spec[1]:
        n *= d
    return n


def _kernel_cost(kernel: str, ins, outs, args):
    """(dot flops, compare flops, bytes, the causal kernel's flops) of
    one kernel call: each input read once and each output written once,
    but box_scan_seg_gather's and box_scan_pruned's rows, read at the
    candidate blocks only (capacity x block x d: a trace cannot see
    n_hit)."""
    byts = sum(_nbytes(s) for s in ins) + sum(_nbytes(s) for s in outs)
    if kernel in ("flash_attention", "flash_attention_bwd"):
        flops = flash_flops if kernel == "flash_attention" else flash_bwd_flops
        causal = bool(args[0]) if args else True
        q = ins[0][1]
        return flops(q), 0, byts, flops(q, causal)
    if kernel == "l2dist":
        (n, d), q = ins[0][1], ins[1][1][0]
        return 0, _KERNEL_COMPARES * n * q * d, byts, 0
    if kernel in ("box_scan_seg_gather", "box_scan_pruned"):
        rows3, cand, boxes = ins[0], ins[1], ins[3]
        c, (_, block, d) = cand[1][0], rows3[1]
        byts += c * block * d * _DTYPE_BYTES[rows3[0]] - _nbytes(rows3)
        return 0, _KERNEL_COMPARES * c * block * boxes[1][0] * d, byts, 0
    rows = ins[0][1][0]                 # zones or rows, [N, d]
    nb, d = ins[2][1][0], ins[2][1][1]  # boxes [B, d]
    return 0, _KERNEL_COMPARES * rows * nb * d, byts, 0


def collectives(comm: Optional[dict]) -> Dict[str, dict]:
    """``CommStats.snapshot()`` (forward and backward) -> {the reference's
    kind: {"count", "bytes"}} in its link-byte convention."""
    out: Dict[str, dict] = {}
    for snap in (comm or {}, (comm or {}).get("backward") or {}):
        for kind, calls in snap.get("calls", {}).items():
            ref_kind, mult = LINK[kind]
            ent = out.setdefault(ref_kind, {"count": 0.0, "bytes": 0.0})
            ent["count"] += calls
            ent["bytes"] += mult * snap["bytes"][kind]
    return out


def analyze(trace: dict) -> dict:
    """A trace (``OpTrace.trace()``, or read back from a dry run's file)
    -> the reference's cost keys for one rank (module docstring)."""
    dot = ew = hbm = upper = causal = dot_bwd = 0.0
    kernels: Dict[str, dict] = {}
    n_bwd = 0
    for name, ins, outs, bwd, extra in trace["ops"]:
        n_bwd += bool(bwd)
        op = _base(name)
        if op in _VIEWS:
            continue
        byts = sum(_nbytes(s) for s in ins) + sum(_nbytes(s) for s in outs)
        upper += byts
        flops = 0
        if name.startswith(NAMESPACE + "."):
            df, cf, kb, kc = _kernel_cost(op, ins, outs,
                                          (extra or {}).get("args", []))
            ent = kernels.setdefault(op, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
            ent["calls"] += 1
            ent["flops"] += df + cf
            ent["bytes"] += kb
            flops, ew, hbm, causal = df, ew + cf, hbm + kb, causal + kc
        elif op in _PRODUCTS:
            k = ins[_PRODUCTS[op]][1][-1]
            flops = 2 * _numel(outs[0]) * k
            hbm += byts
        elif extra and "flops" in extra:
            flops = extra["flops"]
            hbm += byts
        elif name.startswith(_COLLECTIVE_PREFIXES) or op in _MATERIALIZE:
            hbm += byts
        if op in _ELEMENTWISE and outs:
            ew += _numel(outs[0])
        dot += flops
        dot_bwd += flops if bwd else 0
    colls = collectives(trace.get("comm"))
    return {
        "dot_flops": dot,
        "elementwise_flops": ew,
        "total_flops": dot + ew,
        "hbm_bytes": hbm,
        "hbm_bytes_upper": upper,
        "collectives": colls,
        "collective_bytes": sum(v["bytes"] for v in colls.values()),
        "comm": trace.get("comm"),
        "dot_flops_backward": dot_bwd,
        "flash_causal_flops": causal,
        "kernels": kernels,
        "n_ops": len(trace["ops"]),
        "n_backward_ops": n_bwd,
    }
