"""The device trace of a traced window, reduced to what the per-layer
metrics read.

``traced(...)`` runs a function under ``torch.profiler`` (CPU and CUDA
activities) inside the benchmark's own ``bench.window`` range, and
``reduce_events`` turns the raw events into: the window's length (that
range on the host), the device's busy seconds (the union of every
kernel, copy and set on the card within it), device seconds by class,
and the breakdown the result line carries (the device operations of
most time, and the idle gaps by what the host was doing). The reduction
works on plain tuples, so its arithmetic is tested on the CPU.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

WINDOW_RANGE = "bench.window"
# the classes of device time, by kernel name
CLASSES = ("flash_fwd", "flash_bwd", "cublas", "memcpy_h2d", "memcpy",
           "memset", "other")
BREAKDOWN_ENTRIES = 10


class Event(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


def kernel_class(name: str) -> str:
    """The flash forward (its main kernel, the f32 pre-split and the key
    splits' combine), the flash backward (every ``flash_bwd_`` kernel),
    cuBLAS's products (its gemm, xmma and cutlass kernels and, for bf16 on
    the H100, ``nvjet``), host-to-device and other copies, sets, or the
    rest."""
    if name.startswith("Memcpy"):
        return "memcpy_h2d" if "HtoD" in name else "memcpy"
    if name.startswith("Memset"):
        return "memset"
    if any(w in name for w in ("flash_attention_kernel",
                               "flash_attention_presplit",
                               "flash_attention_combine")):
        return "flash_fwd"
    if "flash_bwd_" in name:
        return "flash_bwd"
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "cublas"
    return "other"


def union_ns(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(device: List[Event], host: List[Event]) -> Dict:
    """The traced window's numbers from its device events and its host
    events (the host's ``bench.window`` range among them)."""
    windows = [e for e in host if e.name == WINDOW_RANGE]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} "
                         f"'{WINDOW_RANGE}' ranges, not one")
    w0 = windows[0].start_ns
    w1 = w0 + windows[0].dur_ns
    clipped = []
    for e in device:
        a, b = max(e.start_ns, w0), min(e.start_ns + e.dur_ns, w1)
        if b > a:
            clipped.append((e.name, a, b))
    busy = union_ns([(a, b) for _, a, b in clipped])
    by_name: Dict[str, float] = defaultdict(float)
    by_class = {c: 0.0 for c in CLASSES}
    for name, a, b in clipped:
        by_name[name] += (b - a) * 1e-9
        by_class[kernel_class(name)] += (b - a) * 1e-9
    gaps = _gaps(busy, w0, w1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "device_s_by_class": by_class,
            "breakdown": {
                "device_ops": [[n[:200], s] for n, s in top],
                "idle_gaps": _label_gaps(gaps, host)}}


def _gaps(busy, w0: int, w1: int) -> List[Tuple[int, int]]:
    out, at = [], w0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if w1 > at:
        out.append((at, w1))
    return out


def _label_gaps(gaps, host: List[Event]) -> List[list]:
    """Idle seconds summed by what the host was doing when each gap
    began: the innermost host event (the latest to start) covering the
    gap's start, the window range itself where no other does; the
    ``BREAKDOWN_ENTRIES`` labels of most idle time."""
    if not gaps:
        return []
    inner = [e for e in host if e.name != WINDOW_RANGE]
    starts = np.array([e.start_ns for e in inner], dtype=np.int64)
    ends = np.array([e.start_ns + e.dur_ns for e in inner], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        label = WINDOW_RANGE
        if len(inner):
            cover = np.nonzero((starts <= a) & (ends > a))[0]
            if len(cover):
                label = inner[int(cover[np.argmax(starts[cover])])].name
        idle[label[:200]] += (b - a) * 1e-9
    return [[k, v] for k, v in sorted(idle.items(),
                                      key=lambda kv: -kv[1])
            [:BREAKDOWN_ENTRIES]]


def _kineto_events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished profile. A range of
    ``record_function`` shows on the device too, as an annotation that
    spans its kernels; those are not device work and are left out."""
    from torch.autograd import DeviceType
    device, host, annotations = [], [], {WINDOW_RANGE}
    raw = list(prof.profiler.kineto_results.events())
    for e in raw:
        if e.device_type() == DeviceType.CPU and _annotation(e):
            annotations.add(e.name())
    for e in raw:
        ev = Event(e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e) and ev.name not in annotations:
                device.append(ev)
        elif e.device_type() == DeviceType.CPU:
            host.append(ev)
    return device, host


def _annotation(e) -> bool:
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    user = getattr(e, "is_user_annotation", lambda: False)()
    return bool(user) or "annotation" in kind


def traced(fn: Callable[[], None]) -> Dict:
    """Run ``fn`` (which ends with the card synchronised) under the
    profiler, inside the ``bench.window`` range; its reduced trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_RANGE):
            fn()
    return reduce_events(*_kineto_events(prof))


def share(part: float, whole: float) -> Optional[float]:
    """``part`` as a percentage of ``whole``; None where whole is 0."""
    return 100.0 * part / whole if whole > 0 else None
