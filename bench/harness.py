"""What every job shares: the run's context, its result, the checks
that decide ``correct``, and the timed window.

A job sets up the program, calls ``window`` (or ``traced_window`` with
``--trace 1``), and then, with the program's state freed, runs its
reference and returns the compared numbers as ``Check``s.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from bench import devtrace


@dataclass
class Context:
    """One run: the cell's parts (``registry.cell_parts``), the seed,
    the window's seconds, whether to trace, the device, and the process's
    start on the host clock. ``hooks`` lets a test break the timed path
    underneath (none in a benchmark run)."""
    cell: dict
    config: dict
    traffic: dict
    reference: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    hooks: Dict[str, Callable] = field(default_factory=dict)


@dataclass
class Check:
    name: str
    value: float
    limit: Optional[float]

    @property
    def passed(self) -> bool:
        return (self.limit is not None and self.value == self.value
                and self.value <= self.limit)


def checks(traffic: dict, readings: Dict[str, float]) -> List[Check]:
    """The readings that the mix gives a limit, as checks (a reading it
    leaves out is not compared)."""
    limits = traffic.get("limits", {})
    return [Check(k, v, limits[k]) for k, v in readings.items()
            if k in limits]


def correct(found: List[Check], failed: int) -> bool:
    """A run's ``correct``: some number compared, every one within its
    limit, and no unit failed. The result line and the controls' verdict
    both come from here."""
    return bool(found) and failed == 0 and all(c.passed for c in found)


@dataclass
class JobResult:
    metrics: Dict[str, float]           # end-to-end values by name
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    work: Dict[str, float]              # what the traced window did
    trace: Optional[dict] = None        # trace.reduce_events' numbers
    readings: Dict[str, object] = field(default_factory=dict)


@dataclass
class Window:
    units: int
    seconds: float                      # start to the last unit's end


def window(unit: Callable[[], None], seconds: float) -> Window:
    """Run ``unit`` (work that ends with the card synchronised) until
    ``seconds`` have passed on the host clock; no unit starts after
    that. The window spans its start to the end of its last unit."""
    n = 0
    start = time.perf_counter()
    while True:
        unit()
        n += 1
        end = time.perf_counter()
        if end - start >= seconds:
            return Window(n, end - start)


def traced_window(unit: Callable[[], None], units: int) -> dict:
    """``units`` units under the profiler; the reduced trace."""
    def run():
        for _ in range(units):
            unit()
    return devtrace.traced(run)


def rel_gap(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   leaves=None) -> float:
    """The widest gap between the program's norm of a tensor and the
    reference's, against the larger of the reference's norm of that
    tensor and the median tensor's (``leaves``: the tensors compared,
    default all)."""
    import statistics
    names = list(reference) if leaves is None else list(leaves)
    med = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], med)
               for n in names)


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(dev) -> int:
    """The device's peak of allocated bytes in this process (0 on the
    CPU)."""
    import torch
    return torch.cuda.max_memory_allocated() \
        if torch.device(dev).type == "cuda" else 0


def free(dev) -> None:
    """Release what the program's freed state held on the device."""
    import gc
    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
