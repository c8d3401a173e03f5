"""Per-query tracing: spans, ambient propagation, recent-trace ring.

A ``Trace`` is born at admission (HTTP ``/query`` or ``submit``),
carries a request id (caller-provided ``X-Request-Id`` or a fresh
uuid4 hex), and rides the ``QueryRequest`` through the admission
queue, the batch window, the fit, every per-subset device round, the
rank, and the cache put. Each stage records a span
``(name, start, dur, attrs)``.

Propagation is the hard part: the core engine must stay importable
without the serving stack, and a batched call serves many requests at
once. So spans are recorded through a *thread-local ambient set* of
traces — the serving thread calls ``attach([t1, t2, ...])`` around the
engine call and instrumented code inside (fit loop, score rounds,
rank) just calls ``span("fit")``; the span lands on every attached
trace. When nothing is attached, ``span()`` returns a shared no-op
context — one dict lookup and a falsy check, ≈zero cost with tracing
disabled.

Device rounds use a mark API instead of nesting: the score loops call
``round_mark()`` once per launch round (the ``_round_checkpoint``
seam), which closes the previous ``device_round`` span and opens the
next; ``round_scope()`` around the whole loop closes the dangling
last one. This keeps the per-round cost to two clock reads.

On a CUDA device the engine's launches are asynchronous, so a span
closes when the host has queued its work, not when the device has run
it. Device time lands in whichever span holds the next blocking sync:
the round's stat sync inside ``device_round`` (which also waits for
the fit's queued tail), and the ranked results' copy inside ``rank``.
Nothing here synchronizes the device to make a span "honest": that
would add host syncs the engine's budget does not have.

``TraceStore`` keeps the last N finished traces in a ring and writes a
threshold-gated slow-query log line (one JSON object per slow trace)
so "why was *that* query slow" is answerable after the fact without
re-running anything.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Span", "Trace", "TraceStore", "attach", "active", "span",
           "add_span_active", "round_scope", "round_mark",
           "new_trace_id"]


def new_trace_id() -> str:
    return uuid.uuid4().hex


class Span:
    __slots__ = ("name", "t0", "dur_s", "attrs")

    def __init__(self, name: str, t0: float, dur_s: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = t0
        self.dur_s = dur_s
        self.attrs = attrs

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "t0": self.t0,
                             "dur_s": self.dur_s}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Trace:
    """One query's span record. Append-only under its own small lock
    (spans can arrive from the HTTP loop thread, the serving thread,
    and — via ambient attach — whatever thread runs the engine call).
    """

    __slots__ = ("trace_id", "created_s", "spans", "marks", "status",
                 "finished_s", "attrs", "_lock")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.created_s = time.perf_counter()
        self.spans: List[Span] = []
        self.marks: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self.status: Optional[str] = None
        self.finished_s: Optional[float] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------ recording --
    def add_span(self, name: str, t0: float, dur_s: float,
                 attrs: Optional[Dict[str, Any]] = None) -> None:
        sp = Span(name, t0, dur_s, attrs)
        with self._lock:
            self.spans.append(sp)

    def mark(self, name: str) -> None:
        """Stamp a named instant (e.g. "queued") for a later cross-
        thread span: the queue span runs from the queued mark to handle
        entry, so batch-window formation wait is inside it."""
        self.marks[name] = time.perf_counter()

    def span_from_mark(self, mark: str, name: str,
                       attrs: Optional[Dict[str, Any]] = None) -> None:
        t0 = self.marks.pop(mark, None)
        if t0 is not None:
            self.add_span(name, t0, time.perf_counter() - t0, attrs)

    class _SpanCtx:
        __slots__ = ("_trace", "_name", "_attrs", "_t0")

        def __init__(self, trace: "Trace", name: str,
                     attrs: Optional[Dict[str, Any]]):
            self._trace, self._name, self._attrs = trace, name, attrs

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, exc, tb):
            self._trace.add_span(self._name, self._t0,
                                 time.perf_counter() - self._t0,
                                 self._attrs)
            return False

    def span(self, name: str,
             attrs: Optional[Dict[str, Any]] = None) -> "Trace._SpanCtx":
        return Trace._SpanCtx(self, name, attrs)

    # ------------------------------------------------------ finishing --
    def finish(self, status: str = "ok") -> None:
        if self.finished_s is None:
            self.finished_s = time.perf_counter()
            self.status = status

    @property
    def wall_s(self) -> float:
        end = self.finished_s if self.finished_s is not None \
            else time.perf_counter()
        return end - self.created_s

    def span_total_s(self, names: Optional[Sequence[str]] = None) -> float:
        with self._lock:
            spans = list(self.spans)
        if names is None:
            return sum(s.dur_s for s in spans)
        want = set(names)
        return sum(s.dur_s for s in spans if s.name in want)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        d: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "status": self.status,
            "wall_s": self.wall_s,
            "spans": spans,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class TraceStore:
    """Ring buffer of recently finished traces + slow-query log.

    ``slow_s`` is the latency threshold: any trace finishing above it
    gets one JSON line appended to ``slow_log`` entries (and, when a
    ``slow_log_path`` is set, to that file). Bounded on both axes so a
    long-lived server can't grow without limit."""

    def __init__(self, capacity: int = 256, slow_s: float = 1.0,
                 slow_log_capacity: int = 128,
                 slow_log_path: Optional[str] = None):
        self.capacity = int(capacity)
        self.slow_s = float(slow_s)
        self.slow_log_path = slow_log_path
        self._lock = threading.Lock()
        self._ring: "deque[Trace]" = deque(maxlen=self.capacity)
        self._slow: "deque[str]" = deque(maxlen=int(slow_log_capacity))

    def add(self, trace: Trace) -> None:
        line = None
        if trace.wall_s > self.slow_s:
            line = json.dumps({
                "slow_query": True,
                "trace_id": trace.trace_id,
                "wall_ms": round(trace.wall_s * 1e3, 3),
                "status": trace.status,
                "spans": {s["name"]: round(s["dur_s"] * 1e3, 3)
                          for s in trace.to_dict()["spans"]},
                **({"attrs": trace.attrs} if trace.attrs else {}),
            }, sort_keys=True)
        with self._lock:
            self._ring.append(trace)
            if line is not None:
                self._slow.append(line)
        if line is not None and self.slow_log_path:
            try:
                with open(self.slow_log_path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass    # slow log is best-effort; never fail the query

    def recent(self, n: int = 32) -> List[Dict[str, Any]]:
        with self._lock:
            traces = list(self._ring)
        return [t.to_dict() for t in traces[-max(0, int(n)):]]

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            traces = list(self._ring)
        for t in reversed(traces):
            if t.trace_id == trace_id:
                return t.to_dict()
        return None

    def slow_log(self, n: int = 32) -> List[str]:
        with self._lock:
            return list(self._slow)[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# ---------------------------------------------------------------------
# Ambient propagation: thread-local set of attached traces. The serving
# thread attaches the batch's traces around the engine call; engine code
# records spans without importing anything above obs.
# ---------------------------------------------------------------------

_tls = threading.local()


class _NullCtx:
    """Shared no-op context: the disabled-tracing fast path allocates
    nothing and does two attribute loads + a falsy check per span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullCtx()


class _Attach:
    __slots__ = ("_traces", "_prev")

    def __init__(self, traces: Sequence[Trace]):
        self._traces = list(traces)

    def __enter__(self):
        self._prev = getattr(_tls, "traces", None)
        _tls.traces = self._traces
        return self._traces

    def __exit__(self, exc_type, exc, tb):
        _tls.traces = self._prev
        return False


def attach(traces: Sequence[Trace]) -> _Attach:
    """Context manager binding ``traces`` as this thread's ambient set.
    Nested attaches stack (inner wins, outer restored on exit)."""
    return _Attach(traces)


def active() -> List[Trace]:
    return getattr(_tls, "traces", None) or []


class _MultiSpanCtx:
    __slots__ = ("_traces", "_name", "_attrs", "_t0")

    def __init__(self, traces: List[Trace], name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._traces, self._name, self._attrs = traces, name, attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        for t in self._traces:
            t.add_span(self._name, self._t0, dur, self._attrs)
        return False


def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """A span on every ambient trace; the shared null context when no
    trace is attached (the ≈zero-cost disabled path)."""
    traces = getattr(_tls, "traces", None)
    if not traces:
        return _NULL
    return _MultiSpanCtx(traces, name, attrs)


def add_span_active(name: str, t0: float, dur_s: float,
                    attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-measured span on every ambient trace — for
    code that times a phase anyway (fit wall, ranking block) and can
    donate the measurement instead of paying a second clock pair."""
    traces = getattr(_tls, "traces", None)
    if traces:
        for t in traces:
            t.add_span(name, t0, dur_s, attrs)


class _RoundScope:
    """Per-subset device rounds, recorded by marks not nesting.

    ``round_mark()`` (called by ``_round_checkpoint`` at the top of each
    launch round) closes the open ``device_round`` span and starts the
    next; exiting the scope closes the last. The first mark only starts
    round 0 — so N marks + exit → N spans."""

    __slots__ = ("_traces", "_t0", "_idx", "_prev_scope")

    def __init__(self, traces: List[Trace]):
        self._traces = traces
        self._t0: Optional[float] = None
        self._idx = 0

    def __enter__(self):
        self._prev_scope = getattr(_tls, "round_scope", None)
        _tls.round_scope = self
        return self

    def __exit__(self, exc_type, exc, tb):
        self._close_open()
        _tls.round_scope = self._prev_scope
        return False

    def _close_open(self) -> None:
        if self._t0 is not None:
            now = time.perf_counter()
            dur = now - self._t0
            attrs = {"round": self._idx}
            for t in self._traces:
                t.add_span("device_round", self._t0, dur, attrs)
            self._t0 = None
            self._idx += 1

    def mark(self) -> None:
        self._close_open()
        self._t0 = time.perf_counter()


def round_scope():
    """Scope for a score loop's device rounds; null when untraced."""
    traces = getattr(_tls, "traces", None)
    if not traces:
        return _NULL
    return _RoundScope(traces)


def round_mark() -> None:
    """One device launch round boundary (the ``_round_checkpoint``
    seam). No-op unless inside an active ``round_scope``."""
    scope = getattr(_tls, "round_scope", None)
    if scope is not None:
        scope.mark()
