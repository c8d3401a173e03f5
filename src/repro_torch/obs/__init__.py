"""Unified observability layer (DESIGN.md §17) — the port's copy of
``repro.obs``. The modules are pure Python, so the port keeps its own
copy rather than importing the JAX package; names, sites and metric
families are the reference's.

One subsystem, three surfaces:

  * ``obs.metrics`` — the typed metrics registry every layer reports
    into (counters / gauges / fixed-bucket histograms + scrape-time
    collectors + Prometheus text rendering).
  * ``obs.trace``   — per-query traces with thread-local ambient
    propagation, a recent-traces ring, and a slow-query log.
  * ``obs.profile`` — ``profile(site)`` contexts around jit dispatch,
    device sync, WAL fsync, and compaction.

``Observability`` bundles them per server: the ``QueryServer`` owns one
and folds every finished trace's spans into ``span_seconds{name=}``
histograms, which is where ``serve_load``'s ``stage_frac_*`` cells come
from. Layering contract: this package imports nothing of
``repro_torch.core`` or ``repro_torch.serve`` (stdlib only), so core,
persist, and serve can all depend on it while core stays importable
without the serving stack."""
from __future__ import annotations

import threading
from typing import Optional

# NOTE: import the submodule without rebinding the package attribute —
# ``repro_torch.obs.profile`` must stay the MODULE (consumers import it for
# record/bind_registry/set_enabled); the ``profile(site)`` context is
# ``repro_torch.obs.profile.profile`` / the ``profile_site`` alias below
from . import profile as profile_mod
from .metrics import (AGE_BUCKETS_S, Counter, Gauge, Histogram,
                      LATENCY_BUCKETS_S, MetricsRegistry,
                      default_registry)
from .profile import bind_registry
from .profile import profile as profile_site
from .trace import (Span, Trace, TraceStore, active, attach, new_trace_id,
                    round_mark, round_scope, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS_S", "AGE_BUCKETS_S", "default_registry",
    "Span", "Trace", "TraceStore", "attach", "active", "span",
    "round_scope", "round_mark", "new_trace_id",
    "profile_site", "bind_registry", "Observability",
]

# the stage names serve_load attributes wall time to; "other" absorbs
# the remainder so fractions always sum to ~1
STAGE_SPANS = ("fit", "device_round", "rank")


class Observability:
    """Per-server bundle: registry + trace store + enable switches.

    ``metrics_enabled`` gates collector registration and span-duration
    folding; ``tracing_enabled`` gates Trace creation at admission.
    Both off → the hot path sees only the thread-local null-context
    checks. ``observe_trace`` is called once per finished trace by the
    server and is the single source for the ``span_seconds`` and
    ``request_seconds`` histograms."""

    def __init__(self, metrics_enabled: bool = True,
                 tracing_enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 trace_capacity: int = 256,
                 slow_query_s: float = 1.0,
                 slow_log_path: Optional[str] = None):
        self.metrics_enabled = bool(metrics_enabled)
        self.tracing_enabled = bool(tracing_enabled)
        self.registry = registry or MetricsRegistry()
        self.traces = TraceStore(capacity=trace_capacity,
                                 slow_s=slow_query_s,
                                 slow_log_path=slow_log_path)
        self._lock = threading.Lock()
        if self.metrics_enabled:
            profile_mod.set_enabled(True)
        self.span_seconds = self.registry.histogram(
            "span_seconds", "Per-stage span durations", ("name",))
        self.request_seconds = self.registry.histogram(
            "request_seconds", "End-to-end traced request wall",
            ("status",))

    @property
    def enabled(self) -> bool:
        return self.metrics_enabled or self.tracing_enabled

    def new_trace(self, trace_id: Optional[str] = None) -> Optional[Trace]:
        """A fresh trace when tracing is on; None (caller skips all
        trace work) otherwise."""
        if not self.tracing_enabled:
            return None
        return Trace(trace_id)

    def observe_trace(self, trace: Trace, status: str = "ok") -> None:
        """Finish + archive a trace: status stamped, spans folded into
        the per-stage histograms, ring/slow-log updated."""
        trace.finish(status)
        if self.metrics_enabled:
            for sp in list(trace.spans):
                self.span_seconds.labels(name=sp.name).observe(sp.dur_s)
            self.request_seconds.labels(
                status=trace.status or "ok").observe(trace.wall_s)
        self.traces.add(trace)

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()
