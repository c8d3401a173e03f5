"""Typed metrics registry for the serving stack (DESIGN.md §17).

RapidEarth's pitch is interactive latency, and every layer so far kept
its own ad-hoc ledger — ``QueryServer.stats``, ``ResultCache.counters``,
``Persistence.stats``, the HTTP front end's status buckets. This module
is the one place they all report into: a ``MetricsRegistry`` of typed
``Counter`` / ``Gauge`` / ``Histogram`` primitives plus scrape-time
*collectors* that adapt the existing locked dicts without double
bookkeeping on the hot path.

Design constraints, in order:

  * **lock-cheap on the hot path** — a counter bump is one small
    per-metric lock around an int add; histograms bisect a fixed bucket
    table and bump two ints. No allocation after the first touch of a
    label set.
  * **fixed-bucket histograms** — p50/p99/p999 are derivable from the
    bucket counts alone (log-spaced bounds, linear interpolation within
    a bucket), so no samples are ever stored and the memory footprint
    is constant whatever the request volume.
  * **collectors, not mirrors** — subsystems that already keep a locked
    counter dict (the server ledger, the cache, the WAL) register a
    ``collect()`` callable; the registry reads them at scrape time, so
    the serving thread never pays a second bookkeeping write.
  * **Prometheus text exposition** — ``render_prometheus()`` emits the
    v0.0.4 text format (``# HELP`` / ``# TYPE`` / samples, histograms
    as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), which
    is what ``GET /metrics`` serves.

The port's copy of ``repro.obs.metrics``, unchanged: the family names
and the text format are the reference's.

Naming scheme (§17): ``<subsystem>_<noun>[_<unit>]`` with snake-case
label values — ``server_requests_total{outcome="ok"}``,
``span_seconds{name="fit"}``, ``cache_age_at_eviction_seconds``.
"""
from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BUCKETS_S", "AGE_BUCKETS_S", "default_registry"]

# log-spaced latency bounds, 100us .. 60s (plus +Inf implicitly): wide
# enough that a sub-ms cache hit and a multi-second degraded query both
# land in a resolving bucket, few enough that a scrape stays small
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# cache-entry ages: seconds to hours
AGE_BUCKETS_S: Tuple[float, ...] = (
    0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 3600.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Metric:
    """Shared label-family plumbing: a metric owns one state object per
    distinct label-value tuple; ``labels(**kv)`` resolves (and caches)
    the child. Unlabelled metrics use the empty tuple child."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _new_child(self):
        raise NotImplementedError

    def _child(self, labelvalues: Tuple[str, ...]):
        ch = self._children.get(labelvalues)
        if ch is None:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {labelvalues}")
            with self._lock:
                ch = self._children.setdefault(labelvalues,
                                               self._new_child())
        return ch

    def labels(self, *values, **kv):
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        return self._child(values)

    def _iter_children(self):
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Counter(_Metric):
    """Monotone counter. ``inc`` on the bare metric hits the empty-label
    child; labelled families go through ``labels(...)``."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, v: float = 1.0, **labelkv) -> None:
        if labelkv:
            self.labels(**labelkv).inc(v)
        else:
            self._child(()).inc(v)

    @property
    def value(self) -> float:
        return self._child(()).value


class _GaugeChild:
    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._v -= v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float, **labelkv) -> None:
        if labelkv:
            self.labels(**labelkv).set(v)
        else:
            self._child(()).set(v)

    def inc(self, v: float = 1.0) -> None:
        self._child(()).inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._child(()).dec(v)

    @property
    def value(self) -> float:
        return self._child(()).value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)    # last slot == +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        """Derive quantile ``q`` in [0, 1] from the bucket counts alone
        (no samples stored): find the bucket holding the q-th
        observation and interpolate linearly inside it. The +Inf bucket
        reports its lower bound — an honest floor, never an invented
        value. 0.0 with no observations."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) else lo
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self._bounds[-1]


class Histogram(_Metric):
    """Fixed-bucket histogram: observations land in log-spaced buckets;
    p50/p99/p999 come from the counts (``quantile``), so no sample is
    ever stored. Default buckets suit latencies in seconds."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError("duplicate bucket bounds")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, **labelkv) -> None:
        if labelkv:
            self.labels(**labelkv).observe(v)
        else:
            self._child(()).observe(v)

    def quantile(self, q: float, **labelkv) -> float:
        ch = self.labels(**labelkv) if labelkv else self._child(())
        return ch.quantile(q)

    @property
    def sum(self) -> float:
        return self._child(()).sum

    @property
    def count(self) -> int:
        return self._child(()).count


class MetricsRegistry:
    """Holds metrics + scrape-time collectors, renders Prometheus text.

    Each ``QueryServer`` owns one registry (no cross-server pollution in
    tests or multi-tenant processes); library code without a server —
    benchmarks driving the engine directly — lands in the process-wide
    ``default_registry()`` via ``obs.profile``'s thread binding."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, _Metric]" = {}
        self._collectors: List[Callable[[], Iterable[Tuple]]] = []

    # -------------------------------------------------- registration --
    def register(self, metric: _Metric):
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is not None:
                if type(cur) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered "
                        f"with kind {cur.kind!r}")
                return cur
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    def register_collector(self, fn: Callable[[], Iterable[Tuple]]):
        """``fn()`` runs at scrape time and yields sample tuples
        ``(name, kind, labels_dict, value)`` — the adapter for
        subsystems that already keep their own locked counter dicts
        (server ledger, cache, WAL). kind is "counter" or "gauge"."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -------------------------------------------------------- reading --
    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Tuple[str, str, Dict[str, str], float]]:
        """Every sample in the registry (typed metrics first, then
        collector output) as flat (name, kind, labels, value) tuples —
        histograms expand to ``_sum`` / ``_count`` / ``_bucket``."""
        out: List[Tuple[str, str, Dict[str, str], float]] = []
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            for lv, ch in m._iter_children():
                labels = dict(zip(m.labelnames, lv))
                if isinstance(m, Histogram):
                    counts, s, c = ch.snapshot()
                    cum = 0
                    for bound, cnt in zip(m.buckets + (math.inf,), counts):
                        cum += cnt
                        out.append((m.name + "_bucket", "histogram",
                                    {**labels,
                                     "le": _fmt_value(bound)}, cum))
                    out.append((m.name + "_sum", "histogram", labels, s))
                    out.append((m.name + "_count", "histogram", labels, c))
                else:
                    out.append((m.name, m.kind, labels, ch.value))
        for fn in collectors:
            try:
                for name, kind, labels, value in fn():
                    out.append((_check_name(name), kind, dict(labels),
                                float(value)))
            except Exception as e:  # noqa: BLE001 — a scrape must not die
                out.append(("obs_collector_errors", "counter",
                            {"error": type(e).__name__}, 1.0))
        return out

    def value(self, name: str, /, **labelkv) -> float:
        """One sample's current value (0.0 when absent) — the read API
        benchmarks and tests use so they share the scrape's source of
        truth instead of keeping parallel ledgers. ``name`` is
        positional-only: labels may themselves be called ``name``
        (e.g. ``span_seconds{name=...}``)."""
        want = {str(k): str(v) for k, v in labelkv.items()}
        for n, _, labels, v in self.collect():
            if n == name and labels == want:
                return v
        return 0.0

    # ------------------------------------------------------ rendering --
    def render_prometheus(self) -> str:
        """Text exposition v0.0.4: HELP/TYPE headers per family, then
        samples. Histogram families keep bucket/sum/count adjacent."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        seen = set()
        by_family: Dict[str, List[str]] = {}
        for name, kind, labels, value in self.collect():
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if kind == "histogram" and name.endswith(suffix):
                    family = name[: -len(suffix)]
                    break
            if family not in seen:
                seen.add(family)
                m = next((mm for mm in metrics if mm.name == family), None)
                hdr = []
                if m is not None and m.help:
                    hdr.append(f"# HELP {family} {m.help}")
                hdr.append(f"# TYPE {family} "
                           f"{m.kind if m is not None else kind}")
                by_family[family] = hdr
            by_family[family].append(
                f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
        for fam_lines in by_family.values():
            lines.extend(fam_lines)
        return "\n".join(lines) + ("\n" if lines else "")


_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide fallback registry (library code with no server
    attached). Servers own their own registries; this one exists so
    ``obs.profile`` always has somewhere to record."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
