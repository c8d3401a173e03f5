"""Device-phase profiling hooks: ``profile(site)`` contexts.

The engine's wall time hides in four places a span can't cheaply
separate: jit dispatch (trace/compile + launch), the blocking device
sync, the WAL fsync, and compaction. Each such site wraps itself in
``profile("<site>")``; the elapsed time lands in the
``profile_seconds{site=...}`` histogram of whichever registry the
current thread is bound to (``bind_registry`` — the QueryServer binds
its serving thread and compaction worker), falling back to the
process-wide default registry so bare-engine benchmarks still get a
breakdown.

Disabled path: when ``set_enabled(False)`` (the default until a server
or benchmark opts in) the context is a shared no-op — one module
global load and a falsy check per site.

On the port the sites keep the reference's names and call counts, but
two of them time different work (the engine has no jit):

  * ``jit_dispatch`` is the host time that enqueues one round's probe
    launches (uploads of the boxes and the one-hot, the CUDA launches
    of every pending subset's probe). The launches are asynchronous, so
    it holds no device time.
  * ``device_sync`` is the blocking ``.cpu()`` of the round's stacked
    stat vector. It waits for every kernel queued before it, so the
    round's device time lands here (and the fit's, where the fit left
    work in flight).

This module keeps its own globals: in a process that imports both
packages, ``set_enabled`` and ``bind_registry`` of one do not reach the
other."""
from __future__ import annotations

import threading
import time
from typing import Optional

from .metrics import Histogram, MetricsRegistry, default_registry

__all__ = ["profile", "record", "bind_registry", "set_enabled",
           "enabled", "PROFILE_SITES"]

# the sanctioned site names; new sites should be added here so the
# serve_load stage attribution and DESIGN.md §17 stay in sync
PROFILE_SITES = ("jit_dispatch", "device_sync", "wal_fsync", "compact")

_tls = threading.local()
_enabled = False


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


class _Bind:
    __slots__ = ("_registry", "_prev")

    def __init__(self, registry: Optional[MetricsRegistry]):
        self._registry = registry

    def __enter__(self):
        self._prev = getattr(_tls, "registry", None)
        _tls.registry = self._registry
        return self._registry

    def __exit__(self, exc_type, exc, tb):
        _tls.registry = self._prev
        return False


def bind_registry(registry: Optional[MetricsRegistry]) -> _Bind:
    """Context manager routing this thread's profile observations to
    ``registry`` (None rebinds to the process default)."""
    return _Bind(registry)


def _histogram() -> Histogram:
    reg = getattr(_tls, "registry", None) or default_registry()
    return reg.histogram(
        "profile_seconds",
        "Time spent in device-phase profile sites", ("site",))


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullCtx()


class _ProfileCtx:
    __slots__ = ("_site", "_t0")

    def __init__(self, site: str):
        self._site = site

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        _histogram().labels(site=self._site).observe(dur)
        return False


def profile(site: str):
    """Time a device-phase site into ``profile_seconds{site=}``.
    No-op (shared null context) while profiling is disabled."""
    if not _enabled:
        return _NULL
    return _ProfileCtx(site)


def record(site: str, dur_s: float) -> None:
    """Record an already-measured duration for ``site`` — for callers
    whose timed region spans a loop where re-indenting under a context
    manager would obscure the code. No-op while disabled."""
    if _enabled:
        _histogram().labels(site=site).observe(dur_s)
