"""Deterministic fault injection for the serving path (DESIGN.md §14)
and the durability path (§15) — a copy of ``repro.serve.faults`` that
raises the port's errors. The ``SITES`` registry is the reference's
whole, so the same specs are valid in both packages; the port's engine
and catalog fire the seams of the reference's engine and catalog, and
``submit`` waits for the port's serving layer.

A ``FaultInjector`` threads through the SearchEngine / SegmentedCatalog /
QueryServer / persistence seams and fires scripted faults at named call
sites. Every seam is declared in the ``SITES`` registry below — specs
naming an unknown site are rejected at construction, so a typo'd site
name fails loudly instead of silently never injecting (the registry is
itself pinned by a reachability test: every registered seam must fire
under a schedule).

  site            fired from
  -----------     ----------------------------------------------------
  append          SegmentedCatalog.append, before any state changes
  delete          SegmentedCatalog.delete, before any state changes
  compact         SegmentedCatalog.compact, after the in-progress gate
                  and BEFORE the merge build — a fired fault leaves the
                  old snapshot serving, bitwise untouched
  fused_query     SearchEngine device-score loops, once per launch round
  device_sync     SearchEngine, before each batched device->host sync
  submit          QueryServer admission (serve-layer chaos)
  wal_write       persist.Persistence, before writing a WAL record —
                  ``torn`` leaves a prefix of the record on disk
  wal_commit      SegmentedCatalog, AFTER the WAL record is durable but
                  BEFORE the in-memory snapshot swap (the classic
                  kill-between-log-and-apply crash point)
  wal_fsync       persist.Persistence, before the per-record fsync in
                  sync="always" — ``fail`` exercises the rollback path
  wal_read        persist recovery, after reading a WAL file — ``torn``
                  truncates the buffer like a short read
  segment_write   persist.Persistence.write_segment, before any file
  segment_read    persist recovery, after reading a column/meta/valid
                  file — ``torn`` simulates a truncated file on disk
  manifest_commit persist.Persistence.commit_manifest, after the WAL
                  sync but before the manifest replace (two-phase-commit
                  crash point: segment files down, manifest not flipped)

The seams call ``injector.check(site)`` by duck type — the core layers
never import this module, so the dependency arrow stays serve -> core.

Actions: ``fail`` raises ``TransientDeviceError`` (the retryable class,
so retry-policy coverage composes), ``slow`` sleeps ``delay_s`` then
proceeds, ``hang`` blocks for ``delay_s`` (expected to overrun the
request's deadline — the checkpoint after the seam converts the hang
into a typed ``DeadlineExceeded`` instead of a wedged server), ``crash``
raises ``InjectedCrash`` — a BaseException simulating process death that
tears through every ``except Exception`` handler — and ``torn`` raises
``InjectedCrash`` too, but at seams that interpret it as a PARTIAL
write/read: ``fraction`` of the bytes land (or survive), the rest are
lost, exactly like power failing mid-write. Hangs park on an Event so
``release()`` (called by a draining server) unblocks them immediately
instead of waiting out the sleep.

Determinism is the whole point: a spec fires on explicit 1-based call
indices (``at_calls``) and/or with probability ``prob`` — and the
probabilistic draw is keyed on ``(seed, site, call index)``, NOT on a
shared RNG stream, so two runs fire identically however threads
interleave, and a chaos schedule replays bit-for-bit from its seed.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.errors import InjectedCrash, TransientDeviceError

__all__ = ["FaultSpec", "FaultInjector", "ACTIONS", "SITES",
           "register_site"]

ACTIONS = ("fail", "slow", "hang", "crash", "torn")

# the seam registry: site name -> one-line description of where it
# fires. check() rejects unknown sites the same way spec construction
# does, so the registry can never drift from the wired seams in either
# direction — a seam calling check() with an unregistered name fails the
# first time it runs, and tests/test_chaos.py asserts every registered
# seam is reachable and fires under a schedule.
SITES: Dict[str, str] = {
    "append": "SegmentedCatalog.append, before any state change",
    "delete": "SegmentedCatalog.delete, before any state change",
    "compact": "SegmentedCatalog.compact, before the merge build",
    "fused_query": "SearchEngine device-score loops, per launch round",
    "device_sync": "SearchEngine, before each batched host sync",
    "submit": "QueryServer admission",
    "wal_write": "persist WAL append, before the record write",
    "wal_commit": "catalog, between durable WAL record and snapshot swap",
    "wal_fsync": "persist WAL append, before the per-record fsync",
    "wal_read": "persist recovery, after reading a WAL file",
    "segment_write": "persist.write_segment, before any file lands",
    "segment_read": "persist recovery, after reading a segment file",
    "manifest_commit": "persist.commit_manifest, before the manifest flip",
}


def register_site(site: str, where: str) -> None:
    """Declare a new seam (extensions register before building specs)."""
    SITES[str(site)] = str(where)


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: fire ``action`` at ``site`` on the listed
    call indices (1-based) and/or with per-call probability ``prob``.
    ``fraction`` parameterises ``torn``: how much of the write/read
    survives."""
    site: str
    action: str = "fail"
    at_calls: Tuple[int, ...] = ()
    prob: float = 0.0
    delay_s: float = 0.05
    fraction: float = 0.5
    message: str = ""

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"action must be one of {ACTIONS}, "
                             f"got {self.action!r}")
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} — registered sites: "
                f"{sorted(SITES)} (register_site() to extend)")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")


@dataclass
class FaultRecord:
    site: str
    call: int
    action: str
    t_s: float


class FaultInjector:
    """Seeded, thread-safe, replayable fault schedule.

    ``check(site)`` is the only method the seams call; everything else
    is test/observability surface: ``fired`` (the exact schedule that
    happened), ``calls(site)`` (per-site call counts — asserting these
    pins that the seams are actually wired), ``release()`` (unblock any
    parked hang; a closing server calls this so shutdown never waits
    out an injected sleep).
    """

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for sp in self.specs:
            self._by_site.setdefault(sp.site, []).append(sp)
        self._counts: Dict[str, int] = {}
        self._fired: List[FaultRecord] = []
        self._lock = threading.Lock()
        self._released = threading.Event()
        self._t0 = time.monotonic()

    # ------------------------------------------------------------------
    def _draw(self, site: str, idx: int) -> float:
        """Uniform [0, 1) keyed on (seed, site, call idx) — independent
        of thread interleaving and of every other site's call history."""
        key = zlib.crc32(site.encode()) & 0x7FFFFFFF
        return float(np.random.default_rng(
            [self.seed, key, int(idx)]).random())

    def check(self, site: str) -> None:
        """Count one call at ``site`` and fire whatever the schedule
        says. Raises ``TransientDeviceError`` on ``fail``,
        ``InjectedCrash`` on ``crash``/``torn``; sleeps on
        ``slow``/``hang`` (interruptible via ``release``)."""
        if site not in SITES:
            raise ValueError(
                f"fault seam called with unregistered site {site!r} — "
                "add it to faults.SITES (register_site)")
        with self._lock:
            idx = self._counts.get(site, 0) + 1
            self._counts[site] = idx
            todo = []
            for sp in self._by_site.get(site, ()):
                hit = idx in sp.at_calls
                if not hit and sp.prob > 0.0:
                    hit = self._draw(site, idx) < sp.prob
                if hit:
                    todo.append(sp)
                    self._fired.append(FaultRecord(
                        site, idx, sp.action,
                        time.monotonic() - self._t0))
        for sp in todo:   # sleep/raise OUTSIDE the lock: never wedge peers
            if sp.action in ("slow", "hang"):
                self._released.wait(timeout=sp.delay_s)
            if sp.action == "fail":
                raise TransientDeviceError(
                    sp.message or f"injected fault at {site} "
                                  f"(call {self._counts[site]})")
            if sp.action in ("crash", "torn"):
                raise InjectedCrash(
                    sp.message or f"injected {sp.action} at {site} "
                                  f"(call {self._counts[site]})",
                    fraction=sp.fraction)

    # ------------------------------------------------------------------
    def calls(self, site: str) -> int:
        return self._counts.get(site, 0)

    @property
    def fired(self) -> List[FaultRecord]:
        with self._lock:
            return list(self._fired)

    def release(self) -> None:
        """Unblock every current and future hang/slow immediately."""
        self._released.set()
