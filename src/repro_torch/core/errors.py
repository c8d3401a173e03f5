"""Typed error taxonomy + deadline helpers shared by the core engine and
the serving layer (DESIGN.md §14). A copy of ``repro.core.errors``: the
port imports nothing of the JAX package.

The serving path needs to tell three failure families apart at every
seam — retry, shed, or report — so the exceptions carry a stable
machine-readable ``code`` instead of leaving the server to string-match
messages:

  * ``DeadlineExceeded``     the request ran out of budget; never retry,
                             never bill more device time to it.
  * ``TransientDeviceError`` a fault the retry policy may re-attempt
                             (injected faults, flaky device syncs).
  * everything else          a real bug or bad input; fails the request,
                             exactly once, with per-request isolation.

This module lives in ``core`` (not ``serve``) on purpose: the engine's
query loops raise ``DeadlineExceeded`` between device rounds, and core
importing serve would invert the layering. The serving layer re-exports
these and adds the serve-only types (Overloaded, ...).

Deadlines are ABSOLUTE ``time.monotonic()`` timestamps (never wall
clock — NTP steps must not expire requests), carried as a plain float so
they cross layer boundaries and dataclass fields without wrapping.
"""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["EngineError", "DeadlineExceeded", "TransientDeviceError",
           "CompactionFailed", "PersistenceError", "RecoveryError",
           "InjectedCrash", "deadline_after", "deadline_remaining",
           "check_deadline"]


class EngineError(RuntimeError):
    """Base of the typed taxonomy; ``code`` is the stable wire tag the
    serving layer copies into ``QueryResponse.error_type``."""
    code = "internal"


class DeadlineExceeded(EngineError):
    """The request's deadline passed at a checkpoint. Raised at
    admission, at window formation, before the fit, and between
    per-subset device query rounds — never mid-kernel (device programs
    are not cancellable; the checkpoints bound how stale a dead request
    can run to one round)."""
    code = "deadline_exceeded"


class TransientDeviceError(EngineError):
    """A failure the RetryPolicy classifies as retryable: the operation
    is safe to re-run from scratch (queries are pure over an immutable
    snapshot; appends/compactions are atomic — they either swapped a new
    snapshot in or changed nothing)."""
    code = "transient"


class CompactionFailed(EngineError):
    """A background compaction attempt died. The old snapshot keeps
    serving (the swap never happened); the server records the error and
    retries with backoff."""
    code = "compaction_failed"


class PersistenceError(EngineError):
    """A durability operation (WAL append, fsync, checkpoint commit)
    failed AND the failure was made atomic: the write-ahead log was
    rolled back to the pre-record offset, so neither memory nor disk
    carries the mutation. The caller may retry the whole operation; if
    the rollback itself also failed the log is poisoned and every later
    mutation raises this until the catalog is reopened (serving reads
    continue — only durability is down)."""
    code = "persistence"


class RecoveryError(EngineError):
    """Crash recovery detected corruption — a torn or checksum-failed
    WAL record, a truncated column file, an unreadable manifest — and
    salvaged everything before it. Carries the evidence instead of
    guessing: ``report`` (the durability layer's RecoveryReport) says what
    was salvaged and what was quarantined, and ``catalog`` is the
    recovered SegmentedCatalog over the salvaged prefix (None only when
    nothing was serviceable). The serving layer keeps the salvaged
    catalog and starts ``degraded`` — corruption is NEVER silently
    folded into results."""
    code = "recovery"

    def __init__(self, msg: str, *, report=None, catalog=None):
        super().__init__(msg)
        self.report = report
        self.catalog = catalog


class InjectedCrash(BaseException):
    """A fault-injection seam simulating PROCESS DEATH at an exact
    point (torn write mid-record, kill between WAL append and snapshot
    swap). Deliberately a BaseException: every normal error handler
    (per-request isolation, retry policies) catches ``Exception``, and
    a simulated crash must tear through all of them exactly like a real
    ``kill -9`` would — the test harness catches it at the top, drops
    the dead catalog object, and reopens from disk. ``fraction`` tells
    a torn-write seam how much of the record to leave behind."""

    def __init__(self, msg: str = "injected crash", fraction: float = 0.5):
        super().__init__(msg)
        self.fraction = float(fraction)


# ----------------------------------------------------------------------
# deadline helpers
# ----------------------------------------------------------------------

def deadline_after(timeout_s: float, *, now: Optional[float] = None) -> float:
    """Absolute monotonic deadline ``timeout_s`` from now."""
    return (time.monotonic() if now is None else now) + float(timeout_s)


def deadline_remaining(deadline_s: Optional[float],
                       *, now: Optional[float] = None) -> Optional[float]:
    """Seconds of budget left (negative when expired); None means no
    deadline."""
    if deadline_s is None:
        return None
    return float(deadline_s) - (time.monotonic() if now is None else now)


def check_deadline(deadline_s: Optional[float], where: str = "") -> None:
    """Raise ``DeadlineExceeded`` if ``deadline_s`` (absolute monotonic)
    has passed. ``where`` names the checkpoint so timeout reports say
    which stage burned the budget."""
    if deadline_s is None:
        return
    late = time.monotonic() - float(deadline_s)
    if late > 0:
        raise DeadlineExceeded(
            f"deadline exceeded by {late * 1e3:.1f} ms"
            + (f" at {where}" if where else ""))
