"""Serving robustness policy: typed rejections, retry/backoff, rate
limits and the bounded admission queue (DESIGN.md §14).

This module is pure policy — no engine imports, no device code — so the
server's admission/dispatch/lifecycle refactor composes small pieces
that are each testable in isolation:

  * the typed error taxonomy (``Overloaded``, ``RateLimited``,
    ``ServerClosed`` here; ``DeadlineExceeded`` / ``TransientDeviceError``
    re-exported from ``repro_torch.core.errors`` — the engine raises those
    below the serve layer);
  * ``RetryPolicy`` — exponential backoff with deterministic seeded
    jitter, max attempts, and retryable-error classification, applied to
    transient device failures on the query path and to background
    compaction;
  * ``TokenBucket`` — per-source rate limiting at admission;
  * ``AdmissionQueue`` — the bounded submit queue with load-shedding
    policy (reject-newest vs reject-largest-fit) and typed rejections.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.errors import (CompactionFailed, DeadlineExceeded,
                                     EngineError, PersistenceError,
                                     RecoveryError, TransientDeviceError,
                                     check_deadline, deadline_after,
                                     deadline_remaining)

__all__ = ["EngineError", "DeadlineExceeded", "TransientDeviceError",
           "CompactionFailed", "PersistenceError", "RecoveryError",
           "Overloaded", "RateLimited", "ServerClosed",
           "check_deadline", "deadline_after", "deadline_remaining",
           "RetryPolicy", "TokenBucket", "AdmissionQueue", "SHED_POLICIES",
           "ERROR_STATUS", "http_status_for"]


class Overloaded(EngineError):
    """Admission control shed this request: the bounded queue was full
    (or the shed policy evicted it to admit cheaper work). The caller
    should back off and resubmit — the request never ran."""
    code = "overloaded"


class RateLimited(Overloaded):
    """The per-source token bucket was empty at admission. A subtype of
    Overloaded: clients treat both as back-pressure."""
    code = "rate_limited"


class ServerClosed(EngineError):
    """The server is draining or closed: queued work is being resolved,
    new work is refused."""
    code = "shutdown"


# ----------------------------------------------------------------------
# error-type -> HTTP status mapping (DESIGN.md §16)
# ----------------------------------------------------------------------
# The wire contract the HTTP front end translates the typed taxonomy
# through. Policy lives HERE (with the taxonomy) so serve/http.py stays
# pure transport and a future multi-host front end maps identically:
#   rate_limited      -> 429  the client is over ITS budget; back off
#   overloaded        -> 503  the SERVER is over budget; retry later
#   shutdown          -> 503  draining — same client action as overload
#   deadline_exceeded -> 504  the request's own budget expired upstream
# Everything else (bad labels, internal faults) is a 500: the request
# was accepted and failed, not shed.
ERROR_STATUS = {
    "rate_limited": 429,
    "overloaded": 503,
    "shutdown": 503,
    "deadline_exceeded": 504,
}


def http_status_for(error_type: str, default: int = 500) -> int:
    """HTTP status for a ``QueryResponse.error_type`` tag ('' -> 200)."""
    if not error_type:
        return 200
    return ERROR_STATUS.get(error_type, default)


# ----------------------------------------------------------------------
# retry / backoff
# ----------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Exponential backoff + deterministic jitter, with retryable-error
    classification. One policy object serves both the query path (wrap
    the engine call) and compaction (sleep between re-attempts).

    Classification: only ``retryable`` types (default: transient device
    failures) re-run. ``DeadlineExceeded`` is NEVER retryable — the
    budget is gone; retrying would bill more device time to a dead
    request — and neither are value/usage errors (a bad label set fails
    identically every attempt).

    Jitter is drawn from a SEEDED rng so a replayed schedule backs off
    identically; ``sleep`` is injectable so tests run at full speed.
    """
    max_attempts: int = 3
    backoff_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 1.0
    jitter_frac: float = 0.25
    seed: int = 0
    retryable: Tuple[type, ...] = (TransientDeviceError,)
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def classify(self, exc: BaseException) -> bool:
        """True when ``exc`` is worth another attempt."""
        if isinstance(exc, DeadlineExceeded):
            return False
        return isinstance(exc, self.retryable)

    def delay_s(self, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (1-based): exponential,
        capped, with multiplicative jitter in [1, 1 + jitter_frac)."""
        base = min(self.backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)
        return base * (1.0 + self.jitter_frac * float(self._rng.random()))

    def call(self, fn: Callable, *, deadline_s: Optional[float] = None,
             sleep: Callable[[float], None] = time.sleep,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Run ``fn`` with up to ``max_attempts`` tries. Backoff sleeps
        never overrun ``deadline_s``; if the remaining budget is smaller
        than the backoff, the last error re-raises immediately (typed —
        the caller maps it to a response)."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                if attempt >= self.max_attempts or not self.classify(e):
                    raise
                delay = self.delay_s(attempt)
                rem = deadline_remaining(deadline_s)
                if rem is not None:
                    if rem <= delay:
                        raise
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)


# ----------------------------------------------------------------------
# rate limiting
# ----------------------------------------------------------------------

class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    ``try_acquire`` never blocks — admission control rejects, it does
    not queue-jump. ``clock`` is injectable for deterministic tests."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(self.burst,
                       self._tokens + (now - self._t) * self.rate)


# ----------------------------------------------------------------------
# bounded admission queue + load shedding
# ----------------------------------------------------------------------

SHED_POLICIES = ("reject-newest", "reject-largest-fit")


class AdmissionQueue:
    """Bounded FIFO with a load-shedding policy, the submit queue behind
    ``QueryServer.submit`` (depth=None keeps the legacy unbounded
    behaviour). Entries are opaque ``(item, cost)`` pairs — ``cost`` is
    the shed key (the server uses the label-set size, a fit-cost proxy).

      * ``reject-newest``      full -> the incoming item is refused.
      * ``reject-largest-fit`` full -> the queued item with the LARGEST
        cost is evicted to admit a cheaper newcomer (an expensive fit
        holds the window longest, so shedding it buys the most queue
        headroom per rejection); a newcomer at least as costly as every
        queued entry is refused instead.

    ``offer`` returns ``(admitted, evicted_item)`` so the caller can
    resolve the shed request with a typed Overloaded response — nothing
    is ever dropped silently. ``drain`` empties the queue for shutdown.
    """

    def __init__(self, depth: Optional[int] = None,
                 shed_policy: str = "reject-newest"):
        if depth is not None and depth < 1:
            raise ValueError("depth must be >= 1 (or None for unbounded)")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        self.depth = depth
        self.shed_policy = shed_policy
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self.depth_peak = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    def offer(self, item, cost: float = 0.0):
        """Try to enqueue. Returns (admitted, evicted_item_or_None)."""
        with self._cv:
            if self.depth is None or len(self._dq) < self.depth:
                self._dq.append((item, cost))
                self.depth_peak = max(self.depth_peak, len(self._dq))
                self._cv.notify()
                return True, None
            if self.shed_policy == "reject-newest":
                return False, None
            j = max(range(len(self._dq)),
                    key=lambda i: self._dq[i][1])
            if self._dq[j][1] <= cost:
                return False, None          # newcomer is the largest fit
            evicted = self._dq[j][0]
            del self._dq[j]
            self._dq.append((item, cost))
            self._cv.notify()
            return True, evicted

    def pop(self, timeout: float):
        """Next item in FIFO order, or None after ``timeout`` seconds."""
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            if not self._dq:
                return None
            return self._dq.popleft()[0]

    def drain(self) -> List:
        """Remove and return every queued item (shutdown path)."""
        with self._cv:
            items = [it for it, _ in self._dq]
            self._dq.clear()
            return items
