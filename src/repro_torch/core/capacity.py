"""Capacity-bucketing helpers shared by the engine, index and segment layers.
A copy of ``repro.core.capacity``: the port imports nothing of the JAX
package, and the same policy keeps capacities and retries equal.

In the reference every capacity that reaches a kernel is a static jit
argument, so capacities come from a small set of buckets. The port keeps
the same buckets: they decide gather sizes, overflow retries and tile
memory, which the parity tests compare. Every helper of the reference's
is copied.

- ``pow2ceil(v)`` — smallest power of two >= v (4 -> 4). Used for gather
  capacities and row-tile sizing, where v itself is a valid capacity.
- ``pow2above(v)`` — smallest power of two strictly > v (4 -> 8). Used for
  the sharded ranking's score bound, which must exceed every score.
- ``fit_bucket(v, floor=)`` — pow2ceil with a floor, the reference's
  fit-phase batch bucket.
"""
from __future__ import annotations

import threading

__all__ = ["pow2ceil", "pow2above", "quantum_bucket", "hybrid_bucket",
           "fit_bucket", "HintTable"]


def pow2ceil(v: int) -> int:
    """Smallest power of two >= max(v, 1). pow2ceil(4) == 4."""
    return 1 << max(int(v) - 1, 0).bit_length()


def pow2above(v: int) -> int:
    """Smallest power of two strictly greater than max(v, 1).
    pow2above(4) == 8."""
    return 1 << int(max(v, 1)).bit_length()


def quantum_bucket(v: int, quantum: int) -> int:
    """Round v up to a multiple of ``quantum`` (ceil-div). Used where many
    near-identical capacities would otherwise each get their own jit entry
    but pow2 rounding would overshoot (e.g. per-shard block capacities)."""
    v = int(v)
    q = int(quantum)
    return -(-v // q) * q


def hybrid_bucket(v: int, *, quantum: int) -> int:
    """pow2ceil below ``quantum`` (tiny sizes share a handful of jit
    entries), quantum multiples above it (relative slop bounded by
    quantum/v instead of the ~2x a pure pow2 round can cost). Used for
    survivor-tile row capacities, where the tile IS the score memory and
    pow2 overshoot at large survivor counts directly inflates the peak
    the scale gate budgets."""
    v = max(int(v), 1)
    q = int(quantum)
    return pow2ceil(v) if v <= q else quantum_bucket(v, q)


def fit_bucket(v: int, *, floor: int) -> int:
    """Bucket a fit-phase batch size: pow2ceil with a lower floor so tiny
    batches share one bucket."""
    return max(pow2ceil(v), int(floor))


class HintTable:
    """The engine's capacity-hint table as a first-class object: survivor
    counts keyed by ``(geometry generation, subset, box-count bucket)``,
    with the peak-decay update rule and generation-keyed invalidation
    that used to live inline in ``core/engine.py``.

    Policy (unchanged from the inline dict, now in ONE place):

      * ``observe``          rise to a new peak instantly, decay old
                             peaks by 3/4 — one light query can't make
                             the next heavy one overflow-retry.
      * ``prune_generation`` a compaction REPLACES the geometry, so
                             hints from dead generations are void and
                             dropped wholesale (appends/deletes only
                             extend/overlay geometry and keep theirs).
      * ``invalidate``       the conservative full reset the serving
                             layer applies after a FAILED compaction: a
                             crash mid-merge says nothing about which
                             geometry the engine will serve next, so
                             the next queries re-learn from the
                             capacity_frac cold-start rather than trust
                             hints observed around the failure.

    Thread-safety: observers run on serving threads while a background
    compaction prunes — every mutation swaps a fresh dict under a lock,
    and readers iterate whatever consistent dict they grabbed (same
    discipline as the catalog's snapshot swap). Iteration/len/contains
    mirror the plain-dict surface the engine's tests poke.
    """

    def __init__(self):
        self._d = {}
        self._lock = threading.Lock()

    def get(self, key, default=None):
        return self._d.get(key, default)

    def observe(self, key, value: int) -> None:
        """Fold one observed survivor count in: ``max(value, old * 3/4)``
        — instant rise, slow decay."""
        with self._lock:
            d = dict(self._d)
            d[key] = max(int(value), (d.get(key, 0) * 3) // 4)
            self._d = d

    def prune_generation(self, geom: int) -> None:
        """Drop every hint whose generation tag differs from ``geom``."""
        with self._lock:
            self._d = {k: v for k, v in self._d.items()
                       if k[0] == int(geom)}

    def invalidate(self) -> int:
        """Drop EVERY hint (failed-compaction reset); returns how many
        entries died so the serving stats can report the reset size."""
        with self._lock:
            n = len(self._d)
            self._d = {}
            return n

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()
