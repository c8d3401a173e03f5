"""Epoch-keyed result cache for the serving path (DESIGN.md §16).

RapidEarth's analyst workload repeats itself: the same label sets get
re-queried as users share links, refresh dashboards, or iterate around a
known-good query — the Earth-Copilot front end ships a precomputed
"quickstart cache" for exactly this reason. ``ResultCache`` sits between
the HTTP layer / ``QueryServer`` and the engine and serves a repeat
query from memory, bitwise-equal to its uncached answer.

Never-stale by construction: the CATALOG STATE is part of the key.

  key = (sorted pos ids, sorted neg ids, model,
         canonicalised effective kwargs,          # max_results included
         catalog epoch, compaction generation)

Every append/delete bumps the mutation epoch and every compaction bumps
the generation (core/segments.py), so any mutation makes every prior
key UNREACHABLE — a stale entry cannot be addressed, let alone served.
There is no TTL and no heuristic invalidation to get wrong; the same
(epoch, geom) keying already proved out for the capacity-hint table.
Entries for dead epochs are garbage, not hazards: ``invalidate_epoch``
reclaims their bytes eagerly (the server calls it after each ingest)
and LRU eviction bounds them regardless.

Two defence-in-depth counters pin the invariant observable: ``put``
refuses an entry whose key epoch no longer matches the catalog
(``stale_skips`` — a mutation landed mid-query, the result belongs to
the new epoch's keyspace under an old key) and ``get`` re-checks the
stored entry's key tail against the requested one (``stale_hits``,
asserted == 0 by the test suite — it can only move on a cache bug).

Thread-safe: the server's ``handle``/``handle_batch`` run on the
serving thread but ``summary()``/HTTP stats readers do not.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import (AGE_BUCKETS_S, Histogram,
                                     MetricsRegistry)

__all__ = ["ResultCache", "request_key"]

# accounting overhead charged per entry on top of the payload arrays
# (key tuple, OrderedDict slot, QueryResult envelope)
_ENTRY_OVERHEAD = 256


def _canon(v):
    """Canonicalise one kwarg value into a hashable form, or raise
    TypeError — the caller treats that as 'bypass the cache'."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (str, bytes, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)     # numpy scalars
    if item is not None:
        return item()
    raise TypeError(f"uncacheable kwarg value {type(v).__name__}")


def request_key(pos_ids, neg_ids, model: str,
                kwargs: Dict) -> Optional[Tuple]:
    """The request half of a cache key: sorted label-id tuples, model,
    and the EFFECTIVE query kwargs (after serving-default / degraded
    clamping — two requests that run differently must key differently).
    Returns None when any kwarg resists canonicalisation: an exotic
    request simply bypasses the cache instead of poisoning it."""
    try:
        kw = tuple(sorted((str(k), _canon(v)) for k, v in kwargs.items()))
    except TypeError:
        return None
    return (tuple(sorted(int(i) for i in pos_ids)),
            tuple(sorted(int(i) for i in neg_ids)),
            str(model), kw)


def result_nbytes(result) -> int:
    """Byte charge for one cached QueryResult: the ranked arrays
    dominate; stats/envelope ride the flat overhead."""
    nb = _ENTRY_OVERHEAD
    for arr in (getattr(result, "ids", None),
                getattr(result, "scores", None)):
        nb += int(getattr(arr, "nbytes", 0))
    return nb


class ResultCache:
    """LRU result cache with byte accounting and epoch-keyed entries.

    ``max_bytes`` bounds the summed ``result_nbytes`` of resident
    entries, ``max_entries`` bounds their count; inserting past either
    evicts from the LRU tail. Both bounds are enforced on every ``put``
    so the cache can never outgrow its budget between requests.
    """

    def __init__(self, max_bytes: int = 64 << 20,
                 max_entries: int = 4096):
        if max_bytes < 1 or max_entries < 1:
            raise ValueError("max_bytes and max_entries must be >= 1")
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        # key -> [result, nbytes, inserted_at, hits]; insertion/access
        # order == LRU order. inserted_at/hits feed the age-at-eviction
        # histogram and the per-entry hotness report — the evidence for
        # sizing max_bytes (are we evicting hot young entries, or cold
        # old ones that earned their eviction?)
        self._entries: "OrderedDict[Tuple, List]" = OrderedDict()
        self._bytes = 0
        self.counters = {"hits": 0, "misses": 0, "insertions": 0,
                         "evictions": 0, "stale_evictions": 0,
                         "stale_hits": 0, "stale_skips": 0,
                         "bypassed": 0}
        # owned by the cache so ages are recorded from the first
        # eviction; attach() merges it into a server's registry
        self._age_hist = Histogram(
            "cache_age_at_eviction_seconds",
            "Resident age of cache entries at eviction",
            buckets=AGE_BUCKETS_S)

    def attach(self, registry: MetricsRegistry) -> None:
        """Publish this cache through ``registry``: the counters (plus
        occupancy and hit rate) as a scrape-time collector and the
        age-at-eviction histogram as a first-class metric — serve_load's
        ``cache_hit_rate`` and ``GET /metrics`` both read from here, one
        source of truth."""
        merged = registry.register(self._age_hist)
        if merged is not self._age_hist:
            # a histogram with this name already lives in the registry
            # (e.g. two caches attached): record into the shared one
            self._age_hist = merged

        def _collect():
            st = self.stats()
            rate = st.pop("hit_rate")
            ents = st.pop("entries")
            nbytes = st.pop("bytes")
            st.pop("max_bytes"), st.pop("max_entries")
            for k, v in st.items():
                yield (f"cache_{k}_total", "counter", {}, v)
            yield ("cache_entries", "gauge", {}, ents)
            yield ("cache_bytes", "gauge", {}, nbytes)
            yield ("cache_hit_rate", "gauge", {}, rate)

        registry.register_collector(_collect)

    # ------------------------------------------------------------------
    @staticmethod
    def full_key(req_key: Tuple, epoch: int, geom: int) -> Tuple:
        """Append the catalog-state tail: (epoch, geom) come last so
        invalidation and the get-time cross-check can slice them off."""
        return req_key + (int(epoch), int(geom))

    def get(self, key: Tuple):
        """The cached result for ``key``, or None. The key carries the
        requested (epoch, geom) tail; a resident entry under that key
        was stored under the identical tail, which ``stale_hits``
        cross-checks (it moving off 0 means the keying is broken)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.counters["misses"] += 1
                return None
            result = ent[0]
            stored_tail = getattr(result, "_cache_tail", key[-2:])
            if stored_tail != key[-2:]:
                self.counters["stale_hits"] += 1
                return None
            self._entries.move_to_end(key)
            ent[3] += 1
            self.counters["hits"] += 1
            return result

    def put(self, key: Tuple, result, *,
            current_epoch: Optional[int] = None,
            current_geom: Optional[int] = None) -> bool:
        """Insert ``result`` under ``key``. When the caller passes the
        catalog's CURRENT (epoch, geom) and the key's tail no longer
        matches — a mutation landed between key computation and the
        query finishing — the insert is refused (``stale_skips``): the
        result was computed on the new state and must not become
        addressable under the old key."""
        if current_epoch is not None \
                and key[-2:] != (int(current_epoch), int(current_geom)):
            with self._lock:
                self.counters["stale_skips"] += 1
            return False
        nb = result_nbytes(result)
        try:
            result._cache_tail = key[-2:]   # get-time cross-check
        except AttributeError:
            pass                            # slots/frozen: key-only check
        now = time.monotonic()
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = [result, nb, now, 0]
            self._bytes += nb
            self.counters["insertions"] += 1
            ages = []
            while self._entries and (
                    self._bytes > self.max_bytes
                    or len(self._entries) > self.max_entries):
                _, (_, enb, t_in, _) = self._entries.popitem(last=False)
                self._bytes -= enb
                self.counters["evictions"] += 1
                ages.append(now - t_in)
        for age in ages:    # histogram has its own lock; observe outside
            self._age_hist.observe(age)
        return True

    def invalidate_epoch(self, epoch: int, geom: int) -> int:
        """Eagerly reclaim every entry whose (epoch, geom) tail differs
        from the current catalog state — they are already unreachable
        (keys carry the state), this just returns their bytes now
        instead of waiting for LRU churn. Returns the entry count
        dropped; counted under ``stale_evictions``."""
        tail = (int(epoch), int(geom))
        now = time.monotonic()
        with self._lock:
            dead = [k for k in self._entries if k[-2:] != tail]
            ages = []
            for k in dead:
                _, nb, t_in, _ = self._entries.pop(k)
                self._bytes -= nb
                ages.append(now - t_in)
            self.counters["stale_evictions"] += len(dead)
        for age in ages:
            self._age_hist.observe(age)
        return len(dead)

    def note_bypass(self) -> None:
        with self._lock:
            self.counters["bypassed"] += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict:
        """Counters + occupancy + hit rate, the block ``QueryServer.
        summary()`` publishes under ``"cache"``."""
        with self._lock:
            looked = self.counters["hits"] + self.counters["misses"]
            return {**self.counters,
                    "entries": len(self._entries),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "max_entries": self.max_entries,
                    "hit_rate": (self.counters["hits"] / looked
                                 if looked else 0.0)}

    def entry_report(self, n: int = 10) -> List[Dict]:
        """The ``n`` hottest resident entries (hits desc) with per-entry
        hit counts, resident age, and byte charge — the operator view of
        WHAT the cache is earning its memory with."""
        now = time.monotonic()
        with self._lock:
            rows = [{"hits": ent[3], "age_s": now - ent[2],
                     "nbytes": ent[1]}
                    for ent in self._entries.values()]
        rows.sort(key=lambda r: (-r["hits"], -r["age_s"]))
        return rows[:max(0, int(n))]

    def age_at_eviction_quantile(self, q: float) -> float:
        """Quantile of the age-at-eviction histogram (seconds)."""
        return self._age_hist.quantile(q)
