"""Batched query serving — the online half of the engine (paper §4).

The web application sends labelled-patch queries; this module is the
"search application": it batches concurrent requests, fits the requested
model per query, executes the range queries, and returns ranked ids with
latency statistics. Mirrors a FastAPI deployment's behaviour minus the
HTTP layer (swappable transport), so serving-path tests and benchmarks
measure exactly what production would.

Production notes:
  * queries are independent → batching is for device efficiency, not
    semantics: handle_batch routes the window through
    SearchEngine.query_batch (ONE fused prune/gather/refine call per
    feature subset, per-box ownership map de-muxing counts per query —
    DESIGN.md §6);
  * the feature DB / indexes shard over hosts; each host runs one
    QueryServer on its shard and a stateless front end merges id lists —
    WITHIN a host, ``SearchEngine(n_shards=...)`` row-partitions the
    catalog across that host's devices and merges top-k lists on device
    (DESIGN.md §11; ``merge_shard_results`` below stays as the host
    oracle of that merge);
  * robustness contracts (DESIGN.md §14): absolute deadlines checked at
    admission, window formation, before the fit and between device
    rounds; a bounded admission queue with typed ``Overloaded`` /
    ``RateLimited`` shedding; seeded-backoff retries for transient
    device faults; background compaction that retries with backoff and
    keeps serving the old snapshot on failure; ``close(drain=...)``
    resolves EVERY outstanding request — nothing blocks forever.

The port's copy of ``repro.serve.engine``, bound to the torch engine:
same requests, responses, ledger, spans and wire tags. The engine runs
on the serving thread only (the compaction worker's merge calls no
kernel), on the device the engine was built for. A fault of the device
itself (``torch.AcceleratorError``, ``torch.OutOfMemoryError``) is
tagged ``internal`` (HTTP 500): it is not retryable, and the window's
per-request fallback re-runs each request on the same device, where it
fails again and is reported.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import MODELS, QueryResult, SearchEngine
from repro_torch.core.errors import (DeadlineExceeded, check_deadline,
                                     deadline_after)
from repro_torch.obs import Observability
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.cache import ResultCache, request_key
from repro_torch.serve.policy import (AdmissionQueue, Overloaded,
                                      RateLimited, RetryPolicy,
                                      ServerClosed, TokenBucket)


# faults of the device itself (a failed launch, an illegal address,
# memory exhausted): never retried, never answered from the CPU
_DEVICE_ERRORS = (torch.AcceleratorError, torch.OutOfMemoryError)


def _error_type(exc: BaseException) -> str:
    """Stable wire tag for a failure: the typed taxonomy's ``code``
    when present, ``internal`` for a fault of the device, the exception
    class name otherwise."""
    if isinstance(exc, _DEVICE_ERRORS):
        return "internal"
    return getattr(exc, "code", type(exc).__name__)


@dataclass
class QueryRequest:
    request_id: int
    pos_ids: Sequence[int]
    neg_ids: Sequence[int]
    model: str = "dbranch"
    kwargs: Dict = field(default_factory=dict)
    # absolute time.monotonic() deadline (None = no deadline). The server
    # checks it at admission, window formation, before the fit, and
    # between device rounds — a request never runs more than one round
    # past expiry (device programs are not cancellable).
    deadline_s: Optional[float] = None
    # rate-limit key: each distinct source gets its own token bucket
    source: str = "default"
    # per-query trace (repro_torch.obs.trace.Trace), created at admission by
    # submit()/the HTTP layer when tracing is enabled; None otherwise.
    # Rides the request through the queue, the batch window and the
    # engine so every stage's span lands on the right trace.
    trace: Optional[object] = None


@dataclass
class IngestRequest:
    """A live-catalog mutation riding the same queue as queries
    (DESIGN.md §12): op is "append" (``features`` [m, D] -> new global
    ids in the response info), "delete" (``ids`` to tombstone) or
    "compact". The serving loop applies ingests BETWEEN query windows in
    arrival order — an ingest closes the current batching window, so
    queries batched before it run on the pre-ingest snapshot and queries
    after it see the new epoch."""
    request_id: int
    op: str
    features: Optional[np.ndarray] = None
    ids: Optional[Sequence[int]] = None
    source: str = "default"


@dataclass
class QueryResponse:
    request_id: int
    ok: bool
    result: Optional[QueryResult] = None
    error: str = ""
    latency_s: float = 0.0
    info: Dict = field(default_factory=dict)   # ingest acks land here
    # machine-readable failure class ("" on success): deadline_exceeded,
    # overloaded, rate_limited, shutdown, transient, internal, ...
    error_type: str = ""


class QueryServer:
    """Synchronous core (``handle``) + threaded front end (``submit``).

    ``max_results`` is the serving default for how many ranked ids each
    query returns; a request's own kwargs override it. Setting it keeps
    the whole ranked path device-resident: per query only O(max_results)
    bytes cross device->host (DESIGN.md §9), which ``stats["host_bytes"]``
    tracks across everything this server has served.

    Robustness knobs (all default OFF → legacy behaviour):

      * ``queue_depth`` / ``shed_policy`` — bounded admission queue with
        typed ``Overloaded`` rejections; ``"reject-newest"`` refuses the
        incoming request, ``"reject-largest-fit"`` evicts the queued
        request with the largest label set (fit-cost proxy) to admit a
        cheaper newcomer.
      * ``rate_limit=(rate, burst)`` — per-``source`` token bucket at
        admission; empty bucket → typed ``RateLimited``.
      * ``default_deadline_s`` — relative budget stamped on requests that
        arrive without a deadline.
      * ``retry_policy`` — retries transient device faults on the query
        path (seeded backoff; never retries ``DeadlineExceeded``).
      * ``compaction_retry`` — backoff schedule for failed background
        compactions (the old snapshot keeps serving throughout).
      * ``degraded_max_results`` / ``soft_depth_frac`` — graceful
        degradation: when the queue is above ``soft_depth_frac *
        queue_depth``, windows clamp max_results to this cheaper value
        BEFORE admission starts shedding.
      * ``faults`` — a FaultInjector for the serve-layer ``submit`` seam
        (core seams take theirs via ``SearchEngine(faults=...)``);
        defaults to the engine's injector so ``close`` can release
        parked hangs.
      * ``cache`` — a ``repro_torch.serve.cache.ResultCache``: repeat queries
        serve from memory, bitwise-equal to the uncached answer, keyed
        on (sorted labels, model, effective kwargs, catalog epoch,
        compaction generation) so any ingest makes prior entries
        unreachable — never served stale (DESIGN.md §16).
    """

    def __init__(self, engine: SearchEngine, *, max_batch: int = 8,
                 batch_window_s: float = 0.002,
                 max_results: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 shed_policy: str = "reject-newest",
                 rate_limit: Optional[Tuple[float, float]] = None,
                 default_deadline_s: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 compaction_retry: Optional[RetryPolicy] = None,
                 degraded_max_results: Optional[int] = None,
                 soft_depth_frac: float = 0.75,
                 faults=None,
                 cache: Optional[ResultCache] = None,
                 obs: Optional[Observability] = None):
        self.engine = engine
        self.cache = cache
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.max_results = max_results
        self.queue_depth = queue_depth
        self.rate_limit = rate_limit
        self.default_deadline_s = default_deadline_s
        self.retry_policy = retry_policy
        self.compaction_retry = compaction_retry or RetryPolicy(
            max_attempts=3, backoff_s=0.05)
        self.degraded_max_results = degraded_max_results
        self.soft_depth_frac = float(soft_depth_frac)
        self.faults = faults if faults is not None \
            else getattr(engine, "faults", None)
        # durable startup state (DESIGN.md §15): an engine recovered from
        # a damaged directory carries a non-clean RecoveryReport — the
        # server comes up DEGRADED over the salvaged prefix instead of
        # refusing to serve, and the report rides in summary() so an
        # operator can see exactly what was quarantined.
        rec = getattr(engine, "recovery", None)
        self._recovery_degraded = rec is not None and not rec.clean
        self._q = AdmissionQueue(depth=queue_depth, shed_policy=shed_policy)
        self._buckets: Dict[str, TokenBucket] = {}
        self._stop = threading.Event()
        self._drain = threading.Event()   # close(drain=True): finish queue
        self._closed = False
        self._degraded = False
        self._thread: Optional[threading.Thread] = None
        self._held = None            # ingest that closed a batch window
        self._compact_thread: Optional[threading.Thread] = None
        self._last_compaction_error = ""
        self._stats_lock = threading.Lock()
        self.stats = {"served": 0, "errors": 0, "batches": 0,
                      "batched_queries": 0, "latency_sum": 0.0,
                      "fit_s_sum": 0.0, "host_bytes": 0,
                      "sharded_queries": 0,
                      # high-water mark of the device score-buffer bytes
                      # any served window needed (DESIGN.md §13) — the
                      # figure capacity planning compares against the
                      # dense N*Q*4 equivalent
                      "score_buffer_bytes_peak": 0,
                      "dense_score_bytes_equiv": 0,
                      "ingests": 0, "ingest_errors": 0, "ingest_s_sum": 0.0,
                      "rows_appended": 0, "rows_deleted": 0,
                      "compactions": 0,
                      # robustness ledger (DESIGN.md §14): every submit
                      # lands in exactly one of admitted / rejected_*,
                      # every admitted request in exactly one of served /
                      # expired_in_queue / evicted / shutdown_unserved
                      "admitted": 0, "rejected_overloaded": 0,
                      "rejected_rate_limited": 0, "rejected_deadline": 0,
                      "expired_in_queue": 0, "evicted": 0,
                      "shutdown_unserved": 0, "submit_faults": 0,
                      "retries": 0, "batch_fallbacks": 0,
                      "compaction_errors": 0, "compaction_retries": 0,
                      "degraded_windows": 0,
                      "checkpoints": 0, "checkpoint_errors": 0,
                      "cache_served": 0}
        # observability bundle (DESIGN.md §17): ONE registry + trace
        # store per server. Default-on — the registry is where every
        # layer reports; pass Observability(metrics_enabled=False,
        # tracing_enabled=False) to measure the disabled baseline.
        self.obs = obs if obs is not None else Observability()
        self._h_latency = self.obs.registry.histogram(
            "server_latency_seconds",
            "End-to-end request latency as served (all paths)")
        if self.obs.metrics_enabled:
            self._register_obs_collectors()

    def _register_obs_collectors(self) -> None:
        """Absorb the existing locked counter dicts into the registry as
        scrape-time collectors — the serving thread keeps its one-lock
        batched ledger (``_bump_many``) and pays NOTHING extra per
        request; ``GET /metrics`` reads the same numbers ``summary()``
        reports (one source of truth, no mirror to drift)."""
        reg = self.obs.registry
        gauges = {"score_buffer_bytes_peak", "dense_score_bytes_equiv"}

        def _server():
            with self._stats_lock:
                st = dict(self.stats)
            for k, v in st.items():
                yield (f"server_{k}",
                       "gauge" if k in gauges else "counter", {}, v)
            yield ("server_queue_depth", "gauge", {}, len(self._q))
            yield ("server_queue_depth_peak", "gauge", {},
                   self._q.depth_peak)

        reg.register_collector(_server)
        if self.cache is not None:
            self.cache.attach(reg)
        cat = getattr(self.engine, "_catalog", None)
        if cat is not None:
            def _durable():
                dur = cat.durability_snapshot()
                if not dur:
                    return
                for k, v in dur.items():
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        continue
                    yield (f"persist_{k}",
                           "gauge" if k == "lsn" else "counter", {}, v)

            reg.register_collector(_durable)

    # ------------------------------------------------------------------
    # per-query tracing (DESIGN.md §17)
    # ------------------------------------------------------------------
    def _trace_of(self, req):
        return getattr(req, "trace", None)

    def _close_queue_span(self, req) -> None:
        """End the queue span stamped at admission. It runs from the
        enqueue mark to HANDLE entry on the serving thread, so batch-
        window formation wait is inside it (the trace's span sum must
        account for the full wall — a gap between pop and dispatch
        would be invisible time)."""
        tr = self._trace_of(req)
        if tr is not None:
            tr.span_from_mark("queued", "queue")

    def _finish_trace(self, req, resp: QueryResponse) -> None:
        """Stamp the outcome, fold spans into the per-stage histograms,
        archive in the ring (+ slow-query log), and echo the trace id
        on the response. Idempotent via Trace.finish."""
        tr = self._trace_of(req)
        if tr is None:
            return
        tr.attrs.setdefault("request_id", req.request_id)
        status = "ok" if resp.ok else (resp.error_type or "error")
        self.obs.observe_trace(tr, status)
        resp.info.setdefault("trace_id", tr.trace_id)

    def _observe_latency(self, resp: QueryResponse) -> None:
        if self.obs.metrics_enabled:
            self._h_latency.observe(resp.latency_s)

    def _bump(self, key: str, v=1) -> None:
        """Locked stats increment — submit runs on caller threads and the
        compaction worker off-loop, so ledger counters can race the
        serving thread without this."""
        with self._stats_lock:
            self.stats[key] += v

    def _bump_many(self, updates: Dict) -> None:
        """Locked batch update for the serving hot loop: one lock
        acquisition applies a whole request's (or window's) ledger
        delta. Every stats mutation routes through here or ``_bump`` —
        dict ``+=`` is read-modify-write, and unlocked bumps on the
        serving thread racing ``submit``/``_compact_worker`` silently
        drift the DESIGN.md §14 ledger invariant."""
        with self._stats_lock:
            for k, v in updates.items():
                self.stats[k] += v

    def _fault(self, site: str) -> None:
        if self.faults is not None:
            self.faults.check(site)

    def _note_score_memory(self, st: Dict) -> None:
        """Fold one result's device score-memory figures into the
        server-wide high-water marks (batch_* or plain namespacing —
        whichever the result carries). Locked: a max-merge is a
        read-modify-write like any other stats mutation."""
        peak = st.get("batch_score_buffer_bytes_peak",
                      st.get("score_buffer_bytes_peak", 0))
        eq = st.get("batch_dense_score_bytes_equiv",
                    st.get("dense_score_bytes_equiv", 0))
        with self._stats_lock:
            self.stats["score_buffer_bytes_peak"] = max(
                self.stats["score_buffer_bytes_peak"], int(peak))
            self.stats["dense_score_bytes_equiv"] = max(
                self.stats["dense_score_bytes_equiv"], int(eq))

    def _query_kwargs(self, req: QueryRequest) -> Dict:
        kw = dict(req.kwargs)
        if self.max_results is not None:
            kw.setdefault("max_results", self.max_results)
        if self._degraded and self.degraded_max_results is not None:
            # graceful degradation: clamp the ranked cut BEFORE admission
            # has to shed — a cheaper window drains backlog faster
            mr = kw.get("max_results")
            kw["max_results"] = self.degraded_max_results if mr is None \
                else min(int(mr), self.degraded_max_results)
        return kw

    # ------------------------------------------------------------------
    # result cache (DESIGN.md §16)
    # ------------------------------------------------------------------
    def _epoch_geom(self) -> Tuple[int, int]:
        """The catalog-state tail of every cache key: (mutation epoch,
        compaction generation). Static engines are permanently (0, 0) —
        their catalog never changes, so their entries never go stale."""
        cat = getattr(self.engine, "_catalog", None)
        if cat is None:
            return 0, 0
        s = cat.snapshot()
        return int(s.epoch), int(getattr(s, "geom", 0))

    def _cache_key(self, req: QueryRequest, kw: Dict):
        """Full cache key for ``req`` under the CURRENT catalog state,
        or None (caching off / uncacheable kwargs). ``kw`` must be the
        EFFECTIVE kwargs (serving defaults + degraded clamp applied) —
        two requests that would run differently must key differently."""
        if self.cache is None:
            return None
        rk = request_key(req.pos_ids, req.neg_ids, req.model, kw)
        if rk is None:
            self.cache.note_bypass()
            return None
        return ResultCache.full_key(rk, *self._epoch_geom())

    def _cache_lookup(self, req: QueryRequest, kw: Dict):
        """(key, cached QueryResult or None). The key is computed BEFORE
        the query runs so a store after it can cross-check that no
        mutation landed in between (``ResultCache.put`` refuses the
        insert when the epoch moved — never-stale by construction)."""
        key = self._cache_key(req, kw)
        if key is None:
            return None, None
        return key, self.cache.get(key)

    def _cache_store(self, key, result) -> None:
        if self.cache is None or key is None:
            return
        ep, gm = self._epoch_geom()
        self.cache.put(key, result, current_epoch=ep, current_geom=gm)

    def _cache_invalidate(self) -> None:
        """Eagerly reclaim entries stranded by a catalog mutation; the
        epoch in the key already made them unreachable."""
        if self.cache is not None:
            self.cache.invalidate_epoch(*self._epoch_geom())

    def _cache_hit_response(self, req: QueryRequest, cached,
                            t0: float) -> QueryResponse:
        resp = QueryResponse(req.request_id, True, cached,
                             latency_s=time.perf_counter() - t0,
                             info={"cache": "hit"})
        self._bump_many({"served": 1, "cache_served": 1,
                         "latency_sum": resp.latency_s})
        return resp

    # ------------------------------------------------------------------
    def handle_ingest(self, req: IngestRequest) -> QueryResponse:
        """Apply one live-catalog mutation (engine must be live=True).
        Returns an ack response whose ``info`` carries the op's outcome
        (append -> the new rows' global ids). Per-request error
        isolation: a bad ingest never takes down the server."""
        t0 = time.perf_counter()
        upd: Dict = {}
        try:
            if req.op == "append":
                ids = self.engine.append(req.features)
                info = {"op": "append", "ids": ids, "rows": int(len(ids))}
                upd["rows_appended"] = int(len(ids))
            elif req.op == "delete":
                nd = self.engine.delete(req.ids)
                info = {"op": "delete", "rows": nd}
                upd["rows_deleted"] = nd
            elif req.op == "compact":
                # the heavy merge runs OFF the serving loop (the whole
                # point of background compaction — a synchronous rebuild
                # here would stall every queued query for seconds);
                # queries keep serving the old snapshot until the swap.
                # Compactions are SERIALIZED: while one worker is alive
                # the request coalesces into it instead of leaking a
                # second thread onto the same merge.
                info = {"op": "compact", "background": True}
                if (self._compact_thread is not None
                        and self._compact_thread.is_alive()):
                    info["coalesced"] = True
                else:
                    self._compact_thread = threading.Thread(
                        target=self._compact_worker, daemon=True)
                    self._compact_thread.start()
                upd["compactions"] = 1
            elif req.op == "checkpoint":
                # durable snapshot (DESIGN.md §15): runs synchronously in
                # the ingest slot — it reads an immutable (snapshot, lsn)
                # pair, so queries batched after it are unaffected; the
                # manifest flip bounds the WAL replay cost of the next
                # recovery to mutations after this point.
                ck = self.engine.checkpoint()
                info = {"op": "checkpoint", **ck}
                upd["checkpoints"] = 1
            else:
                raise ValueError(f"unknown ingest op {req.op!r}")
            if req.op in ("append", "delete", "compact"):
                # the mutation bumped the catalog epoch (compaction will,
                # at swap time) — prior cache entries are unreachable by
                # key; reclaim their bytes eagerly
                self._cache_invalidate()
            resp = QueryResponse(req.request_id, True, None,
                                 latency_s=time.perf_counter() - t0,
                                 info=info)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            resp = QueryResponse(req.request_id, False, None, f"{e}",
                                 time.perf_counter() - t0,
                                 error_type=_error_type(e))
            upd["ingest_errors"] = 1
            if req.op == "checkpoint":
                upd["checkpoint_errors"] = 1
        upd["ingests"] = 1
        upd["ingest_s_sum"] = resp.latency_s
        self._bump_many(upd)
        return resp

    def _compact_worker(self) -> None:
        """Background compaction with capture + retry (DESIGN.md §14):
        a failed attempt leaves the old snapshot serving bitwise
        untouched (the catalog's swap is the only mutation), backs off
        per ``compaction_retry``, and on final failure records the error
        and resets the capacity-hint table — a crash mid-merge says
        nothing about the geometry the engine serves next."""
        with obs_profile.bind_registry(self.obs.registry):
            self._compact_worker_body()

    def _compact_worker_body(self) -> None:
        try:
            self.compaction_retry.call(
                self.engine.compact,
                on_retry=lambda a, e: self._bump("compaction_retries"))
            # the swap bumped (epoch, geom): reclaim the stranded
            # pre-compaction cache entries now that it actually happened
            self._cache_invalidate()
        except Exception as e:  # noqa: BLE001 — worker must not die loudly
            self._bump("compaction_errors")
            self._last_compaction_error = f"{e}"
            inval = getattr(self.engine, "invalidate_capacity_hints", None)
            if inval is not None:
                inval()

    def handle(self, req: QueryRequest) -> QueryResponse:
        t0 = time.perf_counter()
        self._close_queue_span(req)
        tr = self._trace_of(req)
        # per-request ledger delta, applied in ONE locked batch below —
        # ``submit`` (caller threads) and the compaction worker bump
        # concurrently, and dict += is read-modify-write
        upd: Dict = {}
        # the trace rides ambient for the WHOLE body — OUTSIDE the retry
        # wrapper, so a retried request carries fit/device-round spans
        # for every attempt, not just the last
        with obs_trace.attach([tr] if tr is not None else []):
            try:
                check_deadline(req.deadline_s, "window formation")
                kw = self._query_kwargs(req)
                with obs_trace.span("cache", {"op": "lookup"}):
                    key, cached = self._cache_lookup(req, kw)
                if cached is not None:
                    resp = self._cache_hit_response(req, cached, t0)
                    self._observe_latency(resp)
                    self._finish_trace(req, resp)
                    return resp

                def run():
                    return self.engine.query(req.pos_ids, req.neg_ids,
                                             model=req.model,
                                             deadline_s=req.deadline_s,
                                             **kw)
                if self.retry_policy is not None:
                    res = self.retry_policy.call(
                        run, deadline_s=req.deadline_s,
                        on_retry=lambda a, e: self._note_retry())
                else:
                    res = run()
                resp = QueryResponse(req.request_id, True, res,
                                     latency_s=time.perf_counter() - t0)
                upd["host_bytes"] = res.stats.get(
                    "host_bytes_transferred", 0)
                self._note_score_memory(res.stats)
                upd["fit_s_sum"] = res.train_time_s
                if res.stats.get("n_shards", 1) > 1:
                    upd["sharded_queries"] = 1
                with obs_trace.span("cache", {"op": "store"}):
                    self._cache_store(key, res)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                resp = QueryResponse(req.request_id, False, None, f"{e}",
                                     time.perf_counter() - t0,
                                     error_type=_error_type(e))
        upd["served"] = 1
        upd["errors"] = 0 if resp.ok else 1
        upd["latency_sum"] = resp.latency_s
        self._bump_many(upd)
        self._observe_latency(resp)
        self._finish_trace(req, resp)
        return resp

    def _note_retry(self) -> None:
        """Ledger + trace marker for one transient-fault retry: the
        zero-duration ``retry`` span makes each extra attempt visible in
        the trace (its re-run fit/device rounds follow it)."""
        self._bump("retries")
        for t in obs_trace.active():
            t.add_span("retry", time.perf_counter(), 0.0)

    @staticmethod
    def _window_deadline(reqs: List[QueryRequest]) -> Optional[float]:
        """The shared device phase runs under the LOOSEST deadline in
        the window (a tight one must not kill its neighbours' work);
        any request without a deadline lifts the constraint entirely.
        Per-request budgets are re-checked at de-mux."""
        dls = [r.deadline_s for r in reqs]
        if any(d is None for d in dls):
            return None
        return max(dls)

    def handle_batch(self, reqs: List[QueryRequest]) -> List[QueryResponse]:
        """Answer a batching-window's worth of requests together.

        With a result cache, a pre-pass serves every request whose key
        is resident (the window shrinks to the misses — repeat queries
        never pay device time); the remainder goes through
        SearchEngine.query_batch: all concurrent index-path queries
        share ONE fused device call per feature subset (per-box
        ownership map de-muxes counts per query), so the batching window
        buys device efficiency instead of just queueing. Per-request
        error isolation is preserved — query_batch returns the raised
        exception for a failed request — and an unexpected batch-wide
        failure falls back to sequential handling (``batch_fallbacks``),
        billing the failed attempt's wall time to the requests that paid
        it instead of dropping it. A batch-wide ``DeadlineExceeded``
        short-circuits: every request in the window shares the deadline
        that expired, so retrying them sequentially would only bill more
        device time to dead requests.
        """
        if len(reqs) == 1:
            self._bump("batches")
            return [self.handle(reqs[0])]
        if self.cache is not None:
            t0 = time.perf_counter()
            hits: Dict[int, QueryResponse] = {}
            misses: List[QueryRequest] = []
            for i, r in enumerate(reqs):
                self._close_queue_span(r)
                tr = self._trace_of(r)
                with obs_trace.attach([tr] if tr is not None else []):
                    with obs_trace.span("cache", {"op": "lookup"}):
                        _, cached = self._cache_lookup(
                            r, self._query_kwargs(r))
                if cached is not None:
                    resp = self._cache_hit_response(r, cached, t0)
                    self._observe_latency(resp)
                    self._finish_trace(r, resp)
                    hits[i] = resp
                else:
                    misses.append(r)
            if hits:
                if not misses:
                    return [hits[i] for i in range(len(reqs))]
                sub = iter(self._handle_batch_engine(misses))
                return [hits[i] if i in hits else next(sub)
                        for i in range(len(reqs))]
        return self._handle_batch_engine(reqs)

    def _handle_batch_engine(self, reqs: List[QueryRequest],
                             ) -> List[QueryResponse]:
        """The uncached window path: one query_batch device call, stats
        applied as ONE locked delta per window (the hot loop's batched
        ledger update — see ``_bump_many``)."""
        if len(reqs) == 1:
            self._bump("batches")
            return [self.handle(reqs[0])]
        t0 = time.perf_counter()
        for r in reqs:
            self._close_queue_span(r)
        traces = [t for t in (self._trace_of(r) for r in reqs)
                  if t is not None]
        window_dl = self._window_deadline(reqs)
        kws = [self._query_kwargs(r) for r in reqs]
        batch = [{"pos_ids": r.pos_ids, "neg_ids": r.neg_ids,
                  "model": r.model, **kw} for r, kw in zip(reqs, kws)]
        # cache keys computed BEFORE the device phase: a mutation landing
        # mid-window moves the epoch and the store-time cross-check in
        # ResultCache.put refuses the insert (never-stale)
        keys = [self._cache_key(r, kw) for r, kw in zip(reqs, kws)]

        def run():
            return self.engine.query_batch(batch, deadline_s=window_dl)
        try:
            # every trace in the window rides ambient through the shared
            # device phase — OUTSIDE the retry wrapper, so each attempt
            # leaves its own fit/device-round spans on each trace
            with obs_trace.attach(traces):
                # window assembly (kwargs, batch dicts, cache keys) is
                # shared pre-device wall — billed like the fit span
                obs_trace.add_span_active("window", t0,
                                          time.perf_counter() - t0,
                                          {"window": len(reqs)})
                if self.retry_policy is not None:
                    outs = self.retry_policy.call(
                        run, deadline_s=window_dl,
                        on_retry=lambda a, e: self._note_retry())
                else:
                    outs = run()
        except DeadlineExceeded as e:
            wall = time.perf_counter() - t0
            resps = [QueryResponse(r.request_id, False, None, f"{e}",
                                   wall, error_type=_error_type(e))
                     for r in reqs]
            self._bump_many({"served": len(reqs), "errors": len(reqs),
                             "latency_sum": wall * len(reqs)})
            for r, resp in zip(reqs, resps):
                self._observe_latency(resp)
                self._finish_trace(r, resp)
            return resps
        except Exception:  # noqa: BLE001 — never take down the batch
            # sequential fallback: each request retried alone. The failed
            # batch attempt's wall time was REAL latency for every
            # request in the window — bill it, don't drop it.
            self._bump("batch_fallbacks")
            wasted = time.perf_counter() - t0
            resps = [self.handle(r) for r in reqs]
            for resp in resps:
                resp.latency_s += wasted
            self._bump_many({"latency_sum": wasted * len(resps)})
            return resps
        wall = time.perf_counter() - t0
        resps = []
        upd: Dict = {"batches": 1, "batched_queries": len(reqs),
                     "served": len(reqs), "errors": 0, "latency_sum": 0.0,
                     "fit_s_sum": 0.0, "host_bytes": 0,
                     "sharded_queries": 0}
        batch_bytes_counted = False
        for r, key, out in zip(reqs, keys, outs):
            expired = None
            if not isinstance(out, Exception):
                try:     # per-request deadline re-check at de-mux
                    check_deadline(r.deadline_s, "de-mux")
                except DeadlineExceeded as e:
                    expired = e
            if isinstance(out, Exception):
                resp = QueryResponse(r.request_id, False, None, f"{out}",
                                     wall, error_type=_error_type(out))
            elif expired is not None:
                resp = QueryResponse(r.request_id, False, None,
                                     f"{expired}", wall,
                                     error_type=_error_type(expired))
            else:
                resp = QueryResponse(r.request_id, True, out,
                                     latency_s=wall)
                # per-request fit shares sum to the window's fit wall
                # (engine bills the shared batched fit evenly)
                upd["fit_s_sum"] += out.train_time_s
                # batch_* aggregates describe the SHARED device phase —
                # count them once per batch, not once per request
                if "batch_host_bytes_transferred" in out.stats:
                    if not batch_bytes_counted:
                        upd["host_bytes"] += out.stats[
                            "batch_host_bytes_transferred"]
                        batch_bytes_counted = True
                else:
                    upd["host_bytes"] += out.stats.get(
                        "host_bytes_transferred", 0)
                self._note_score_memory(out.stats)
                if out.stats.get("batch_n_shards",
                                 out.stats.get("n_shards", 1)) > 1:
                    upd["sharded_queries"] += 1
                tr = self._trace_of(r)
                with obs_trace.attach([tr] if tr is not None else []):
                    with obs_trace.span("cache", {"op": "store"}):
                        self._cache_store(key, out)
            upd["errors"] += 0 if resp.ok else 1
            upd["latency_sum"] += resp.latency_s
            self._observe_latency(resp)
            self._finish_trace(r, resp)
            resps.append(resp)
        self._bump_many(upd)
        return resps

    # ------------------------------------------------------------------
    # threaded front end
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _reject(self, out: "queue.Queue[QueryResponse]", req,
                exc: BaseException) -> "queue.Queue[QueryResponse]":
        resp = QueryResponse(req.request_id, False, None, f"{exc}",
                             error_type=_error_type(exc))
        # rejected requests get finished traces too: a shed/expired
        # request's admission + queue spans explain WHERE it died
        self._close_queue_span(req)
        self._finish_trace(req, resp)
        out.put(resp)
        return out

    def _request_cost(self, req) -> float:
        """Shed key for reject-largest-fit: the label-set size is the
        fit-cost proxy (training dominates small-result queries; a big
        label set holds the window longest). Ingests cost 0 — admission
        never sheds a catalog mutation to make room for a query."""
        if isinstance(req, QueryRequest):
            return float(len(req.pos_ids) + len(req.neg_ids))
        return 0.0

    def submit(self, req) -> "queue.Queue[QueryResponse]":
        """Enqueue a QueryRequest OR an IngestRequest; both resolve to a
        QueryResponse on the returned queue — ALWAYS, even when admission
        sheds the request (a typed Overloaded/RateLimited/expired
        response resolves immediately). After ``close`` the server
        raises ``ServerClosed`` instead of enqueueing into a dead queue.
        """
        if self._closed:
            raise ServerClosed("server is closed; submit refused")
        t_sub = time.perf_counter()
        # trace born at ADMISSION (tracing enabled and none attached yet
        # — the HTTP layer creates its own to honor X-Request-Id)
        if isinstance(req, QueryRequest) and req.trace is None:
            req.trace = self.obs.new_trace()
        out: "queue.Queue[QueryResponse]" = queue.Queue(maxsize=1)
        try:
            self._fault("submit")    # serve-layer chaos seam
        except Exception as e:  # noqa: BLE001 — typed, never unserved
            self._bump("submit_faults")
            return self._reject(out, req, e)
        # stamp the default deadline budget at ADMISSION time: queue wait
        # burns it, which is exactly what a latency SLO means
        if isinstance(req, QueryRequest):
            if req.deadline_s is None and self.default_deadline_s is not None:
                req.deadline_s = deadline_after(self.default_deadline_s)
            if req.deadline_s is not None \
                    and time.monotonic() > req.deadline_s:
                self._bump("rejected_deadline")
                return self._reject(out, req, DeadlineExceeded(
                    "deadline already expired at admission"))
        if self.rate_limit is not None:
            src = getattr(req, "source", "default")
            bucket = self._buckets.get(src)
            if bucket is None:
                bucket = self._buckets.setdefault(
                    src, TokenBucket(*self.rate_limit))
            if not bucket.try_acquire():
                self._bump("rejected_rate_limited")
                return self._reject(out, req, RateLimited(
                    f"source {src!r} exceeded "
                    f"{self.rate_limit[0]:g} req/s"))
        tr = self._trace_of(req)
        if tr is not None:
            # admission span: deadline stamp + rate limit + shed checks;
            # the queue span opens here (mark) and closes at handle
            # entry, so window-formation wait is INSIDE it
            tr.add_span("admission", t_sub,
                        time.perf_counter() - t_sub)
            tr.mark("queued")
        admitted, evicted = self._q.offer((req, out),
                                          cost=self._request_cost(req))
        if not admitted:
            self._bump("rejected_overloaded")
            return self._reject(out, req, Overloaded(
                f"admission queue full (depth={self.queue_depth}, "
                f"policy={self._q.shed_policy})"))
        self._bump("admitted")
        if evicted is not None:
            ev_req, ev_out = evicted
            self._bump("evicted")
            self._reject(ev_out, ev_req, Overloaded(
                "shed by reject-largest-fit to admit a cheaper request"))
        return out

    def _next_item(self, timeout: float):
        if self._held is not None:
            item, self._held = self._held, None
            return item
        return self._q.pop(timeout)

    def _pop_live(self, timeout: float):
        """Next queue item whose deadline hasn't already expired; expired
        requests resolve immediately with a typed response (window
        formation checkpoint — queue wait burned their budget).

        ITERATIVE on purpose: an open-loop overload against an unbounded
        queue piles up thousands of already-expired entries, and popping
        them by recursion blew the interpreter stack (RecursionError on
        the serving thread — every caller stranded). The loop drains an
        arbitrarily deep expired backlog in constant stack."""
        while True:
            item = self._next_item(timeout)
            if item is None:
                return None
            req, out = item
            if isinstance(req, QueryRequest) and req.deadline_s is not None \
                    and time.monotonic() > req.deadline_s:
                self._bump("expired_in_queue")
                self._reject(out, req, DeadlineExceeded(
                    "deadline expired while queued"))
                timeout = 0     # try the next entry, don't wait
                continue
            return item

    def _update_health(self) -> None:
        """Degraded when the queue is above the soft-depth watermark —
        checked once per window so every query in a window sees one
        consistent max_results clamp."""
        qd = self.queue_depth
        if qd is None:
            self._degraded = False
            return
        self._degraded = len(self._q) >= max(
            1, int(qd * self.soft_depth_frac))
        if self._degraded:
            self._bump("degraded_windows")

    def _loop(self):
        """Batching loop with ingest interleaving: ingests apply BETWEEN
        query windows, in arrival order. An ingest at the head of the
        queue runs immediately; one arriving mid-window closes the
        window (the collected queries run on the snapshot they arrived
        under) and applies before the next window opens. In drain mode
        (close(drain=True)) the loop exits only once the queue is empty
        — every queued request gets a real answer."""
        with obs_profile.bind_registry(self.obs.registry):
            self._loop_body()

    def _loop_body(self):
        while not self._stop.is_set():
            first = self._pop_live(0.05)
            if first is None:
                if self._drain.is_set() and len(self._q) == 0 \
                        and self._held is None:
                    break
                continue
            if isinstance(first[0], IngestRequest):
                first[1].put(self.handle_ingest(first[0]))
                continue
            self._update_health()
            batch = [first]
            deadline = time.perf_counter() + self.batch_window_s
            while len(batch) < self.max_batch:
                item = self._pop_live(
                    max(deadline - time.perf_counter(), 0))
                if item is None:
                    break
                if isinstance(item[0], IngestRequest):
                    self._held = item      # closes this window; runs next
                    break
                batch.append(item)
            reqs = [b[0] for b in batch]
            resps = self.handle_batch(reqs)
            for (_, out), resp in zip(batch, resps):
                out.put(resp)

    def close(self, drain: bool = True):
        """Shut down the threaded front end. ``drain=True`` (default)
        answers every queued request before stopping; ``drain=False``
        stops immediately and resolves the backlog with typed shutdown
        errors. Either way NOTHING is stranded: every submitted request's
        queue gets exactly one response, and ``submit`` afterwards raises
        ``ServerClosed``. Idempotent."""
        self._closed = True
        if drain:
            self._drain.set()
        else:
            self._stop.set()
        if self.faults is not None and not drain:
            # a fast close must not wait out injected hangs
            self.faults.release()
        if self._thread is not None:
            if drain and self.faults is not None:
                # drain promises a REAL answer to everything queued, but
                # an injected hang parks the serving thread mid-request;
                # once the queue is empty the only thing between us and
                # the join is that sleep — release it (a hang is a delay
                # seam, not a failure: the parked request still gets its
                # real answer) instead of eating the full join timeout.
                dl = time.monotonic() + 30.0
                while time.monotonic() < dl and (
                        len(self._q) > 0 or self._held is not None):
                    time.sleep(0.002)
                self.faults.release()
            self._thread.join(timeout=30.0 if drain else 2.0)
            if self._thread.is_alive():
                self._stop.set()
                if self.faults is not None:
                    self.faults.release()
                self._thread.join(timeout=2.0)
        self._stop.set()
        # typed shutdown errors for whatever the loop did not serve
        leftovers = self._q.drain()
        if self._held is not None:
            leftovers.insert(0, self._held)
            self._held = None
        for req, out in leftovers:
            self._bump("shutdown_unserved")
            self._reject(out, req, ServerClosed(
                "server closed before this request ran"))
        if self._compact_thread is not None:
            self._compact_thread.join(timeout=30.0)

    # ------------------------------------------------------------------
    @property
    def health(self) -> str:
        """Coarse serving state: ``ok`` / ``degraded`` (soft-depth
        watermark crossed, the last compaction attempt failed, or the
        engine recovered from a damaged directory and is serving the
        salvaged prefix) / ``draining`` (close in progress or done)."""
        if self._closed:
            return "draining"
        if (self._degraded or self._recovery_degraded
                or self.stats["compaction_errors"] > 0):
            return "degraded"
        return "ok"

    def summary(self) -> Dict:
        # one locked copy: summary readers race the serving thread's
        # batched updates, and a dict comprehension over a mutating dict
        # can tear mid-ledger
        with self._stats_lock:
            stats = dict(self.stats)
        served = max(stats["served"], 1)
        out = {**stats,
               "health": self.health,
               "queue_depth_peak": self._q.depth_peak,
               "last_compaction_error": self._last_compaction_error,
               "n_shards": getattr(self.engine, "n_shards", 1),
               "live": getattr(self.engine, "live", False),
               "mean_latency_s": stats["latency_sum"] / served,
               "mean_fit_s": stats["fit_s_sum"] / served,
               "mean_ingest_s": (stats["ingest_s_sum"]
                                 / max(stats["ingests"], 1)),
               # sparse serving headroom: peak device score bytes as a
               # fraction of what the dense [N, Q] buffer would need
               "score_buffer_frac_of_dense": (
                   stats["score_buffer_bytes_peak"]
                   / max(stats["dense_score_bytes_equiv"], 1))}
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        cat = getattr(self.engine, "_catalog", None)
        if cat is not None:
            snap = cat.snapshot()
            out["epoch"] = snap.epoch
            out["n_segments"] = len(snap.segments)
            out["rows_live"] = snap.live_rows
            out["rows_tombstoned"] = snap.n - snap.live_rows
            # durability ledger (DESIGN.md §15): WAL records/bytes/fsyncs
            # this process has billed, so an operator can see the per-
            # append durability overhead next to the serving latencies —
            # read as ONE locked pair (lsn, stats): a concurrent append
            # must not yield an lsn from after it with stats from before
            # durability_snapshot deep-copies under the catalog lock —
            # the caller OWNS every nested value in this summary; no
            # block may alias live server state (a reader iterating a
            # live dict races the serving thread)
            dur = cat.durability_snapshot()
            if dur is not None:
                out["durable"] = dur
        rec = getattr(self.engine, "recovery", None)
        if rec is not None:
            out["recovery"] = {
                "clean": rec.clean, "manifest_id": rec.manifest_id,
                "horizon_lsn": rec.horizon_lsn, "last_lsn": rec.last_lsn,
                "replayed_appends": rec.replayed_appends,
                "replayed_deletes": rec.replayed_deletes,
                "torn_tail": rec.torn_tail,
                # copy.deepcopy, not list(): RecoveryReport is mutable
                # and shared with the engine — entries must not alias
                "quarantined": copy.deepcopy(rec.quarantined),
                "errors": copy.deepcopy(rec.errors)}
        out["obs"] = {"metrics_enabled": self.obs.metrics_enabled,
                      "tracing_enabled": self.obs.tracing_enabled,
                      "traces_buffered": len(self.obs.traces),
                      "latency_p50_s": self._h_latency.quantile(0.5),
                      "latency_p99_s": self._h_latency.quantile(0.99)}
        return out


def merge_shard_results(per_shard: List[QueryResult],
                        shard_offsets: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """HOST ORACLE for the cross-shard merge: offset local ids to global,
    concatenate, re-rank. Pure function — the stateless front-end merge
    as it ran before the device-side sharded path existed, kept as the
    reference the sharded tests compare kernels/ops.merge_topk against.

    Ordering is pinned to the rank_topk tie-break contract (DESIGN.md
    §9/§11): descending score, ascending GLOBAL id within equal scores —
    a stable sort on -score alone would instead break ties by shard
    arrival order, which only coincides with the contract when shards
    arrive pre-sorted and in offset order."""
    ids, scores = [], []
    for res, off in zip(per_shard, shard_offsets):
        ids.append(np.asarray(res.ids) + off)
        scores.append(np.asarray(res.scores))
    ids = np.concatenate(ids) if ids else np.empty(0, np.int64)
    scores = np.concatenate(scores) if scores else np.empty(0)
    order = np.lexsort((ids, -scores))
    return ids[order], scores[order]
