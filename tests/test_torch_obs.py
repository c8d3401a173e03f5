"""The port's observability layer (``repro_torch.obs``) against the
reference's, on the CPU.

Every case of tests/test_obs.py and every case of tests/test_trace.py
that needs no socket runs here once per package, parametrised over
``("repro", "repro_torch")`` (the port's engines with ``device="cpu"``),
with the reference test's assertions. The last case sends one seeded
schedule (a batch window, overflow retries, a deadline expiry in the
queue, an append, a background compaction, a durable WAL) through a
server of each package and holds the two to each other: each request's
multiset of span names, its status, and the count of
``profile_seconds{site}`` per site. Times are never compared.

``Pkg`` is the one place the two packages' modules are looked up; the
other serving twins (tests/test_torch_serve.py, test_torch_http.py,
test_torch_chaos.py) import it from here.
"""
from __future__ import annotations

import collections
import importlib
import re
import threading
import time

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


class Pkg:
    """One package's serving stack: modules by role, and the engine
    constructors with the port bound to the CPU."""

    def __init__(self, name: str):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.obs = mod("obs")
        self.metrics = mod("obs.metrics")
        self.profile = mod("obs.profile")
        self.trace = mod("obs.trace")
        self.cache = mod("serve.cache")
        self.server = mod("serve.engine")
        self.http = mod("serve.http")
        self.policy = mod("serve.policy")
        self.faults = mod("serve.faults")
        self.errors = mod("core.errors")
        self.core = mod("core.engine")
        self.segments = mod("core.segments")
        self._dev = {"device": "cpu"} if name == "repro_torch" else {}
        for n in ("QueryRequest", "IngestRequest", "QueryServer",
                  "merge_shard_results"):
            setattr(self, n, getattr(self.server, n))
        self.ResultCache = self.cache.ResultCache
        self.HttpFrontEnd = self.http.HttpFrontEnd
        self.Observability = self.obs.Observability
        self.FaultInjector = self.faults.FaultInjector
        self.FaultSpec = self.faults.FaultSpec
        self.RetryPolicy = self.policy.RetryPolicy
        self.QueryResult = self.core.QueryResult

    def engine(self, *args, **kw):
        return self.core.SearchEngine(*args, **kw, **self._dev)

    def open_catalog(self, d, **kw):
        return self.segments.SegmentedCatalog.open(d, **kw, **self._dev)


_PKGS = {}


def get_pkg(name: str) -> Pkg:
    if name not in _PKGS:
        _PKGS[name] = Pkg(name)
    return _PKGS[name]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return get_pkg(request.param)


ENG = dict(n_subsets=4, subset_dim=4, block=64)


def _data(n=300, d=16, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, d)).astype(np.float32)


def _labels():
    return list(range(10)), list(range(100, 150))


def _span_names(trace_dict):
    return [s["name"] for s in trace_dict["spans"]]


# ----------------------------------------------------------------------
# registry primitives
# ----------------------------------------------------------------------

def test_counter_gauge_basics(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(4)
    assert c.value == 5.0
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.inc(2)
    g.dec()
    assert g.value == 8.0


def test_counter_labels_are_independent_children(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("hits_total", "hits", labelnames=("route",))
    c.inc(1, route="/query")
    c.inc(2, route="/stats")
    assert reg.value("hits_total", route="/query") == 1.0
    assert reg.value("hits_total", route="/stats") == 2.0


def test_register_same_name_same_kind_returns_shared_instance(pkg):
    reg = pkg.metrics.MetricsRegistry()
    a = reg.counter("x_total", "x")
    b = reg.counter("x_total", "x")
    assert a is b
    a.inc()
    assert b.value == 1.0


def test_register_kind_mismatch_fails_loudly(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("thing", "x")
    with pytest.raises((TypeError, ValueError)):
        reg.gauge("thing", "x")


def test_histogram_quantiles_without_stored_samples(pkg):
    buckets = pkg.metrics.LATENCY_BUCKETS_S
    h = pkg.metrics.Histogram("lat_seconds", "latency", buckets=buckets)
    rng = np.random.default_rng(0)
    xs = rng.uniform(0.001, 0.5, size=2000)
    for x in xs:
        h.observe(float(x))
    for q in (0.5, 0.99):
        est = h.quantile(q)
        true = float(np.quantile(xs, q))
        lo = max(b for b in buckets if b <= true)
        hi = min(b for b in buckets if b >= true)
        assert lo * 0.99 <= est <= hi * 1.01, (q, est, true)
    assert h.count == 2000
    assert h.sum == pytest.approx(float(xs.sum()), rel=1e-6)


def test_histogram_empty_and_overflow_bucket(pkg):
    h = pkg.metrics.Histogram("h_seconds", "h", buckets=(0.01, 0.1))
    assert h.quantile(0.5) == 0.0
    h.observe(5.0)
    assert h.quantile(0.99) == pytest.approx(0.1)


def test_metric_constants_match_reference():
    ref, port = get_pkg("repro"), get_pkg("repro_torch")
    assert port.metrics.LATENCY_BUCKETS_S == ref.metrics.LATENCY_BUCKETS_S
    assert port.metrics.AGE_BUCKETS_S == ref.metrics.AGE_BUCKETS_S
    assert port.profile.PROFILE_SITES == ref.profile.PROFILE_SITES
    assert port.obs.STAGE_SPANS == ref.obs.STAGE_SPANS


# ----------------------------------------------------------------------
# Prometheus text exposition
# ----------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"[^"]*")*\})? '
    r'[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$')


def assert_valid_exposition(text: str) -> None:
    families = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP") or line.startswith("# TYPE"):
            parts = line.split(None, 3)
            assert len(parts) >= 3, line
            if parts[1] == "TYPE":
                assert parts[2] not in families, line
                families[parts[2]] = parts[3]
            continue
        assert _SAMPLE_RE.match(line), f"unparseable sample: {line!r}"


def _render_demo(pkg) -> str:
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("a_total", "a counter").inc(3)
    reg.gauge("b_gauge", "a gauge", labelnames=("x",)).set(1.5, x="y")
    h = reg.histogram("c_seconds", "a histogram", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    return reg.render_prometheus()


def test_render_prometheus_is_valid_and_complete(pkg):
    text = _render_demo(pkg)
    assert_valid_exposition(text)
    m = {ln.split(" ")[0]: float(ln.split(" ")[1])
         for ln in text.splitlines()
         if ln and not ln.startswith("#")}
    assert m['c_seconds_bucket{le="0.1"}'] == 1
    assert m['c_seconds_bucket{le="1"}'] == 2
    assert m['c_seconds_bucket{le="+Inf"}'] == 3
    assert m["c_seconds_count"] == 3
    assert m["c_seconds_sum"] == pytest.approx(5.55)
    assert m["a_total"] == 3


def test_render_prometheus_text_equal_between_packages():
    assert _render_demo(get_pkg("repro_torch")) == \
        _render_demo(get_pkg("repro"))


def test_collector_publishes_external_counters(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ledger = {"served": 0}

    def collect():
        yield ("srv_served_total", "counter", {}, ledger["served"])

    reg.register_collector(collect)
    ledger["served"] = 42
    assert reg.value("srv_served_total") == 42.0
    assert "srv_served_total 42" in reg.render_prometheus()


def test_broken_collector_does_not_kill_scrape(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("ok_total", "fine").inc()

    def broken():
        raise RuntimeError("boom")
        yield  # pragma: no cover

    reg.register_collector(broken)
    text = reg.render_prometheus()
    assert_valid_exposition(text)
    assert "ok_total 1" in text
    assert "obs_collector_errors" in text


# ----------------------------------------------------------------------
# profiling hooks
# ----------------------------------------------------------------------

def test_profile_records_into_bound_registry(pkg):
    reg = pkg.metrics.MetricsRegistry()
    prof = pkg.profile
    prev = prof.enabled()
    prof.set_enabled(True)
    try:
        with prof.bind_registry(reg):
            with prof.profile("device_sync"):
                pass
            prof.record("jit_dispatch", 0.25)
        assert reg.value("profile_seconds_count", site="device_sync") == 1
        assert reg.value("profile_seconds_sum",
                         site="jit_dispatch") == pytest.approx(0.25)
    finally:
        prof.set_enabled(prev)


def test_profile_disabled_is_noop(pkg):
    reg = pkg.metrics.MetricsRegistry()
    prof = pkg.profile
    prev = prof.enabled()
    prof.set_enabled(False)
    try:
        with prof.bind_registry(reg):
            with prof.profile("device_sync"):
                pass
            prof.record("wal_fsync", 1.0)
        assert reg.value("profile_seconds_count", site="device_sync") == 0
        assert reg.value("profile_seconds_sum", site="wal_fsync") == 0.0
    finally:
        prof.set_enabled(prev)


def test_profile_binding_is_per_thread(pkg):
    reg_a, reg_b = pkg.metrics.MetricsRegistry(), \
        pkg.metrics.MetricsRegistry()
    prof = pkg.profile
    prev = prof.enabled()
    prof.set_enabled(True)
    done = threading.Event()

    def other():
        with prof.bind_registry(reg_b):
            prof.record("compact", 1.0)
        done.set()

    try:
        with prof.bind_registry(reg_a):
            t = threading.Thread(target=other)
            t.start()
            t.join()
            prof.record("compact", 2.0)
        assert done.is_set()
        assert reg_a.value("profile_seconds_sum",
                           site="compact") == pytest.approx(2.0)
        assert reg_b.value("profile_seconds_sum",
                           site="compact") == pytest.approx(1.0)
    finally:
        prof.set_enabled(prev)


def test_profile_switches_are_per_package():
    """Each package keeps its own module globals: enabling one
    package's profiling, or binding its registry, leaves the other's
    untouched (the parity tests run both in one process)."""
    ref, port = get_pkg("repro").profile, get_pkg("repro_torch").profile
    prev = (ref.enabled(), port.enabled())
    try:
        ref.set_enabled(False)
        port.set_enabled(True)
        assert port.enabled() and not ref.enabled()
        reg = get_pkg("repro_torch").metrics.MetricsRegistry()
        with port.bind_registry(reg):
            ref.record("compact", 1.0)
            port.record("compact", 2.0)
        assert reg.value("profile_seconds_sum",
                         site="compact") == pytest.approx(2.0)
    finally:
        ref.set_enabled(prev[0])
        port.set_enabled(prev[1])


def test_default_registry_is_a_singleton(pkg):
    assert pkg.metrics.default_registry() is pkg.metrics.default_registry()


# ----------------------------------------------------------------------
# cache instrumentation
# ----------------------------------------------------------------------

class _Res:
    def __init__(self, nbytes=100):
        self.ids = np.zeros(nbytes // 8, dtype=np.int64)
        self.scores = np.zeros(0, dtype=np.float32)


def test_cache_per_entry_hits_and_report(pkg):
    c = pkg.ResultCache(max_bytes=1 << 20, max_entries=16)
    k1 = ("a",) + (0, 0)
    k2 = ("b",) + (0, 0)
    c.put(k1, _Res())
    c.put(k2, _Res())
    for _ in range(3):
        assert c.get(k1) is not None
    assert c.get(k2) is not None
    rep = c.entry_report(10)
    assert [r["hits"] for r in rep] == [3, 1]
    assert all(r["age_s"] >= 0 and r["nbytes"] > 0 for r in rep)


def test_cache_age_histogram_and_registry_attach(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = pkg.ResultCache(max_bytes=1 << 20, max_entries=2)
    c.attach(reg)
    c.put(("a",) + (0, 0), _Res())
    c.put(("b",) + (0, 0), _Res())
    c.get(("a",) + (0, 0))
    c.put(("c",) + (0, 0), _Res())
    assert reg.value("cache_age_at_eviction_seconds_count") == 1
    assert c.age_at_eviction_quantile(0.5) >= 0.0
    st = c.stats()
    assert reg.value("cache_hits_total") == st["hits"] == 1
    assert reg.value("cache_evictions_total") == st["evictions"] == 1
    assert reg.value("cache_entries") == len(c) == 2
    assert reg.value("cache_hit_rate") == pytest.approx(st["hit_rate"])
    assert_valid_exposition(reg.render_prometheus())


def test_cache_stale_invalidation_records_ages(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = pkg.ResultCache()
    c.attach(reg)
    c.put(("a",) + (0, 0), _Res())
    c.put(("b",) + (1, 0), _Res())
    dropped = c.invalidate_epoch(1, 0)
    assert dropped == 1
    assert reg.value("cache_age_at_eviction_seconds_count") == 1
    assert reg.value("cache_stale_evictions_total") == 1


# ----------------------------------------------------------------------
# summary() snapshot isolation + obs block
# ----------------------------------------------------------------------

def test_summary_returns_snapshots_not_live_references(pkg, tmp_path):
    eng = pkg.engine(_data(), **ENG, live=True,
                     data_dir=str(tmp_path / "cat"), wal_sync="always")
    srv = pkg.QueryServer(eng, max_results=10)
    try:
        s1 = srv.summary()
        assert "durable" in s1
        for k in list(s1["durable"]):
            s1["durable"][k] = "poisoned"
        if "recovery" in s1:
            for k in list(s1["recovery"]):
                s1["recovery"][k] = "poisoned"
        s2 = srv.summary()
        assert all(v != "poisoned" for v in s2["durable"].values())
        if "recovery" in s2:
            assert all(v != "poisoned"
                       for v in s2["recovery"].values())
    finally:
        srv.close()
        eng.close()


def _mk_req(pkg, srv):
    req = pkg.QueryRequest(1, list(range(8)), list(range(50, 80)),
                           "dbranch")
    req.trace = srv.obs.new_trace()
    return req


def test_summary_carries_obs_block_and_latency_quantiles(pkg):
    eng = pkg.engine(_data(), **ENG, live=True)
    srv = pkg.QueryServer(eng, max_results=10)
    try:
        r = srv.handle(_mk_req(pkg, srv))
        assert r.ok
        s = srv.summary()
        assert s["obs"]["metrics_enabled"] is True
        assert s["obs"]["tracing_enabled"] is True
        assert s["obs"]["latency_p50_s"] > 0.0
        assert s["obs"]["traces_buffered"] >= 1
    finally:
        srv.close()


def test_observability_disabled_creates_no_traces(pkg):
    obs = pkg.Observability(metrics_enabled=False, tracing_enabled=False)
    assert obs.new_trace() is None
    assert len(obs.traces) == 0


# ----------------------------------------------------------------------
# traces without a socket (the unit cases of tests/test_trace.py)
# ----------------------------------------------------------------------

def test_trace_span_and_mark_arithmetic(pkg):
    tr = pkg.trace.Trace("t1")
    with tr.span("a"):
        time.sleep(0.01)
    tr.mark("q")
    time.sleep(0.01)
    tr.span_from_mark("q", "queue")
    tr.span_from_mark("q", "queue")
    tr.finish("ok")
    tr.finish("late")
    d = tr.to_dict()
    assert d["status"] == "ok"
    assert _span_names(d) == ["a", "queue"]
    assert all(s["dur_s"] >= 0.009 for s in d["spans"])
    assert tr.wall_s >= 0.02


def test_retry_attempts_visible_in_trace(pkg):
    inj = pkg.FaultInjector(specs=[pkg.FaultSpec("fused_query",
                                                 at_calls=(1,))])
    eng = pkg.engine(_data(500), **ENG, live=True, faults=inj)
    srv = pkg.QueryServer(eng, max_results=20,
                          retry_policy=pkg.RetryPolicy(max_attempts=3,
                                                       backoff_s=0.001))
    srv.start()
    try:
        pos, neg = _labels()
        resp = srv.submit(pkg.QueryRequest(1, pos, neg,
                                           "dbranch")).get(timeout=120)
        assert resp.ok
        assert srv.stats["retries"] == 1
        names = _span_names(srv.obs.traces.get(resp.info["trace_id"]))
        assert names.count("retry") == 1
        assert names.count("fit") == 2
        assert names.count("device_round") >= 2
        assert names.index("retry") > names.index("fit")
    finally:
        srv.close()


def test_overflow_retry_rounds_leave_extra_device_round_spans(pkg):
    eng = pkg.engine(_data(500), **ENG, live=True, capacity_frac=1e-6)
    srv = pkg.QueryServer(eng, max_results=20)
    srv.start()
    try:
        pos, neg = _labels()
        resp = srv.submit(pkg.QueryRequest(1, pos, neg,
                                           "dbranch")).get(timeout=120)
        assert resp.ok
        tr = srv.obs.traces.get(resp.info["trace_id"])
        rounds = [s for s in tr["spans"] if s["name"] == "device_round"]
        assert len(rounds) >= 2, _span_names(tr)
        assert [s["attrs"]["round"] for s in rounds] == \
            list(range(len(rounds)))
    finally:
        srv.close()


def test_deadline_expired_request_still_finishes_its_trace(pkg):
    eng = pkg.engine(_data(500), **ENG, live=True)
    srv = pkg.QueryServer(eng, max_results=20)
    srv.start()
    try:
        pos, neg = _labels()
        req = pkg.QueryRequest(1, pos, neg, "dbranch",
                               deadline_s=pkg.errors.deadline_after(-1.0))
        resp = srv.submit(req).get(timeout=30)
        assert not resp.ok and resp.error_type == "deadline_exceeded"
        tr = srv.obs.traces.get(resp.info["trace_id"])
        assert tr is not None
        assert tr["status"] == "deadline_exceeded"
    finally:
        srv.close()


def test_trace_ids_unique_across_concurrent_submits(pkg):
    eng = pkg.engine(_data(500), **ENG, live=True)
    srv = pkg.QueryServer(eng, max_results=20, queue_depth=256,
                          cache=pkg.ResultCache())
    srv.start()
    ids, lock = [], threading.Lock()
    pos, neg = _labels()

    def one(i):
        resp = srv.submit(pkg.QueryRequest(i, pos, neg,
                                           "dbranch")).get(timeout=120)
        with lock:
            ids.append(resp.info.get("trace_id"))

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(100)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(ids) == 100
        assert None not in ids
        assert len(set(ids)) == 100
    finally:
        srv.close()


def test_slow_query_log_lines_parse(pkg, tmp_path):
    import json
    log = tmp_path / "slow.jsonl"
    obs = pkg.Observability(slow_query_s=0.0, slow_log_path=str(log))
    eng = pkg.engine(_data(500), **ENG, live=True)
    srv = pkg.QueryServer(eng, max_results=20, obs=obs)
    srv.start()
    try:
        pos, neg = _labels()
        resp = srv.submit(pkg.QueryRequest(1, pos, neg,
                                           "dbranch")).get(timeout=120)
        assert resp.ok
    finally:
        srv.close()
    lines = [json.loads(ln) for ln in
             log.read_text().strip().splitlines()]
    assert lines, "no slow-query lines written"
    entry = lines[0]
    assert entry["slow_query"] is True
    assert entry["trace_id"] == resp.info["trace_id"]
    assert entry["status"] == "ok"
    assert entry["wall_ms"] > 0
    assert "fit" in entry["spans"] and "device_round" in entry["spans"]
    assert obs.traces.slow_log(5)


# ----------------------------------------------------------------------
# one seeded schedule through both packages: spans and profile sites
# ----------------------------------------------------------------------

def _schedule(pkg, d):
    """A durable live server with cold capacities (every probe overflows
    its first round), driven through: one batch window of three queries
    and a request whose deadline burns in the queue, an append that
    closes the window, a background compaction, then a window of two
    queries. Returns per-request (status, span-name multiset) in
    request order and the per-site counts of profile_seconds."""
    x = _data(400, seed=3)
    eng = pkg.engine(x, **ENG, live=True, capacity_frac=1e-6,
                     data_dir=str(d), wal_sync="always")
    srv = pkg.QueryServer(eng, max_batch=4, batch_window_s=0.05,
                          max_results=15, cache=pkg.ResultCache())
    dl = pkg.errors.deadline_after
    qs = [pkg.QueryRequest(0, list(range(6)), list(range(100, 140))),
          pkg.QueryRequest(1, list(range(3, 12)), list(range(200, 230)),
                           "dbens", kwargs={"n_models": 3}),
          pkg.QueryRequest(2, list(range(6)), list(range(100, 140))),
          pkg.QueryRequest(3, [1, 2], [300, 301], deadline_s=dl(0.02))]
    outs = [srv.submit(r) for r in qs]
    outs.append(srv.submit(pkg.IngestRequest(
        4, "append", features=_data(30, seed=11))))
    tail = [pkg.QueryRequest(5, list(range(6)), list(range(100, 140))),
            pkg.QueryRequest(6, [7, 8, 9], list(range(150, 170)))]
    time.sleep(0.05)                 # request 3's budget burns queued
    srv.start()
    resps = [o.get(timeout=120) for o in outs]
    c = srv.handle_ingest(pkg.IngestRequest(7, "compact"))
    assert c.ok
    srv._compact_thread.join(timeout=60)
    outs = [srv.submit(r) for r in tail]
    resps += [o.get(timeout=120) for o in outs]
    srv.close()
    eng.close()
    per_req = []
    for r in resps:
        tid = r.info.get("trace_id")
        tr = srv.obs.traces.get(tid) if tid else None
        per_req.append((r.request_id, r.ok, r.error_type,
                        None if tr is None else tr["status"],
                        None if tr is None else
                        sorted(collections.Counter(
                            _span_names(tr)).items())))
    reg = srv.obs.registry
    sites = {s: reg.value("profile_seconds_count", site=s)
             for s in pkg.profile.PROFILE_SITES}
    ledger = {k: v for k, v in srv.stats.items()
              if isinstance(v, int)}
    ids = [(r.request_id, None if r.result is None
            else (r.result.ids.tolist(), r.result.scores.tolist()))
           for r in resps]
    return per_req, sites, ledger, ids


def test_schedule_spans_and_profile_sites_equal_between_packages(
        tmp_path):
    ref = _schedule(get_pkg("repro"), tmp_path / "ref")
    port = _schedule(get_pkg("repro_torch"), tmp_path / "port")
    per_req, sites, ledger, ids = port
    # the schedule reached what it is for
    by_id = {p[0]: p for p in per_req}
    assert by_id[3][2] == "deadline_exceeded"
    spans0 = dict(by_id[0][4])
    assert spans0["device_round"] >= 2       # overflow retry rounds
    assert spans0["fit"] == 1 and spans0["rank"] == 1
    assert ledger["batches"] >= 1 and ledger["rows_appended"] == 30
    assert ledger["compactions"] == 1 and ledger["expired_in_queue"] == 1
    assert all(sites[s] > 0 for s in sites), sites
    assert per_req == ref[0]
    assert sites == ref[1]
    assert ledger == ref[2]
    assert ids == ref[3]
