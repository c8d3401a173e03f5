"""The port's serving core (``repro_torch.serve``: ``QueryServer``,
``ResultCache``, the robustness policy) against the reference's, on the
CPU.

Twins of tests/test_serve_robustness.py and tests/test_result_cache.py,
under the same names (the serving cases of tests/test_serve_features.py
are in tests/test_torch_serve_features.py). Each twin runs one case body
through both packages (the port's engines with ``device="cpu"``): the
reference test's assertions hold in each, and what the case returns —
ranked ids and scores, integer ledgers and counters, error tags — is
equal between the two. Times are never compared.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from test_torch_obs import ENG, get_pkg


def _data(n=500, d=16, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, d)).astype(np.float32)


def _labels():
    return list(range(10)), list(range(100, 150))


def twin(case, *args):
    """Run ``case(pkg, *args)`` on the port, then on the reference, and
    hold what each returns equal."""
    port = case(get_pkg("repro_torch"), *args)
    ref = case(get_pkg("repro"), *args)
    assert port == ref
    return port


def _res(r):
    """A response's comparable content: ok, tag, ids and scores."""
    if r.result is None:
        return (r.request_id, r.ok, r.error_type, None, None)
    return (r.request_id, r.ok, r.error_type,
            np.asarray(r.result.ids).tolist(),
            np.asarray(r.result.scores).tolist())


def _ints(d):
    return {k: v for k, v in d.items()
            if isinstance(v, int) and not isinstance(v, bool)}


@pytest.fixture(scope="module")
def base_x():
    return _data()


# ----------------------------------------------------------------------
# policy units
# ----------------------------------------------------------------------

def test_retry_policy_retries_transient_then_succeeds():
    def case(p):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise p.errors.TransientDeviceError("flake")
            return "ok"

        naps = []
        pol = p.RetryPolicy(max_attempts=5, backoff_s=0.01, seed=7)
        assert pol.call(flaky, sleep=naps.append) == "ok"
        assert calls["n"] == 3 and len(naps) == 2
        assert naps[1] > naps[0] > 0
        return naps
    twin(case)


def test_retry_policy_gives_up_and_classifies():
    def case(p):
        pol = p.RetryPolicy(max_attempts=2, backoff_s=0.0)
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            raise p.errors.TransientDeviceError("flake")
        with pytest.raises(p.errors.TransientDeviceError):
            pol.call(always, sleep=lambda s: None)
        assert calls["n"] == 2
        calls["n"] = 0

        def bad():
            calls["n"] += 1
            raise ValueError("bug")
        with pytest.raises(ValueError):
            pol.call(bad, sleep=lambda s: None)
        assert calls["n"] == 1
        assert not pol.classify(p.errors.DeadlineExceeded("late"))
    twin(case)


def test_retry_policy_does_not_retry_device_faults():
    """A fault of the device itself is no transient: the port's policy
    gives up on the first attempt, and the server tags it internal."""
    import torch
    p = get_pkg("repro_torch")
    pol = p.RetryPolicy(max_attempts=5, backoff_s=0.0)
    calls = {"n": 0}

    def launch_failed():
        calls["n"] += 1
        raise torch.AcceleratorError("CUDA error: unspecified launch "
                                     "failure")
    with pytest.raises(torch.AcceleratorError):
        pol.call(launch_failed, sleep=lambda s: None)
    assert calls["n"] == 1
    assert p.server._error_type(
        torch.AcceleratorError("x")) == "internal"
    assert p.server._error_type(
        torch.OutOfMemoryError("x")) == "internal"
    assert p.policy.http_status_for("internal") == 500


def test_retry_policy_respects_deadline_budget():
    def case(p):
        pol = p.RetryPolicy(max_attempts=10, backoff_s=10.0)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            raise p.errors.TransientDeviceError("flake")
        with pytest.raises(p.errors.TransientDeviceError):
            pol.call(flaky, deadline_s=p.errors.deadline_after(0.05),
                     sleep=lambda s: None)
        assert calls["n"] == 1
    twin(case)


def test_retry_backoff_is_seeded_deterministic():
    def case(p):
        a = p.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=3)
        b = p.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=3)
        da = [a.delay_s(i) for i in (1, 2, 3)]
        assert da == [b.delay_s(i) for i in (1, 2, 3)]
        return da
    twin(case)


def test_token_bucket_burst_and_refill():
    def case(p):
        t = {"now": 0.0}
        tb = p.policy.TokenBucket(rate=10.0, burst=2.0,
                                  clock=lambda: t["now"])
        got = [tb.try_acquire(), tb.try_acquire(), tb.try_acquire()]
        assert got == [True, True, False]
        t["now"] += 0.1
        got += [tb.try_acquire(), tb.try_acquire()]
        assert got[3:] == [True, False]
        t["now"] += 10.0
        assert tb.tokens == pytest.approx(2.0)
        return got
    twin(case)


def test_admission_queue_reject_newest():
    def case(p):
        q = p.policy.AdmissionQueue(depth=2)
        assert q.offer("a")[0] and q.offer("b")[0]
        admitted, evicted = q.offer("c")
        assert not admitted and evicted is None
        assert len(q) == 2 and q.depth_peak == 2
        assert q.pop(0.01) == "a"
    twin(case)


def test_admission_queue_reject_largest_fit():
    def case(p):
        q = p.policy.AdmissionQueue(depth=2,
                                    shed_policy="reject-largest-fit")
        q.offer("small", cost=5)
        q.offer("big", cost=50)
        admitted, evicted = q.offer("tiny", cost=1)
        assert admitted and evicted == "big"
        admitted, evicted = q.offer("huge", cost=100)
        assert not admitted and evicted is None
        assert q.drain() == ["small", "tiny"]
        assert len(q) == 0
    twin(case)


def test_error_status_table_matches_reference():
    ref, port = get_pkg("repro"), get_pkg("repro_torch")
    assert port.policy.ERROR_STATUS == ref.policy.ERROR_STATUS
    assert port.policy.SHED_POLICIES == ref.policy.SHED_POLICIES
    for n in ("Overloaded", "RateLimited", "ServerClosed",
              "DeadlineExceeded", "TransientDeviceError",
              "CompactionFailed", "PersistenceError", "RecoveryError"):
        assert getattr(port.policy, n).code == getattr(ref.policy, n).code


def test_fault_injector_deterministic_schedule():
    def case(p):
        specs = (p.FaultSpec("append", at_calls=(2,)),
                 p.FaultSpec("compact", prob=0.5, action="slow",
                             delay_s=0.0))

        def schedule(seed):
            inj = p.FaultInjector(seed=seed, specs=specs)
            fired = []
            for _ in range(20):
                try:
                    inj.check("append")
                except p.errors.TransientDeviceError:
                    fired.append(("append", inj.calls("append")))
                inj.check("compact")
            return fired + [(r.site, r.call) for r in inj.fired]

        assert schedule(11) == schedule(11)
        assert ("append", 2) in schedule(11)
        assert schedule(11) != schedule(12)
        return schedule(11)
    twin(case)


# ----------------------------------------------------------------------
# deadlines
# ----------------------------------------------------------------------

def test_engine_query_deadline_expired_before_fit(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG)
        pos, neg = _labels()
        with pytest.raises(p.errors.DeadlineExceeded):
            eng.query(pos, neg, model="dbranch",
                      deadline_s=time.monotonic() - 0.01)
    twin(case)


def test_submit_rejects_expired_deadline(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        pos, neg = _labels()
        resp = srv.submit(p.QueryRequest(
            0, pos, neg, deadline_s=time.monotonic() - 1)).get(timeout=5)
        assert not resp.ok and resp.error_type == "deadline_exceeded"
        assert srv.stats["rejected_deadline"] == 1
        return _res(resp), _ints(srv.stats)
    twin(case)


def test_deadline_expires_while_queued(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        pos, neg = _labels()
        dead = srv.submit(p.QueryRequest(
            0, pos, neg, deadline_s=p.errors.deadline_after(0.03)))
        live = srv.submit(p.QueryRequest(1, pos, neg))
        time.sleep(0.1)
        srv.start()
        r0 = dead.get(timeout=120)
        r1 = live.get(timeout=120)
        srv.close()
        assert not r0.ok and r0.error_type == "deadline_exceeded"
        assert "queued" in r0.error
        assert r1.ok
        assert srv.stats["expired_in_queue"] == 1
        return _res(r0), _res(r1), _ints(srv.stats)
    twin(case)


def test_default_deadline_stamped_at_admission(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), default_deadline_s=30.0)
        req = p.QueryRequest(0, *_labels())
        srv.submit(req)
        assert req.deadline_s is not None
        assert req.deadline_s - time.monotonic() == \
            pytest.approx(30.0, abs=1.0)
        srv.close(drain=False)
    twin(case)


# ----------------------------------------------------------------------
# admission control / backpressure
# ----------------------------------------------------------------------

def test_queue_full_typed_rejection(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), queue_depth=2)
        pos, neg = _labels()
        outs = [srv.submit(p.QueryRequest(i, pos, neg)) for i in range(4)]
        r2 = outs[2].get(timeout=5)
        r3 = outs[3].get(timeout=5)
        assert not r2.ok and r2.error_type == "overloaded"
        assert not r3.ok and r3.error_type == "overloaded"
        assert srv.stats["rejected_overloaded"] == 2
        assert srv.stats["admitted"] == 2
        srv.close(drain=False)
        rest = [o.get(timeout=5) for o in outs[:2]]
        assert all(r.error_type == "shutdown" for r in rest)
        return [_res(r) for r in (r2, r3, *rest)], _ints(srv.stats)
    twin(case)


def test_shed_policy_evicts_largest_fit(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), queue_depth=2,
                            shed_policy="reject-largest-fit")
        big = p.QueryRequest(0, list(range(40)), list(range(100, 200)))
        small = p.QueryRequest(1, [0, 1], [100, 101])
        tiny = p.QueryRequest(2, [0], [100])
        out_big = srv.submit(big)
        srv.submit(small)
        out_tiny = srv.submit(tiny)
        r = out_big.get(timeout=5)
        assert not r.ok and r.error_type == "overloaded"
        assert "largest-fit" in r.error
        assert srv.stats["evicted"] == 1
        assert out_tiny.empty()
        srv.close(drain=False)
        return _res(r), _ints(srv.stats)
    twin(case)


def test_rate_limit_per_source(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), rate_limit=(0.001, 2))
        pos, neg = _labels()
        rs = [srv.submit(p.QueryRequest(i, pos, neg,
                                        source="alice")).empty()
              for i in range(3)]
        assert rs == [True, True, False]
        assert srv.submit(p.QueryRequest(9, pos, neg,
                                         source="bob")).empty()
        assert srv.stats["rejected_rate_limited"] == 1
        srv.close(drain=False)
        return _ints(srv.stats)
    twin(case)


def test_degraded_mode_clamps_max_results(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), max_results=50,
                            queue_depth=4, degraded_max_results=5,
                            soft_depth_frac=0.5)
        req = p.QueryRequest(0, *_labels())
        assert srv._query_kwargs(req)["max_results"] == 50
        srv._degraded = True
        assert srv._query_kwargs(req)["max_results"] == 5
        req2 = p.QueryRequest(1, *_labels(), kwargs={"max_results": 3})
        assert srv._query_kwargs(req2)["max_results"] == 3
    twin(case)


def test_degraded_windows_under_backlog(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), max_results=50,
                            queue_depth=8, degraded_max_results=4,
                            soft_depth_frac=0.25, max_batch=2)
        pos, neg = _labels()
        outs = [srv.submit(p.QueryRequest(i, pos, neg)) for i in range(6)]
        assert srv.health == "ok"
        srv.start()
        resps = [o.get(timeout=120) for o in outs]
        srv.close()
        assert all(r.ok for r in resps)
        assert srv.stats["degraded_windows"] >= 1
        assert min(len(r.result.ids) for r in resps) <= 4
        # the first window is formed with the whole backlog queued
        return _res(resps[0]), _res(resps[1])
    twin(case)


# ----------------------------------------------------------------------
# lifecycle
# ----------------------------------------------------------------------

def test_close_resolves_queued_requests_with_typed_errors(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        pos, neg = _labels()
        outs = [srv.submit(p.QueryRequest(i, pos, neg)) for i in range(3)]
        outs.append(srv.submit(p.IngestRequest(3, "append",
                                               features=_data(4))))
        srv.close(drain=False)
        rs = [o.get(timeout=5) for o in outs]
        assert all(not r.ok and r.error_type == "shutdown" for r in rs)
        assert srv.stats["shutdown_unserved"] == 4
        assert srv.summary()["health"] == "draining"
        return [_res(r) for r in rs], _ints(srv.stats)
    twin(case)


def test_submit_after_close_raises(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        srv.start()
        srv.close()
        with pytest.raises(p.policy.ServerClosed):
            srv.submit(p.QueryRequest(0, *_labels()))
    twin(case)


def test_close_drain_answers_everything(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), max_batch=2)
        pos, neg = _labels()
        outs = [srv.submit(p.QueryRequest(i, pos, neg)) for i in range(5)]
        srv.start()
        srv.close(drain=True)
        resps = [o.get(timeout=120) for o in outs]
        assert all(r.ok for r in resps)
        assert srv.stats["served"] == 5
        assert srv.stats["shutdown_unserved"] == 0
        return [_res(r) for r in resps]
    twin(case)


def test_close_is_idempotent(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        srv.start()
        srv.close()
        srv.close()
        srv.close(drain=False)
        return srv.health
    twin(case)


# ----------------------------------------------------------------------
# compaction robustness
# ----------------------------------------------------------------------

def _live_server(p, x, faults=None, **kw):
    eng = p.engine(x, **ENG, live=True, faults=faults)
    return eng, p.QueryServer(eng, **kw)


def test_compaction_failure_keeps_old_snapshot(base_x):
    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec("compact",
                                                 at_calls=(1, 2, 3))])
        eng, srv = _live_server(
            p, base_x, faults=inj,
            compaction_retry=p.RetryPolicy(max_attempts=3,
                                           backoff_s=0.001))
        eng.append(_data(40, seed=5))
        pos, neg = _labels()
        before = eng.query(pos, neg, model="dbranch", max_results=20)
        epoch0 = eng._catalog.epoch
        assert len(eng._cap_hints) > 0
        rc = srv.handle_ingest(p.IngestRequest(0, "compact"))
        assert rc.ok and rc.info["background"]
        srv._compact_thread.join(timeout=30)
        assert not srv._compact_thread.is_alive()
        assert eng._catalog.epoch == epoch0
        assert srv.stats["compaction_errors"] == 1
        assert srv.stats["compaction_retries"] == 2
        assert "injected fault" in srv.summary()["last_compaction_error"]
        assert srv.summary()["health"] == "degraded"
        assert len(eng._cap_hints) == 0
        after = eng.query(pos, neg, model="dbranch", max_results=20)
        np.testing.assert_array_equal(before.ids, after.ids)
        np.testing.assert_array_equal(before.scores, after.scores)
        srv.close()
        return after.ids.tolist(), after.scores.tolist(), _ints(srv.stats)
    twin(case)


def test_compaction_transient_failure_retries_to_success(base_x):
    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec("compact",
                                                 at_calls=(1,))])
        eng, srv = _live_server(
            p, base_x, faults=inj,
            compaction_retry=p.RetryPolicy(max_attempts=3,
                                           backoff_s=0.001))
        eng.append(_data(40, seed=5))
        epoch0 = eng._catalog.epoch
        rc = srv.handle_ingest(p.IngestRequest(0, "compact"))
        assert rc.ok
        srv._compact_thread.join(timeout=30)
        assert srv.stats["compaction_retries"] == 1
        assert srv.stats["compaction_errors"] == 0
        assert eng._catalog.epoch == epoch0 + 1
        assert len(eng._catalog.snapshot().segments) == 1
        srv.close()
        return _ints(srv.stats)
    twin(case)


def test_concurrent_compact_requests_coalesce(base_x):
    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec(
            "compact", action="slow", at_calls=(1,), delay_s=0.3)])
        eng, srv = _live_server(p, base_x, faults=inj)
        eng.append(_data(40, seed=5))
        r1 = srv.handle_ingest(p.IngestRequest(0, "compact"))
        r2 = srv.handle_ingest(p.IngestRequest(1, "compact"))
        assert r1.ok and r2.ok
        assert r2.info.get("coalesced")
        srv._compact_thread.join(timeout=30)
        assert srv.stats["compactions"] == 2
        assert inj.calls("compact") == 1
        srv.close()
        return r1.info, r2.info
    twin(case)


# ----------------------------------------------------------------------
# query-path retries + batch fallback billing
# ----------------------------------------------------------------------

def test_query_retries_transient_device_fault(base_x):
    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec("device_sync",
                                                 at_calls=(1,))])
        srv = p.QueryServer(p.engine(base_x, **ENG, faults=inj),
                            retry_policy=p.RetryPolicy(max_attempts=3,
                                                       backoff_s=0.001))
        resp = srv.handle(p.QueryRequest(0, *_labels()))
        assert resp.ok
        assert srv.stats["retries"] == 1
        want = p.engine(base_x, **ENG).query(*_labels(), model="dbranch")
        np.testing.assert_array_equal(resp.result.ids, want.ids)
        return _res(resp), _ints(srv.stats)
    twin(case)


def test_batch_fallback_bills_wasted_wall(base_x):
    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec("fused_query",
                                                 at_calls=(1,))])
        srv = p.QueryServer(p.engine(base_x, **ENG, faults=inj))
        pos, neg = _labels()
        reqs = [p.QueryRequest(i, pos, neg) for i in range(3)]
        sum0 = srv.stats["latency_sum"]
        resps = srv.handle_batch(reqs)
        assert all(r.ok for r in resps)
        assert srv.stats["batch_fallbacks"] == 1
        assert srv.stats["batches"] == 0
        assert srv.stats["served"] == 3
        assert srv.stats["latency_sum"] - sum0 == pytest.approx(
            sum(r.latency_s for r in resps), rel=1e-6)
        return [_res(r) for r in resps], _ints(srv.stats)
    twin(case)


def test_batch_deadline_exceeded_short_circuits(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        pos, neg = _labels()
        dl = time.monotonic() - 0.01
        reqs = [p.QueryRequest(i, pos, neg, deadline_s=dl)
                for i in range(2)]
        resps = srv.handle_batch(reqs)
        assert all(not r.ok for r in resps)
        assert all(r.error_type == "deadline_exceeded" for r in resps)
        assert srv.stats["batch_fallbacks"] == 0
        assert srv.stats["errors"] == 2
        return [_res(r) for r in resps], _ints(srv.stats)
    twin(case)


def test_device_fault_in_window_is_internal_and_not_retried(base_x,
                                                            monkeypatch):
    """A fault of the device itself inside a window: the server does
    not retry it (only the injected transient is retryable), the
    window's per-request fallback re-runs each request on the same
    engine, where it fails again, and each is reported as ``internal``
    — no request is answered some other way."""
    import torch
    p = get_pkg("repro_torch")
    eng = p.engine(base_x, **ENG)
    calls = {"n": 0}

    def failed_launch(*a, **kw):
        calls["n"] += 1
        raise torch.AcceleratorError("CUDA error: an illegal memory "
                                     "access was encountered")
    monkeypatch.setattr(eng, "_device_scores", failed_launch)
    srv = p.QueryServer(eng, retry_policy=p.RetryPolicy(max_attempts=3,
                                                        backoff_s=0.0))
    pos, neg = _labels()
    resps = srv.handle_batch([p.QueryRequest(i, pos, neg)
                              for i in range(3)])
    assert [r.error_type for r in resps] == ["internal"] * 3
    assert not any(r.ok for r in resps)
    assert srv.stats["retries"] == 0
    assert srv.stats["batch_fallbacks"] == 1
    assert srv.stats["errors"] == 3
    assert calls["n"] == 4          # the window, then each request alone


# ----------------------------------------------------------------------
# serving-thread stat races + expired-backlog recursion
# ----------------------------------------------------------------------

class _InstantResult:
    def __init__(self):
        self.ids = np.arange(4, dtype=np.int32)
        self.scores = np.ones(4, dtype=np.float32)
        self.train_time_s = 0.0
        self.query_time_s = 0.0
        self.stats = {"host_bytes_transferred": 32}


class _InstantEngine:
    live = True

    def __init__(self):
        self._next = 1000
        self._lock = threading.Lock()

    def query(self, pos, neg, model="dbranch", deadline_s=None, **kw):
        return _InstantResult()

    def query_batch(self, batch, deadline_s=None):
        return [_InstantResult() for _ in batch]

    def append(self, feats):
        with self._lock:
            lo = self._next
            self._next += len(feats)
        return np.arange(lo, lo + len(feats))


def _ledger_holds(stats):
    return stats["admitted"] == (stats["served"] + stats["ingests"]
                                 + stats["expired_in_queue"]
                                 + stats["evicted"]
                                 + stats["shutdown_unserved"])


def test_stats_ledger_exact_under_hammer():
    """The port's server under the reference test's hammer: the exact
    ledger equalities hold over 100 server lifetimes (the interleaving
    differs run to run, so nothing is compared across packages)."""
    p = get_pkg("repro_torch")
    n_threads, per_thread = 6, 20
    for it in range(100):
        srv = p.QueryServer(_InstantEngine(), max_batch=4,
                            batch_window_s=0.0005, queue_depth=24,
                            shed_policy="reject-largest-fit")
        srv.start()
        outs, outs_lock = [], threading.Lock()

        def worker(tid, srv=srv, outs=outs, outs_lock=outs_lock):
            rng = np.random.default_rng(tid)
            local = []
            for j in range(per_thread):
                rid = tid * 1000 + j
                draw = rng.random()
                if draw < 0.2:
                    req = p.IngestRequest(
                        rid, "append",
                        features=np.zeros((2, 4), np.float32))
                elif draw < 0.4:
                    req = p.QueryRequest(
                        rid, [0], [1],
                        deadline_s=p.errors.deadline_after(0.001))
                else:
                    n = int(rng.integers(1, 30))
                    req = p.QueryRequest(rid, list(range(n)), [100])
                local.append(srv.submit(req))
            with outs_lock:
                outs.extend(local)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv.close(drain=bool(it % 2))
        resps = [o.get(timeout=10) for o in outs]
        assert len(resps) == n_threads * per_thread
        s = srv.summary()
        assert _ledger_holds(s), f"iteration {it}: ledger drifted: {s}"
        assert len(resps) == (s["admitted"] + s["rejected_overloaded"]
                              + s["rejected_rate_limited"]
                              + s["rejected_deadline"]
                              + s["submit_faults"])


def test_expired_backlog_resolves_iteratively():
    p = get_pkg("repro_torch")
    srv = p.QueryServer(_InstantEngine())
    dl = p.errors.deadline_after(2.0)
    outs = [srv.submit(p.QueryRequest(i, [0], [1], deadline_s=dl))
            for i in range(5000)]
    while time.monotonic() <= dl:
        time.sleep(0.01)
    srv.start()
    live = srv.submit(p.QueryRequest(9999, [0], [1]))
    resps = [o.get(timeout=120) for o in outs]
    assert all(r.error_type == "deadline_exceeded" for r in resps)
    assert srv.stats["expired_in_queue"] == 5000
    assert srv._thread.is_alive()
    assert live.get(timeout=120).ok
    assert _ledger_holds(srv.summary())
    srv.close()


def test_close_drain_releases_parked_hang(base_x):
    def case(p):
        p.engine(base_x, **ENG).query(*_labels(), model="dbranch")
        inj = p.FaultInjector(specs=[p.FaultSpec(
            "fused_query", action="hang", at_calls=(1,), delay_s=60.0)])
        srv = p.QueryServer(p.engine(base_x, **ENG, faults=inj))
        out = srv.submit(p.QueryRequest(0, *_labels()))
        srv.start()
        time.sleep(0.3)
        t0 = time.monotonic()
        srv.close(drain=True)
        elapsed = time.monotonic() - t0
        r = out.get(timeout=5)
        assert r.ok
        assert elapsed < 15.0, f"drain-close took {elapsed:.1f}s"
        assert srv.stats["served"] == 1
        assert srv.stats["shutdown_unserved"] == 0
        return _res(r)
    twin(case)


def test_durability_snapshot_is_locked_pair(base_x, tmp_path):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True,
                       data_dir=str(tmp_path / p.name))
        srv = p.QueryServer(eng)
        cat = eng._catalog
        assert cat.durability_snapshot()["lsn"] == cat._lsn
        stop = threading.Event()
        torn = []

        def reader():
            while not stop.is_set():
                s = srv.summary()["durable"]
                if s["wal_records"] != s["lsn"]:
                    torn.append(s)

        t = threading.Thread(target=reader)
        t.start()
        for i in range(100):
            eng.append(_data(2, seed=i))
        stop.set()
        t.join()
        assert torn == []
        assert srv.summary()["durable"]["lsn"] == 100
        plain = p.engine(base_x, **ENG, live=True)
        assert plain._catalog.durability_snapshot() is None
        assert "durable" not in p.QueryServer(plain).summary()
        srv.close()
        eng.close()
        return _ints(srv.summary()["durable"])
    twin(case)


# ----------------------------------------------------------------------
# result cache: key canonicalisation, LRU, staleness
# ----------------------------------------------------------------------

class _FakeResult:
    def __init__(self, n=8, seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, 1000, n).astype(np.int32)
        self.scores = rng.random(n).astype(np.float32)


def test_request_key_is_order_insensitive():
    def case(p):
        rk = p.cache.request_key
        a = rk([3, 1, 2], [9, 7], "dbranch", {"max_results": 10})
        b = rk([1, 2, 3], [7, 9], "dbranch", {"max_results": 10})
        assert a == b
        c = rk(np.array([2, 3, 1]), np.array([7, 9]), "dbranch",
               {"max_results": np.int64(10)})
        assert c == a
        return a
    twin(case)


def test_request_key_distinguishes_what_matters():
    def case(p):
        rk = p.cache.request_key
        base = rk([1], [2], "dbranch", {"max_results": 10})
        assert rk([1], [2], "rf", {"max_results": 10}) != base
        assert rk([1], [2], "dbranch", {"max_results": 20}) != base
        assert rk([1, 3], [2], "dbranch", {"max_results": 10}) != base
        assert rk([1], [2], "dbranch", {"seed": 0, "max_results": 10}) == \
            rk([1], [2], "dbranch", {"max_results": 10, "seed": 0})
        return base
    twin(case)


def test_request_key_bypasses_uncacheable_kwargs():
    def case(p):
        rk = p.cache.request_key
        assert rk([1], [2], "dbranch", {"callback": lambda: None}) is None
        k = rk([1], [2], "dbranch", {"opts": [1, 2, (3, "x")]})
        assert k is not None
        return k
    twin(case)


def test_full_key_tail_and_nbytes():
    def case(p):
        rk = p.cache.request_key([1], [2], "dbranch", {})
        k = p.ResultCache.full_key(rk, 7, 3)
        assert k[-2:] == (7, 3) and k[:-2] == rk
        r = _FakeResult(n=16)
        nb = p.cache.result_nbytes(r)
        assert nb == r.ids.nbytes + r.scores.nbytes + 256
        return k, nb
    twin(case)


def test_lru_evicts_by_entry_count():
    def case(p):
        c = p.ResultCache(max_entries=2)
        rks = [p.ResultCache.full_key(p.cache.request_key([i], [], "m", {}),
                                      0, 0) for i in range(3)]
        results = [_FakeResult(seed=i) for i in range(3)]
        c.put(rks[0], results[0])
        c.put(rks[1], results[1])
        assert c.get(rks[0]) is results[0]
        c.put(rks[2], results[2])
        assert c.get(rks[1]) is None
        assert c.get(rks[0]) is results[0]
        assert c.get(rks[2]) is results[2]
        assert c.counters["evictions"] == 1
        assert len(c) == 2
        return dict(c.counters)
    twin(case)


def test_lru_evicts_by_bytes():
    def case(p):
        one = p.cache.result_nbytes(_FakeResult())
        c = p.ResultCache(max_bytes=2 * one)
        for i in range(3):
            c.put(p.ResultCache.full_key(
                p.cache.request_key([i], [], "m", {}), 0, 0),
                _FakeResult(seed=i))
        assert len(c) == 2
        assert c.nbytes == 2 * one
        assert c.counters["evictions"] == 1
        st = c.stats()
        assert st["bytes"] == 2 * one and st["entries"] == 2
        return st
    twin(case)


def test_put_replaces_without_double_billing():
    def case(p):
        c = p.ResultCache()
        k = p.ResultCache.full_key(p.cache.request_key([1], [], "m", {}),
                                   0, 0)
        c.put(k, _FakeResult(seed=0))
        nb = c.nbytes
        c.put(k, _FakeResult(seed=1))
        assert c.nbytes == nb and len(c) == 1
        return nb
    twin(case)


def test_put_refuses_insert_after_epoch_moved():
    def case(p):
        c = p.ResultCache()
        k = p.ResultCache.full_key(p.cache.request_key([1], [], "m", {}),
                                   5, 0)
        assert not c.put(k, _FakeResult(), current_epoch=6, current_geom=0)
        assert len(c) == 0 and c.counters["stale_skips"] == 1
        assert c.put(k, _FakeResult(), current_epoch=5, current_geom=0)
        return dict(c.counters)
    twin(case)


def test_invalidate_epoch_reclaims_dead_entries():
    def case(p):
        c = p.ResultCache()
        fk, rk = p.ResultCache.full_key, p.cache.request_key
        old = fk(rk([1], [], "m", {}), 1, 0)
        new = fk(rk([2], [], "m", {}), 2, 0)
        c.put(old, _FakeResult(seed=0))
        c.put(new, _FakeResult(seed=1))
        assert c.invalidate_epoch(2, 0) == 1
        assert len(c) == 1 and c.get(new) is not None
        assert c.counters["stale_evictions"] == 1
        assert c.nbytes == p.cache.result_nbytes(_FakeResult(seed=1))
        return dict(c.counters)
    twin(case)


def test_get_cross_checks_stored_tail():
    def case(p):
        c = p.ResultCache()
        k = p.ResultCache.full_key(p.cache.request_key([1], [], "m", {}),
                                   3, 0)
        r = _FakeResult()
        c.put(k, r)
        r._cache_tail = (2, 0)
        assert c.get(k) is None
        assert c.counters["stale_hits"] == 1
        return dict(c.counters)
    twin(case)


# ----------------------------------------------------------------------
# result cache in the server: bitwise hits, never stale across mutations
# ----------------------------------------------------------------------

def _cached_server(p, x):
    eng = p.engine(x, **ENG, live=True)
    return eng, p.QueryServer(eng, max_results=30, cache=p.ResultCache())


def test_cache_hit_is_bitwise_uncached(base_x):
    def case(p):
        eng, srv = _cached_server(p, base_x)
        pos, neg = _labels()
        miss = srv.handle(p.QueryRequest(0, pos, neg))
        hit = srv.handle(p.QueryRequest(1, pos, neg))
        assert miss.ok and hit.ok
        assert miss.info.get("cache") != "hit"
        assert hit.info.get("cache") == "hit"
        np.testing.assert_array_equal(miss.result.ids, hit.result.ids)
        np.testing.assert_array_equal(miss.result.scores,
                                      hit.result.scores)
        assert miss.result.ids.dtype == hit.result.ids.dtype
        assert miss.result.scores.dtype == hit.result.scores.dtype
        want = p.engine(base_x, **ENG).query(pos, neg, model="dbranch",
                                             max_results=30)
        np.testing.assert_array_equal(hit.result.ids, want.ids)
        np.testing.assert_array_equal(hit.result.scores, want.scores)
        assert srv.stats["cache_served"] == 1
        assert srv.cache.stats()["stale_hits"] == 0
        return (_res(hit), str(hit.result.ids.dtype),
                str(hit.result.scores.dtype), _ints(srv.stats))
    twin(case)


@pytest.mark.parametrize("op,kw", [
    ("append", dict(features=_data(8, seed=3))),
    ("delete", dict(ids=[400])),
    ("compact", dict()),
])
def test_every_mutation_invalidates(base_x, op, kw):
    def case(p):
        eng, srv = _cached_server(p, base_x)
        if op in ("delete", "compact"):
            eng.append(_data(8, seed=9))
            srv._cache_invalidate()
        pos, neg = _labels()
        first = srv.handle(p.QueryRequest(0, pos, neg))
        assert srv.handle(p.QueryRequest(1, pos, neg)).info.get(
            "cache") == "hit"
        rc = srv.handle_ingest(p.IngestRequest(2, op, **kw))
        assert rc.ok
        if op == "compact":
            srv._compact_thread.join(timeout=30)
            srv._cache_invalidate()
        assert len(srv.cache) == 0
        again = srv.handle(p.QueryRequest(3, pos, neg))
        assert again.ok and again.info.get("cache") != "hit"
        rehit = srv.handle(p.QueryRequest(4, pos, neg))
        assert rehit.ok and rehit.info.get("cache") == "hit"
        np.testing.assert_array_equal(again.result.ids, rehit.result.ids)
        st = srv.cache.stats()
        assert st["stale_hits"] == 0
        assert st["stale_evictions"] >= 1
        return _res(first), _res(again), _ints(st)
    twin(case)


def test_batch_window_serves_hits_and_misses(base_x):
    def case(p):
        eng, srv = _cached_server(p, base_x)
        pos, neg = _labels()
        warm = srv.handle(p.QueryRequest(0, pos, neg))
        reqs = [p.QueryRequest(1, pos, neg),
                p.QueryRequest(2, list(range(5)), neg),
                p.QueryRequest(3, pos, neg)]
        resps = srv.handle_batch(reqs)
        assert [r.info.get("cache") == "hit" for r in resps] == \
            [True, False, True]
        np.testing.assert_array_equal(resps[0].result.ids, warm.result.ids)
        np.testing.assert_array_equal(resps[2].result.ids, warm.result.ids)
        assert all(r.ok for r in resps)
        resps2 = srv.handle_batch([p.QueryRequest(4, pos, neg),
                                   p.QueryRequest(5, list(range(5)), neg)])
        assert all(r.info.get("cache") == "hit" for r in resps2)
        return [_res(r) for r in resps + resps2]
    twin(case)


def test_degraded_clamp_keys_differently(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), max_results=30,
                            queue_depth=8, degraded_max_results=5,
                            cache=p.ResultCache())
        pos, neg = _labels()
        full = srv.handle(p.QueryRequest(0, pos, neg))
        srv._degraded = True
        clamped = srv.handle(p.QueryRequest(1, pos, neg))
        assert clamped.info.get("cache") != "hit"
        assert len(clamped.result.ids) == 5
        srv._degraded = False
        again = srv.handle(p.QueryRequest(2, pos, neg))
        assert again.info.get("cache") == "hit"
        assert len(again.result.ids) == len(full.result.ids)
        return _res(full), _res(clamped)
    twin(case)


def test_uncacheable_kwargs_bypass(base_x):
    def case(p):
        eng, srv = _cached_server(p, base_x)
        pos, neg = _labels()
        r = srv.handle(p.QueryRequest(0, pos, neg,
                                      kwargs={"max_results": {"bad": 1}}))
        assert not r.ok
        assert srv.cache.stats()["bypassed"] >= 1
        assert len(srv.cache) == 0
        return r.error_type
    twin(case)


def test_summary_publishes_cache_block(base_x):
    def case(p):
        eng, srv = _cached_server(p, base_x)
        pos, neg = _labels()
        srv.handle(p.QueryRequest(0, pos, neg))
        srv.handle(p.QueryRequest(1, pos, neg))
        s = srv.summary()
        assert s["cache"]["hits"] == 1
        assert s["cache"]["hit_rate"] == pytest.approx(0.5)
        assert s["cache_served"] == 1
        assert "stale_hits" in s["cache"] and s["cache"]["stale_hits"] == 0
        assert "cache" not in p.QueryServer(eng).summary()
        return _ints(s["cache"]), _ints(s)
    twin(case)
