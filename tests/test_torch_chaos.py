"""The port's serving stack under the reference's chaos suite, on the CPU.

Twins of tests/test_chaos.py, under the same names. Each twin runs one
case body through both packages (the port's engines with
``device="cpu"``): the reference test's assertions hold in each, and the
seeded fault schedule, the outcome of every request (ids and scores
bitwise), the server's integer ledger and the per-seam call counts are
equal between the two. Every seam of the registry, ``submit`` included,
fires in the port.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import pytest

from test_torch_obs import ENG, get_pkg
from test_torch_serve import twin

GET_S = 120


def _data(n=400, d=16, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, d)).astype(np.float32)


def _qlabels(i):
    return list(range(5 + 2 * i)), list(range(100, 140 + 5 * i))


OPS = [("query", 0), ("query", 1), ("append", 0), ("query", 2),
       ("delete", 0), ("query", 3), ("compact", 0), ("query", 4),
       ("append", 1), ("query", 5), ("query", 6), ("compact", 1),
       ("query", 7)]


def _run_schedule(p, x, faults, retry):
    eng = p.engine(x, **ENG, live=True, faults=faults)
    srv = p.QueryServer(eng, retry_policy=retry, max_results=20)
    srv.start()
    results = {}
    for rid, (op, arg) in enumerate(OPS):
        if op == "query":
            pos, neg = _qlabels(arg)
            results[arg] = srv.submit(
                p.QueryRequest(rid, pos, neg)).get(timeout=GET_S)
        elif op == "append":
            r = srv.submit(p.IngestRequest(
                rid, "append",
                features=_data(30, seed=100 + arg))).get(timeout=GET_S)
            assert r.ok
        elif op == "delete":
            r = srv.submit(p.IngestRequest(
                rid, "delete", ids=range(20, 30))).get(timeout=GET_S)
            assert r.ok
        else:
            r = srv.submit(p.IngestRequest(rid, "compact")).get(
                timeout=GET_S)
            assert r.ok
            if srv._compact_thread is not None:
                srv._compact_thread.join(timeout=60)
                assert not srv._compact_thread.is_alive()
    srv.close()
    return eng, srv, results


def _chaos_injector(p, seed=5):
    return p.FaultInjector(seed=seed, specs=[
        p.FaultSpec("fused_query", prob=0.12),
        p.FaultSpec("device_sync", prob=0.12),
        p.FaultSpec("device_sync", action="slow", prob=0.1, delay_s=0.01),
        p.FaultSpec("compact", at_calls=(1,)),
        p.FaultSpec("submit", action="slow", prob=0.2, delay_s=0.005)])


def _ledger(st):
    return {k: v for k, v in st.items()
            if isinstance(v, int) and not isinstance(v, bool)}


def _outcomes(results):
    return {q: (r.ok, r.error_type,
                None if r.result is None else r.result.ids.tolist(),
                None if r.result is None else r.result.scores.tolist())
            for q, r in results.items()}


def test_chaos_schedule_parity_and_ledger():
    x = _data()

    def case(p):
        retry = p.RetryPolicy(max_attempts=5, backoff_s=0.001)
        inj = _chaos_injector(p)
        _, srv, chaos = _run_schedule(p, x, inj, retry)
        _, osrv, oracle = _run_schedule(p, x, None, None)
        assert all(r.ok for r in oracle.values())
        assert osrv.stats["errors"] == 0
        assert inj.calls("fused_query") > 0
        assert inj.calls("device_sync") > 0
        assert inj.calls("compact") >= 1
        assert inj.calls("submit") == len(OPS)
        assert len(inj.fired) > 0
        assert srv.stats["compaction_errors"] == 0
        assert srv.stats["compaction_retries"] >= 1
        assert srv.summary()["epoch"] == osrv.summary()["epoch"]
        assert srv.summary()["n_segments"] == osrv.summary()["n_segments"]
        survivors = 0
        for q, resp in chaos.items():
            if not resp.ok:
                assert resp.error_type == "transient", resp.error
                continue
            survivors += 1
            np.testing.assert_array_equal(resp.result.ids,
                                          oracle[q].result.ids)
            np.testing.assert_array_equal(resp.result.scores,
                                          oracle[q].result.scores)
        assert survivors >= len(chaos) // 2
        for s in (srv, osrv):
            st = s.stats
            assert st["admitted"] == (st["served"] + st["ingests"]
                                      + st["expired_in_queue"]
                                      + st["evicted"]
                                      + st["shutdown_unserved"])
            assert st["errors"] <= st["served"]
            assert st["shutdown_unserved"] == 0
        return (_ledger(srv.stats), _ledger(osrv.stats),
                sorted((r.site, r.call, r.action) for r in inj.fired),
                {s: inj.calls(s) for s in ("fused_query", "device_sync",
                                           "compact", "submit")},
                _outcomes(chaos), _outcomes(oracle))
    twin(case)


def test_chaos_schedule_replays_bitwise():
    x = _data()

    def case(p):
        runs = []
        for _ in range(2):
            retry = p.RetryPolicy(max_attempts=5, backoff_s=0.001)
            inj = _chaos_injector(p)
            _, _, results = _run_schedule(p, x, inj, retry)
            runs.append((sorted((r.site, r.call, r.action)
                                for r in inj.fired),
                         {q: (r.ok, r.error_type)
                          for q, r in results.items()}))
        assert runs[0][0] == runs[1][0]
        assert runs[0][1] == runs[1][1]
        return runs[0]
    twin(case)


def test_chaos_server_survives_every_fault_site():
    x = _data(200)
    pos, neg = list(range(8)), list(range(100, 130))

    def case(p):
        out = []
        for site, op in [("append", "ingest"), ("delete", "ingest"),
                         ("fused_query", "query"), ("device_sync", "query"),
                         ("submit", "submit")]:
            inj = p.FaultInjector(specs=[p.FaultSpec(site, at_calls=(1,))])
            eng = p.engine(x, **ENG, live=True, faults=inj)
            srv = p.QueryServer(eng, faults=inj)
            epoch0 = eng._catalog.epoch
            if op == "ingest":
                kind = "append" if site == "append" else "delete"
                r = srv.handle_ingest(p.IngestRequest(
                    0, kind, features=_data(10, seed=9), ids=[0, 1]))
                assert not r.ok and r.error_type == "transient"
                assert eng._catalog.epoch == epoch0
                assert srv.stats["ingest_errors"] == 1
            elif op == "query":
                r = srv.handle(p.QueryRequest(0, pos, neg))
                assert not r.ok and r.error_type == "transient"
            else:
                srv.start()
                r = srv.submit(p.QueryRequest(0, pos, neg)).get(
                    timeout=GET_S)
                assert not r.ok and r.error_type == "transient"
                assert srv.stats["submit_faults"] == 1
            if op == "submit":
                r2 = srv.submit(p.QueryRequest(1, pos, neg)).get(
                    timeout=GET_S)
            else:
                r2 = srv.handle(p.QueryRequest(1, pos, neg))
            assert r2.ok
            srv.close()
            out.append((site, r.error_type, r2.result.ids.tolist(),
                        r2.result.scores.tolist(), _ledger(srv.stats)))
        return out
    twin(case)


def test_injected_hang_released_by_close():
    x = _data(200)

    def case(p):
        inj = p.FaultInjector(specs=[p.FaultSpec(
            "fused_query", action="hang", at_calls=(1,), delay_s=60.0)])
        srv = p.QueryServer(p.engine(x, **ENG, faults=inj))
        p.engine(x, **ENG).query(list(range(8)), list(range(100, 130)),
                                 model="dbranch")
        srv.start()
        out = srv.submit(p.QueryRequest(0, list(range(8)),
                                        list(range(100, 130))))
        time.sleep(0.3)
        t0 = time.monotonic()
        srv.close(drain=False)
        assert time.monotonic() - t0 < 30.0
        resp = out.get(timeout=GET_S)
        assert resp.request_id == 0
    twin(case)


def test_every_registered_seam_is_reachable_and_fires():
    x = _data(200)
    pos, neg = list(range(8)), list(range(100, 130))

    def case(p):
        sites = p.faults.SITES
        inj = p.FaultInjector(specs=[
            p.FaultSpec(site, action="slow", at_calls=(1,), delay_s=0.0)
            for site in sites])
        with tempfile.TemporaryDirectory() as d:
            eng = p.engine(x, **ENG, live=True, faults=inj,
                           data_dir=d, wal_sync="always")
            srv = p.QueryServer(eng, faults=inj)
            srv.start()
            r = srv.submit(p.QueryRequest(0, pos, neg)).get(timeout=GET_S)
            assert r.ok
            srv.close()
            eng.append(_data(10, seed=9))
            eng.delete([3, 4])
            eng.compact()
            eng.append(_data(5, seed=10))
            eng.close()
            cat = p.open_catalog(d, faults=inj)
            assert cat.recovery.clean
            cat.close()
        fired_sites = {r.site for r in inj.fired}
        missing = sorted(set(sites) - fired_sites)
        assert not missing, f"registered seams never fired: {missing}"
        for site in sites:
            assert inj.calls(site) >= 1
        return {site: inj.calls(site) for site in sites}
    calls = twin(case)
    assert calls["submit"] >= 1


def test_seam_registry_rejects_unknown_sites_both_directions():
    def case(p):
        with pytest.raises(ValueError, match="unknown fault site"):
            p.FaultSpec("no_such_seam", at_calls=(1,))
        inj = p.FaultInjector()
        with pytest.raises(ValueError, match="unregistered site"):
            inj.check("no_such_seam")
    twin(case)
    assert get_pkg("repro_torch").faults.SITES == \
        get_pkg("repro").faults.SITES
