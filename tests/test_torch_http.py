"""The port's HTTP front end (``repro_torch.serve.http``) against the
reference's, over real sockets on the CPU.

Twins of tests/test_http.py and of the HTTP cases of tests/test_trace.py,
under the same names. Each twin runs one case body through both packages
(the port's engines with ``device="cpu"``): the reference test's
assertions hold in each, and the wire bodies are equal between the two —
every key, ids and scores bitwise through the JSON round trip — apart
from wall times and minted trace ids, which are never compared.
"""
from __future__ import annotations

import contextlib
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_obs import ENG, assert_valid_exposition, get_pkg
from test_torch_serve import twin

# wire keys that carry wall times or minted ids
_VOLATILE = {"e2e_ms", "latency_ms", "train_time_s", "query_time_s",
             "trace_id"}


def _data(n=500, d=16, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, d)).astype(np.float32)


def _labels():
    return list(range(10)), list(range(100, 150))


def wire(body):
    """A JSON body without its wall times and minted trace ids."""
    return {k: v for k, v in body.items() if k not in _VOLATILE}


@pytest.fixture(scope="module")
def base_x():
    return _data()


@contextlib.contextmanager
def serving(p, srv, start_engine=True):
    if start_engine:
        srv.start()
    fe = p.HttpFrontEnd(srv)
    host, port = fe.start()
    try:
        yield f"http://{host}:{port}", fe
    finally:
        fe.close()
        srv.close(drain=False)


def post(base, path, body, headers=None, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(base, path, timeout=30):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_raw(base, path, timeout=30):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _span_names(trace_dict):
    return [s["name"] for s in trace_dict["spans"]]


# ----------------------------------------------------------------------
# end-to-end correctness
# ----------------------------------------------------------------------

def test_query_bitwise_matches_direct_engine(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        pos, neg = _labels()
        want = eng.query(pos, neg, model="dbranch", max_results=30)
        with serving(p, p.QueryServer(eng, max_results=30)) as (base, _):
            status, body, _ = post(base, "/query",
                                   {"pos_ids": pos, "neg_ids": neg})
        assert status == 200 and body["ok"]
        np.testing.assert_array_equal(
            np.asarray(body["ids"], dtype=want.ids.dtype), want.ids)
        np.testing.assert_array_equal(
            np.asarray(body["scores"], dtype=want.scores.dtype),
            want.scores)
        assert body["n_found"] == want.n_found
        assert body["model"] == "dbranch"
        assert body["e2e_ms"] >= body["latency_ms"] >= 0
        return wire(body)
    body = twin(case)
    assert len(body["ids"]) > 0


def test_cached_repeat_bitwise_and_ingest_invalidates(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=30, cache=p.ResultCache())
        pos, neg = _labels()
        q = {"pos_ids": pos, "neg_ids": neg}
        with serving(p, srv) as (base, _):
            s1, b1, _ = post(base, "/query", q)
            s2, b2, _ = post(base, "/query", q)
            assert (s1, s2) == (200, 200)
            assert b1["cache"] == "miss" and b2["cache"] == "hit"
            assert b2["ids"] == b1["ids"] and b2["scores"] == b1["scores"]
            si, bi, _ = post(base, "/ingest",
                             {"op": "append",
                              "features": _data(4, seed=7).tolist()})
            assert si == 200 and bi["info"]["rows"] == 4
            assert bi["info"]["ids"] == [500, 501, 502, 503]
            s3, b3, _ = post(base, "/query", q)
            assert s3 == 200 and b3["cache"] == "miss"
            st, summary = get(base, "/stats")
        assert st == 200
        assert summary["cache"]["stale_hits"] == 0
        assert summary["cache"]["hits"] == 1
        assert summary["cache_served"] == 1
        return [wire(b) for b in (b1, b2, bi, b3)]
    twin(case)


def test_delete_and_compact_over_http(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=10, cache=p.ResultCache())
        with serving(p, srv) as (base, _):
            s, b1, _ = post(base, "/ingest", {"op": "delete",
                                              "ids": [5, 6]})
            assert s == 200 and b1["info"]["rows"] == 2
            s, b2, _ = post(base, "/ingest", {"op": "compact"})
            assert s == 200 and b2["info"]["background"]
            s, b3, _ = post(base, "/query",
                            {"pos_ids": [0, 1, 2], "neg_ids": [100, 101]})
            assert s == 200
            assert 5 not in b3["ids"] and 6 not in b3["ids"]
        return [wire(b) for b in (b1, b2)], b3["ids"], b3["scores"]
    twin(case)


# ----------------------------------------------------------------------
# typed rejections -> HTTP statuses
# ----------------------------------------------------------------------

def test_deadline_maps_to_504(base_x):
    def case(p):
        with serving(p, p.QueryServer(p.engine(base_x, **ENG))) as (base,
                                                                    _):
            pos, neg = _labels()
            status, body, _ = post(base, "/query",
                                   {"pos_ids": pos, "neg_ids": neg,
                                    "timeout_ms": 0.001})
        assert status == 504
        assert body["error_type"] == "deadline_exceeded"
        assert not body["ok"]
        return status, wire(body)
    twin(case)


def test_overloaded_maps_to_503_with_retry_after(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), queue_depth=1)
        parked = srv.submit(p.QueryRequest(0, *_labels()))
        with serving(p, srv, start_engine=False) as (base, _):
            status, body, headers = post(base, "/query",
                                         {"pos_ids": [0], "neg_ids": [100]})
            assert status == 503
            assert body["error_type"] == "overloaded"
            assert headers.get("Retry-After") == "1"
        assert parked.get(timeout=5).error_type == "shutdown"
        return status, wire(body)
    twin(case)


def test_rate_limited_maps_to_429(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG), rate_limit=(0.001, 1))
        with serving(p, srv) as (base, _):
            q = {"pos_ids": [0, 1], "neg_ids": [100, 101]}
            s1, b1, _ = post(base, "/query", q)
            s2, body, headers = post(base, "/query", q)
            assert s1 == 200 and s2 == 429
            assert body["error_type"] == "rate_limited"
            assert headers.get("Retry-After") == "1"
            s3, b3, _ = post(base, "/query", {**q, "source": "other"})
            assert s3 == 200
        return [wire(b) for b in (b1, body, b3)]
    twin(case)


def test_shutdown_maps_to_503_and_healthz_drains(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        with serving(p, srv) as (base, _):
            assert get(base, "/healthz") == (200, {"ok": True,
                                                   "health": "ok"})
            srv.close()
            status, body, _ = post(base, "/query",
                                   {"pos_ids": [0], "neg_ids": [100]})
            assert status == 503 and body["error_type"] == "shutdown"
            hs, hb = get(base, "/healthz")
            assert hs == 503 and hb["health"] == "draining"
        return wire(body), hb
    twin(case)


# ----------------------------------------------------------------------
# transport errors
# ----------------------------------------------------------------------

def test_transport_rejections(base_x):
    def case(p):
        out = []
        with serving(p, p.QueryServer(p.engine(base_x, **ENG))) as (base,
                                                                    _):
            out.append(get(base, "/nope"))
            out.append(get(base, "/query"))
            assert [o[0] for o in out] == [404, 405]
            s, b, _ = post(base, "/healthz", {})
            assert s == 405
            out.append((s, b))
            s, b, _ = post(base, "/query", {"pos_ids": [0],
                                            "neg_ids": [1], "bogus": 2})
            assert s == 400 and "bogus" in b["error"]
            out.append((s, b))
            s, b, _ = post(base, "/query", {"pos_ids": "zero",
                                            "neg_ids": [1]})
            assert s == 400 and b["error_type"] == "bad_request"
            out.append((s, b))
            s, b, _ = post(base, "/query", {"pos_ids": [0], "neg_ids": [1],
                                            "timeout_ms": -5})
            assert s == 400
            out.append((s, b))
            s, b, _ = post(base, "/ingest", {"op": "explode"})
            assert s == 400
            out.append((s, b))
            host, port = base[7:].split(":")
            with socket.create_connection((host, int(port)),
                                          timeout=10) as c:
                c.sendall(b"POST /query HTTP/1.1\r\nContent-Length: 9\r\n"
                          b"Connection: close\r\n\r\nnot json!")
                reply = c.recv(65536).decode()
            assert reply.startswith("HTTP/1.1 400")
            out.append(reply.split("\r\n\r\n", 1)[1])
        return out
    twin(case)


def test_keep_alive_serves_multiple_requests(base_x):
    def case(p):
        payloads = []
        with serving(p, p.QueryServer(p.engine(base_x, **ENG))) as (base,
                                                                    fe):
            host, port = base[7:].split(":")
            body = json.dumps({"pos_ids": [0, 1],
                               "neg_ids": [100]}).encode()
            head = (f"POST /query HTTP/1.1\r\nHost: x\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n").encode()
            with socket.create_connection((host, int(port)),
                                          timeout=120) as c:
                f = c.makefile("rb")
                for _ in range(3):
                    c.sendall(head + body)
                    status_line = f.readline().decode()
                    assert status_line.startswith("HTTP/1.1 200")
                    clen = 0
                    while True:
                        line = f.readline()
                        if line in (b"\r\n", b""):
                            break
                        k, _, v = line.decode().partition(":")
                        if k.strip().lower() == "content-length":
                            clen = int(v)
                    payload = json.loads(f.read(clen))
                    assert payload["ok"]
                    payloads.append(wire(payload))
            stats = fe.http_stats()
        assert stats["by_route"]["/query"] == 3
        assert stats["http_2xx"] == 3
        return payloads, stats
    twin(case)


def test_stats_route_is_json_clean(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=10, cache=p.ResultCache())
        with serving(p, srv) as (base, _):
            post(base, "/query", {"pos_ids": [0, 1],
                                  "neg_ids": [100, 101]})
            status, s = get(base, "/stats")
        assert status == 200
        assert s["served"] == 1 and s["epoch"] == 0
        assert s["http"]["http_requests"] >= 1
        assert s["cache"]["entries"] == 1
        assert s["admitted"] == s["served"] + s["ingests"] + \
            s["expired_in_queue"] + s["evicted"] + s["shutdown_unserved"]
        # nothing on the wire is a tensor's str()
        leaked = [v for v in _walk(s)
                  if isinstance(v, str) and "tensor(" in v]
        assert not leaked, leaked
        return {k: v for k, v in s.items()
                if isinstance(v, (int, bool)) or k in ("health",)}
    twin(case)


def _walk(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _walk(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _walk(v)
    else:
        yield obj


def test_jsonable_sanitises_numpy():
    def case(p):
        blob = {"a": np.arange(3, dtype=np.int32),
                "b": np.float32(1.5), "c": (np.int64(2), [np.bool_(True)]),
                "d": {"nested": np.float64(0.25)}, "e": None}
        out = json.loads(json.dumps(p.http.jsonable(blob)))
        assert out == {"a": [0, 1, 2], "b": 1.5, "c": [2, [True]],
                       "d": {"nested": 0.25}, "e": None}
        return out
    twin(case)


def test_jsonable_converts_tensors_as_arrays():
    """A tensor that leaked into a payload goes on the wire as its
    values, exactly as the same ndarray does — never as its str()."""
    jsonable = get_pkg("repro_torch").http.jsonable
    a = np.array([[1.5, -2.0], [3.25, 0.0]], np.float32)
    blob = {"t": torch.from_numpy(a), "i": torch.arange(3),
            "s": torch.tensor(7), "n": [torch.tensor([True, False])]}
    out = json.loads(json.dumps(jsonable(blob)))
    assert out == {"t": jsonable(a), "i": [0, 1, 2], "s": 7,
                   "n": [[True, False]]}


def test_front_end_close_is_idempotent(base_x):
    def case(p):
        srv = p.QueryServer(p.engine(base_x, **ENG))
        srv.start()
        fe = p.HttpFrontEnd(srv)
        fe.start()
        fe.close()
        fe.close()
        srv.close()
        with pytest.raises(RuntimeError):
            fe.start()
    twin(case)


# ----------------------------------------------------------------------
# the HTTP cases of tests/test_trace.py
# ----------------------------------------------------------------------

def test_http_trace_covers_90_percent_of_wall(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=20, cache=p.ResultCache())
        pos, neg = _labels()
        with serving(p, srv) as (base, _):
            st, body, _ = post(base, "/query",
                               {"pos_ids": pos, "neg_ids": neg})
            assert st == 200 and body["ok"]
            tid = body["trace_id"]
        tr = srv.obs.traces.get(tid)
        assert tr is not None and tr["status"] == "ok"
        names = _span_names(tr)
        for required in ("admission", "queue", "fit", "device_round",
                         "rank", "cache"):
            assert required in names, (required, names)
        covered = sum(s["dur_s"] for s in tr["spans"])
        assert covered >= 0.90 * tr["wall_s"], \
            f"spans cover {covered / tr['wall_s']:.1%} of wall ({names})"
        return names, wire(body)
    twin(case)


def test_cache_hit_trace_has_cache_span_and_fresh_id(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=20, cache=p.ResultCache())
        pos, neg = _labels()
        q = {"pos_ids": pos, "neg_ids": neg}
        with serving(p, srv) as (base, _):
            _, b1, _ = post(base, "/query", q)
            _, b2, _ = post(base, "/query", q)
            assert b2["cache"] == "hit"
            assert b2["trace_id"] != b1["trace_id"]
        names = _span_names(srv.obs.traces.get(b2["trace_id"]))
        assert "cache" in names
        assert "device_round" not in names and "fit" not in names
        return names, wire(b2)
    twin(case)


def test_metrics_endpoint_is_prometheus_text(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=20, cache=p.ResultCache())
        pos, neg = _labels()
        with serving(p, srv) as (base, _):
            post(base, "/query", {"pos_ids": pos, "neg_ids": neg})
            st, ctype, raw = get_raw(base, "/metrics")
        assert st == 200
        assert ctype.startswith("text/plain")
        assert "version=0.0.4" in ctype
        text = raw.decode()
        assert_valid_exposition(text)
        for family in ("server_latency_seconds_bucket", "span_seconds_sum",
                       "request_seconds_count", "cache_hits_total",
                       "server_served"):
            assert family in text, family
        return _counts_of(text)
    twin(case)


def _counts_of(text):
    """The exposition's families and every sample that counts (never a
    time): histogram ``_count``s, and counters and gauges other than
    the ledger's time sums."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("# TYPE"):
            out.append(ln)
            continue
        if not ln or ln.startswith("#"):
            continue
        name = ln.split(" ")[0].split("{")[0]
        if name.endswith("_count") or not (
                name.endswith(("_sum", "_bucket")) or "latency" in name):
            out.append(ln)
    return sorted(out)


def test_traces_endpoint_and_x_request_id_honored(base_x):
    def case(p):
        eng = p.engine(base_x, **ENG, live=True)
        srv = p.QueryServer(eng, max_results=20)
        pos, neg = _labels()
        with serving(p, srv) as (base, _):
            st, body, hdrs = post(base, "/query",
                                  {"pos_ids": pos, "neg_ids": neg},
                                  headers={"X-Request-Id": "corr-77"})
            assert st == 200
            assert body["trace_id"] == "corr-77"
            assert hdrs.get("X-Request-Id") == "corr-77"
            st2, ctype2, raw2 = get_raw(base, "/traces?n=10")
            assert st2 == 200 and ctype2.startswith("application/json")
            payload = json.loads(raw2)
        ids = [t["trace_id"] for t in payload["traces"]]
        assert "corr-77" in ids
        tr = [t for t in payload["traces"] if t["trace_id"] == "corr-77"][0]
        assert "device_round" in _span_names(tr)
        return _span_names(tr), tr["status"], wire(body)
    twin(case)
