"""The serving cases of tests/test_serve_features.py through both
packages, and the port's serving entry points, on the CPU.

Twins of the non-sharded serving cases (``test_server_handles_request``,
``test_server_error_isolation``, ``test_server_threaded_batching``,
``test_merge_shard_results``), under the same names, by
tests/test_torch_serve.py's ``twin``: each case body runs on the port
(``device="cpu"``) and on the reference, and what it returns is equal.
The sharded case waits for the sharded engine (ROADMAP A11); the feature
extraction cases are held by tests/test_torch_features.py. The CLI entry
points run on the CPU only when asked, and without a card refuse.
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_serve import _res, twin


@pytest.fixture(scope="module")
def small_x(catalog):
    feats, labels = catalog
    return feats[:800], labels[:800]


def _small_engine(p, feats):
    return p.engine(feats, n_subsets=8, subset_dim=5, block=64)


def test_server_handles_request(small_x):
    feats, labels = small_x

    def case(p):
        srv = p.QueryServer(_small_engine(p, feats))
        pos = np.nonzero(labels == 2)[0][:10]
        neg = np.nonzero(labels != 2)[0][:40]
        resp = srv.handle(p.QueryRequest(0, pos, neg, "dbranch"))
        assert resp.ok and resp.result is not None
        assert resp.latency_s > 0
        return _res(resp)
    twin(case)


def test_server_error_isolation(small_x):
    feats, _ = small_x

    def case(p):
        srv = p.QueryServer(_small_engine(p, feats))
        good = p.QueryRequest(0, [1, 2, 3], [10, 11], "dbranch")
        bad = p.QueryRequest(1, [1], [2], "not_a_model")
        out = srv.handle_batch([good, bad])
        assert out[0].ok and not out[1].ok
        assert "not_a_model" in out[1].error
        assert srv.stats["errors"] == 1
        return [_res(r) for r in out], out[1].error
    twin(case)


def test_server_threaded_batching(small_x):
    feats, labels = small_x

    def case(p):
        srv = p.QueryServer(_small_engine(p, feats), max_batch=4)
        srv.start()
        pos = np.nonzero(labels == 2)[0][:8]
        neg = np.nonzero(labels != 2)[0][:30]
        pending = [srv.submit(p.QueryRequest(i, pos, neg, "dbranch"))
                   for i in range(5)]
        resps = []
        for i, q in enumerate(pending):
            resp = q.get(timeout=120)
            assert resp.ok and resp.request_id == i
            resps.append(resp)
        srv.close()
        assert srv.summary()["served"] == 5
        return [_res(r) for r in resps]
    twin(case)


def test_merge_shard_results():
    def case(p):
        r1 = p.QueryResult("dbranch", np.asarray([2, 0]),
                           np.asarray([5.0, 1.0]), 0, 0)
        r2 = p.QueryResult("dbranch", np.asarray([1]), np.asarray([3.0]),
                           0, 0)
        ids, scores = p.merge_shard_results([r1, r2], [0, 100])
        np.testing.assert_array_equal(ids, [2, 101, 0])
        np.testing.assert_array_equal(scores, [5.0, 3.0, 1.0])
        return ids.tolist(), scores.tolist()
    twin(case)


# ----------------------------------------------------------------------
# the serving entry points
# ----------------------------------------------------------------------

def test_launch_serve_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--rows", "600", "--queries", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 queries in" in out and "errors 0" in out


def test_serving_entry_points_refuse_without_cuda():
    """The CLI entry points default to CUDA: without a card they raise
    before serving anything, never falling back to the CPU."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serve import http
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--rows", "600", "--queries", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        http.main(["--n", "600", "--port", "0"])
