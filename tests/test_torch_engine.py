"""The port's SearchEngine against the reference's, end to end on the CPU.

Both engines run the static single-device survivor-sparse configuration
with the numpy trainers (``use_jax_fit=False``) on the same seeded data
and labels. Ranked ids and scores must be bitwise equal, and so must the
integer stats that pin the device path's contracts: one stat sync per
round, overflow retries, gather pricing, host bytes and tile memory.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.engine import SearchEngine as JaxEngine
from repro_torch.core import SearchEngine
from repro_torch.core.index import build_index

STATS = ("n_host_syncs", "retried_subsets", "blocks_touched",
         "blocks_gathered", "bytes_touched", "host_bytes_transferred",
         "score_buffer_bytes_peak", "score_rows")
KW = dict(n_subsets=8, block=64, seed=0, use_jax_fit=False)


def _clustered(n=3000, d=24, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5.0, (16, d)).astype(np.float32)
    assign = rng.integers(0, 16, n)
    x = (centers[assign] + rng.normal(0, 0.3, (n, d))).astype(np.float32)
    return x, (assign == 0).astype(np.int32)


@pytest.fixture(params=["catalog", "blob_data", "clustered"])
def data(request):
    """(features, labels, positive ids, negative ids)."""
    if request.param == "clustered":
        x, y = _clustered()
    else:
        x, y = request.getfixturevalue(request.param)
    if request.param == "catalog":
        y = (y == 1).astype(np.int32)
    rng = np.random.default_rng(1)
    pos = rng.choice(np.nonzero(y == 1)[0], 10, replace=False)
    neg = rng.choice(np.nonzero(y == 0)[0], 40, replace=False)
    return np.asarray(x, np.float32), y, pos, neg


def _same(a, b, batched=False):
    assert a.model == b.model
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    for k in STATS:
        key = "batch_" + k if batched else k
        assert a.stats[key] == b.stats[key], key
    assert a.stats["n_boxes"] == b.stats["n_boxes"]


def _engines(x, **kw):
    opts = {**KW, **kw}
    return JaxEngine(x, **opts), SearchEngine(x, device="cpu", **opts)


@pytest.mark.parametrize("model", ["dbranch", "dbens"])
def test_query_matches_reference(data, model):
    x, _, pos, neg = data
    je, te = _engines(x)
    for mr in (None, 10):
        for inc in (False, True):
            kw = dict(model=model, max_results=mr, include_training=inc,
                      n_models=6)
            _same(te.query(pos, neg, **kw), je.query(pos, neg, **kw))


def test_query_batch_matches_reference(data):
    x, y, pos, neg = data
    rng = np.random.default_rng(2)
    reqs = []
    for i, (model, mr, inc) in enumerate([("dbranch", 10, False),
                                          ("dbens", 25, True),
                                          ("dbranch", 3, True),
                                          ("dbens", 10, False)]):
        p = rng.choice(np.nonzero(y == 1)[0], 8 + i, replace=False)
        n = rng.choice(np.nonzero(y == 0)[0], 30, replace=False)
        reqs.append({"pos_ids": p, "neg_ids": n, "model": model,
                     "max_results": mr, "include_training": inc,
                     "n_models": 5, "seed": i})
    je, te = _engines(x)
    for batch in (reqs,                                    # device-ranked
                  [dict(r, max_results=None) if i == 2 else r
                   for i, r in enumerate(reqs)]):          # host-ranked
        for a, b in zip(te.query_batch(batch), je.query_batch(batch)):
            _same(a, b, batched=True)


def test_overflow_retry_matches_reference():
    """capacity_frac=1/64 under-sizes every cold gather: the first round
    overflows, the retry round re-runs only those subsets, and the hints
    then size later queries right."""
    x, y = _clustered()
    pos = np.nonzero(y == 1)[0][:12]
    neg = np.nonzero(y == 0)[0][:50]
    je, te = _engines(x, capacity_frac=1 / 64)
    first = te.query(pos, neg, model="dbens", max_results=20, n_models=5)
    assert first.stats["retried_subsets"] > 0
    assert first.stats["n_host_syncs"] == 2
    _same(first, je.query(pos, neg, model="dbens", max_results=20,
                          n_models=5))
    for model in ("dbranch", "dbens"):
        _same(te.query(pos, neg, model=model, n_models=5),
              je.query(pos, neg, model=model, n_models=5))
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": "dbens",
             "max_results": 7, "n_models": 4}]
    _same(te.query_batch(reqs)[0], je.query_batch(reqs)[0], batched=True)


def test_from_arrays_engine_matches():
    """An engine assembled from the reference engine's state answers as
    the port's own engine and as the reference."""
    x, y = _clustered(n=2000, seed=9)
    je, te = _engines(x)
    fields = ("dims", "perm", "rows", "zlo", "zhi", "block", "n_rows",
              "subset_id")
    fe = SearchEngine.from_arrays(
        je.x, je.subsets,
        [{f: getattr(ix, f) for f in fields} for ix in je.indexes],
        je.frange, device="cpu")
    pos = np.nonzero(y == 1)[0][:10]
    neg = np.nonzero(y == 0)[0][:30]
    for model in ("dbranch", "dbens"):
        kw = dict(model=model, max_results=15, n_models=5)
        want = je.query(pos, neg, **kw)
        _same(fe.query(pos, neg, **kw), want)
        _same(te.query(pos, neg, **kw), want)
    res = fe.query(pos[:6], neg[:10])
    _same(fe.refine(res, pos[6:], neg[10:], pos[:6], neg[:10]),
          je.refine(res, pos[6:], neg[10:], pos[:6], neg[:10]))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.core import SearchEngine\n"
        "x = np.random.default_rng(0).normal(size=(600, 12))"
        ".astype(np.float32)\n"
        "e = SearchEngine(x, n_subsets=4, block=64, device='cpu')\n"
        "r = e.query(range(8), range(100, 130), max_results=5)\n"
        "assert r.n_found > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    x, _ = _clustered(n=300)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine(x, n_subsets=2, block=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(x, np.arange(6), block=64)


@pytest.mark.parametrize("opt,item", [
    ({"use_jax_fit": True}, "A5"), ({"score_mode": "dense"}, "A3/A4"),
    ({"mirror": "quantized"}, "A10"), ({"n_shards": 2}, "A11"),
    ({"live": True}, "A7/A8"), ({"data_dir": "somewhere"}, "A7/A8"),
    ({"use_fused": False}, "A6"), ({"faults": object()}, "A9")])
def test_unported_options_raise(opt, item):
    x, _ = _clustered(n=300)
    with pytest.raises(NotImplementedError, match=item):
        SearchEngine(x, n_subsets=2, block=64, device="cpu", **opt)


@pytest.mark.parametrize("model", ["dtree", "rforest", "knn"])
def test_unported_models_raise(model):
    x, y = _clustered(n=600)
    te = SearchEngine(x, n_subsets=2, block=64, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        te.query(range(5), range(100, 120), model=model)
    out = te.query_batch([{"pos_ids": range(5), "neg_ids": range(100, 120),
                           "model": model}])
    assert isinstance(out[0], NotImplementedError)
