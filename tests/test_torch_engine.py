"""The port's SearchEngine against the reference's, end to end on the CPU.

Both engines run the static single-device configuration with the numpy
trainers (``use_jax_fit=False``) on the same seeded data and labels. For
dbranch/dbens on the survivor-sparse path, ranked ids and scores must be
bitwise equal, and so must the integer stats that pin the device path's
contracts: one stat sync per round, overflow retries, gather pricing,
host bytes and tile memory. For the scan models (dtree, rforest), the
knn model and the use_fused=False host oracle, the whole result is
bitwise equal, stats included.

knn on float data: the reference sums squared differences with
``jnp.sum`` and the port in ascending dim order, so distances may differ
in the last bit; a vote count moves only if that swaps a row across the
k-th neighbour. At these seeds none does and the results are equal; on
integer-valued features the arithmetic is exact and so must they be.
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


def _same_all(a, b):
    """Model, ids, scores (dtypes too) and the whole stats dict equal."""
    if isinstance(b, Exception):
        assert type(a) is type(b), (a, b)
        return
    assert a.model == b.model
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.stats == b.stats


@pytest.fixture(scope="module")
def int_catalog(catalog):
    """The catalog's features on a grid of quarters: squared distances
    are exact in f32, with many exact ties."""
    x, y = catalog
    return np.round(np.asarray(x, np.float32) * 4).astype(np.float32) / 4, y


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


def test_from_arrays_host_oracle_engine_matches():
    """A use_fused=False engine assembled from the reference's state
    answers all five models as the reference's use_fused=False engine
    and as the port's own."""
    x, y = _clustered(n=2000, seed=9)
    je, te = _engines(x, use_fused=False)
    fields = ("dims", "perm", "rows", "zlo", "zhi", "block", "n_rows",
              "subset_id")
    fe = SearchEngine.from_arrays(
        je.x, je.subsets,
        [{f: getattr(ix, f) for f in fields} for ix in je.indexes],
        je.frange, device="cpu", use_fused=False)
    assert not fe.use_fused
    pos = np.nonzero(y == 1)[0][:10]
    neg = np.nonzero(y == 0)[0][:30]
    for model in ("dbranch", "dbens", "dtree", "rforest", "knn"):
        kw = dict(model=model, max_results=15, n_models=5)
        want = je.query(pos, neg, **kw)
        _same_all(fe.query(pos, neg, **kw), want)
        _same_all(te.query(pos, neg, **kw), want)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.core import SearchEngine\n"
        "x = np.random.default_rng(0).normal(size=(600, 12))"
        ".astype(np.float32)\n"
        "e = SearchEngine(x, n_subsets=4, block=64, device='cpu')\n"
        "r = e.query(range(8), range(100, 130), max_results=5)\n"
        "assert r.n_found > 0\n"
        "for m in ('dtree', 'knn'):\n"
        "    assert e.query(range(8), range(100, 130), model=m).n_found\n"
        "from repro_torch.configs.base import ModelConfig\n"
        "from repro_torch.features import extract, vit\n"
        "from repro_torch.data.synthetic import PatchDatasetConfig, "
        "generate_patches\n"
        "cfg = ModelConfig(name='t', family='vit', num_layers=1, d_model=16,"
        " vocab_size=0, num_heads=2, num_kv_heads=2, d_ff=32)\n"
        "imgs = generate_patches(PatchDatasetConfig(n_patches=5, "
        "patch_size=16))['images']\n"
        "import torch\n"
        "m = vit.init_vit(cfg, image_size=16, patch_size=8, "
        "generator=torch.Generator().manual_seed(0), device='cpu')\n"
        "f = extract.extract_catalog(imgs, extract.vit_feature_fn(m), "
        "batch=4, device='cpu')\n"
        "assert f.shape == (5, 32)\n"
        "import json, urllib.request\n"
        "from repro_torch.serve import HttpFrontEnd, QueryServer, "
        "ResultCache\n"
        "srv = QueryServer(SearchEngine(x, n_subsets=4, block=64, "
        "live=True, device='cpu'), max_results=5, cache=ResultCache())\n"
        "srv.start()\n"
        "fe = HttpFrontEnd(srv)\n"
        "host, port = fe.start()\n"
        "base = f'http://{host}:{port}'\n"
        "req = urllib.request.Request(base + '/query', method='POST', "
        "data=json.dumps({'pos_ids': list(range(8)), "
        "'neg_ids': list(range(100, 130))}).encode())\n"
        "body = json.loads(urllib.request.urlopen(req, timeout=60).read())\n"
        "assert body['ok'] and body['ids'] == r.ids.tolist(), body\n"
        "text = urllib.request.urlopen(base + '/metrics', timeout=60)"
        ".read().decode()\n"
        "assert 'profile_seconds_count{site=\"device_sync\"}' in text\n"
        "fe.close()\n"
        "srv.close()\n"
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
    from repro_torch.configs import get_config
    from repro_torch.features.extract import (extract_catalog,
                                              extraction_throughput)
    from repro_torch.features.vit import ViT, init_vit
    cfg = get_config("rapidearth-vit-t")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViT(cfg, image_size=64, patch_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_vit(cfg, image_size=64, patch_size=16,
                 generator=torch.Generator().manual_seed(0))
    imgs = np.zeros((2, 64, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_catalog(imgs, lambda t: t, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extraction_throughput(lambda t: t, imgs, batch=2)


def _unknown_fault_site():
    from repro_torch.serve import FaultInjector, FaultSpec
    return {"faults": FaultInjector(specs=[FaultSpec("no_such_site")])}


# ids kept as they were before ported options left or changed this list
# (live=True alone is ported: its case now asks for a live sharded
# catalog). data_dir and faults are ported: their cases now hold the
# reference's refusals — data_dir without live=True, and a fault spec
# naming an unknown site (FaultSpec rejects it, as the reference's does)
@pytest.mark.parametrize("opt,exc,match", [
    pytest.param(lambda: {"mirror": "quantized"}, NotImplementedError,
                 "A10", id="opt2-A10"),
    pytest.param(lambda: {"n_shards": 2}, NotImplementedError, "A11",
                 id="opt3-A11"),
    pytest.param(lambda: {"live": True, "n_shards": 2}, NotImplementedError,
                 "A11", id="opt4-A7/A8"),
    pytest.param(lambda: {"data_dir": "somewhere"}, ValueError,
                 "data_dir requires live=True", id="opt5-A7/A8"),
    pytest.param(_unknown_fault_site, ValueError, "unknown fault site",
                 id="opt6-A9")])
def test_unported_options_raise(opt, exc, match):
    x, _ = _clustered(n=300)
    with pytest.raises(exc, match=match):
        SearchEngine(x, n_subsets=2, block=64, device="cpu", **opt())
    if exc is ValueError:
        # the reference refuses the same arguments the same way
        with pytest.raises(exc, match=match):
            JaxEngine(x, n_subsets=2, block=64, **opt())


@pytest.mark.parametrize("opt", [{"use_jax_fit": True},
                                 {"score_mode": "dense"}])
def test_ported_options_work(opt):
    """The two options that used to raise (A5, A3/A4) now build an engine
    that answers as the reference's with the same options."""
    x, y = _clustered(n=600)
    kw = dict(n_subsets=4, block=64, seed=0, **opt)
    te = SearchEngine(x, device="cpu", **kw)
    je = JaxEngine(x, **kw)
    pos, neg = np.nonzero(y == 1)[0][:8], np.nonzero(y == 0)[0][:30]
    for mr in (None, 10):
        got = te.query(pos, neg, max_results=mr)
        _same(got, je.query(pos, neg, max_results=mr))
        assert got.n_found > 0
        assert got.stats["fit_path"] == "jax"


@pytest.mark.parametrize("model", ["dtree", "rforest", "knn"])
def test_scan_and_knn_models_match_reference(data, model):
    """query() of the full-scan models and of knn: ids, scores and stats
    (path, bytes_touched, n_boxes) bitwise, with and without max_results
    and training rows."""
    x, _, pos, neg = data
    je, te = _engines(x)
    for mr in (None, 10):
        for inc in (False, True):
            kw = dict(model=model, max_results=mr, include_training=inc,
                      n_models=6, k_neighbors=300)
            got = te.query(pos, neg, **kw)
            _same_all(got, je.query(pos, neg, **kw))
            assert got.n_found > 0
    assert te.feature_mirror_bytes() == (0 if model == "knn" else x.nbytes)


@pytest.mark.parametrize("k_neighbors", [1000, 40])
def test_knn_exact_on_integer_catalog(int_catalog, k_neighbors):
    x, y = int_catalog
    rng = np.random.default_rng(3)
    pos = rng.choice(np.nonzero(y == 1)[0], 12, replace=False)
    neg = rng.choice(np.nonzero(y != 1)[0], 40, replace=False)
    je, te = _engines(x)
    for mr in (None, 25):
        kw = dict(model="knn", max_results=mr, k_neighbors=k_neighbors)
        got = te.query(pos, neg, **kw)
        _same_all(got, je.query(pos, neg, **kw))
        assert got.stats == {"path": "index",
                             "bytes_touched": te.indexes[0].rows.nbytes}
        assert got.train_time_s == 0.0


def test_scan_models_refine_and_batch(data):
    """refine() of a scan model, and query_batch() of the models that
    query() answers one by one."""
    x, y, pos, neg = data
    je, te = _engines(x)
    res = te.query(pos[:6], neg[:20], model="rforest", n_models=5)
    _same_all(te.refine(res, pos[6:], neg[20:], pos[:6], neg[:20],
                        n_models=5),
              je.refine(res, pos[6:], neg[20:], pos[:6], neg[:20],
                        n_models=5))
    rng = np.random.default_rng(4)
    reqs = []
    for i, (model, mr, inc) in enumerate([("dtree", None, False),
                                          ("knn", 20, True),
                                          ("rforest", 10, False),
                                          ("knn", None, False),
                                          ("dtree", 5, True)]):
        p = rng.choice(np.nonzero(y == 1)[0], 8 + i, replace=False)
        n = rng.choice(np.nonzero(y == 0)[0], 30, replace=False)
        reqs.append({"pos_ids": p, "neg_ids": n, "model": model,
                     "max_results": mr, "include_training": inc,
                     "n_models": 4, "seed": i, "k_neighbors": 200})
    got = te.query_batch(reqs)
    for a, b in zip(got, je.query_batch(reqs)):
        _same_all(a, b)


@pytest.mark.parametrize("model", ["dbranch", "dbens"])
def test_host_oracle_engine_matches_reference(data, model):
    """use_fused=False: the host query_index oracle. Ids, scores and the
    aggregated stats bitwise the reference's use_fused=False engine, and
    ranked ids equal to the port's fused engine on the same requests."""
    x, y, pos, neg = data
    je, te = _engines(x, use_fused=False)
    fused = SearchEngine(x, device="cpu", **KW)
    for mr in (None, 10):
        for inc in (False, True):
            kw = dict(model=model, max_results=mr, include_training=inc,
                      n_models=6)
            got = te.query(pos, neg, **kw)
            _same_all(got, je.query(pos, neg, **kw))
            assert got.n_found > 0 and got.stats["n_range_queries"] > 0
            ref = fused.query(pos, neg, **kw)
            np.testing.assert_array_equal(got.ids, ref.ids)
            np.testing.assert_array_equal(got.scores, ref.scores)
    rng = np.random.default_rng(7)
    reqs = [{"pos_ids": rng.choice(np.nonzero(y == 1)[0], 8, replace=False),
             "neg_ids": rng.choice(np.nonzero(y == 0)[0], 30, replace=False),
             "model": model, "max_results": mr, "n_models": 4, "seed": i}
            for i, mr in enumerate((None, 12, None))]
    for a, b, c in zip(te.query_batch(reqs), je.query_batch(reqs),
                       fused.query_batch(reqs)):
        _same_all(a, b)
        np.testing.assert_array_equal(a.ids, c.ids)


def test_mixed_batch_isolates_failures():
    """A batch of dbens, knn, dtree and a request with a bad id returns
    each result in place and the bad request's exception in its slot,
    like the reference."""
    x, y = _clustered(n=2000, seed=11)
    pos = np.nonzero(y == 1)[0][:10]
    neg = np.nonzero(y == 0)[0][:30]
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": "dbens",
             "n_models": 4, "max_results": 20},
            {"pos_ids": pos, "neg_ids": neg, "model": "knn"},
            {"pos_ids": pos, "neg_ids": neg, "model": "dtree",
             "max_results": 30},
            {"pos_ids": [len(x) + 5], "neg_ids": neg, "model": "dtree"},
            {"pos_ids": pos, "neg_ids": neg, "model": "nope"}]
    for uf in (True, False):
        je, te = _engines(x, use_fused=uf)
        got = te.query_batch(reqs)
        want = je.query_batch(reqs)
        assert isinstance(got[3], IndexError)
        assert isinstance(got[4], ValueError)
        for a, b in zip(got, want):
            if uf and not isinstance(b, Exception) and b.model == "dbens":
                _same(a, b, batched=True)        # the fused batch's stats
            else:
                _same_all(a, b)
