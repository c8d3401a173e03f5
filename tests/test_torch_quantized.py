"""The port's quantized mirror (``mirror="quantized"``) against the
reference's, on the CPU.

Twins of tests/test_sparse_scores.py's quantized cases: the code-space
prune is conservative (the port's thresholds held to the reference's
formula and to the exact f32 predicate), the f16 zone widening goes
outward (and the whole compressed mirror is byte-equal to the
reference's), the quantized engine is bitwise the dense one — and the
reference's quantized engine, integer stats included — and the
reference's refusals. Integers are compared bitwise. The ``gpu``-marked
case runs the engine on the card against the CPU and skips without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import index as jindex
from repro.core.engine import SearchEngine as JaxEngine
from repro_torch.core import SearchEngine
from repro_torch.core import index as tindex

SEED = 7
ENG_KW = dict(n_subsets=8, subset_dim=4, block=64)
STATS = ("n_host_syncs", "retried_subsets", "blocks_touched",
         "blocks_gathered", "blocks_total", "bytes_touched",
         "host_bytes_transferred", "score_buffer_bytes_peak", "score_rows",
         "n_boxes", "n_range_queries", "scan_bytes_equiv")


def _data(n=3000, d=12, seed=SEED):
    rng = np.random.default_rng(seed)
    # half-integer grid values force heavy score ties downstream
    x = (rng.integers(0, 6, size=(n, d)) / 2.0).astype(np.float32)
    x += rng.normal(scale=1e-3, size=(n, d)).astype(np.float32)
    pos = rng.choice(n, 12, replace=False)
    neg = rng.choice(np.setdiff1d(np.arange(n), pos), 25, replace=False)
    return x, pos, neg


def _same(a, b, batched=False):
    """Ranked ids and scores bitwise, and the integer stats equal."""
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    for k in STATS:
        k = f"batch_{k}" if batched else k
        if k in a.stats or k in b.stats:
            assert a.stats[k] == b.stats[k], (k, a.stats[k], b.stats[k])


# ----------------------------------------------------------------------
# the code-space thresholds: conservative, and the reference's formula
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 12, 13])
def test_quantized_prune_is_conservative_property(seed):
    """For random rows, quantization grids and (lo, hi] boxes, every row
    the exact f32 predicate admits, the int8 code-space test with the
    port's thresholds admits too; and those thresholds are bitwise the
    reference test's numpy formula."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n, d = 64, 3
        x = rng.normal(scale=rng.uniform(0.1, 10), size=(n, d)) \
            .astype(np.float32)
        lo0, hi0 = x.min(0), x.max(0)
        scale = np.maximum((hi0 - lo0) / 254.0, 1e-12).astype(np.float32)
        t = np.clip(np.round((x - lo0) / scale), 0, 254).astype(np.float32)
        lo = (x[rng.integers(0, n)] - rng.uniform(0, 1, d)) \
            .astype(np.float32)
        hi = (lo + rng.uniform(0, 2, d)).astype(np.float32)
        tlo, thi = tindex.code_thresholds(
            torch.from_numpy(lo[None]), torch.from_numpy(hi[None]),
            torch.from_numpy(lo0), torch.from_numpy(scale))
        np.testing.assert_array_equal(
            tlo.numpy()[0], np.floor((lo - lo0) / scale) - 1.0)
        np.testing.assert_array_equal(
            thi.numpy()[0], np.ceil((hi - lo0) / scale) + 1.0)
        exact = np.all((x > lo) & (x <= hi), axis=1)
        coded = np.all((t > tlo.numpy()) & (t <= thi.numpy()), axis=1)
        assert np.all(coded[exact]), "conservative prune dropped a member"


@pytest.mark.parametrize("n,block,capacity", [(3000, 64, 47),
                                              (3000, 64, 8),
                                              (777, 32, 25)])
def test_quantized_probe_and_compact_match_reference(n, block, capacity):
    """quantized_probe (gids, cmask, stats) and quantized_compact
    bitwise the reference's, over boxes with open (+-inf) sides and the
    impossible pad boxes; the candidate mask covers every row the exact
    f32 boxes hold."""
    x, _, _ = _data(n=n)
    dims = np.array([0, 3, 5, 8])
    jix = jindex.build_index(x, dims, block=block)
    tix = tindex.build_index(x, dims, block=block, device="cpu")
    rng = np.random.default_rng(n + capacity)
    c = x[rng.choice(n, 5, replace=False)][:, dims]
    lo = (c - rng.uniform(0.2, 1.0, c.shape)).astype(np.float32)
    hi = (c + rng.uniform(0.2, 1.0, c.shape)).astype(np.float32)
    lo[1, 2], hi[3, 0] = -np.inf, np.inf
    lo, hi, _ = tindex.pad_boxes(lo, hi, None)
    want = jindex.quantized_probe(jix, jnp.asarray(lo), jnp.asarray(hi),
                                  capacity=capacity)
    got = tindex.quantized_probe(tix, torch.from_numpy(lo),
                                 torch.from_numpy(hi), capacity=capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_hit, ncand = (int(v) for v in got[2])
    rcap = 1 << max(ncand - 1, 0).bit_length()
    wc, wn = jindex.quantized_compact(want[0], want[1], row_capacity=rcap)
    gc, gn = tindex.quantized_compact(got[0], got[1], row_capacity=rcap)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gn) == int(wn) == ncand
    if n_hit <= capacity:
        inside = np.zeros(n, bool)
        for b in range(len(lo)):
            inside |= np.all((x[:, dims] > lo[b]) & (x[:, dims] <= hi[b]), 1)
        assert np.isin(np.nonzero(inside)[0], gc.numpy()).all()


def test_quantized_recheck_matches_reference():
    x, _, _ = _data(n=500)
    rng = np.random.default_rng(3)
    cg = np.full(64, -1, np.int32)
    cg[:40] = rng.choice(500, 40, replace=False)
    xsub = np.full((64, 12), np.inf, np.float32)
    xsub[:40] = x[cg[:40]]
    lo = (x[:3] - 0.6).astype(np.float32)
    hi = (x[:3] + 0.6).astype(np.float32)
    oh = np.eye(3, 2, dtype=np.float32)
    want = jindex.quantized_recheck(*(jnp.asarray(a)
                                      for a in (xsub, cg, lo, hi, oh)))
    got = tindex.quantized_recheck(*(torch.from_numpy(a)
                                     for a in (xsub, cg, lo, hi, oh)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------------
# the compressed mirror
# ----------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 100])
def test_quantized_zone_widening_is_outward(block):
    """Every f16 zone bound lies outside its f32 one, and the whole
    mirror (codes, c0, scale, f16 zones) is byte-equal to the
    reference's."""
    x, _, _ = _data()
    te = SearchEngine(x, mirror="quantized", device="cpu",
                      **{**ENG_KW, "block": block})
    je = JaxEngine(x, mirror="quantized", use_pallas=False,
                   **{**ENG_KW, "block": block})
    for tix, jix in zip(te.indexes, je.indexes):
        got = tix.device_quantized()
        _, _, _, zlo16, zhi16 = got
        assert np.all(zlo16.numpy().astype(np.float32) <= tix.zlo)
        assert np.all(zhi16.numpy().astype(np.float32) >= tix.zhi)
        for g, w in zip(got, jix.device_quantized()):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
        assert tix.device_bytes() == jix.device_bytes()


# ----------------------------------------------------------------------
# the engine: bitwise the dense one and the reference's quantized one
# ----------------------------------------------------------------------

@pytest.mark.parametrize("capacity_frac", [1.0, 0.02])
def test_quantized_engine_matches_dense_bitwise(capacity_frac):
    """Ids and scores bitwise the port's dense engine and the reference's
    quantized one, the integer stats equal to the latter (a small
    capacity_frac forces overflow retries, 1.0 none); the f32 rows and
    zones are never uploaded."""
    x, pos, neg = _data()
    kw = dict(capacity_frac=capacity_frac, **ENG_KW)
    eq = SearchEngine(x, mirror="quantized", device="cpu", **kw)
    ed = SearchEngine(x, score_mode="dense", device="cpu", **kw)
    je = JaxEngine(x, mirror="quantized", use_pallas=False, **kw)
    retried = 0
    for model in ("dbranch", "dbens"):
        for mr in (None, 50):
            rq = eq.query(pos, neg, model=model, max_results=mr, n_models=6)
            retried += rq.stats["retried_subsets"]
            rd = ed.query(pos, neg, model=model, max_results=mr, n_models=6)
            np.testing.assert_array_equal(rq.ids, rd.ids)
            np.testing.assert_array_equal(rq.scores, rd.scores)
            _same(rq, je.query(pos, neg, model=model, max_results=mr,
                               n_models=6))
    assert (retried > 0) == (capacity_frac < 0.1)
    st = eq.index_stats()
    assert st["device_bytes"]["rows"] == 0
    assert st["device_bytes"]["zones"] == 0
    assert st["device_bytes"]["quantized"] > 0
    assert st["mirror"] == "quantized"
    assert st["device_bytes"] == je.index_stats()["device_bytes"]


def test_quantized_batch_and_other_models_match_reference():
    """query_batch (device fit and numpy fit) and the dtree / knn models
    on a quantized engine answer as the reference's; knn leaves no f32
    mirror behind."""
    x, pos, neg = _data()
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": "dbranch",
             "max_results": 40},
            {"pos_ids": neg[:10], "neg_ids": pos, "model": "dbens",
             "n_models": 5, "max_results": 40},
            {"pos_ids": pos[:6], "neg_ids": neg, "model": "dbranch"}]
    for fit in (True, False):
        kw = dict(mirror="quantized", use_jax_fit=fit, **ENG_KW)
        te = SearchEngine(x, device="cpu", **kw)
        je = JaxEngine(x, use_pallas=False, **kw)
        for a, b in zip(te.query_batch(reqs), je.query_batch(reqs)):
            _same(a, b, batched=True)
    for model in ("dtree", "knn"):
        a = te.query(pos, neg, model=model, max_results=30)
        b = je.query(pos, neg, model=model, max_results=30)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert te.index_stats()["device_bytes"]["rows"] == 0


@pytest.mark.parametrize("opt", [
    {"mirror": "quantized", "score_mode": "dense"},
    {"mirror": "quantized", "n_shards": 2},
    {"mirror": "quantized", "live": True},
    {"mirror": "quantized", "use_fused": False},
    {"mirror": "bogus"},
    {"score_mode": "bogus"}])
def test_quantized_requires_static_fused_sparse(opt):
    """The reference's refusals, with its ValueError messages."""
    x, _, _ = _data(n=500)
    with pytest.raises(ValueError) as want:
        JaxEngine(x, **opt, **ENG_KW)
    with pytest.raises(ValueError) as got:
        SearchEngine(x, device="cpu", **opt, **ENG_KW)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_quantized_engine_cuda_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card "
                    "(python -m pytest -m gpu tests/test_torch_quantized.py)")
    x, pos, neg = _data()
    eg = SearchEngine(x, mirror="quantized", device="cuda", **ENG_KW)
    ec = SearchEngine(x, mirror="quantized", device="cpu", **ENG_KW)
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "max_results": mr}
            for m in ("dbranch", "dbens") for mr in (40, None)]
    for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
        _same(a, b, batched=True)
    assert eg.index_stats()["device_bytes"] == ec.index_stats()[
        "device_bytes"]
