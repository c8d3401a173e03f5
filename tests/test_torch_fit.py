"""The batched device fit: the port's ``fit_dbranch_dev`` / ``fit_select``
against the reference's ``fit_dbranch_jax`` / ``fit_select_jax``, and the
default-configured engines (``use_jax_fit=True``) against each other.

Both trainers compute every split score, midpoint and nudge as one IEEE
f32 op, so boxes, validity and the [2, G] winner meta must be bitwise
equal — whole arrays, padding slots and padding groups included, not
just box sets. Cases: ``tests/test_fit_parity.py``'s ``_rand_case``
seeds, padded label sets, host split tables, trees that fill
``max_nodes``, and lane stacks whose deep lanes stay live into round 2.
The engine tests hold ids, scores and the integer stats of a default
port engine to the default JAX engine, and the port's device fit to its
own numpy trainers. The batch-wide fallback of ``query_batch`` may not
hide a fault of the device.

On a CUDA card (marker ``gpu``; skipped without one): fit_select and the
default engine on the card against the same on the CPU. Run them there
with ``python -m pytest -m gpu tests/test_torch_fit.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dbranch as jdb
from repro.core.engine import SearchEngine as JaxEngine
from repro.kernels import ops as jops
from repro_torch.core import SearchEngine
from repro_torch.core import dbranch as tdb
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops as tops

STATS = ("n_host_syncs", "retried_subsets", "blocks_touched",
         "blocks_gathered", "bytes_touched", "host_bytes_transferred",
         "score_buffer_bytes_peak", "score_rows")
KW = dict(n_subsets=8, block=64, seed=0)


def _rand_case(seed):
    """tests/test_fit_parity.py's cases."""
    rng = np.random.default_rng(seed)
    p = int(rng.integers(3, 40))
    ng = int(rng.integers(5, 120))
    d = int(rng.integers(2, 7))
    xp = rng.normal(1.0, 0.5, (p, d)).astype(np.float32)
    xn = rng.normal(0.0, 1.0, (ng, d)).astype(np.float32)
    flo = (np.minimum(xp.min(0), xn.min(0)) - 1).astype(np.float32)
    fhi = (np.maximum(xp.max(0), xn.max(0)) + 1).astype(np.float32)
    return xp, xn, flo, fhi


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# trainer level
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 4), (3, 29, 5), (2, 3, 16, 2)])
def test_split_tables_match_reference(shape):
    """Ties included (values on a coarse grid)."""
    x = np.round(np.random.default_rng(sum(shape)).normal(0, 1, shape),
                 1).astype(np.float32)
    for got, want in zip(tdb.split_tables(x), jdb.split_tables(x)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_fit_dbranch_dev_bitwise_reference(seed, tables):
    """lo, hi, valid [max_nodes] bitwise, expansion and feature_range
    included; with the split tables derived on the device or from the
    host."""
    xp, xn, flo, fhi = _rand_case(seed)
    extra = ()
    if tables:
        si, re = jdb.split_tables(np.concatenate([xp, xn]))
        extra = (None, None, si, re)
    want = jdb.fit_dbranch_jax(
        *(jnp.asarray(a) for a in (xp, xn, flo, fhi)),
        *(None if a is None else jnp.asarray(a) for a in extra),
        max_nodes=128, max_depth=10)
    got = tdb.fit_dbranch_dev(
        *_t(xp, xn, flo, fhi),
        *(None if a is None else _t(a)[0] for a in extra),
        max_nodes=128, max_depth=10)
    _same_arrays(got, want)


@pytest.mark.parametrize("seed", (0, 3, 7))
@pytest.mark.parametrize("expand", [True, False])
def test_fit_dbranch_dev_padded_bitwise_reference(seed, expand):
    """pow2-padded rows with validity masks, as the engine's lanes are."""
    xp, xn, flo, fhi = _rand_case(seed)
    p, ng, d = len(xp), len(xn), xp.shape[1]
    xpp = np.zeros((64, d), np.float32)
    xpp[:p] = xp
    xnp = np.zeros((128, d), np.float32)
    xnp[:ng] = xn
    pm, nm = np.arange(64) < p, np.arange(128) < ng
    want = jdb.fit_dbranch_jax(
        *(jnp.asarray(a) for a in (xpp, xnp, flo, fhi, pm, nm)),
        max_nodes=64, expand=expand)
    got = tdb.fit_dbranch_dev(*_t(xpp, xnp, flo, fhi, pm, nm),
                              max_nodes=64, expand=expand)
    _same_arrays(got, want)


def _interleaved(p, ng, d, seed):
    """Positives and negatives drawn from one distribution: the tree
    needs many small leaves, so a low max_nodes fills."""
    rng = np.random.default_rng(seed)
    xp = rng.normal(0, 1, (p, d)).astype(np.float32)
    xn = rng.normal(0, 1, (ng, d)).astype(np.float32)
    return xp, xn, np.full(d, -5, np.float32), np.full(d, 5, np.float32)


@pytest.mark.parametrize("max_nodes", [4, 8, 16])
def test_fit_dbranch_dev_tree_fills_max_nodes(max_nodes):
    """36 positives against 90 interleaved negatives: the worklist runs
    out of slots (child writes past the end must drop, as JAX's
    out-of-range ``.at[].set`` does), and the capped tree emits fewer
    boxes than the uncapped numpy trainer."""
    xp, xn, flo, fhi = _interleaved(36, 90, 3, seed=max_nodes)
    want = jdb.fit_dbranch_jax(*(jnp.asarray(a) for a in (xp, xn, flo, fhi)),
                               max_nodes=max_nodes)
    got = tdb.fit_dbranch_dev(*_t(xp, xn, flo, fhi), max_nodes=max_nodes)
    _same_arrays(got, want)
    full = jdb.fit_dbranch(xp, xn, np.arange(3), feature_range=(flo, fhi))
    assert int(got[2].sum()) < full.n_boxes


def _separable(seed, d):
    """Positives far from every negative: the root is pure and emits at
    the first pop."""
    rng = np.random.default_rng(seed)
    xp = rng.normal(5, 0.1, (12, d)).astype(np.float32)
    xn = rng.normal(0, 1, (50, d)).astype(np.float32)
    return xp, xn, np.full(d, -9, np.float32), np.full(d, 9, np.float32)


def _lane_stack(seeds, p_pad=64, n_pad=128, d=4, dummy=2):
    """A fit_select input: one lane a case (cases of ``d`` dims, padded
    to p_pad / n_pad), groups of up to three lanes, ``dummy`` padding
    lanes in one extra group, and n_groups padded to a power of two past
    it (groups with no lane at all). A seed below 0 is an interleaved
    case, one of 100 and more a separable case, the rest _rand_case's."""
    cases = []
    for s in seeds:
        if s < 0:          # interleaved: deep trees, live into round 2
            cases.append(_interleaved(30, 100, d, seed=-s))
            continue
        if s >= 100:       # one emitted root: done after round 1
            cases.append(_separable(s, d))
            continue
        xp, xn, flo, fhi = _rand_case(s)
        if xp.shape[1] < d:
            continue
        cases.append((xp[:, :d], xn[:, :d], flo[:d], fhi[:d]))
    t = len(cases) + dummy
    x = np.zeros((t, p_pad + n_pad, d), np.float32)
    m = np.zeros((t, p_pad + n_pad), bool)
    fr = np.zeros((t, 2, d), np.float32)
    gid = np.zeros(t, np.int32)
    for i, (xp, xn, flo, fhi) in enumerate(cases):
        x[i, :len(xp)] = xp
        m[i, :len(xp)] = True
        x[i, p_pad:p_pad + len(xn)] = xn
        m[i, p_pad:p_pad + len(xn)] = True
        fr[i] = flo, fhi
        gid[i] = i // 3
    g_real = -(-len(cases) // 3)
    gid[len(cases):] = g_real
    n_groups = 1 << (g_real + 1).bit_length()
    si, re = jdb.split_tables(x)
    return x, m, fr, gid, np.concatenate([si, re], 2), n_groups


@pytest.mark.parametrize("seeds,max_nodes,round1", [
    ((0, 1, 2, 3, 4, 5, 6, 7), 64, 1),
    ((8, 9, 10, 11, -1, -2), 64, 1),
    ((-3, 2, -4, 5, -5), 32, 1),
    ((0, 3, -6, 7), 64, 3),
    ((100, 101, 102, 103), 64, 1),
    ((100, -7, 101), 16, 1)])
def test_fit_select_bitwise_reference(seeds, max_nodes, round1):
    """lo_c, hi_c [G, S, d'] and the [2, G] meta bitwise, padding groups
    (winner INT32_MAX) included. Lanes that are not separable stay live
    after round 1, so the survivor round runs; an all-separable stack
    finishes in round 1; max_nodes 16 fills with 30 positives."""
    x, m, fr, gid, tab, n_groups = _lane_stack(seeds)
    kw = dict(p_cnt=64, n_groups=n_groups, max_nodes=max_nodes,
              max_depth=12, round1_iters=round1)
    want = jdb.fit_select_jax(*(jnp.asarray(a) for a in (x, m, fr, gid,
                                                         tab)), **kw)
    got = tdb.fit_select(*_t(x, m, fr, gid, tab), **kw)
    _same_arrays(got, want)
    meta = got[2].numpy()
    assert (meta[0, -1] == np.iinfo(np.int32).max) and meta[1].max() > 0
    state = tdb._grow_round(*_t(x, m), torch.from_numpy(tab), p_cnt=64,
                            max_nodes=max_nodes, max_depth=12,
                            max_iters=round1)
    assert bool(state[5].any()) == any(s < 100 for s in seeds)


def test_fit_select_without_tables_matches():
    """tables=None derives the split tables on the device."""
    x, m, fr, gid, tab, n_groups = _lane_stack((1, -2, 4))
    kw = dict(p_cnt=64, n_groups=n_groups, max_nodes=64, max_depth=12)
    want = tdb.fit_select(*_t(x, m, fr, gid, tab), **kw)
    _same_arrays(tdb.fit_select(*_t(x, m, fr, gid), **kw),
                 [w.numpy() for w in want])


def test_batch_box_membership_and_predict_boxes_match_reference():
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 1, (5, 40, 3)), 1).astype(np.float32)
    lo = np.round(rng.normal(-0.5, 0.5, (5, 7, 3)), 1).astype(np.float32)
    hi = (lo + np.round(rng.uniform(0, 2, (5, 7, 3)), 1)).astype(np.float32)
    valid = rng.random((5, 7)) < 0.7
    want = jops.batch_box_membership(*(jnp.asarray(a)
                                       for a in (x, lo, hi, valid)))
    got = tops.batch_box_membership(*_t(x, lo, hi, valid))
    _same_arrays([got], [want])
    want = jdb.predict_boxes_jax(*(jnp.asarray(a)
                                   for a in (x[0], lo[0], hi[0], valid[0])))
    got = tdb.predict_boxes(*_t(x[0], lo[0], hi[0], valid[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# engine level: the reference's defaults on both packages
# ----------------------------------------------------------------------

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
    y = (np.asarray(y) == 1).astype(np.int32)
    rng = np.random.default_rng(1)
    pos = rng.choice(np.nonzero(y == 1)[0], 14, replace=False)
    neg = rng.choice(np.nonzero(y == 0)[0], 60, replace=False)
    return np.asarray(x, np.float32), y, pos, neg


def _same(a, b, batched=False):
    if isinstance(b, Exception):
        assert type(a) is type(b), (a, b)
        return
    assert a.model == b.model
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    for k in STATS:
        key = "batch_" + k if batched else k
        assert a.stats[key] == b.stats[key], key
    assert a.stats["n_boxes"] == b.stats["n_boxes"]
    assert a.stats["fit_path"] == b.stats["fit_path"]


def _requests(y, n, seed, mr=(None, 9)):
    rng = np.random.default_rng(seed)
    return [{"pos_ids": rng.choice(np.nonzero(y == 1)[0], 6 + 3 * i,
                                   replace=False),
             "neg_ids": rng.choice(np.nonzero(y == 0)[0], 25 + 10 * i,
                                   replace=False),
             "model": ("dbranch", "dbens")[i % 2], "n_models": 4,
             "seed": i, "max_results": mr[i % len(mr)]}
            for i in range(n)]


@pytest.mark.parametrize("model", ["dbranch", "dbens"])
def test_default_engine_matches_reference(data, model):
    """SearchEngine(x) on both packages — the device fit, the survivor
    tiles — query() with and without max_results and training rows."""
    x, _, pos, neg = data
    je, te = JaxEngine(x, **KW), SearchEngine(x, device="cpu", **KW)
    assert te.use_jax_fit and te.fit_max_nodes == je.fit_max_nodes == 64
    for mr in (None, 10):
        for inc in (False, True):
            kw = dict(model=model, max_results=mr, include_training=inc,
                      n_models=5)
            got = te.query(pos, neg, **kw)
            _same(got, je.query(pos, neg, **kw))
            assert got.stats["fit_path"] == "jax" and got.n_found > 0


def test_default_engine_batch_matches_reference(data):
    """A mixed dbranch/dbens query_batch of the default engines, full and
    device-ranked, ids, scores and batch stats bitwise."""
    x, y, _, _ = data
    je, te = JaxEngine(x, **KW), SearchEngine(x, device="cpu", **KW)
    for mr in ((None, 9), (12, 5)):
        reqs = _requests(y, 4, seed=2, mr=mr)
        for a, b in zip(te.query_batch(reqs), je.query_batch(reqs)):
            _same(a, b, batched=True)


def test_fit_boxes_batched_matches_reference(data):
    """_fit_boxes_batched(return_device=True): the compacted winner
    arrays bitwise, and the same (winner row, subset, box count) per
    spec."""
    x, y, _, _ = data
    je, te = JaxEngine(x, **KW), SearchEngine(x, device="cpu", **KW)
    specs = [(r["model"], x[r["pos_ids"]], x[r["neg_ids"]], r["n_models"],
              r["seed"]) for r in _requests(y, 4, seed=7)]
    lo_t, hi_t, ent_t = te._fit_boxes_batched(specs, max_depth=12,
                                              return_device=True)
    lo_j, hi_j, ent_j = je._fit_boxes_batched(specs, max_depth=12,
                                              return_device=True)
    _same_arrays([lo_t, hi_t], [lo_j, hi_j])
    assert ent_t == ent_j


def _sorted_boxes(lo, hi):
    lo, hi = np.asarray(lo), np.asarray(hi)
    key = np.lexsort(np.concatenate([lo, hi], 1).T[::-1])
    return lo[key], hi[key]


@pytest.mark.parametrize("model", ["dbranch", "dbens"])
def test_device_fit_matches_numpy_fit(data, model):
    """In the port: the device fit's winners are the numpy trainers'
    (same subset, the same boxes as a set), and the answers equal."""
    x, _, pos, neg = data
    te = SearchEngine(x, device="cpu", **KW)
    tn = SearchEngine(x, device="cpu", use_jax_fit=False, **KW)
    dev = te._fit_boxes(model, x[pos], x[neg], max_depth=12, n_models=5,
                        seed=3)
    npy = tn._fit_boxes(model, x[pos], x[neg], max_depth=12, n_models=5,
                        seed=3)
    assert len(dev) == len(npy)
    for a, b in zip(dev, npy):
        assert a.subset_id == b.subset_id
        assert isinstance(a.lo, torch.Tensor)
        for u, v in zip(_sorted_boxes(a.lo.numpy(), a.hi.numpy()),
                        _sorted_boxes(b.lo, b.hi)):
            np.testing.assert_array_equal(u, v)
    for mr in (None, 10):
        a = te.query(pos, neg, model=model, n_models=5, max_results=mr)
        b = tn.query(pos, neg, model=model, n_models=5, max_results=mr)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert (a.stats["fit_path"], b.stats["fit_path"]) == ("jax",
                                                              "numpy")


def test_batch_isolates_a_request_without_boxes():
    """A request with no positives produces no boxes on the device fit;
    it alone is retried on the numpy trainer and fails in its slot, as in
    the reference, while the rest of the window keeps its device fit."""
    x, y = _clustered(n=2000, seed=9)
    je, te = JaxEngine(x, **KW), SearchEngine(x, device="cpu", **KW)
    reqs = _requests(y, 3, seed=4)
    reqs.insert(1, {"pos_ids": [], "neg_ids": reqs[0]["neg_ids"],
                    "model": "dbranch"})
    got, want = te.query_batch(reqs), je.query_batch(reqs)
    assert isinstance(got[1], Exception)
    for a, b in zip(got, want):
        _same(a, b, batched=True)


def test_batch_fallback_does_not_hide_the_device(monkeypatch):
    """query_batch's batch-wide fallback: a device fault
    (torch.AcceleratorError, torch.OutOfMemoryError) from the fit
    propagates; any other exception sends the window to the numpy
    trainers request by request, which answer as the numpy engine."""
    x, y = _clustered(n=2000, seed=9)
    te = SearchEngine(x, device="cpu", **KW)
    tn = SearchEngine(x, device="cpu", use_jax_fit=False, **KW)
    reqs = _requests(y, 4, seed=5)

    def raiser(exc):
        def fit_select(*a, **k):
            raise exc
        return fit_select

    for exc in (torch.AcceleratorError("device fault"),
                torch.OutOfMemoryError("out of memory")):
        monkeypatch.setattr(tengine, "fit_select", raiser(exc))
        with pytest.raises(type(exc)):
            te.query_batch(reqs)
    monkeypatch.setattr(tengine, "fit_select",
                        raiser(ValueError("bad label set")))
    for a, b in zip(te.query_batch(reqs), tn.query_batch(reqs)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.stats["fit_path"] == "jax"


# ----------------------------------------------------------------------
# On the card: the device fit against the same fit on the CPU
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card "
                    "(python -m pytest -m gpu tests/test_torch_fit.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fit_select_cuda_matches_cpu(cuda):
    x, m, fr, gid, tab, n_groups = _lane_stack((0, 1, -1, 3, -2, 5, -3))
    kw = dict(p_cnt=64, n_groups=n_groups, max_nodes=64, max_depth=12)
    want = tdb.fit_select(*_t(x, m, fr, gid, tab), **kw)
    got = tdb.fit_select(*(a.to(cuda) for a in _t(x, m, fr, gid, tab)),
                         **kw)
    _same_arrays(got, [w.numpy() for w in want])


@pytest.mark.gpu
def test_default_engine_cuda_matches_cpu(cuda):
    x, y = _clustered(n=4000, seed=11)
    eg = SearchEngine(x, device=cuda, **KW)
    ec = SearchEngine(x, device="cpu", **KW)
    for mr in ((None, 9), (12, 5)):
        reqs = _requests(y, 4, seed=6, mr=mr)
        for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
            _same(a, b, batched=True)
