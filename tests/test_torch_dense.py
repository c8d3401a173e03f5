"""The dense score oracle (``score_mode="dense"``): the port's
``accumulate_scores``, ``rank_topk`` (all three methods) and
``ZoneMapIndex.device_inv_perm`` against the reference's, and the dense
engine against the sparse one and against the reference's dense engine.

All int32: equality is exact. The ranking contract is the host oracle's
stable sort of -score — descending score, ascending row id — ties across
the k boundary included; every method must give it. Sparse and dense
engines must agree bitwise (int32 vote addition is exactly associative),
with and without ``max_results``, and the dense engine's stats must be
the reference's dense engine's.

On a CUDA card (marker ``gpu``; skipped without one): every rank method
and the dense engine on the card against the same on the CPU. Run them
there with ``python -m pytest -m gpu tests/test_torch_dense.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SearchEngine as JaxEngine
from repro.core.index import build_index as jbuild_index
from repro.kernels import ops as jops
from repro_torch.core import SearchEngine
from repro_torch.core.engine import SparseScores
from repro_torch.core.index import build_index
from repro_torch.kernels import ops as tops

STATS = ("n_host_syncs", "retried_subsets", "blocks_touched",
         "blocks_gathered", "bytes_touched", "host_bytes_transferred",
         "score_buffer_bytes_peak", "score_rows")
KW = dict(n_subsets=8, block=64, seed=0)
METHODS = ("topk", "sort", "threshold")


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _same_arrays(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# ops level
# ----------------------------------------------------------------------

def test_device_inv_perm_matches_reference():
    x = np.random.default_rng(0).normal(0, 1, (1000, 5)).astype(np.float32)
    want = jbuild_index(x, np.arange(3), block=64)
    got = build_index(x, np.arange(3), block=64, device="cpu")
    _same_arrays([got.device_inv_perm()], [want.device_inv_perm()])
    assert got.device_bytes()["inv_perm"] == 1000 * 4


@pytest.mark.parametrize("n_hit,cap", [(5, 8), (8, 8), (0, 4), (3, 3)])
@pytest.mark.parametrize("with_block0", [False, True])
def test_accumulate_scores_matches_reference(n_hit, cap, with_block0):
    """Survivor slots then 0-filled slots that alias block 0 (a survivor
    or not); blocks absent from cand take 0."""
    rng = np.random.default_rng(n_hit * 10 + cap + with_block0)
    nb, block, q = 12, 16, 3
    n = nb * block - 5
    blocks = rng.choice(np.arange(1, nb), n_hit, replace=False)
    if with_block0 and n_hit:
        blocks[0] = 0
    cand = np.zeros(cap, np.int32)
    cand[:n_hit] = np.sort(blocks)
    counts = rng.integers(0, 5, (cap, block, q)).astype(np.int32)
    counts[n_hit:] = 0
    perm = rng.permutation(nb * block)
    perm = np.where(perm < n, perm, -1)
    inv = np.empty(n, np.int32)
    inv[perm[perm >= 0]] = np.nonzero(perm >= 0)[0]
    scores = rng.integers(0, 3, (n, q)).astype(np.int32)
    want = jops.accumulate_scores(*(jnp.asarray(a) for a in (
        scores, counts, cand, inv)), nb=nb)
    got = tops.accumulate_scores(*_t(scores, counts, cand, inv), nb=nb)
    _same_arrays([got], [want])


def _tied_scores(seed, nq=3, n=300, smax=6):
    """Few distinct scores, so ties straddle every k; training ids
    padded with n."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, smax + 1, (nq, n)).astype(np.int32)
    scores[:, rng.choice(n, n // 3, replace=False)] = 0
    tids = np.full((nq, 16), n, np.int32)
    for q in range(nq):
        tids[q, :5 + q] = rng.choice(n, 5 + q, replace=False)
    return scores, tids


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [1, 7, 64, 300])
@pytest.mark.parametrize("transposed", [False, True])
def test_rank_topk_matches_reference(method, k, transposed):
    """Each method against the reference's same method, and against its
    'sort' (the plain two-key sort): ids, scores, n_valid."""
    scores, tids = _tied_scores(seed=k)
    arr = np.ascontiguousarray(scores.T) if transposed else scores
    kw = dict(k=k, score_bound=6, scores_transposed=transposed)
    got = tops.rank_topk(*_t(arr, tids), method=method, **kw)
    for m in (method, "sort"):
        want = jops.rank_topk(jnp.asarray(arr), jnp.asarray(tids),
                              method=m, **kw)
        _same_arrays(got, want)


def test_rank_topk_default_method_and_bounds():
    """CPU tensors default to 'threshold'; without a bound 'threshold'
    searches 30 bits and still ranks exactly; 'topk' refuses a key that
    would overflow int32."""
    scores, tids = _tied_scores(seed=3)
    want = jops.rank_topk(*(jnp.asarray(a) for a in (scores, tids)), k=20,
                          method="sort")
    _same_arrays(tops.rank_topk(*_t(scores, tids), k=20, score_bound=6),
                 want)
    _same_arrays(tops.rank_topk(*_t(scores, tids), k=20,
                                method="threshold"), want)
    with pytest.raises(ValueError, match="int32"):
        tops.rank_topk(*_t(scores, tids), k=20, score_bound=2 ** 28,
                       method="topk")


# ----------------------------------------------------------------------
# engine level
# ----------------------------------------------------------------------

def _clustered(n=3000, d=24, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5.0, (16, d)).astype(np.float32)
    assign = rng.integers(0, 16, n)
    x = (centers[assign] + rng.normal(0, 0.3, (n, d))).astype(np.float32)
    return x, (assign == 0).astype(np.int32)


@pytest.fixture(params=["catalog", "clustered"])
def data(request):
    if request.param == "clustered":
        x, y = _clustered()
    else:
        x, y = request.getfixturevalue(request.param)
    y = (np.asarray(y) == 1).astype(np.int32)
    rng = np.random.default_rng(2)
    pos = rng.choice(np.nonzero(y == 1)[0], 12, replace=False)
    neg = rng.choice(np.nonzero(y == 0)[0], 50, replace=False)
    return np.asarray(x, np.float32), y, pos, neg


def _requests(y, seed, mr):
    rng = np.random.default_rng(seed)
    return [{"pos_ids": rng.choice(np.nonzero(y == 1)[0], 5 + 2 * i,
                                   replace=False),
             "neg_ids": rng.choice(np.nonzero(y == 0)[0], 30, replace=False),
             "model": ("dbranch", "dbens")[i % 2], "n_models": 4, "seed": i,
             "max_results": mr[i % len(mr)]} for i in range(4)]


def _same(a, b, stats=True, batched=False):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    for k in STATS if stats else ("n_host_syncs", "retried_subsets",
                                  "blocks_touched"):
        key = "batch_" + k if batched else k
        assert a.stats[key] == b.stats[key], key


@pytest.mark.parametrize("fit", [True, False])
def test_dense_matches_sparse_bitwise(data, fit):
    """The dense buffer and the survivor tiles give the same ids and
    scores, query() and query_batch(), with and without max_results,
    ties included; the same syncs and retries."""
    x, y, pos, neg = data
    es = SearchEngine(x, device="cpu", use_jax_fit=fit, **KW)
    ed = SearchEngine(x, device="cpu", use_jax_fit=fit, score_mode="dense",
                      **KW)
    for model in ("dbranch", "dbens"):
        for mr in (None, 1, 25):
            kw = dict(model=model, max_results=mr, n_models=4)
            _same(ed.query(pos, neg, **kw), es.query(pos, neg, **kw),
                  stats=False)
    for mr in ((None, 9), (15, 4)):
        reqs = _requests(y, seed=3, mr=mr)
        for a, b in zip(ed.query_batch(reqs), es.query_batch(reqs)):
            _same(a, b, stats=False, batched=True)


@pytest.mark.parametrize("model", ["dbranch", "dbens"])
def test_dense_engine_matches_reference_dense(data, model):
    """score_mode="dense" on both packages: ids, scores and the integer
    stats (one sync per round, gather pricing, host bytes, the [N, Q]
    buffer as the peak), query() and query_batch()."""
    x, y, pos, neg = data
    je = JaxEngine(x, score_mode="dense", **KW)
    te = SearchEngine(x, device="cpu", score_mode="dense", **KW)
    for mr in (None, 10):
        for inc in (False, True):
            kw = dict(model=model, max_results=mr, include_training=inc,
                      n_models=4)
            got = te.query(pos, neg, **kw)
            _same(got, je.query(pos, neg, **kw))
            assert got.stats["score_buffer_bytes_peak"] == x.shape[0] * 4
    reqs = _requests(y, seed=8, mr=(None, 12))
    for a, b in zip(te.query_batch(reqs), je.query_batch(reqs)):
        _same(a, b, batched=True)
        assert a.stats["batch_score_rows"] == x.shape[0]


def test_dense_overflow_retry_matches_reference():
    """capacity_frac=0.01 forces first-round overflows: the same retried
    subsets and syncs as the reference's dense engine and the port's
    sparse one."""
    x, y = _clustered(n=4000, seed=6)
    pos, neg = np.nonzero(y == 1)[0][:10], np.nonzero(y == 0)[0][:40]
    kw = dict(KW, capacity_frac=0.01)
    ed = SearchEngine(x, device="cpu", score_mode="dense", **kw)
    es = SearchEngine(x, device="cpu", **kw)
    je = JaxEngine(x, score_mode="dense", **kw)
    rd = ed.query(pos, neg, max_results=50)
    _same(rd, je.query(pos, neg, max_results=50))
    rs = es.query(pos, neg, max_results=50)
    _same(rd, rs, stats=False)
    assert rd.stats["retried_subsets"] > 0


def test_dense_device_form_and_host_export():
    """The dense form is an [N, Q] int32 tensor, and the sparse tiles'
    host export equals it."""
    x, y = _clustered(n=2000, seed=7)
    pos, neg = np.nonzero(y == 1)[0][:9], np.nonzero(y == 0)[0][:30]
    es = SearchEngine(x, device="cpu", **KW)
    ed = SearchEngine(x, device="cpu", score_mode="dense", **KW)
    boxsets = es._fit_boxes("dbens", x[pos], x[neg], max_depth=12,
                            n_models=4, seed=0)
    jobs, _ = es._make_jobs([(bs, 0) for bs in boxsets], 1)
    sp, _ = es._device_scores(jobs, 1, es._view())
    dn, _ = ed._device_scores(jobs, 1, ed._view())
    assert isinstance(sp, SparseScores) and isinstance(dn, torch.Tensor)
    assert dn.dtype == torch.int32 and dn.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(es._scores_to_host(sp, es._view()),
                                  ed._scores_to_host(dn, ed._view()))


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card "
                    "(python -m pytest -m gpu tests/test_torch_dense.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_rank_topk_cuda_matches_cpu(cuda, method):
    for k in (1, 7, 64, 300):
        scores, tids = _tied_scores(seed=k, n=5000)
        kw = dict(k=k, score_bound=6, method=method)
        want = tops.rank_topk(*_t(scores, tids), **kw)
        got = tops.rank_topk(*(a.to(cuda) for a in _t(scores, tids)), **kw)
        _same_arrays(got, [w.numpy() for w in want])


@pytest.mark.gpu
def test_dense_engine_cuda_matches_cpu(cuda):
    x, y = _clustered(n=4000, seed=12)
    eg = SearchEngine(x, device=cuda, score_mode="dense", **KW)
    ec = SearchEngine(x, device="cpu", score_mode="dense", **KW)
    for mr in ((None, 9), (12, 5)):
        reqs = _requests(y, seed=9, mr=mr)
        for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
            _same(a, b, batched=True)
