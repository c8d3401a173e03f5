"""The scan and kNN models of the port against the reference's.

The tree trainers are numpy copies, so their boxes must be byte-equal to
the reference's on the same data and seeds. The kNN search must equal
the reference's bitwise on integer-valued data, where every squared
distance is exact in f32 and ties are frequent (so the tie order, lower
row position first, is exercised). On float data the reference sums the
squared differences with ``jnp.sum`` and the port in ascending dim
order, so distances are held to the kernel tolerance (rtol 1e-4, atol
1e-3). The neighbour ids are equal at every rank but where two rows lie
one ulp apart in the reference and tie here: the catalog at k = 1000
shows one such swap (query 10, ranks 952 and 953). At swapped ranks only
the distances are compared, and the swapped ids must be the same rows.
"""
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import knn as jknn
from repro.core import trees as jtrees
from repro_torch.core import index as tindex
from repro_torch.core import knn as tknn
from repro_torch.core import trees as ttrees
from repro_torch.core.boxes import BoxSet, merge_boxsets

DIMS = np.array([0, 2, 5, 7, 9, 11])


def _labelled(name, request):
    x, y = request.getfixturevalue(name)
    return np.asarray(x, np.float32), (np.asarray(y) == 1).astype(np.int32)


def _train(x, y, seed):
    rng = np.random.default_rng(seed)
    pos = rng.choice(np.nonzero(y == 1)[0], 15, replace=False)
    neg = rng.choice(np.nonzero(y == 0)[0], 80, replace=False)
    xtr = np.concatenate([x[pos], x[neg]])
    ytr = np.concatenate([np.ones(15), np.zeros(80)])
    return xtr, ytr


def _byte_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["blob_data", "catalog"])
@pytest.mark.parametrize("max_depth", [3, 12])
def test_decision_tree_boxes_byte_equal(name, max_depth, request):
    x, y = _labelled(name, request)
    xtr, ytr = _train(x, y, seed=max_depth)
    want = jtrees.fit_decision_tree(xtr, ytr, max_depth=max_depth)
    got = ttrees.fit_decision_tree(xtr, ytr, max_depth=max_depth)
    assert len(got.lo) > 0
    _byte_equal(got.lo, want.lo)
    _byte_equal(got.hi, want.hi)
    assert got.n_features == want.n_features
    np.testing.assert_array_equal(got.predict_counts(x),
                                  want.predict_counts(x))


@pytest.mark.parametrize("name", ["blob_data", "catalog"])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_forest_boxes_byte_equal(name, seed, request):
    x, y = _labelled(name, request)
    xtr, ytr = _train(x, y, seed=seed + 10)
    want = jtrees.fit_random_forest(xtr, ytr, n_trees=7, max_depth=8,
                                    seed=seed)
    got = ttrees.fit_random_forest(xtr, ytr, n_trees=7, max_depth=8,
                                   seed=seed)
    for a, b in zip(got.boxes(), want.boxes()):
        _byte_equal(a, b)
    np.testing.assert_array_equal(got.predict_counts(x),
                                  want.predict_counts(x))


def test_merge_boxsets_and_to_full_match_reference():
    from repro.core.boxes import BoxSet as JBoxSet
    from repro.core.boxes import merge_boxsets as jmerge
    rng = np.random.default_rng(0)
    sets = []
    for sid, dims in enumerate((np.array([1, 4]), np.array([0, 2, 3]))):
        lo = rng.normal(0, 1, (3, len(dims))).astype(np.float32)
        sets.append((lo, lo + 1, dims, sid))
    got = merge_boxsets([BoxSet(*a) for a in sets], 6)
    want = jmerge([JBoxSet(*a) for a in sets], 6)
    for a, b in zip(got, want):
        _byte_equal(a, b)
    cat = BoxSet(*sets[0]).concatenate(BoxSet(*sets[0]))
    assert cat.n_boxes == 6 and cat.subset_id == 0


def _knn_data(name, request, integer):
    x, _ = _labelled(name, request)
    if integer:
        x = np.round(x * 4).astype(np.float32) / 4
    rng = np.random.default_rng(2)
    q = x[rng.choice(len(x), 12, replace=False)]
    return x, q


@pytest.mark.parametrize("name", ["blob_data", "catalog"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [1, 37, 1000])
def test_knn_subset_and_vote_match_reference(name, integer, k, request):
    x, q = _knn_data(name, request, integer)
    jix = jindex.build_index(x, DIMS, block=64, subset_id=0)
    tix = tindex.build_index(x, DIMS, block=64, subset_id=0, device="cpu")
    wids, wd = jknn.knn_subset(jix, q, k=k)
    gids, gd = tknn.knn_subset(tix, q, k=k)
    assert gids.dtype == wids.dtype and gids.shape == wids.shape
    assert gd.dtype == wd.dtype
    if integer:
        np.testing.assert_array_equal(gids, wids)
        np.testing.assert_array_equal(gd, wd)
    else:
        swapped = gids != wids
        assert swapped.sum() <= 2
        for r in np.nonzero(swapped.any(1))[0]:
            np.testing.assert_array_equal(np.sort(gids[r, swapped[r]]),
                                          np.sort(wids[r, swapped[r]]))
        np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tknn.knn_vote(gids, len(x)),
                                  jknn.knn_vote(wids, len(x)))


@pytest.mark.parametrize("name", ["blob_data", "catalog"])
@pytest.mark.parametrize("integer", [True, False])
def test_knn_full_matches_reference(name, integer, request):
    x, q = _knn_data(name, request, integer)
    wi, wd = jknn.knn_full(x, q, k=50)
    gi, gd = tknn.knn_full(torch.from_numpy(x), q, k=50)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    if integer:
        np.testing.assert_array_equal(gd, np.asarray(wd))
    else:
        np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-4, atol=1e-3)
    # the nearest row of a query drawn from x is itself, at distance 0
    assert (gd[:, 0] == 0).all()


def test_knn_subset_refuses_unported_index_kinds(request):
    """Kept under its name from when the sharded index was refused: knn
    over a ShardedZoneMapIndex is now the reference's (per-shard top-k,
    merged by (distance, global id)), flat and on a device-list mesh."""
    x, q = _knn_data("blob_data", request, True)
    for s in (2, 4, 8):
        jix = jindex.build_sharded_index(x, DIMS, s, block=64, subset_id=0)
        tix = tindex.build_sharded_index(x, DIMS, s, block=64, subset_id=0,
                                         device="cpu")
        wids, wd = jknn.knn_subset(jix, q, k=37)
        for mesh in (None, ["cpu"] * s):
            gids, gd = tknn.knn_subset(tix, q, k=37, mesh=mesh)
            np.testing.assert_array_equal(gids, wids)
            np.testing.assert_array_equal(gd, wd)


def test_knn_subset_reads_the_device_mirror():
    """The rows come from rows3 (padding only at its tail): the first
    n_rows mirror rows are the index's real rows."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (333, 12)).astype(np.float32)
    tix = tindex.build_index(x, DIMS, block=64, device="cpu")
    rows3, _, _ = tix.device_arrays()
    flat = rows3.reshape(-1, len(DIMS)).numpy()
    np.testing.assert_array_equal(flat[:333], tix.rows[:333])
    assert np.isinf(flat[333:]).all()
    ids, d = tknn.knn_subset(tix, x[:3], k=5)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
    want = np.sort(((x[:, DIMS][None] - x[:3, DIMS][:, None]) ** 2)
                   .sum(-1), 1)[:, :5]
    np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_results", [None, 100])
def test_knn_engine_ranks_inf_rows_as_reference(max_results):
    """ROADMAP C1 at engine level: a catalog with a +inf row and a -inf
    row among the positives. A query of +inf against the +inf row is
    inf - inf in every dim, x86's negative NaN, which the reference's
    lax.top_k(-d.T, k) ranks first; the port ranks by the same total
    order, so the knn ids and scores equal the reference's, and both
    equal the ids and scores chip_smoke.py holds the card's engine to."""
    import importlib.util
    from pathlib import Path

    from repro.core.engine import SearchEngine as JEngine
    from repro_torch.core import SearchEngine as TEngine
    x = np.random.default_rng(0).standard_normal((4096, 12)).astype(
        np.float32)
    x[7], x[9] = np.inf, -np.inf
    pos, neg = [7, 1, 2, 9], [3, 4, 5]
    geo = dict(n_subsets=4, subset_dim=6, block=256)
    want = JEngine(x, **geo).query(pos, neg, model="knn", k_neighbors=16,
                                   max_results=max_results)
    got = TEngine(x, device="cpu", **geo).query(
        pos, neg, model="knn", k_neighbors=16, max_results=max_results)
    assert len(want.ids) == 45
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    np.testing.assert_array_equal(smoke.c1_catalog(), x)
    assert (smoke.C1_POS, smoke.C1_NEG) == (tuple(pos), tuple(neg))
    assert want.ids.tolist() == list(smoke.C1_KNN_IDS)
    assert want.scores.tolist() == list(smoke.C1_KNN_SCORES)
