"""The port's sharded catalogs (``n_shards``) against the reference's, on
the CPU.

Twins of tests/test_sharded_query.py (shard-count invariance of the
ranked engine for n_shards in {1, 2, 4, 8}, ragged and empty shards,
the cross-shard merge against the host oracle with ties at the global
k-th score, host bytes flat in S, the exact overflow retry), of
tests/test_sparse_scores.py:142 (sparse = dense at every shard count),
of tests/test_live_catalog.py:390 (a live catalog with shards) and of
tests/test_index_engine.py:133 (the distributed query). Each runs the
reference and the port on the same seeded data: ids, scores and integer
stats compared bitwise. The mesh leg runs on a device list that names
the CPU several times (``shard_mesh=["cpu"] * 8``), in this process; it
must give the flat formulation's bits. The ``gpu``-marked cases run on
the card against the CPU and skip without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import index as jindex
from repro.core.boxes import BoxSet as JaxBoxSet
from repro.core.boxes import boxes_contain
from repro.core.engine import SearchEngine as JaxEngine
from repro.kernels import ops as jops
from repro_torch.core import SearchEngine
from repro_torch.core import index as tindex
from repro_torch.core.boxes import BoxSet
from repro_torch.kernels import ops as tops
from repro_torch.serve import merge_shard_results
from repro_torch.core.engine import QueryResult

SHARD_COUNTS = (1, 2, 4, 8)
ENG = dict(n_subsets=8, subset_dim=5, block=64, seed=0)
STATS = ("n_host_syncs", "retried_subsets", "blocks_touched",
         "blocks_gathered", "blocks_total", "bytes_touched",
         "host_bytes_transferred", "score_buffer_bytes_peak", "score_rows",
         "n_boxes", "n_range_queries", "n_shards", "capacity")


def _query_sets(labels, cls, n_pos=12, n_neg=50, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.choice(np.nonzero(labels == cls)[0], n_pos, replace=False)
    neg = rng.choice(np.nonzero(labels != cls)[0], n_neg, replace=False)
    return pos, neg


def _host_rank(counts, train_ids):
    found = np.nonzero(counts > 0)[0]
    found = found[~np.isin(found, train_ids)]
    order = np.argsort(-counts[found], kind="stable")
    return found[order], counts[found][order]


def _same(a, b, batched=False):
    """Ranked ids and scores bitwise, the integer stats equal."""
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    for k in STATS:
        k = f"batch_{k}" if batched else k
        if k in a.stats or k in b.stats:
            assert a.stats[k] == b.stats[k], (k, a.stats[k], b.stats[k])


# ----------------------------------------------------------------------
# partition + sharded index build
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(1500, 8), (10, 8), (1000, 3), (64, 1)])
def test_shard_offsets_partition_is_ragged_and_total(n, s):
    offs = tindex.shard_offsets(n, s)
    np.testing.assert_array_equal(offs, jindex.shard_offsets(n, s))
    assert offs[0] == 0 and offs[-1] == n and np.diff(offs).sum() == n


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_counts_equal_unsharded_and_scan(n_shards):
    """query_index_sharded == the reference's == query_index == a full
    scan, stats included, with boxes centred on rows at the shard cuts."""
    rng = np.random.default_rng(0)
    n, d = 1000, 5
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    dims = np.arange(d)
    offs = tindex.shard_offsets(n, n_shards)
    centers = np.concatenate([x[offs[:-1]], x[rng.integers(0, n, 4)]])
    lo = (centers - 0.5).astype(np.float32)
    hi = (centers + 0.5).astype(np.float32)
    sidx = tindex.build_sharded_index(x, dims, n_shards, block=64,
                                      device="cpu")
    got, st = tindex.query_index_sharded(sidx, BoxSet(lo, hi, dims))
    want, wst = jindex.query_index_sharded(
        jindex.build_sharded_index(x, dims, n_shards, block=64),
        JaxBoxSet(lo, hi, dims))
    np.testing.assert_array_equal(got, want)
    assert st == wst
    mono, _ = tindex.query_index(tindex.build_index(x, dims, block=64,
                                                    device="cpu"),
                                 BoxSet(lo, hi, dims))
    np.testing.assert_array_equal(got, mono)
    np.testing.assert_array_equal(got, boxes_contain(x, lo, hi))
    assert [sh.n_rows for sh in sidx.shards] == np.diff(offs).tolist()


def test_sharded_counts_with_empty_tail_shards():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (10, 3)).astype(np.float32)
    dims = np.arange(3)
    sidx = tindex.build_sharded_index(x, dims, 8, block=4, device="cpu")
    assert any(sh.n_rows == 0 for sh in sidx.shards)
    lo = (x[3] - 1.0)[None].astype(np.float32)
    hi = (x[3] + 1.0)[None].astype(np.float32)
    got, _ = tindex.query_index_sharded(sidx, BoxSet(lo, hi, dims))
    np.testing.assert_array_equal(got, boxes_contain(x, lo, hi))


@pytest.mark.parametrize("n,n_shards", [(1000, 4), (10, 8), (333, 3)])
def test_stacked_mirrors_match_reference(n, n_shards):
    """rows4 / zlo3 / zhi3, the inverse permutations (virtual when flat,
    local on a mesh) and the global ids are the reference's arrays; a
    mesh places shard s's slice on mesh[s]."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    dims = np.arange(4)
    jix = jindex.build_sharded_index(x, dims, n_shards, block=16)
    tix = tindex.build_sharded_index(x, dims, n_shards, block=16,
                                     device="cpu")
    assert tix.stats() == jix.stats()
    for mesh in (None, ["cpu"] * n_shards):
        want = [*jix.device_arrays(), jix.device_gids()]
        got = [*tix.device_arrays(mesh), tix.device_gids(mesh)]
        for g, w in zip(got, want):
            g = np.stack(g) if isinstance(g, list) else g
            np.testing.assert_array_equal(g, np.asarray(w))
        inv = tix.device_inv_perm(mesh)
        if mesh is None:
            np.testing.assert_array_equal(inv, np.asarray(
                jix.device_inv_perm()))
        else:
            pad = tix.nb_max * tix.block
            for i, sh in enumerate(jix.shards):
                w = np.full(tix.n_loc_max, pad, np.int32)
                w[:sh.n_rows] = np.asarray(sh.device_inv_perm())
                np.testing.assert_array_equal(inv[i], w)
    assert tix.device_bytes()["rows"] == jix.device_bytes()["rows"]


# ----------------------------------------------------------------------
# the engine: shard-count invariance, bitwise the reference
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_engines(catalog):
    feats, labels = catalog
    engines = {s: (SearchEngine(feats, n_shards=s, device="cpu", **ENG),
                   JaxEngine(feats, n_shards=s, **ENG))
               for s in SHARD_COUNTS}
    return engines, labels


@pytest.mark.parametrize("model,seed", [("dbranch", 0), ("dbranch", 1),
                                        ("dbens", 2)])
def test_shard_count_invariance_ranked(sharded_engines, model, seed):
    """ids and scores bitwise for n_shards in {1, 2, 4, 8}, equal to the
    host ranking oracle, and every result (stats too) the reference's."""
    engines, labels = sharded_engines
    pos, neg = _query_sets(labels, 2, seed=seed)
    kw = dict(n_models=6) if model == "dbens" else {}
    # the host-ranked oracle query, on both packages' S = 1 engines so
    # their capacity hints stay alike
    host = engines[1][0].query(pos, neg, model=model, **kw)
    engines[1][1].query(pos, neg, model=model, **kw)
    assert host.n_found > 0
    k = max(1, host.n_found // 2)
    for s, (te, je) in engines.items():
        for mr in (te.n, k, None):
            got = te.query(pos, neg, model=model, max_results=mr, **kw)
            _same(got, je.query(pos, neg, model=model, max_results=mr,
                                **kw))
            np.testing.assert_array_equal(got.ids, host.ids[:mr])
            np.testing.assert_array_equal(got.scores, host.scores[:mr])
            if s > 1:
                assert got.stats["n_shards"] == s


def test_shard_count_invariance_batched(sharded_engines):
    engines, labels = sharded_engines
    reqs = []
    for i in range(3):
        pos, neg = _query_sets(labels, 2, seed=60 + i)
        reqs.append({"pos_ids": pos, "neg_ids": neg, "model": "dbranch",
                     "max_results": 25})
    want = [engines[1][0].query(r["pos_ids"], r["neg_ids"], model="dbranch",
                                max_results=25) for r in reqs]
    for s in (2, 4, 8):
        te, je = engines[s]
        outs = te.query_batch(reqs)
        for o, w, j in zip(outs, want, je.query_batch(reqs)):
            np.testing.assert_array_equal(o.ids, w.ids, err_msg=f"S={s}")
            np.testing.assert_array_equal(o.scores, w.scores)
            _same(o, j, batched=True)
        assert outs[0].stats["batch_n_shards"] == s


@pytest.mark.parametrize("model", ["dtree", "rforest", "knn"])
def test_scan_and_knn_models_on_a_sharded_engine(sharded_engines, model):
    """The scan models and knn (one l2dist a shard, merged by (distance,
    global id)) answer as the reference's sharded engine and as the
    unsharded port."""
    engines, labels = sharded_engines
    pos, neg = _query_sets(labels, 3, seed=5)
    single = engines[1][0].query(pos, neg, model=model, n_models=5,
                                 max_results=60)
    for s in (2, 8):
        te, je = engines[s]
        got = te.query(pos, neg, model=model, n_models=5, max_results=60)
        want = je.query(pos, neg, model=model, n_models=5, max_results=60)
        for other in (want, single):
            np.testing.assert_array_equal(got.ids, other.ids)
            np.testing.assert_array_equal(got.scores, other.scores)
        assert got.stats == want.stats


def test_merged_topk_ties_at_global_kth_score():
    """Whole score-tie groups straddle the global k-th position; every
    shard count cuts them at the host oracle's ascending-id boundary."""
    rng = np.random.default_rng(5)
    base = rng.normal(0, 1, (40, 12)).astype(np.float32)
    x = np.tile(base, (25, 1))
    pos, neg = list(range(5)), list(range(600, 640))
    kw = dict(n_subsets=6, subset_dim=4, block=64, seed=1)
    host = SearchEngine(x, device="cpu", **kw).query(pos, neg)
    ks = [k for k in range(1, host.n_found)
          if host.scores[k - 1] == host.scores[k]]
    assert ks
    for s in (2, 4, 8):
        eng = SearchEngine(x, device="cpu", n_shards=s, **kw)
        for k in (ks[0], ks[-1], host.n_found):
            res = eng.query(pos, neg, max_results=k)
            np.testing.assert_array_equal(res.ids, host.ids[:k],
                                          err_msg=f"S={s} k={k}")
            np.testing.assert_array_equal(res.scores, host.scores[:k])


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sparse_matches_dense_bitwise(n_shards):
    """Twin of tests/test_sparse_scores.py:142: sparse = dense, the same
    host-sync cadence, and both the reference's."""
    rng = np.random.default_rng(7)
    n, d = 3000, 12
    x = (rng.integers(0, 6, size=(n, d)) / 2.0).astype(np.float32)
    x += rng.normal(scale=1e-3, size=(n, d)).astype(np.float32)
    pos = rng.choice(n, 12, replace=False)
    neg = rng.choice(np.setdiff1d(np.arange(n), pos), 25, replace=False)
    kw = dict(n_subsets=8, subset_dim=4, block=64, n_shards=n_shards)
    es = SearchEngine(x, score_mode="sparse", device="cpu", **kw)
    ed = SearchEngine(x, score_mode="dense", device="cpu", **kw)
    js = JaxEngine(x, score_mode="sparse", use_pallas=False, **kw)
    jd = JaxEngine(x, score_mode="dense", use_pallas=False, **kw)
    for mr in (None, 50):
        rs = es.query(pos, neg, max_results=mr)
        rd = ed.query(pos, neg, max_results=mr)
        np.testing.assert_array_equal(rs.ids, rd.ids)
        np.testing.assert_array_equal(rs.scores, rd.scores)
        assert rs.stats["n_host_syncs"] == rd.stats["n_host_syncs"]
        _same(rs, js.query(pos, neg, max_results=mr))
        _same(rd, jd.query(pos, neg, max_results=mr))
    assert es.index_stats()["device_bytes"] == js.index_stats()[
        "device_bytes"]
    assert ed.index_stats()["device_bytes"] == jd.index_stats()[
        "device_bytes"]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_host_oracle_on_a_sharded_engine(sharded_engines, n_shards):
    """use_fused=False runs query_index_sharded: the reference's result
    and stats, and the unsharded engine's ids and scores."""
    engines, labels = sharded_engines
    feats = engines[1][0].x
    pos, neg = _query_sets(labels, 2, seed=8)
    te = SearchEngine(feats, n_shards=n_shards, use_fused=False,
                      device="cpu", **ENG)
    je = JaxEngine(feats, n_shards=n_shards, use_fused=False, **ENG)
    for model in ("dbranch", "dbens"):
        got = te.query(pos, neg, model=model, n_models=5)
        want = je.query(pos, neg, model=model, n_models=5)
        _same(got, want)
        single = engines[1][0].query(pos, neg, model=model, n_models=5)
        np.testing.assert_array_equal(got.ids, single.ids)


# ----------------------------------------------------------------------
# merge vs the host oracle (merge_shard_results), ties included
# ----------------------------------------------------------------------

def _shard_scores(scores_qn, offs):
    s = len(offs) - 1
    nl = np.diff(offs)
    out = np.zeros((s, max(nl.max(), 1), scores_qn.shape[0]),
                   scores_qn.dtype)
    for i in range(s):
        out[i, :nl[i]] = scores_qn[:, offs[i]:offs[i + 1]].T
    return out


def _ops_shard_rank(scores_qn, tids, offs, *, k, smax):
    """The port's sharded ranking through the ops: shard_local_topk per
    shard, then merge_topk."""
    stacked = torch.from_numpy(_shard_scores(scores_qn, offs))
    t = torch.from_numpy(tids)
    per = [tops.shard_local_topk(stacked[i], t, int(offs[i]),
                                 int(offs[i + 1] - offs[i]), k=k,
                                 score_bound=smax)
           for i in range(len(offs) - 1)]
    return tops.merge_topk(torch.stack([g for g, _, _ in per]),
                           torch.stack([c for _, c, _ in per]), k=k)


def _jax_shard_rank(scores_qn, tids, offs, *, k, smax):
    import functools
    local = functools.partial(jops.shard_local_topk, k=k, score_bound=smax)
    gids, sc, _ = jax.vmap(local, in_axes=(0, None, 0, 0))(
        jnp.asarray(_shard_scores(scores_qn, offs)), jnp.asarray(tids),
        jnp.asarray(offs[:-1], jnp.int32),
        jnp.asarray(np.diff(offs), jnp.int32))
    return jops.merge_topk(gids, sc, k=k)


@pytest.mark.parametrize("seed,nq,n,smax,n_shards", [
    (0, 1, 500, 3, 4), (1, 3, 997, 2, 8), (2, 2, 64, 1, 2)])
def test_merge_topk_matches_host_oracle_merge(seed, nq, n, smax, n_shards):
    """Low smax: massive cross-shard ties. The port's merge equals the
    reference's, its own global rank_topk and the host oracle
    merge_shard_results fed each shard's own ranking."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, smax + 1, (nq, n)).astype(np.int32)
    tids = np.full((nq, 8), n, np.int32)
    for q in range(nq):
        tids[q, :4] = rng.choice(n, 4, replace=False)
    offs = tindex.shard_offsets(n, n_shards)
    got = [a.numpy() for a in _ops_shard_rank(scores, tids, offs, k=n,
                                              smax=smax)]
    want = [np.asarray(a) for a in _jax_shard_rank(scores, tids, offs, k=n,
                                                   smax=smax)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids_m, sc_m, nv_m = got
    ids_g, sc_g, nv_g = (a.numpy() for a in tops.rank_topk(
        torch.from_numpy(scores), torch.from_numpy(tids), k=n,
        score_bound=smax))
    for q in range(nq):
        nv = int(nv_g[q])
        assert int(nv_m[q]) == nv
        np.testing.assert_array_equal(ids_m[q, :nv], ids_g[q, :nv])
        np.testing.assert_array_equal(sc_m[q, :nv], sc_g[q, :nv])
        assert (ids_m[q, nv:] == -1).all()
        per_shard = []
        for s in range(n_shards):
            lt = tids[q][(tids[q] >= offs[s]) & (tids[q] < offs[s + 1])]
            i_s, c_s = _host_rank(scores[q, offs[s]:offs[s + 1]],
                                  lt - offs[s])
            per_shard.append(QueryResult("dbranch", i_s, c_s, 0, 0))
        o_ids, o_sc = merge_shard_results(per_shard, offs[:-1].tolist())
        np.testing.assert_array_equal(ids_m[q, :nv], o_ids)
        np.testing.assert_array_equal(sc_m[q, :nv], o_sc)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                       # dev dependency
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1), st.integers(9, 300),
           st.integers(1, 8), st.integers(1, 32), st.integers(1, 6))
    def test_global_ids_survive_remap_property(seed, n, n_shards, k, smax):
        """Any catalog size, shard count, k and score range: the port's
        rank + merge is exactly the global host ranking."""
        rng = np.random.default_rng(seed)
        scores = rng.integers(0, smax + 1, (1, n)).astype(np.int32)
        tids = np.full((1, 4), n, np.int32)
        tids[0, :2] = rng.choice(n, 2, replace=False)
        offs = tindex.shard_offsets(n, n_shards)
        ids_m, sc_m, nv_m = (a.numpy() for a in _ops_shard_rank(
            scores, tids, offs, k=k, smax=smax))
        want_ids, want_sc = _host_rank(scores[0], tids[0, :2])
        nv = min(k, len(want_ids))
        assert int(nv_m[0]) == nv
        np.testing.assert_array_equal(ids_m[0, :nv], want_ids[:nv])
        np.testing.assert_array_equal(sc_m[0, :nv], want_sc[:nv])


# ----------------------------------------------------------------------
# host traffic + overflow semantics
# ----------------------------------------------------------------------

def test_host_bytes_flat_in_shard_count(sharded_engines):
    """Ranked per-query host traffic does not grow with the shard count
    (one sync of a fixed-width stat vector a subset, a [Q, k] result)."""
    engines, labels = sharded_engines
    feats = engines[1][0].x
    pos, neg = _query_sets(labels, 2, seed=9)
    seen = {}
    for s in (2, 4, 8):
        for mode in ("sparse", "dense"):
            eng = SearchEngine(feats, n_shards=s, capacity_frac=1.0,
                               score_mode=mode, device="cpu", **ENG)
            res = eng.query(pos, neg, model="dbranch", max_results=50)
            seen[s, mode] = res.stats["host_bytes_transferred"]
            assert res.stats["n_host_syncs"] == 1
    assert len({v for (s, m), v in seen.items() if m == "dense"}) == 1
    assert len({v for (s, m), v in seen.items() if m == "sparse"}) == 1
    assert max(seen.values()) < 4 * engines[1][0].n


@pytest.mark.parametrize("mesh", [False, True])
def test_sharded_overflow_retry_is_exact(catalog, mesh):
    """A tiny capacity forces overflow; the deferred retry gives the host
    oracle's exact ranking in one extra round, flat and on a mesh."""
    feats, labels = catalog
    kw = dict(n_subsets=8, subset_dim=5, block=16, seed=0, n_shards=4,
              capacity_frac=0.01)
    eng = SearchEngine(feats, device="cpu",
                       shard_mesh=["cpu"] * 4 if mesh else False, **kw)
    pos, neg = _query_sets(labels, 2, seed=4)
    res = eng.query(pos, neg, model="dbens", n_models=6, max_results=eng.n)
    host = SearchEngine(feats, n_subsets=8, subset_dim=5, block=16, seed=0,
                        device="cpu").query(pos, neg, model="dbens",
                                            n_models=6)
    np.testing.assert_array_equal(res.ids, host.ids)
    np.testing.assert_array_equal(res.scores, host.scores)
    assert res.stats["retried_subsets"] > 0
    assert res.stats["n_host_syncs"] == 2
    if not mesh:
        _same(res, JaxEngine(feats, **kw).query(
            pos, neg, model="dbens", n_models=6, max_results=eng.n))


def test_sharded_engine_reports_shard_stats(sharded_engines):
    engines, labels = sharded_engines
    pos, neg = _query_sets(labels, 2, seed=3)
    te, je = engines[4]
    st = te.query(pos, neg, model="dbranch", max_results=20).stats
    assert st["n_shards"] == 4 and st["path"] == "index"
    assert 0 < st["blocks_touched"] <= st["blocks_gathered"]
    want, got = je.index_stats(), te.index_stats()
    for k in ("n_shards", "rows", "index_bytes", "device_bytes",
              "device_bytes_per_index", "score_buffer_bytes_peak"):
        assert got[k] == want[k], k
    assert te.shard_mesh is None


# ----------------------------------------------------------------------
# the mesh leg: a device list naming the CPU several times
# ----------------------------------------------------------------------

@pytest.mark.parametrize("score_mode", ["sparse", "dense"])
def test_shard_map_mesh_mode_matches_flat_and_oracle(catalog, score_mode):
    """n_shards=8 over shard_mesh=["cpu"] * 8: each shard's step runs on
    its list entry, the outputs gathered to the first; ids and scores
    bitwise the flat engine's and the host oracle's, for query and
    query_batch."""
    feats, labels = catalog
    feats, labels = feats[:900], labels[:900]
    kw = dict(n_subsets=6, subset_dim=5, block=64, seed=0,
              score_mode=score_mode)
    pos, neg = _query_sets(labels, 2, n_pos=10, n_neg=40, seed=3)
    host = SearchEngine(feats, device="cpu", **kw).query(pos, neg)
    em = SearchEngine(feats, n_shards=8, shard_mesh=["cpu"] * 8,
                      device="cpu", **kw)
    ev = SearchEngine(feats, n_shards=8, shard_mesh=False, device="cpu",
                      **kw)
    assert em.shard_mesh == (torch.device("cpu"),) * 8
    assert ev.shard_mesh is None
    for mr in (em.n, 17, None):
        rm = em.query(pos, neg, max_results=mr)
        rv = ev.query(pos, neg, max_results=mr)
        for other in (rv, host):
            np.testing.assert_array_equal(rm.ids, other.ids[:mr])
            np.testing.assert_array_equal(rm.scores, other.scores[:mr])
        # per-shard capacities on the mesh: every shard gathers the bucket
        assert rm.stats["n_shards"] == 8
        assert rm.stats["blocks_gathered"] % 8 == 0
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "max_results": 30}
            for m in ("dbranch", "dbens")]
    for a, b in zip(em.query_batch(reqs), ev.query_batch(reqs)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_mesh_resolution():
    """None builds a mesh only on CUDA with >= n_shards cards; False is
    flat; an explicit list is honoured; a live engine is always flat."""
    x = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    kw = dict(n_subsets=2, subset_dim=4, block=32, device="cpu")
    assert SearchEngine(x, n_shards=2, **kw).shard_mesh is None
    assert SearchEngine(x, n_shards=2, shard_mesh=False,
                        **kw).shard_mesh is None
    eng = SearchEngine(x, n_shards=2, shard_mesh=["cpu", "cpu"], **kw)
    assert eng.shard_mesh == (torch.device("cpu"),) * 2
    live = SearchEngine(x, n_shards=2, live=True,
                        shard_mesh=["cpu", "cpu"], **kw)
    assert live.shard_mesh is None and live.n_shards == 2


# ----------------------------------------------------------------------
# live catalogs with shards (flat)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("score_mode", ["sparse", "dense"])
def test_live_with_shards_flat_fallback_parity(score_mode):
    """Twin of tests/test_live_catalog.py:390: a ceil-split base, deltas
    on per-shard tails, tombstones; every result the reference's (stats
    included) and the port's monolithic engine's over the survivors."""
    rng = np.random.default_rng(0)
    base = rng.normal(0, 1, (2500, 12)).astype(np.float32)
    extra = rng.normal(0, 1, (600, 12)).astype(np.float32)
    pos, neg = list(range(8)), list(range(100, 140))
    kw = dict(n_subsets=6, subset_dim=4, block=64, seed=0, n_shards=2,
              live=True, score_mode=score_mode)
    te = SearchEngine(base, device="cpu", **kw)
    je = JaxEngine(base, **kw)
    assert te.index_stats()["n_segments"] == 2
    dele = rng.choice(3100, 150, replace=False)
    dele = dele[~np.isin(dele, pos + neg)]
    for e in (te, je):
        e.append(extra[:100])
        e.append(extra[100:])
        e.delete(dele)
    st = te.index_stats()
    assert sorted({s["shard"] for s in st["segments"]}) == [0, 1]
    assert st["n_shards"] == je.index_stats()["n_shards"] == 2
    x_all = np.concatenate([base, extra])
    alive = np.setdiff1d(np.arange(len(x_all)), dele)
    mono = SearchEngine(x_all[alive], n_subsets=6, subset_dim=4, block=64,
                        seed=0, device="cpu")
    mpos = np.searchsorted(alive, pos)
    mneg = np.searchsorted(alive, neg)
    for model in ("dbranch", "dbens"):
        for mr in (50, None):
            got = te.query(pos, neg, model=model, n_models=5,
                           max_results=mr)
            _same(got, je.query(pos, neg, model=model, n_models=5,
                                max_results=mr))
            m = mono.query(mpos, mneg, model=model, n_models=5,
                           max_results=mr)
            np.testing.assert_array_equal(got.ids, alive[m.ids])
            np.testing.assert_array_equal(got.scores, m.scores)


# ----------------------------------------------------------------------
# the distributed query over a device list
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 4])
def test_distributed_query_matches_local(n_dev):
    """Twin of tests/test_index_engine.py:133: distributed_query over a
    device list == the reference's over a one-device mesh == query_index,
    Morton order mapped back; distributed_query_pruned too (capacity per
    device covers the survivors)."""
    from jax.sharding import Mesh
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2048, 4)).astype(np.float32)
    idx = tindex.build_index(x, np.arange(4), block=128, device="cpu")
    lo = (x[5] - 0.4)[None].astype(np.float32)
    hi = (x[5] + 0.4)[None].astype(np.float32)
    rows = idx.rows.reshape(idx.n_blocks, idx.block, -1)
    args = [torch.from_numpy(a) for a in (rows, idx.zlo, idx.zhi, lo, hi)]
    mesh = ["cpu"] * n_dev
    got = tindex.distributed_query(*args, mesh, idx.block).numpy()
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1), ("data",))
    jargs = [jnp.asarray(a) for a in (rows, idx.zlo, idx.zhi, lo, hi)]
    want = np.asarray(jindex.distributed_query(*jargs, jmesh, idx.block))
    np.testing.assert_array_equal(got, want)
    pruned = tindex.distributed_query_pruned(*args, mesh, idx.block,
                                             idx.n_blocks // n_dev).numpy()
    np.testing.assert_array_equal(pruned, np.asarray(
        jindex.distributed_query_pruned(*jargs, jmesh, idx.block,
                                        idx.n_blocks)))
    back = np.zeros(idx.n_rows, np.int32)
    valid = idx.perm >= 0
    back[idx.perm[valid]] = got[valid]
    local, _ = tindex.query_index(idx, BoxSet(lo, hi, np.arange(4)))
    np.testing.assert_array_equal(back, local)


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_pruned_local_step_matches_reference(capacity):
    """The per-device step alone, overflow included (capacity below the
    survivors drops the later blocks, as in the reference)."""
    rng = np.random.default_rng(capacity)
    x = rng.normal(0, 1, (1024, 3)).astype(np.float32)
    idx = tindex.build_index(x, np.arange(3), block=64, device="cpu")
    lo = (x[:3] - 0.5).astype(np.float32)
    hi = (x[:3] + 0.5).astype(np.float32)
    rows = idx.rows.reshape(idx.n_blocks, idx.block, -1)
    got = tindex.pruned_local_step(64, capacity)(
        *(torch.from_numpy(a) for a in (rows, idx.zlo, idx.zhi, lo, hi)))
    want = jindex.pruned_local_step(64, capacity)(
        *(jnp.asarray(a) for a in (rows, idx.zlo, idx.zhi, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card "
                    "(python -m pytest -m gpu tests/test_torch_sharded.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("opts", [{}, {"score_mode": "dense"},
                                  {"use_fused": False},
                                  {"shard_mesh": ["cuda:0"] * 8}])
def test_sharded_engine_cuda_matches_cpu(cuda, catalog, n_shards, opts):
    feats, labels = catalog
    if "shard_mesh" in opts:
        opts = {"shard_mesh": opts["shard_mesh"][:n_shards]}
    eg = SearchEngine(feats, n_shards=n_shards, device=cuda, **ENG, **opts)
    ec = SearchEngine(feats, n_shards=n_shards, device="cpu", **ENG,
                      **{k: v for k, v in opts.items() if k != "shard_mesh"})
    pos, neg = _query_sets(labels, 2, seed=1)
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "max_results": mr}
            for m in ("dbranch", "dbens") for mr in (40, None)]
    for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    for m in ("dtree", "knn"):
        a, b = eg.query(pos, neg, model=m), ec.query(pos, neg, model=m)
        np.testing.assert_array_equal(a.ids, b.ids)


def _distributed_inputs(seed, n, d, block, box_rows, width):
    """A small index's Morton-ordered rows and zones and boxes around the
    given rows, as numpy arrays (rows [NB, block, d'])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    idx = tindex.build_index(x, np.arange(d), block=block, device="cpu")
    lo = (x[box_rows] - width).astype(np.float32)
    hi = (x[box_rows] + width).astype(np.float32)
    rows = idx.rows.reshape(idx.n_blocks, idx.block, -1)
    return idx, (rows, idx.zlo, idx.zhi, lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("n_dev", [2, 4])
def test_distributed_query_cuda_matches_cpu(cuda, n_dev):
    """distributed_query (zone_hits + box_scan a device) and its pruned
    form (zone_candidates + box_scan) over a list naming the card n_dev
    times: bitwise the same calls over a CPU list."""
    idx, arrs = _distributed_inputs(0, 2048, 4, 128, [5, 77], 0.4)
    cpu = [torch.from_numpy(a) for a in arrs]
    dev = [t.to(cuda) for t in cpu]
    for fn, extra in ((tindex.distributed_query, ()),
                      (tindex.distributed_query_pruned,
                       (idx.n_blocks // n_dev,))):
        want = fn(*cpu, ["cpu"] * n_dev, idx.block, *extra)
        got = fn(*dev, [cuda] * n_dev, idx.block, *extra)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_pruned_local_step_cuda_matches_cpu(cuda, capacity):
    """The per-device step on the card (scatter_reduce over 0-filled
    candidate slots included), overflow too: bitwise the CPU step."""
    idx, arrs = _distributed_inputs(capacity, 1024, 3, 64, [0, 1, 2], 0.5)
    step = tindex.pruned_local_step(64, capacity)
    cpu = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_array_equal(
        step(*(t.to(cuda) for t in cpu)).cpu().numpy(), step(*cpu).numpy())
