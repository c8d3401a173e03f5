"""The port's live catalog (``live=True``: append / delete / compact over
segmented zone maps) against the reference's, on the CPU.

Every schedule runs through the reference's live engine and the port's
(``device="cpu"``) with the same seeded data, labels and options. After
every step the ranked ids and scores, and the integer stats (syncs,
retries, gather pricing, host bytes, tile memory, ``n_segments``,
``rows_live``, ``rows_tombstoned``, ``per_segment_blocks_touched``), must
be bitwise equal, and the port's ids and scores bitwise those of its own
monolithic engine built over the surviving rows (ids mapped through the
live-id list). Four modes: the default (device fit, survivor tiles), the
numpy trainers, the dense score buffer, and the ``use_fused=False`` host
oracle.

knn distances on float data: the reference sums squared differences with
``jnp.sum`` and the port in ascending dim order, so a distance may differ
in the last bit (tests/test_torch_models.py); where distances are float
they are held to rtol 1e-4 / atol 1e-3 and a swapped pair of ids must be
the same ids.

The ``gpu``-marked twins run the same schedules on the card against the
CPU and skip without one.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import knn as jknn
from repro.core.engine import SearchEngine as JaxEngine
from repro.kernels import ops as jops
from repro_torch.core import SearchEngine
from repro_torch.core import knn as tknn
from repro_torch.core.convert import catalog_from_arrays
from repro_torch.core.errors import PersistenceError, TransientDeviceError
from repro_torch.core.segments import SegmentedCatalog
from repro_torch.kernels import ops as tops

ENG = dict(n_subsets=4, subset_dim=4, block=64)
MODES = {"default": {},
         "numpy_fit": {"use_jax_fit": False},
         "dense": {"score_mode": "dense"},
         "host_oracle": {"use_fused": False, "use_jax_fit": False}}
# stats that are wall-clock times, not results
TIMES = ("batch_fit_s",)


def _data(n=700, extra=300, d=16, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n + extra, d)).astype(np.float32)
    if ties:
        x[50:60] = x[40:50]          # duplicate rows -> kth-score ties
    return x[:n], x[n:]


def _labels(n_pos=12, n_neg=60):
    return list(range(n_pos)), list(range(100, 100 + n_neg))


def _pair(x, mode="default"):
    opts = {**ENG, **MODES[mode]}
    return (JaxEngine(x, live=True, **opts),
            SearchEngine(x, live=True, device="cpu", **opts))


def _same(a, b):
    """Ids, scores (dtypes too), the same stat keys, and every non-float
    stat equal."""
    if isinstance(a, Exception):
        assert type(a) is type(b), (a, b)
        return
    assert a.model == b.model
    assert a.ids.dtype == b.ids.dtype and a.scores.dtype == b.scores.dtype
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert set(a.stats) == set(b.stats), set(a.stats) ^ set(b.stats)
    for k, v in a.stats.items():
        if isinstance(v, float) or k in TIMES:
            continue
        assert b.stats[k] == v, (k, v, b.stats[k])


def _live_ids(eng):
    return np.nonzero(eng._catalog.snapshot().valid_host)[0]


def _mono(x_all, live_ids, pos, neg, k, mode):
    """The port's monolithic engine over ONLY the surviving rows; ids
    mapped back to global through the live-id list."""
    eng = SearchEngine(x_all[live_ids], **ENG, **MODES[mode], device="cpu")
    res = eng.query(np.searchsorted(live_ids, pos),
                    np.searchsorted(live_ids, neg), model="dbranch",
                    max_results=k)
    return live_ids[res.ids], res.scores


def _parity(je, te, x_all, pos, neg, k, mode):
    """Reference == port (ids, scores, stats), and port == its monolithic
    rebuild over the survivors. Returns the port's result."""
    a = je.query(pos, neg, model="dbranch", max_results=k)
    b = te.query(pos, neg, model="dbranch", max_results=k)
    _same(a, b)
    np.testing.assert_array_equal(_live_ids(je), _live_ids(te))
    ids_m, sc_m = _mono(x_all, _live_ids(te), pos, neg, k, mode)
    np.testing.assert_array_equal(b.ids, ids_m)
    np.testing.assert_array_equal(b.scores, sc_m)
    if mode != "host_oracle":
        per_seg = b.stats["per_segment_blocks_touched"]
        assert len(per_seg) == b.stats["n_segments"]
        assert sum(per_seg) == b.stats["blocks_touched"]
    return b


def _same_catalog_stats(je, te, mode="default"):
    """index_stats equal, the resident device bytes too: by kind and per
    index, except on the host oracle, whose query_index reads the port's
    device mirror and the reference's host rows."""
    sj, st = je.index_stats(), te.index_stats()
    for k, v in sj.items():
        if k in ("build_time_s", "device_bytes", "device_bytes_per_index"):
            continue
        assert st[k] == v, (k, v, st[k])
    if mode == "host_oracle":
        return
    assert st["device_bytes"] == sj["device_bytes"]
    for wj, wt in zip(sj["device_bytes_per_index"],
                      st["device_bytes_per_index"]):
        assert wt == wj


# ----------------------------------------------------------------------
# the reference's schedules, through both packages, in every mode
# ----------------------------------------------------------------------

def _run_schedule(seed: int, n0: int, ops, mode: str):
    rng = np.random.default_rng(seed)
    d = 10
    x_all = rng.normal(0, 1, (n0 + 4 * 80, d)).astype(np.float32)
    x_all[30:36] = x_all[24:30]            # kth-score tie fodder
    pos = list(rng.choice(n0 // 2, 8, replace=False))
    neg = [int(v) for v in
           rng.choice(np.arange(n0 // 2, n0), 30, replace=False)]
    je, te = _pair(x_all[:n0], mode)
    cursor = n0
    for op in ops:
        if op == "append":
            m = int(rng.integers(1, 80))   # ragged tails (m % 64)
            np.testing.assert_array_equal(
                je.append(x_all[cursor:cursor + m]),
                te.append(x_all[cursor:cursor + m]))
            cursor += m
        elif op == "delete":
            cand = _live_ids(te)
            cand = cand[~np.isin(cand, pos + neg)]
            if len(cand) > 20:
                dele = rng.choice(cand, 15, replace=False)
                assert je.delete(dele) == te.delete(dele)
        else:
            sj, st = je.compact(), te.compact()
            assert sj["skipped"] == st["skipped"]
        _parity(je, te, x_all[:cursor], pos, neg, 25, mode)
        _same_catalog_stats(je, te, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed,ops", [
    (1, ["append", "delete", "append", "compact"]),
    (2, ["delete", "compact", "append"]),
    (3, ["append", "append", "append", "delete", "compact", "delete"]),
])
def test_schedule_parity_seeded(seed, ops, mode):
    _run_schedule(seed, 200 + 13 * seed, ops, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_append_then_delete_then_compact_with_ties(mode):
    base, extra = _data()
    x_all = np.concatenate([base, extra])
    pos, neg = _labels()
    je, te = _pair(base, mode)
    _parity(je, te, base, pos, neg, 50, mode)
    ids = te.append(extra)                       # ragged delta (300 % 64)
    je.append(extra)
    assert ids[0] == len(base) and len(ids) == len(extra)
    res = _parity(je, te, x_all, pos, neg, 50, mode)
    dele = [int(i) for i in res.ids[:5]] + [int(ids[3])]
    dele = [i for i in dele if i not in pos + neg]
    assert te.delete(dele) == je.delete(dele) == len(set(dele))
    res = _parity(je, te, x_all, pos, neg, 50, mode)
    assert not np.intersect1d(res.ids, dele).size
    sj, st = je.compact(), te.compact()
    assert not st["skipped"] and st["merged_segments"] == 2
    assert {k: v for k, v in sj.items() if k != "compact_s"} == \
        {k: v for k, v in st.items() if k != "compact_s"}
    assert te.index_stats()["n_segments"] == 1
    res2 = _parity(je, te, x_all, pos, neg, 50, mode)
    np.testing.assert_array_equal(res.ids, res2.ids)
    np.testing.assert_array_equal(res.scores, res2.scores)
    _same_catalog_stats(je, te, mode)


def test_host_rank_path_and_oracle_engine():
    """max_results=None (host ranking) and use_fused=False (per-segment
    query_index) after an append + delete, both packages."""
    base, extra = _data(ties=False)
    pos, neg = _labels()
    for mode in ("default", "dense", "host_oracle"):
        je, te = _pair(base, mode)
        for e in (je, te):
            e.append(extra)
            e.delete([500, 710, 711])
        for mr in (80, None):
            _same(je.query(pos, neg, max_results=mr),
                  te.query(pos, neg, max_results=mr))
        host = te.query(pos, neg, max_results=None)
        if mode == "default":
            want = host
        np.testing.assert_array_equal(host.ids, want.ids)
        np.testing.assert_array_equal(host.scores, want.scores)
        dev = te.query(pos, neg, max_results=80)
        np.testing.assert_array_equal(dev.ids, host.ids[:80])


def test_query_batch_parity_and_generation_tagged_hints():
    base, extra = _data(ties=False)
    x_all = np.concatenate([base, extra])
    je, te = _pair(base)
    reqs = [{"pos_ids": list(range(i, i + 10)),
             "neg_ids": list(range(200, 260)),
             "model": "dbranch", "max_results": 40} for i in (0, 20)]
    for a, b in zip(je.query_batch(reqs), te.query_batch(reqs)):
        _same(a, b)
    gen0 = set(te._cap_hints)
    assert gen0 == set(je._cap_hints) and all(k[0] == 0 for k in gen0)
    for e in (je, te):
        e.append(extra)
    assert gen0 <= set(te._cap_hints)       # appends keep the hints
    for e in (je, te):
        e.delete([650])
    assert gen0 <= set(te._cap_hints)
    outs = te.query_batch(reqs)
    for a, b in zip(je.query_batch(reqs), outs):
        _same(a, b)
    live_ids = _live_ids(te)
    mono = SearchEngine(x_all[live_ids], **ENG, device="cpu")
    mono_outs = mono.query_batch(
        [{**r, "pos_ids": np.searchsorted(live_ids, r["pos_ids"]),
          "neg_ids": np.searchsorted(live_ids, r["neg_ids"])}
         for r in reqs])
    for out, m in zip(outs, mono_outs):
        np.testing.assert_array_equal(out.ids, live_ids[m.ids])
        np.testing.assert_array_equal(out.scores, m.scores)
    for e in (je, te):
        e.compact()
    assert all(k[0] == 1 for k in te._cap_hints)
    for a, b in zip(je.query_batch(reqs), te.query_batch(reqs)):
        _same(a, b)
    assert set(te._cap_hints) == set(je._cap_hints)
    assert any(k[0] == 1 for k in te._cap_hints)


def test_hint_pruning_across_two_generations():
    """Deltas larger than the base, two compactions: hints are relearned
    per generation and the table holds one generation, as the
    reference's."""
    rng = np.random.default_rng(9)
    base = rng.normal(0, 1, (400, 16)).astype(np.float32)
    d1 = rng.normal(0, 1, (500, 16)).astype(np.float32)
    d2 = rng.normal(0, 1, (400, 16)).astype(np.float32)
    x_all = np.concatenate([base, d1, d2])
    pos, neg = _labels()
    je, te = _pair(base)
    _parity(je, te, base, pos, neg, 40, "default")
    for e in (je, te):
        e.append(d1)
        e.delete([700, 705])
    _parity(je, te, x_all[:900], pos, neg, 40, "default")
    for gen, delta in ((1, d2), (2, None)):
        for e in (je, te):
            e.compact()
        assert all(k[0] == gen for k in te._cap_hints)
        if delta is not None:
            for e in (je, te):
                e.append(delta)
        _parity(je, te, x_all, pos, neg, 40, "default")
        assert set(te._cap_hints) == set(je._cap_hints)
        assert {k[0] for k in te._cap_hints} == {gen}


def test_refine_id_stability_across_append():
    base, extra = _data(ties=False)
    x_all = np.concatenate([base, extra])
    pos, neg = _labels()
    je, te = _pair(base)
    first = te.query(pos, neg, model="dbranch", max_results=30)
    _same(je.query(pos, neg, model="dbranch", max_results=30), first)
    extra_pos, extra_neg = [int(first.ids[0])], [int(first.ids[-1])]
    for e in (je, te):
        e.append(extra)
    got = te.refine(first, extra_pos, extra_neg, pos, neg, max_results=30)
    _same(je.refine(first, extra_pos, extra_neg, pos, neg, max_results=30),
          got)
    ids_m, sc_m = _mono(x_all, np.arange(len(x_all)), pos + extra_pos,
                        neg + extra_neg, 30, "default")
    np.testing.assert_array_equal(got.ids, ids_m)
    np.testing.assert_array_equal(got.scores, sc_m)


# ----------------------------------------------------------------------
# scan and knn under tombstones
# ----------------------------------------------------------------------

def test_scan_and_knn_paths_respect_tombstones():
    """dtree / rforest / knn after an append and a delete: equal to the
    reference, and no tombstoned id comes back; the scan copy of the
    features follows the appends."""
    base, extra = _data(ties=False)
    pos, neg = _labels()
    je, te = _pair(base)
    te.query(pos, neg, model="dtree")           # upload the base's rows
    assert te.feature_mirror_bytes() == base.nbytes
    ids = te.append(extra)
    je.append(extra)
    probe = te.query(pos, neg, model="dtree", max_results=None)
    _same(je.query(pos, neg, model="dtree", max_results=None), probe)
    assert te.feature_mirror_bytes() == base.nbytes + extra.nbytes
    dele = [int(i) for i in probe.ids[:3]] + [int(ids[0])]
    for e in (je, te):
        e.delete(dele)
    for model in ("dtree", "rforest", "knn"):
        for mr in (None, 20):
            a = je.query(pos, neg, model=model, max_results=mr,
                         k_neighbors=40)
            b = te.query(pos, neg, model=model, max_results=mr,
                         k_neighbors=40)
            _same(a, b)
            assert not np.intersect1d(b.ids, dele).size, model


def _assert_knn_float(got_ids, got_d, want_ids, want_d):
    assert got_ids.shape == want_ids.shape
    swapped = got_ids != want_ids
    assert swapped.sum() <= 2
    for r in np.nonzero(swapped.any(1))[0]:
        np.testing.assert_array_equal(np.sort(got_ids[r, swapped[r]]),
                                      np.sort(want_ids[r, swapped[r]]))
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("k", [1, 25, 2000])
def test_knn_segmented_matches_reference_and_bruteforce(k):
    base, extra = _data(ties=False)
    x_all = np.concatenate([base, extra])
    je, te = _pair(base)
    for e in (je, te):
        e.append(extra[:100])
        e.append(extra[100:])
        e.delete(list(range(60, 90)) + [701, 702])
    sj, st = je._catalog.snapshot(), te._catalog.snapshot()
    queries = x_all[[5, 300, 720]]
    wids, wd = jknn.knn_subset(sj.indexes[0], queries, k=k,
                               live=sj.valid_host)
    gids, gd = tknn.knn_subset(st.indexes[0], queries, k=k,
                               live=st.valid_host)
    assert gids.dtype == wids.dtype
    _assert_knn_float(gids, gd, wids, np.asarray(wd))
    live_ids = np.nonzero(st.valid_host)[0]
    assert gids.shape == (3, min(k, len(live_ids)))
    dims = st.indexes[0].dims
    xl = x_all[live_ids][:, dims]
    qd = ((xl[None, :, :] - queries[:, None, dims]) ** 2).sum(-1)
    order = np.lexsort(
        (np.broadcast_to(live_ids, qd.shape), qd), axis=1)[:, :k]
    _assert_knn_float(gids, gd, live_ids[order],
                      np.take_along_axis(qd, order, 1))


# ----------------------------------------------------------------------
# the masked ops
# ----------------------------------------------------------------------

def test_masked_accumulate_and_tile_candidates_match_reference():
    rng = np.random.default_rng(0)
    n, block, nb, q, c = 256, 32, 8, 3, 6
    counts = rng.integers(0, 5, (c, block, q)).astype(np.int32)
    counts[1] = 0
    cand = np.array([1, 3, 4, 6, 0, 0], np.int32)
    inv = rng.permutation(n).astype(np.int32)
    valid = rng.integers(0, 2, n).astype(np.int32)
    gids = rng.permutation(nb * block).astype(np.int32).reshape(nb, block)
    gids[gids >= n] = -1                      # padding slots
    start = rng.integers(0, 9, (n, q)).astype(np.int32)
    for v in (None, valid):
        vj = None if v is None else jnp.asarray(v)
        vt = None if v is None else torch.from_numpy(v)
        want = np.asarray(jops.accumulate_scores(
            jnp.asarray(start), jnp.asarray(counts), jnp.asarray(cand),
            jnp.asarray(inv), vj, nb=nb))
        got = tops.accumulate_scores(
            torch.from_numpy(start), torch.from_numpy(counts),
            torch.from_numpy(cand), torch.from_numpy(inv), vt, nb=nb)
        np.testing.assert_array_equal(got.numpy(), want)
        wg, wo = jops.tile_candidates(jnp.asarray(counts), jnp.asarray(cand),
                                      jnp.asarray(gids), valid=vj)
        gg, go = tops.tile_candidates(torch.from_numpy(counts),
                                      torch.from_numpy(cand),
                                      torch.from_numpy(gids), valid=vt)
        np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    # the mask zeroes exactly the tombstoned rows' increments
    base = tops.accumulate_scores(
        torch.zeros((n, q), dtype=torch.int32), torch.from_numpy(counts),
        torch.from_numpy(cand), torch.from_numpy(inv), nb=nb).numpy()
    masked = tops.accumulate_scores(
        torch.zeros((n, q), dtype=torch.int32), torch.from_numpy(counts),
        torch.from_numpy(cand), torch.from_numpy(inv),
        torch.from_numpy(valid), nb=nb).numpy()
    np.testing.assert_array_equal(masked, base * valid[:, None])
    assert masked.sum() < base.sum()


# ----------------------------------------------------------------------
# stats, guards, snapshots, compaction off the serving thread
# ----------------------------------------------------------------------

def test_segment_stats_honest_accounting():
    base, extra = _data(ties=False)
    pos, neg = _labels()
    je, te = _pair(base)
    for e in (je, te):
        ids = e.append(extra)
        e.delete(ids[:10])
    _same_catalog_stats(je, te)
    st = te.index_stats()
    assert st["live"] and st["n_segments"] == 2 and st["epoch"] == 2
    assert st["rows_live"] == len(base) + len(extra) - 10
    assert st["rows_tombstoned"] == 10
    assert sum(s["bytes"] for s in st["segments"]) == st["index_bytes"]
    a = je.query(pos, neg, model="dbranch", max_results=40)
    b = te.query(pos, neg, model="dbranch", max_results=40)
    _same(a, b)
    for k in ("n_segments", "rows_live", "rows_tombstoned",
              "per_segment_blocks_touched"):
        assert b.stats[k] == a.stats[k], k
    assert b.stats["rows_live"] == st["rows_live"]
    # after the query the mirrors it built count, as in the reference
    _same_catalog_stats(je, te)
    assert te.index_stats()["device_bytes"]["total"] > 0


def test_lifecycle_guards():
    base, extra = _data(ties=False)
    static = SearchEngine(base, **ENG, device="cpu")
    with pytest.raises(RuntimeError, match="live=True"):
        static.append(extra)
    with pytest.raises(RuntimeError, match="live=True"):
        static.compact()
    eng = SearchEngine(base, **ENG, live=True, device="cpu")
    with pytest.raises(ValueError, match="width"):
        eng.append(extra[:, :4])
    with pytest.raises(ValueError, match="range"):
        eng.delete([len(base) + 5])
    assert eng.append(extra[:0]).size == 0           # no-op, no epoch
    assert eng.index_stats()["epoch"] == 0
    assert eng.delete([]) == 0
    assert eng.delete([3, 3, 3]) == 1                # idempotent dedup
    assert eng.delete([3]) == 0
    assert eng.compact()["skipped"]                  # single segment
    assert eng.index_stats()["epoch"] == 1
    assert eng.invalidate_capacity_hints() == 0
    eng.query(*_labels(), max_results=10)
    assert eng.invalidate_capacity_hints() > 0
    assert len(eng._cap_hints) == 0
    eng.close()                                      # nothing to flush
    # a memory-only catalog has nothing to checkpoint to: the typed error
    # of the reference (tests/test_durability.py's last test)
    with pytest.raises(PersistenceError, match="persist_dir"):
        eng.checkpoint()


def test_catalog_refuses_durability_and_faults():
    """Durability and the fault seams are ported: a memory-only catalog
    refuses checkpoint() with the reference's typed error and reports no
    durability; a durable one fills stats()["durable"] with the
    reference's keys and values (wall times aside), and its seams fire
    before any state changes."""
    import tempfile
    from repro.core.segments import SegmentedCatalog as JaxCatalog
    from repro_torch.serve import FaultInjector, FaultSpec
    base, extra = _data(ties=False)
    subsets = SearchEngine(base, **ENG, device="cpu").subsets
    cat = SegmentedCatalog(base, subsets, block=64, device="cpu")
    with pytest.raises(PersistenceError, match="persist_dir"):
        cat.checkpoint()
    assert cat.durability_snapshot() is None
    assert cat.stats()["durable"] is None
    cat.close()                                      # nothing to flush
    got = {}
    for name, cls, kw in (("repro", JaxCatalog, {}),
                          ("repro_torch", SegmentedCatalog,
                           {"device": "cpu"})):
        with tempfile.TemporaryDirectory() as d:
            c = cls(base, subsets, block=64, persist_dir=d, **kw)
            c.append(extra[:100])
            c.delete([3, 4])
            c.checkpoint()
            got[name] = c.stats()["durable"]
            c.close()
    for st in got.values():
        st.pop("wal_sync_s")
    assert got["repro_torch"] == got["repro"]
    assert got["repro"]["lsn"] == 2 and got["repro"]["checkpoints"] == 2
    inj = FaultInjector(specs=[FaultSpec("append", "fail", at_calls=(1,)),
                               FaultSpec("delete", "fail", at_calls=(1,))])
    cat = SegmentedCatalog(base, subsets, block=64, device="cpu",
                           faults=inj)
    for call in (lambda: cat.append(extra[:10]), lambda: cat.delete([1])):
        with pytest.raises(TransientDeviceError):
            call()
    assert cat.epoch == 0 and cat._lsn == 0          # nothing changed


def test_build_indexes_equals_each_build_index():
    """The thread-pooled build of every subset's index (the catalog's
    segments, the static engine) gives each subset's build_index."""
    from repro_torch.core.index import build_index, build_indexes
    base, _ = _data(ties=False)
    subsets = SearchEngine(base, **ENG, device="cpu").subsets
    got = build_indexes(base, subsets, block=64, device="cpu")
    for k, (ix, dims) in enumerate(zip(got, subsets)):
        want = build_index(base, dims, block=64, subset_id=k, device="cpu")
        assert ix.subset_id == k and ix.n_rows == want.n_rows
        for f in ("dims", "perm", "rows", "zlo", "zhi"):
            np.testing.assert_array_equal(getattr(ix, f), getattr(want, f))


def test_catalog_snapshot_isolation():
    """An in-flight reader's snapshot is untouched by later mutations."""
    base, extra = _data(ties=False)
    cat = SegmentedCatalog(base, SearchEngine(base, **ENG,
                                              device="cpu").subsets,
                           block=64, device="cpu")
    snap0 = cat.snapshot()
    cat.append(extra)
    cat.delete([0, 1])
    cat.compact()
    assert snap0.epoch == 0 and snap0.n == len(base)
    assert snap0.valid_host.all()
    assert len(snap0.segments) == 1
    assert cat.snapshot().epoch == 3 and cat.snapshot().geom == 1
    assert cat.snapshot().n == len(base) + len(extra)
    assert not cat.snapshot().valid_host[:2].any()


def test_catalog_shard_bookkeeping_matches_reference():
    """n_shards > 1 at the catalog level (host bookkeeping only): the
    ceil-split base and the per-shard tails of appends, as the
    reference's catalog keeps them."""
    from repro.core.segments import SegmentedCatalog as JaxCatalog
    base, extra = _data(ties=False)
    subsets = SearchEngine(base, **ENG, device="cpu").subsets
    jc = JaxCatalog(base, subsets, block=64, n_shards=3)
    tc = SegmentedCatalog(base, subsets, block=64, n_shards=3,
                          device="cpu")
    for c in (jc, tc):
        c.append(extra[:100])
        c.append(extra[100:])
        c.delete([5, 400])
    sj, st = jc.stats(), tc.stats()
    assert st == {**sj, "durable": None}
    assert st["shard_tail_segments"] == [2, 2, 1]


def _counting_ops(monkeypatch):
    """Wrap the kernel stages of kernels/ops and record the thread of each
    call."""
    calls = []
    for name in ("zone_candidates", "zone_prune", "zone_hits", "box_scan",
                 "box_scan_seg_gather", "l2dist"):
        fn = getattr(tops, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, threading.get_ident()))
            return _fn(*a, **kw)
        monkeypatch.setattr(tops, name, rec)
    return calls


def test_background_compaction_launches_nothing(monkeypatch):
    """The merge thread does host work only: no kernel stage runs on it,
    and the merged segment's device mirrors are not built until a query
    needs them. Queries on the old snapshot meanwhile answer as before."""
    base, extra = _data(ties=False)
    x_all = np.concatenate([base, extra])
    pos, neg = _labels()
    je, te = _pair(base)
    for e in (je, te):
        e.append(extra)
    before = te.query(pos, neg, model="dbranch", max_results=50)
    calls = _counting_ops(monkeypatch)
    main = threading.get_ident()
    t = te.compact(background=True)
    during = te.query(pos, neg, model="dbranch", max_results=50)
    t.join(timeout=60)
    assert not t.is_alive()
    assert calls and {tid for _, tid in calls} == {main}
    np.testing.assert_array_equal(during.ids, before.ids)
    snap = te._catalog.snapshot()
    assert snap.geom == 1 and len(snap.segments) == 1
    merged = snap.segments[0].indexes
    assert all(ix._dev is None and ix._dev_gids is None for ix in merged)
    je.compact()
    after = _parity(je, te, x_all, pos, neg, 50, "default")
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.scores, after.scores)


def test_late_hints_of_a_replaced_generation_match_reference(monkeypatch):
    """A batch bound to the snapshot before a compaction's swap that ends
    after it observes its survivor counts under the replaced generation's
    key: both tables keep those hints until their next prune (the
    reference's rule; a hint only sizes a gather), and the late batch
    answers as it did before the compaction."""
    base, extra = _data(ties=False)
    pos, neg = _labels()
    engines = _pair(base)
    for e in engines:
        e.append(extra)
    want = [e.query(pos, neg, max_results=30) for e in engines]
    olds = [e._view() for e in engines]
    for e in engines:
        e.compact()
        assert len(e._cap_hints) == 0       # pruned to generation 1
    for e, old in zip(engines, olds):
        monkeypatch.setattr(e, "_view", lambda old=old: old)
    late = [e.query(pos, neg, max_results=30) for e in engines]
    _same(*late)
    np.testing.assert_array_equal(late[1].ids, want[1].ids)
    np.testing.assert_array_equal(late[1].scores, want[1].scores)
    monkeypatch.undo()
    je, te = engines

    def table(e):
        return {k: e._cap_hints.get(k) for k in e._cap_hints}
    gen0 = set(te._cap_hints)
    assert gen0 and {k[0] for k in gen0} == {0}
    assert table(te) == table(je)
    _same(*[e.query(pos, neg, max_results=30) for e in engines])
    assert table(te) == table(je)
    assert {k[0] for k in te._cap_hints} == {0, 1}
    for e in engines:                     # the next mutation prunes them
        e.delete([int(want[1].ids[0])])
    assert table(te) == table(je) and {k[0] for k in te._cap_hints} == {1}


# ----------------------------------------------------------------------
# the state crosses over
# ----------------------------------------------------------------------

def _catalog_arrays(cat):
    """A reference SegmentedCatalog's state as numpy arrays."""
    s = cat.snapshot()
    return dict(
        x=np.asarray(s.x), subsets=np.asarray(cat.subsets),
        segments=[{"offset": g.offset, "rows": g.n_rows, "shard": g.shard,
                   "indexes": [{"perm": ix.perm, "rows": ix.rows,
                                "zlo": ix.zlo, "zhi": ix.zhi}
                               for ix in g.indexes]}
                  for g in s.segments],
        valid=s.valid_host, frange=s.frange, block=cat.block,
        epoch=s.epoch, geom=s.geom, n_shards=cat.n_shards,
        next_shard=cat._next_shard)


@pytest.mark.parametrize("mode", ["default", "dense", "host_oracle"])
def test_catalog_from_arrays_answers_as_reference(mode):
    base, extra = _data()
    x_all = np.concatenate([base, extra])
    pos, neg = _labels()
    je = JaxEngine(base, **ENG, **MODES[mode], live=True)
    je.append(extra[:120])
    je.delete([17, 130, 705])
    je.compact()
    je.append(extra[120:])
    je.delete([800])
    te = SearchEngine.from_catalog(
        catalog_from_arrays(**_catalog_arrays(je._catalog), device="cpu"),
        **MODES[mode])
    _same_catalog_stats(je, te)
    res = _parity(je, te, x_all, pos, neg, 50, mode)
    assert not np.isin([17, 130, 705, 800], res.ids).any()
    # the carried catalog goes on living: mutations stay in step
    for e in (je, te):
        e.delete([int(res.ids[0])])
        e.compact()
    _parity(je, te, x_all, pos, neg, 50, mode)
    _same_catalog_stats(je, te, mode)


def test_catalog_from_arrays_refuses_gaps():
    base, _ = _data(ties=False)
    je = JaxEngine(base, **ENG, live=True)
    arrs = _catalog_arrays(je._catalog)
    arrs["segments"][0]["offset"] = 5
    with pytest.raises(ValueError, match="contiguously"):
        catalog_from_arrays(**arrs, device="cpu")


# ----------------------------------------------------------------------
# On the card: the live engine against the same schedule on the CPU
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card "
                    "(python -m pytest -m gpu tests/test_torch_live.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
def test_live_schedule_cuda_matches_cpu(cuda, mode):
    base, extra = _data(n=3000, extra=1500)
    pos, neg = _labels()
    opts = {**ENG, **MODES[mode]}
    eg = SearchEngine(base, live=True, device=cuda, **opts)
    ec = SearchEngine(base, live=True, device="cpu", **opts)
    reqs = [{"pos_ids": pos, "neg_ids": neg, "model": m, "max_results": mr}
            for m in ("dbranch", "dbens") for mr in (40, None)]

    def step():
        for a, b in zip(eg.query_batch(reqs), ec.query_batch(reqs)):
            _same(b, a)
        for m in ("dtree", "knn"):
            _same(ec.query(pos, neg, model=m), eg.query(pos, neg, model=m))
    step()
    for chunk in np.array_split(extra, 3):
        for e in (eg, ec):
            e.append(chunk)
    step()
    dele = eg.query(pos, neg, max_results=20).ids[:5].tolist() + [3100]
    for e in (eg, ec):
        e.delete(dele)
    step()
    for e in (eg, ec):
        e.compact()
    step()


@pytest.mark.gpu
def test_background_compaction_launches_nothing_on_the_card(cuda):
    """The kernel wrappers' launch counters stand still during a
    background merge with no query running."""
    from repro_torch.kernels import box_scan, l2dist, zone_prune
    base, extra = _data(n=3000, extra=1500)
    pos, neg = _labels()
    eng = SearchEngine(base, live=True, device=cuda, **ENG)
    eng.append(extra)
    eng.query(pos, neg, max_results=20)
    torch.cuda.synchronize()
    counters = lambda: (zone_prune.launches, box_scan.seg_launches,
                        box_scan.scan_launches, l2dist.launches)
    mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = counters()
    th = eng.compact(background=True)
    th.join(timeout=120)
    assert not th.is_alive()
    assert counters() == c0
    # nothing allocated on the card (the old segments' mirrors may go)
    assert torch.cuda.max_memory_allocated() <= mem
    assert eng.index_stats()["n_segments"] == 1
    eng.query(pos, neg, max_results=20)
    assert counters() != c0
