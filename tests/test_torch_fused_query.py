"""The per-index fused query (DESIGN.md §6), the index's stats and the
fit bucket: the port against the reference, on the CPU.

``query_index_fused`` / ``query_index_fused_multi`` run as the
reference's own tests call them (tests/test_fused_query.py: the JAX
package dispatches to its plain jnp versions off the TPU), and the port
on CPU tensors takes the plain versions of its kernels. Counts are
bitwise equal, the stats dicts equal; the cases are the reference
test's: seeds, sizes and box counts, a capacity below the survivors, a
box that overlaps no zone, and the multi call against per-query calls.
"""
import numpy as np
import pytest
import torch

from repro.core import capacity as jcapacity
from repro.core import index as jindex
from repro.core.boxes import BoxSet as JBoxSet
from repro_torch.core import capacity as tcapacity
from repro_torch.core import index as tindex
from repro_torch.core.boxes import BoxSet, boxes_contain


def _random_boxes(rng, x, b, width=0.3):
    centers = x[rng.integers(0, len(x), b)]
    lo = (centers - width).astype(np.float32)
    hi = (centers + width).astype(np.float32)
    return lo, hi


def _indexes(x, dims, block=128):
    return (tindex.build_index(x, dims, block=block, device="cpu"),
            jindex.build_index(x, dims, block=block))


@pytest.mark.parametrize("seed,n,b", [(0, 3000, 1), (1, 5000, 4),
                                      (2, 2000, 9)])
def test_fused_equals_reference_and_host_path(seed, n, b):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    dims = np.arange(4)
    tix, jix = _indexes(x, dims)
    lo, hi = _random_boxes(rng, x, b)
    got, st = tindex.query_index_fused(tix, BoxSet(lo, hi, dims))
    want, st_ref = jindex.query_index_fused(jix, JBoxSet(lo, hi, dims))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert st == st_ref
    host, st_host = tindex.query_index(tix, BoxSet(lo, hi, dims))
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, boxes_contain(x, lo, hi))
    assert not st["overflowed"]
    assert st["blocks_touched"] == st_host["blocks_touched"]


def test_fused_takes_device_resident_boxes():
    """Boxes held as tensors (the batched trainer's) are padded on their
    device and give the numpy boxes' counts."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2500, 4)).astype(np.float32)
    dims = np.arange(4)
    tix, _ = _indexes(x, dims)
    lo, hi = _random_boxes(rng, x, 5)
    got, st = tindex.query_index_fused(
        tix, BoxSet(torch.from_numpy(lo), torch.from_numpy(hi), dims))
    want, st_np = tindex.query_index_fused(tix, BoxSet(lo, hi, dims))
    np.testing.assert_array_equal(got, want)
    assert st == st_np


def test_fused_capacity_overflow_matches_reference():
    """capacity < survivors: the first-capacity surviving blocks (zone
    order) are refined, the rest dropped, the overflow reported, as in
    the reference."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4000, 4)).astype(np.float32)
    dims = np.arange(4)
    tix, jix = _indexes(x, dims)
    lo, hi = _random_boxes(rng, x, 2, width=0.5)
    mask = tindex.kops.zone_prune(*(torch.from_numpy(a) for a in (
        tix.zlo, tix.zhi, lo, hi))).numpy()
    hit_ids = np.nonzero(mask.any(1))[0]
    assert len(hit_ids) >= 3, "test needs several survivors"
    cap = len(hit_ids) // 2
    got, st = tindex.query_index_fused(tix, BoxSet(lo, hi, dims),
                                       capacity=cap)
    want, st_ref = jindex.query_index_fused(jix, JBoxSet(lo, hi, dims),
                                            capacity=cap)
    np.testing.assert_array_equal(got, want)
    assert st == st_ref
    assert st["overflowed"] and st["survivors"] == len(hit_ids)
    assert st["blocks_touched"] == cap
    # the reference test's own reckoning: the first-capacity surviving
    # blocks' box counts, in original row order
    rows3 = tix.rows.reshape(tix.n_blocks, tix.block, -1)
    counts = np.zeros(tix.rows.shape[0], np.int32)
    for bi in hit_ids[:cap]:
        counts[bi * tix.block:(bi + 1) * tix.block] = boxes_contain(
            rows3[bi], lo, hi)
    first = np.zeros(tix.n_rows, np.int32)
    valid = tix.perm >= 0
    first[tix.perm[valid]] = counts[valid]
    np.testing.assert_array_equal(got, first)


def test_fused_empty_survivors():
    """A box overlapping no zone: zero counts, zero blocks touched."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2000, 4)).astype(np.float32)
    dims = np.arange(4)
    tix, jix = _indexes(x, dims)
    lo = np.full((1, 4), 50.0, np.float32)
    hi = np.full((1, 4), 51.0, np.float32)
    got, st = tindex.query_index_fused(tix, BoxSet(lo, hi, dims))
    want, st_ref = jindex.query_index_fused(jix, JBoxSet(lo, hi, dims))
    assert (got == 0).all()
    np.testing.assert_array_equal(got, want)
    assert st == st_ref
    assert st["survivors"] == 0 and st["blocks_touched"] == 0
    assert not st["overflowed"]


@pytest.mark.parametrize("capacity", [None, 4])
def test_fused_multi_matches_reference_and_per_query(capacity):
    """One fused multi call with an ownership map == the reference's, and
    (where capacity covers the union's survivors) the per-query host
    path."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (6000, 5)).astype(np.float32)
    dims = np.arange(5)
    tix, jix = _indexes(x, dims)
    n_queries = 4
    los, his, owner = [], [], []
    for q in range(n_queries):
        b = int(rng.integers(1, 5))
        lo, hi = _random_boxes(rng, x, b)
        los.append(lo)
        his.append(hi)
        owner.append(np.full(b, q, np.int32))
    lo, hi, owner = map(np.concatenate, (los, his, owner))
    got, st = tindex.query_index_fused_multi(
        tix, BoxSet(lo, hi, dims), owner, n_queries, capacity=capacity)
    want, st_ref = jindex.query_index_fused_multi(
        jix, JBoxSet(lo, hi, dims), owner, n_queries, capacity=capacity)
    assert got.shape == (n_queries, tix.n_rows)
    np.testing.assert_array_equal(got, want)
    assert st == st_ref
    if st["overflowed"]:
        return
    for q in range(n_queries):
        alone, _ = tindex.query_index(tix, BoxSet(los[q], his[q], dims))
        np.testing.assert_array_equal(got[q], alone)


@pytest.mark.parametrize("n,d,block", [(1000, 4, 64), (777, 6, 128)])
def test_zone_map_index_stats_equal_reference(n, d, block):
    x = np.random.default_rng(n).normal(0, 1, (n, d)).astype(np.float32)
    tix, jix = _indexes(x, np.arange(d), block=block)
    st = tix.stats()
    assert st == jix.stats()
    assert st["rows"] == n and st["blocks"] == tix.n_blocks


# tests/test_capacity.py's cases, then a floor of 1 and an empty batch
@pytest.mark.parametrize("v,floor,want", [(3, 64, 64), (64, 64, 64),
                                          (65, 64, 128), (200, 16, 256),
                                          (1000, 1, 1024), (0, 8, 8)])
def test_fit_bucket_equals_reference(v, floor, want):
    assert tcapacity.fit_bucket(v, floor=floor) == want
    assert jcapacity.fit_bucket(v, floor=floor) == want
