"""Index build, box padding, state carry-over, the host query_index
oracle, the full scan and the k-d tree: the port against the reference,
byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import kdtree as jkdtree
from repro.core.boxes import BoxSet as JBoxSet
from repro_torch.core import index as tindex
from repro_torch.core import kdtree as tkdtree
from repro_torch.core.boxes import BoxSet, boxes_contain, concat_box_arrays
from repro_torch.core.convert import index_from_arrays

FIELDS = ("dims", "perm", "rows", "zlo", "zhi")


def _x(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    x[: n // 4, 0] = 0.5                      # ties in one dim
    return x


@pytest.mark.parametrize("n,block", [(1000, 64), (1024, 64), (777, 128),
                                     (64, 64)])
def test_morton_and_build_index_byte_equal(n, block):
    x = _x(n, 12, seed=n)
    dims = np.array([1, 4, 5, 7, 9, 11])
    np.testing.assert_array_equal(tindex.morton_code(x[:, dims]),
                                  jindex.morton_code(x[:, dims]))
    want = jindex.build_index(x, dims, block=block, subset_id=3)
    got = tindex.build_index(x, dims, block=block, subset_id=3,
                             device="cpu")
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.block, got.n_rows, got.subset_id, got.n_blocks) == \
        (want.block, want.n_rows, want.subset_id, want.n_blocks)
    rows3, zlo, zhi = got.device_arrays()
    jr, jl, jh = want.device_arrays()
    np.testing.assert_array_equal(rows3.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(zlo.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(zhi.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(got.device_gids().numpy(),
                                  np.asarray(want.device_gids()))
    assert got.device_bytes()["rows"] == want.device_bytes()["rows"]


@pytest.mark.parametrize("b", [1, 7, 8, 13])
def test_pad_boxes_matches_reference(b):
    rng = np.random.default_rng(b)
    lo = rng.normal(0, 1, (b, 6)).astype(np.float32)
    hi = lo + 1
    owner = rng.integers(0, 3, b).astype(np.int32)
    wlo, whi, wown = jindex.pad_boxes(lo, hi, owner)
    for arr_lo, arr_hi in ((lo, hi), (torch.from_numpy(lo),
                                      torch.from_numpy(hi))):
        glo, ghi, gown = tindex.pad_boxes(arr_lo, arr_hi, owner)
        assert isinstance(glo, type(arr_lo))     # tensors stay tensors
        np.testing.assert_array_equal(np.asarray(glo), np.asarray(wlo))
        np.testing.assert_array_equal(np.asarray(ghi), np.asarray(whi))
        np.testing.assert_array_equal(gown, wown)


def test_concat_box_arrays_stays_on_tensor_device():
    a = torch.ones((2, 3))
    out = concat_box_arrays([a, np.zeros((1, 3), np.float32)])
    assert isinstance(out, torch.Tensor) and out.shape == (3, 3)
    out = concat_box_arrays([np.ones((2, 3)), np.zeros((1, 3))])
    assert isinstance(out, np.ndarray)


def test_index_from_arrays_round_trip_and_probe():
    x = _x(1500, 8, seed=11)
    dims = np.array([0, 2, 3, 5, 6, 7])
    jix = jindex.build_index(x, dims, block=64, subset_id=2)
    tix = index_from_arrays(**{f: getattr(jix, f) for f in FIELDS},
                            block=jix.block, n_rows=jix.n_rows,
                            subset_id=jix.subset_id, device="cpu")
    ref = tindex.build_index(x, dims, block=64, subset_id=2, device="cpu")
    for f in FIELDS:
        assert getattr(tix, f).tobytes() == getattr(ref, f).tobytes()
    rng = np.random.default_rng(0)
    centers = x[rng.integers(0, len(x), 5)][:, dims]
    lo, hi, owner = jindex.pad_boxes((centers - 0.4).astype(np.float32),
                                     (centers + 0.4).astype(np.float32),
                                     np.array([0, 1, 1, 0, 1], np.int32))
    onehot = (owner[:, None] == np.arange(2)[None]).astype(np.float32)
    for cap in (4, 24):                    # overflowing and sufficient
        want = jindex.sparse_probe(jix, jnp.asarray(lo), jnp.asarray(hi),
                                   jnp.asarray(onehot), capacity=cap)
        got = tindex.sparse_probe(tix, *(torch.from_numpy(a) for a in
                                         (lo, hi, onehot)), capacity=cap)
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        nh = int(got[3][0])
        assert tindex.fused_stats(tix, nh, cap, 5) == \
            jindex.fused_stats(jix, nh, cap, 5)


def test_index_from_arrays_rejects_ragged_rows():
    with pytest.raises(ValueError):
        index_from_arrays(np.arange(2), np.arange(10), np.zeros((10, 2)),
                          np.zeros((1, 2)), np.zeros((1, 2)), block=4,
                          n_rows=10, device="cpu")


def _box_case(x, dims, b, seed):
    rng = np.random.default_rng(seed)
    centers = x[rng.integers(0, len(x), b)][:, dims]
    lo = (centers - rng.uniform(0.1, 0.8, centers.shape)).astype(np.float32)
    hi = (centers + rng.uniform(0.1, 0.8, centers.shape)).astype(np.float32)
    lo[0, 1], hi[0, 1] = -np.inf, np.inf
    return lo, hi


@pytest.mark.parametrize("n,block,b", [(1000, 64, 5), (1024, 64, 9),
                                       (777, 128, 1), (300, 64, 0)])
def test_query_index_matches_reference(n, block, b):
    """Counts and all six stats, on a ragged n and on an exact multiple
    of the block; B = 0 touches nothing."""
    x = _x(n, 12, seed=n + b)
    x[7, 3] = np.nan
    dims = np.array([0, 3, 4, 6, 8, 10])
    jix = jindex.build_index(x, dims, block=block, subset_id=1)
    tix = tindex.build_index(x, dims, block=block, subset_id=1,
                             device="cpu")
    lo, hi = _box_case(x, dims, max(b, 1), seed=b)
    lo, hi = lo[:b], hi[:b]
    want_c, want_st = jindex.query_index(jix, JBoxSet(lo, hi, dims, 1))
    got_c, got_st = tindex.query_index(tix, BoxSet(lo, hi, dims, 1))
    assert got_c.dtype == want_c.dtype
    np.testing.assert_array_equal(got_c, want_c)
    assert got_st == want_st
    # against a scan: the NaN row's block has NaN zone maps and is pruned
    # from every query, in the reference as here (ROADMAP.md, section C),
    # so its rows are left out of this check
    nan_blk = ~np.isfinite(tix.zlo).all(1) | ~np.isfinite(tix.zhi).all(1)
    in_nan = np.zeros(n, bool)
    slot = np.nonzero(tix.perm >= 0)[0]
    in_nan[tix.perm[slot]] = nan_blk[slot // block]
    assert 0 < in_nan.sum() <= block
    np.testing.assert_array_equal(got_c[~in_nan],
                                  boxes_contain(x[:, dims], lo, hi)[~in_nan])
    if b:
        assert 0 < got_st["blocks_touched"] <= got_st["blocks_total"]


@pytest.mark.parametrize("n,d,b", [(1500, 384, 7), (999, 24, 30), (50, 5, 0)])
def test_full_scan_matches_reference(n, d, b):
    """Full-width boxes with most dims open, as tree leaves have them."""
    rng = np.random.default_rng(n + b)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    x[3, 2] = np.nan
    lo = np.full((b, d), -np.inf, np.float32)
    hi = np.full((b, d), np.inf, np.float32)
    for i in range(b):
        k = rng.choice(d, min(d, 4), replace=False)
        lo[i, k] = rng.normal(-0.6, 0.3, len(k))
        hi[i, k] = lo[i, k] + 1.5
    want = jindex.full_scan(x, lo, hi, use_pallas=True)
    got = tindex.full_scan(torch.from_numpy(x), lo, hi)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jindex.full_scan(x, lo, hi, use_pallas=False))


@pytest.mark.parametrize("n,leaf", [(500, 16), (2000, 64)])
def test_kdtree_matches_reference(n, leaf):
    """build_kdtree and range_query: the same tree and the same ids as
    the reference, and the ids of a scan."""
    x = _x(n, 6, seed=n)
    want = jkdtree.build_kdtree(x, leaf_size=leaf)
    got = tkdtree.build_kdtree(x, leaf_size=leaf)
    for f in ("points", "ids", "split_dim", "split_val", "left", "right",
              "lo_idx", "hi_idx"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    lo, hi = _box_case(x, np.arange(6), 4, seed=n)
    for qlo, qhi in zip(lo, hi):
        ids, touched = tkdtree.range_query(got, qlo, qhi)
        wids, wtouched = jkdtree.range_query(want, qlo, qhi)
        np.testing.assert_array_equal(ids, wids)
        assert touched == wtouched
        np.testing.assert_array_equal(
            ids, np.nonzero(boxes_contain(x, qlo[None], qhi[None]))[0])
