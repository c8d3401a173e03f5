"""Main-path device ops: the port's fused_query, tile stages and
sparse_topk against repro.kernels.ops on the same numpy inputs. Every
output is an integer or a bool, so equality is exact — dtypes included
(int32 everywhere, as under JAX's x64-off default)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

INVALID = int(tops.TILE_INVALID)


def _eq(got, want):
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _probe_case(nb=20, block=32, d=6, b=9, q=3, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.normal(0, 1, (nb * block, d)).astype(np.float32), 0)
    x[-5:] = np.inf                                    # ragged tail pad
    rows3 = x.reshape(nb, block, d)
    real = np.isfinite(rows3)
    zlo = np.where(real, rows3, np.inf).min(1)
    zhi = np.where(real, rows3, -np.inf).max(1)
    centers = x[rng.integers(0, nb * block - 5, b)]
    lo = (centers - 0.3).astype(np.float32)
    hi = (centers + 0.3).astype(np.float32)
    lo[-1], hi[-1] = np.inf, -np.inf                   # impossible pad box
    owner = rng.integers(0, q, b)
    onehot = (owner[:, None] == np.arange(q)[None]).astype(np.float32)
    gids = np.arange(nb * block, dtype=np.int32)
    gids = rng.permutation(gids).astype(np.int32)
    gids[-5:] = -1
    return rows3, zlo, zhi, lo, hi, onehot, gids.reshape(nb, block)


def _jfused(rows3, zlo, zhi, lo, hi, onehot, cap):
    return jops.fused_query(*map(jnp.asarray, (rows3, zlo, zhi, lo, hi,
                                               onehot)),
                            capacity=cap, interpret=True)


@pytest.mark.parametrize("cap", [2, 7, 20])      # overflow, tight, all
def test_fused_query_and_tile_candidates_match(cap):
    rows3, zlo, zhi, lo, hi, onehot, gids_b = _probe_case()
    want = _jfused(rows3, zlo, zhi, lo, hi, onehot, cap)
    got = tops.fused_query(*_t(rows3, zlo, zhi, lo, hi, onehot),
                           capacity=cap)
    for g, w in zip(got, want):
        _eq(g, w)
    if cap == 2:
        assert int(got[2]) > cap                     # overflow exercised
    wg, wok = jops.tile_candidates(want[0], want[1], jnp.asarray(gids_b))
    gg, gok = tops.tile_candidates(got[0], got[1], torch.from_numpy(gids_b))
    _eq(gg, wg)
    _eq(gok, wok)


def _parts(seed, sizes=(4, 6, 2), block=8, q=3, dup=True, hi_val=5):
    """(counts, gids, ok) triples; with ``dup`` the subsets share global
    ids, as one row surviving several subsets does."""
    rng = np.random.default_rng(seed)
    parts = []
    for c in sizes:
        counts = rng.integers(0, hi_val, (c, block, q)).astype(np.int32)
        pool = 64 if dup else 10_000
        gids = rng.choice(pool, c * block, replace=False).astype(np.int32)
        gids = gids.reshape(c, block)
        gids[0, :2] = -1                              # padding slots
        ok = (counts != 0).any(-1) & (gids >= 0)
        parts.append((counts, gids, ok))
    return parts


@pytest.mark.parametrize("vd", ["int32", "int16"])
def test_survivor_tiles_match(vd):
    counts, gids, ok = _parts(1)[1]
    nm = int(ok.sum())
    for rcap in (nm, 1 << (nm - 1).bit_length(), nm + 9):
        want = jops.survivor_tiles(*map(jnp.asarray, (counts, gids, ok)),
                                   row_capacity=rcap,
                                   val_dtype=getattr(jnp, vd))
        got = tops.survivor_tiles(*_t(counts, gids, ok), row_capacity=rcap,
                                  val_dtype=getattr(torch, vd))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("vd", ["int32", "int16"])
def test_packed_survivor_tiles_match(vd):
    parts = _parts(2)
    rcaps = tuple(int(p[2].sum()) + 3 for p in parts)
    want = jops.packed_survivor_tiles(
        tuple(tuple(map(jnp.asarray, p)) for p in parts),
        row_capacities=rcaps, val_dtype=getattr(jnp, vd))
    got = tops.packed_survivor_tiles(tuple(tuple(_t(*p)) for p in parts),
                                     row_capacities=rcaps,
                                     val_dtype=getattr(torch, vd))
    for g, w in zip(got, want):
        _eq(g, w)


def _tiles(seed, r=120, n=60, q=3, pad=17, hi_val=3):
    """Tiles with duplicate keys and scores dense in ties."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([rng.integers(0, n, r).astype(np.int32),
                           np.full(pad, INVALID, np.int32)])
    vals = np.concatenate([rng.integers(0, hi_val, (r, q)).astype(np.int32),
                           np.zeros((pad, q), np.int32)])
    return keys, vals, n


@pytest.mark.parametrize("k", [1, 4, 16, 64, 300])   # ties at k; k > rows
@pytest.mark.parametrize("vd", [np.int32, np.int16])
def test_sparse_topk_matches(k, vd):
    keys, vals, n = _tiles(k)
    vals = vals.astype(vd)
    tids = np.full((3, 16), n, np.int32)
    tids[0, :5] = keys[:5]                       # mask training rows
    tids[1, :3] = [0, 1, 2]
    tids[2, :2] = [n - 1, n - 1]                 # repeated train id
    want = jops.sparse_topk(*map(jnp.asarray, (keys, vals, tids)), k=k)
    got = tops.sparse_topk(*_t(keys, vals, tids), k=k)
    for g, w in zip(got, want):
        _eq(g, w)


def test_sparse_topk_all_padding_and_single_score():
    keys = np.full(8, INVALID, np.int32)
    vals = np.zeros((8, 2), np.int32)
    tids = np.full((2, 16), 5, np.int32)
    for kk, vv in ((keys, vals),
                   (np.array([3, 3, 3, INVALID], np.int32),
                    np.array([[1, 0], [1, 0], [1, 1], [0, 0]], np.int32))):
        want = jops.sparse_topk(*map(jnp.asarray, (kk, vv, tids)), k=4)
        got = tops.sparse_topk(*_t(kk, vv, tids), k=4)
        for g, w in zip(got, want):
            _eq(g, w)


def test_tiles_to_topk_pipeline_matches():
    """fused_query -> tile_candidates -> packed tiles -> sparse_topk over
    three subsets, int16 values, one overflowing probe re-run at its
    retry capacity — the engine's round structure end to end."""
    outs = {}
    for lib, ops_mod in (("jax", jops), ("torch", tops)):
        parts, rcaps = [], []
        for seed in (0, 1, 2):
            case = _probe_case(seed=seed)
            gids_b = case[-1]
            for cap in (3, 20):
                if lib == "jax":
                    c, cand, nh = _jfused(*case[:-1], cap)
                    g, ok = jops.tile_candidates(c, cand,
                                                 jnp.asarray(gids_b))
                else:
                    c, cand, nh = tops.fused_query(*_t(*case[:-1]),
                                                   capacity=cap)
                    g, ok = tops.tile_candidates(c, cand,
                                                 torch.from_numpy(gids_b))
                if int(nh) <= cap:
                    break
            parts.append((c, g, ok))
            rcaps.append(int(np.asarray(ok).sum()) + 1)
        k16 = jnp.int16 if lib == "jax" else torch.int16
        keys, vals = ops_mod.packed_survivor_tiles(
            tuple(parts), row_capacities=tuple(rcaps), val_dtype=k16)
        tids = np.full((3, 16), 640, np.int32)
        tids[1, :4] = [1, 2, 3, 4]
        arr = jnp.asarray(tids) if lib == "jax" else torch.from_numpy(tids)
        outs[lib] = ops_mod.sparse_topk(keys, vals, arr, k=32)
    for g, w in zip(outs["torch"], outs["jax"]):
        _eq(g, w)
