"""The pruned step's scan, ``box_scan_pruned``, against the reference, on
the CPU.

``kernels/ops.box_scan_pruned`` (on the CPU ``ref.box_scan_pruned_ref``)
is held bitwise to the reference's glue in ``repro.core.index.
pruned_local_step``: the candidate blocks gathered, ``box_scan_ref``, the
slots >= n_hit zeroed and ``out.at[cand].max(counts)`` into zeros; and
the port's ``pruned_local_step``, built on it, to the reference's step.
Inputs are seeded numpy arrays: n_hit 0 (a box that overlaps no zone),
n_hit past C, C past NB, d' = 6 in blocks of 1,024, d = 1 and d = 9,
block lengths not a multiple of 4.

The CUDA kernel (csrc/box_scan.cu, box_scan_pruned_kernel) splits its
work into items (up to 1,024 rows of one live slot) and each CTA's even
share of the dead words, whose gaps it finds by a 32-way search over
cand; ``kernel_writes`` emulates that split, and every output word must
be written exactly once: the live blocks' rows by items, the rest as
zeros. The kernel itself is held to the plain version on a card by the
``gpu`` tests in tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.kernels import ref as jref
from repro_torch.core import index as tindex
from repro_torch.kernels import ops as tops


def _case(nb, block, d, b, c, m, seed):
    """rows3 [nb, block, d] ~ N(0, 1) with NaN, +inf and -inf entries;
    b boxes around random rows, one (+inf, -inf) pad; cand [c] holding m
    ascending, unique blocks, 0-filled."""
    rng = np.random.default_rng(seed)
    rows3 = rng.normal(0, 1, (nb, block, d)).astype(np.float32)
    flat = rows3.reshape(-1, d)
    centers = flat[rng.integers(0, len(flat), b)]
    w = np.float32(0.3 + 0.25 * np.sqrt(d))
    lo, hi = centers - w, centers + w
    flat[rng.integers(0, len(flat), 2), 0] = np.nan
    flat[rng.integers(0, len(flat), 2), d - 1] = np.inf
    flat[rng.integers(0, len(flat), 2), 0] = -np.inf
    lo[-1], hi[-1] = np.inf, -np.inf
    cand = np.zeros(c, np.int32)
    cand[:m] = np.sort(rng.choice(nb, m, replace=False))
    return rows3, cand, lo, hi


def _reference_glue(rows3, cand, n_hit, lo, hi):
    """The reference's pruned_local_step past its compaction."""
    nb, block, d = rows3.shape
    c = cand.shape[0]
    sel = jnp.asarray(rows3)[jnp.asarray(cand)]
    counts = jref.box_scan_ref(sel.reshape(-1, d), jnp.asarray(lo),
                               jnp.asarray(hi)).reshape(c, block)
    counts = counts * (jnp.arange(c) < n_hit)[:, None]
    out = jnp.zeros((nb, block), jnp.int32).at[jnp.asarray(cand)].max(counts)
    return np.asarray(out.reshape(-1))


# (nb, block, d, boxes, C, live slots, n_hit): d' = 6 in blocks of 1,024;
# n_hit 0, within the live slots, all of them, past C where every slot is
# live; C > NB; d = 1 and d = 9; blocks of 37 and 6 rows
OP_CASES = [(5, 1024, 6, 16, 4, 3, 3), (5, 1024, 6, 16, 4, 3, 0),
            (5, 1024, 6, 16, 4, 4, 9), (6, 64, 6, 8, 10, 5, 5),
            (6, 64, 6, 8, 10, 6, 2), (40, 37, 6, 9, 16, 16, 20),
            (12, 64, 1, 5, 8, 6, 6), (12, 64, 9, 5, 8, 6, 6),
            (30, 6, 6, 5, 12, 12, 12)]


@pytest.mark.parametrize("nb,block,d,b,c,m,nh", OP_CASES)
def test_box_scan_pruned_matches_reference_glue(nb, block, d, b, c, m, nh):
    rows3, cand, lo, hi = _case(nb, block, d, b, c, m, seed=nb + block + d)
    got = tops.box_scan_pruned(
        *(torch.from_numpy(a) for a in (rows3, cand)),
        torch.tensor(nh, dtype=torch.int32),
        *(torch.from_numpy(a) for a in (lo, hi)))
    assert got.dtype == torch.int32 and got.shape == (nb * block,)
    want = _reference_glue(rows3, cand, nh, lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    if nh == 0:
        assert not got.any()


def _index_case(n, d, block, seed, far=False):
    """A seeded index and boxes around its first rows (or far outside
    every zone) as numpy arrays: rows [NB, block, d'], zlo, zhi, lo, hi."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    idx = tindex.build_index(x, np.arange(d), block=block, device="cpu")
    lo = (x[:4] - 0.4).astype(np.float32)
    hi = (x[:4] + 0.4).astype(np.float32)
    if far:
        lo, hi = lo + 100, hi + 100
    rows = idx.rows.reshape(idx.n_blocks, idx.block, -1)
    return (rows, idx.zlo, idx.zhi, lo, hi), idx.n_blocks


# (rows, d', block, capacity, far): d' = 6 in blocks of 1,024 with a few
# blocks (5); a box far outside every zone (n_hit 0); C past NB; capacity
# below the survivors (n_hit past C)
STEP_CASES = [(5 * 1024, 6, 1024, 4, False), (5 * 1024, 6, 1024, 4, True),
              (5 * 1024, 6, 1024, 9, False), (5 * 1024, 6, 1024, 1, False)]


@pytest.mark.parametrize("n,d,block,capacity,far", STEP_CASES)
def test_pruned_local_step_matches_reference(n, d, block, capacity, far):
    arrs, nb = _index_case(n, d, block, seed=n + d, far=far)
    got = tindex.pruned_local_step(block, capacity)(
        *(torch.from_numpy(a) for a in arrs))
    want = jindex.pruned_local_step(block, capacity)(
        *(jnp.asarray(a) for a in arrs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (nb * block,)
    if far:
        assert not got.any()


# ----------------------------------------------------------------------
# the kernel's split of its writes, emulated
# ----------------------------------------------------------------------

ITEM_ROWS = 1024                   # csrc/box_scan.cu kItemRows
STAGE_TARGET = 32 * 1024           # kPrStageTarget


def live_before(cand, nh, k):
    """box_scan.cu live_before: the first slot s < nh with cand[s] - s >
    k, or nh, by its 32-probe rounds."""
    a, b = 0, nh
    while a < b:
        step = (b - a + 31) // 32
        probes = [a + lane * step for lane in range(32)]
        t = [p < b and int(cand[p]) - p > k for p in probes]
        if any(t):
            j = t.index(True)
            a, b = (a if j == 0 else a + (j - 1) * step + 1), a + j * step
        else:
            a += min(31, (b - a - 1) // step) * step + 1
    return a


def kernel_writes(nb, block, d, cand, nh, grid):
    """How often the kernel writes each output word: the live items', and
    each of ``grid`` CTAs' zeros over its share of the dead words."""
    writes = np.zeros(nb * block, np.int64)
    tile = max(1, min(STAGE_TARGET // (4 * d), ITEM_ROWS, block))
    for s in range(nh):
        b0 = int(cand[s]) * block
        for t0 in range(0, block, tile):
            writes[b0 + t0:b0 + min(block, t0 + tile)] += 1
    dead = (nb - nh) * block
    g = lambda s: int(cand[s]) - s
    for cta in range(grid):
        w0, w1 = dead * cta // grid, dead * (cta + 1) // grid
        if w0 >= w1:
            continue
        s0 = live_before(cand, nh, w0 // block)
        s1 = live_before(cand, nh, (w1 - 1) // block)
        for s in range(s0, s1 + 1):
            g0 = 0 if s == 0 else g(s - 1) * block
            g1 = dead if s == nh else g(s) * block
            a, b = max(g0, w0) + s * block, min(g1, w1) + s * block
            if a < b:
                writes[a:b] += 1
    return writes


@pytest.mark.parametrize("grid", [1, 3, 264])
@pytest.mark.parametrize("nb,block,d,live", [
    (300, 5, 6, [0, 1, 2, 299]), (300, 5, 6, []),
    (300, 5, 6, list(range(300))), (4096, 3, 6, [0, 4095]),
    (4096, 3, 6, [2048]), (70, 2000, 1, [3, 4, 9, 60]),
    (50, 37, 17, list(range(1, 50, 3)))])
def test_pruned_split_writes_every_word_once(nb, block, d, live, grid):
    cand = np.zeros(max(len(live), 1) + 3, np.int32)
    cand[:len(live)] = live
    writes = kernel_writes(nb, block, d, cand, len(live), grid)
    np.testing.assert_array_equal(writes, np.ones(nb * block, np.int64))


def test_live_before_is_a_lower_bound_search():
    """The 32-way search gives bisect's answer over g(s) = cand[s] - s at
    every k, over 32,768 slots (three rounds) and a few."""
    rng = np.random.default_rng(0)
    for nh, nb in ((32768, 88311), (5, 9), (33, 40), (1, 1)):
        cand = np.sort(rng.choice(nb, nh, replace=False)).astype(np.int32)
        g = cand - np.arange(nh)
        for k in list(range(0, nb - nh + 1, max(1, (nb - nh) // 50))) + [
                nb - nh]:
            assert live_before(cand, nh, k) == int(
                np.searchsorted(g, k, side="right"))
