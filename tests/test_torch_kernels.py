"""The port's kernels against the reference's.

On the CPU: the plain PyTorch versions (repro_torch.kernels.ref, what the
wrappers use for CPU tensors) against the Pallas kernels run in interpret
mode, at the shapes of tests/test_kernels.py and tests/test_fused_query.py
plus the half-open boundary and +-inf / NaN padding cases. The box and
zone outputs are bool or int32: equality is exact. Squared distances are
held to the kernel tolerance of tests/test_kernels.py (rtol 1e-4, atol
1e-3): the Pallas kernel expands |x|^2 - 2x.q + |q|^2 and the port sums
(x - q)^2 directly, so they differ by rounding; on integer-valued inputs
both are exact and must agree bitwise.

On a CUDA card (marker ``gpu``; skipped without one): the hand-written
CUDA kernels against their plain versions at the same shapes, bitwise.
Run them there with ``python -m pytest -m gpu tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.box_scan import box_scan_pallas
from repro.kernels.l2dist import l2dist_pallas
from repro.kernels.zone_prune import zone_prune_pallas
from repro_torch.kernels import box_scan as tbox_scan
from repro_torch.kernels import l2dist as tl2dist
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import zone_prune as tzone_prune


def _boxes(rng, b, d):
    lo = rng.normal(0, 1, (b, d)).astype(np.float32)
    hi = lo + np.abs(rng.normal(0, 1, (b, d))).astype(np.float32)
    return lo, hi


def _seg_case(n, d, b, q, seed):
    """x, boxes around random rows, a one-hot owner map — with +inf pad
    rows, a NaN row, and impossible (+inf, -inf) pad boxes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    centers = x[rng.integers(0, n, b)]
    lo = (centers - 0.3).astype(np.float32)
    hi = (centers + 0.3).astype(np.float32)
    x[-2:] = np.inf
    x[0, 0] = np.nan
    lo = np.concatenate([lo, np.full((3, d), np.inf, np.float32)])
    hi = np.concatenate([hi, np.full((3, d), -np.inf, np.float32)])
    owner = np.concatenate([rng.integers(0, q, b), np.zeros(3, np.int64)])
    onehot = (owner[:, None] == np.arange(q)[None]).astype(np.float32)
    return x, lo, hi, onehot


# tests/test_kernels.py: the raw kernel's aligned shapes, the wrapper's
# ragged ones; then the card's other code paths: D > 384, and boxes that
# take more than one shared-memory chunk (D = 384 with 100 boxes, d' = 6
# with 5000)
SCAN_PALLAS_SHAPES = [(1024, 128, 4), (2048, 128, 16), (1024, 256, 1),
                      (4096, 128, 64)]
SCAN_SHAPES = [(100, 6, 3), (1000, 384, 25), (1023, 17, 1), (1, 6, 2),
               (513, 130, 7)]
SCAN_CUDA_SHAPES = SCAN_PALLAS_SHAPES + SCAN_SHAPES + [
    (3000, 400, 9), (700, 384, 100), (2500, 6, 5000), (4099, 6, 64)]
L2_SHAPES = [(1024, 128, 8), (2048, 384, 4), (1000, 5, 3), (777, 17, 15),
             (513, 130, 2), (1, 6, 1)]
# the card's routes: tiled (D, Q <= 32 at 128-row tiles, <= 64 at 64-row
# ones: ragged last tiles, Q over one 16-query group, even Q) and
# D-chunked (the rest)
L2_CUDA_SHAPES = L2_SHAPES + [(4099, 384, 100), (3000, 6, 15),
                              (4097, 6, 33), (1000, 64, 64), (130, 32, 16),
                              (257, 3, 100), (20000, 6, 15)]

ZONE_SHAPES = [(512, 128, 8), (1024, 128, 32), (512, 256, 2),
               (37, 6, 3), (513, 5, 9), (1, 6, 1), (1024, 6, 64)]
SEG_SHAPES = [(300, 6, 7, 3), (1024, 4, 16, 1), (513, 17, 5, 9),
              (2048, 6, 40, 8)]
# the [NZ, B] mask kernel's routes (csrc/zone_prune.cu, on 132 SMs: one
# round of 32 pairs a warp up to 270,336 pairs, tiles of 128 pairs; four
# rounds beyond, tiles of 512): B = 1, B not a multiple of 4, B past the
# boxes a CTA stages at once (the tile's window, wrapping at B); d 1-8
# staged (d' = 6 its own route), 17 read from device memory; NZ not a
# multiple of the tile; the host oracle's 1,024 zones and the paper's
# 131,072
ZONE_MASK_CUDA_SHAPES = (
    [(1025, 6, 1), (1024, 6, 2), (1023, 6, 7), (1024, 6, 16),
     (200, 6, 300), (999, 6, 513), (300, 6, 1200), (131072, 6, 13),
     (300000, 6, 1), (70000, 8, 5), (20000, 17, 16)]
    + [(777, d, 5) for d in (1, 2, 3, 4, 5, 7, 8)]
    + [(513, 17, 9), (257, 17, 600)])


def _zone_case(nz, d, b):
    rng = np.random.default_rng(nz + d + b)
    zlo, zhi = _boxes(rng, nz, d)
    blo, bhi = _boxes(rng, b, d)
    # padded zones (+inf, -inf) and a padded dim (-inf, +inf) overlap
    # nothing / everything, as ops.zone_prune pads them
    if nz > 2:
        zlo[-1], zhi[-1] = np.inf, -np.inf
    blo[0, 0], bhi[0, 0] = -np.inf, np.inf
    return zlo, zhi, blo, bhi


def _zone_mask_case(nz, d, b):
    """_zone_case with the padding and NaN the mask must keep: a NaN zone
    bound (overlaps nothing), a zone open on every dim (-inf, +inf:
    overlaps every box but the impossible one), an impossible (+inf,
    -inf) box, and a box whose lo equals a zone's hi (half-open: no
    overlap on that dim)."""
    zlo, zhi, blo, bhi = _zone_case(nz, d, b)
    if nz > 3:
        zlo[1, 0] = np.nan
        zlo[2], zhi[2] = -np.inf, np.inf
    if b > 2:
        blo[-1], bhi[-1] = np.inf, -np.inf
        blo[1], bhi[1] = zhi[0], zhi[0] + 1
    return zlo, zhi, blo, bhi


def _scan_case(n, d, b, seed):
    """Rows and boxes in the manner of tests/test_kernels.py, with the
    full scan's edge cases: most box dims (-inf, +inf) as a tree leaf
    leaves them, rows holding NaN, -inf and +inf, rows exactly on a
    box's lo (outside) and hi (inside)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    lo, hi = _boxes(rng, b, d)
    free = rng.random((b, d)) < 0.8
    free[0] = False
    lo[free], hi[free] = -np.inf, np.inf
    if n > 4:
        x[1, d - 1] = np.nan
        x[2, 0] = -np.inf
        x[3, 0] = np.inf
        x[4] = hi[0]                        # inside box 0: x == hi
    if n > 5:
        x[5] = hi[0]
        x[5, 0] = lo[0, 0]                  # outside box 0: x == lo
    return x, lo, hi


def _t(*arrs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrs]


# ----------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("nz,d,b", ZONE_SHAPES)
def test_zone_prune_ref_matches_pallas(nz, d, b):
    arrs = _zone_case(nz, d, b)
    if nz % 256 == 0 and d % 128 == 0:
        want = zone_prune_pallas(*map(jnp.asarray, arrs), tile_z=256,
                                 interpret=True)
    else:
        want = jops.zone_prune(*map(jnp.asarray, arrs), interpret=True)
    want = np.asarray(want)
    got = tref.zone_prune_ref(*_t(*arrs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.zone_hits_ref(*_t(*arrs)).numpy(),
                                  want.any(1))
    # CPU tensors dispatch to the plain versions
    np.testing.assert_array_equal(tops.zone_prune(*_t(*arrs)).numpy(), want)
    np.testing.assert_array_equal(tops.zone_hits(*_t(*arrs)).numpy(),
                                  want.any(1))


@pytest.mark.parametrize("n,d,b,q", SEG_SHAPES)
def test_box_scan_seg_ref_matches_pallas(n, d, b, q):
    x, lo, hi, onehot = _seg_case(n, d, b, q, seed=n + d + b + q)
    want = np.asarray(jops.box_scan_seg(*map(jnp.asarray, (x, lo, hi, onehot)),
                                        interpret=True))
    got = tref.box_scan_seg_ref(*_t(x, lo, hi, onehot))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.box_scan_seg(*_t(x, lo, hi, onehot)).numpy(), want)


def test_box_scan_seg_gather_ref_zeroes_past_n_hit():
    x, lo, hi, onehot = _seg_case(8 * 64, 6, 12, 3, seed=4)
    rows3 = x.reshape(8, 64, 6)
    cand = np.array([5, 1, 6, 0], np.int32)
    want = np.array(jops.box_scan_seg(
        *map(jnp.asarray, (rows3[cand].reshape(-1, 6), lo, hi, onehot)),
        interpret=True)).reshape(4, 64, 3)
    want[3:] = 0                                   # slot 3 >= n_hit
    got = tops.box_scan_seg_gather(*_t(rows3, cand), torch.tensor(3,
                                   dtype=torch.int32), *_t(lo, hi, onehot))
    np.testing.assert_array_equal(got.numpy().reshape(4, 64, 3), want)


def test_box_scan_seg_half_open_semantics():
    """x == lo excluded, x == hi included (tests/test_kernels.py)."""
    x = np.array([[0.0], [1.0], [0.5]], np.float32)
    lo, hi = np.array([[0.0]], np.float32), np.array([[1.0]], np.float32)
    one = np.ones((1, 1), np.float32)
    want = np.asarray(jops.box_scan_seg(*map(jnp.asarray, (x, lo, hi, one)),
                                        interpret=True))[:, 0]
    got = tref.box_scan_seg_ref(*_t(x, lo, hi, one)).numpy()[:, 0]
    np.testing.assert_array_equal(want, [0, 1, 1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d,b", SCAN_PALLAS_SHAPES)
def test_box_scan_ref_matches_pallas(n, d, b):
    rng = np.random.default_rng(n + d + b)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    lo, hi = _boxes(rng, b, d)
    want = np.asarray(box_scan_pallas(*map(jnp.asarray, (x, lo, hi)),
                                      tile_n=512, interpret=True))
    got = tref.box_scan_ref(*_t(x, lo, hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,b", SCAN_SHAPES)
def test_box_scan_ref_matches_wrapper(n, d, b):
    """Ragged shapes through the padded wrapper, with +-inf box dims and
    NaN / +-inf rows."""
    x, lo, hi = _scan_case(n, d, b, seed=n * 7 + d)
    want = np.asarray(jops.box_scan(*map(jnp.asarray, (x, lo, hi)),
                                    interpret=True))
    got = tref.box_scan_ref(*_t(x, lo, hi))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.box_scan(*_t(x, lo, hi)).numpy(),
                                  want)
    if n > 5:
        assert got[1] == 0 and got[2] == 0          # NaN, -inf rows
        in0 = ((x > lo[0]) & (x <= hi[0])).all(1)
        assert in0[4] and not in0[5]                # x == hi in, == lo out


def test_box_scan_ref_chunks_rows():
    """More rows than one comparison chunk holds: the chunked loop gives
    the unchunked answer."""
    x, lo, hi = _scan_case(6000, 384, 40, seed=3)
    step = tref._SCAN_CHUNK_ELEMS // (40 * 384)
    assert step < 6000
    want = np.asarray(jref.box_scan_ref(*map(jnp.asarray, (x, lo, hi))))
    np.testing.assert_array_equal(tref.box_scan_ref(*_t(x, lo, hi)).numpy(),
                                  want)


def test_box_scan_half_open_and_empty():
    """x == lo excluded, x == hi included (tests/test_kernels.py); no
    boxes count nothing."""
    x = np.array([[0.0], [1.0], [0.5]], np.float32)
    lo, hi = np.array([[0.0]], np.float32), np.array([[1.0]], np.float32)
    want = np.asarray(jops.box_scan(*map(jnp.asarray, (x, lo, hi)),
                                    interpret=True))
    np.testing.assert_array_equal(want, [0, 1, 1])
    np.testing.assert_array_equal(tref.box_scan_ref(*_t(x, lo, hi)).numpy(),
                                  want)
    empty = np.zeros((0, 1), np.float32)
    got = tops.box_scan(*_t(x, empty, empty))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [0, 0, 0])


def _l2_case(n, d, q, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-8, 9, (n, d)).astype(np.float32),
                rng.integers(-8, 9, (q, d)).astype(np.float32))
    return (rng.normal(0, 1, (n, d)).astype(np.float32),
            rng.normal(0, 1, (q, d)).astype(np.float32))


@pytest.mark.parametrize("n,d,q", L2_SHAPES)
def test_l2dist_ref_matches_pallas(n, d, q):
    x, qq = _l2_case(n, d, q, seed=n + d + q)
    want = np.asarray(jops.l2dist(*map(jnp.asarray, (x, qq)),
                                  interpret=True))
    if n % 512 == 0 and d % 128 == 0:
        raw = l2dist_pallas(*map(jnp.asarray, (x, qq)), tile_n=512,
                            interpret=True)
        np.testing.assert_array_equal(np.asarray(raw), want)
    got = tref.l2dist_ref(*_t(x, qq))
    assert got.dtype == torch.float32 and got.shape == (n, q)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tops.l2dist(*_t(x, qq)).numpy(),
                                  got.numpy())
    # integer-valued inputs: every step of both forms is exact
    xi, qi = _l2_case(n, d, q, seed=n + d + q, integer=True)
    want = np.asarray(jops.l2dist(*map(jnp.asarray, (xi, qi)),
                                  interpret=True))
    np.testing.assert_array_equal(tref.l2dist_ref(*_t(xi, qi)).numpy(),
                                  want)


def test_l2dist_ref_sums_dims_in_order():
    """The plain version is the sequential f32 sum the CUDA kernel
    spells with round-to-nearest intrinsics."""
    x, qq = _l2_case(300, 17, 5, seed=1)
    acc = np.zeros((300, 5), np.float32)
    for j in range(17):
        t = x[:, j, None] - qq[None, :, j]
        acc = acc + t * t
    np.testing.assert_array_equal(tref.l2dist_ref(*_t(x, qq)).numpy(), acc)


@pytest.mark.parametrize("n,d,q,k", [(500, 6, 3, 10), (2000, 384, 2, 100),
                                     (1000, 6, 15, 1000)])
def test_knn_topk_matches_reference(n, d, q, k):
    """Distances within the tolerance at every rank. On integer-valued
    rows with many exact ties the indices must be equal too: distance
    ascending, the lower row position first on ties."""
    x, qq = _l2_case(n, d, q, seed=n + k)
    wd, wi = jops.knn_topk(jnp.asarray(x), jnp.asarray(qq), k)
    gd, gi = tops.knn_topk(*_t(x, qq), k)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4,
                               atol=1e-3)
    xi, qi = _l2_case(n, d, q, seed=n + k, integer=True)
    xi = xi[np.random.default_rng(k).integers(0, n // 4, n)]   # duplicates
    if d > 6:
        xi[:, 6:] = 0
    for interpret in (None, True):
        wd, wi = jops.knn_topk(jnp.asarray(xi), jnp.asarray(qi), k,
                               interpret=interpret)
        gd, gi = tops.knn_topk(*_t(xi, qi), k)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    ties = np.diff(gd.numpy(), axis=1) == 0
    assert ties.any()
    assert (np.diff(gi.numpy(), axis=1)[ties] > 0).all()


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


# The NaN rule's edge cases (kernels/ref.py l2dist_ref): a row and a query
# of 3 dims, and the bits of their squared distance
NAN_CASES = {
    "inf_minus_inf": ([np.inf, 0, 0], [np.inf, 0, 0], 0xFFC00000),
    "neg_inf_minus_neg_inf": ([-np.inf, 1, 0], [-np.inf, 1, 0], 0xFFC00000),
    "nan_in_x": ([0, _bits(0x7FC00123)[0], 0], [0, 0, 0], 0x7FC00123),
    "signalling_nan_in_x": ([_bits(0x7F800001)[0], 0, 0], [0, 0, 0],
                            0x7FC00001),
    "nan_in_q": ([1, 2, 3], [1, _bits(0xFFC00042)[0], 3], 0xFFC00042),
    "nan_in_both_opposite_signs": ([_bits(0xFFC00001)[0], 0, 0],
                                   [_bits(0x7FC00123)[0], 0, 0], 0xFFC00001),
    "nan_after_inf_minus_inf": ([np.inf, 0, _bits(0x7FC00123)[0]],
                                [np.inf, 0, 0], 0xFFC00000),
    "inf_minus_neg_inf": ([np.inf, 0, 0], [-np.inf, 0, 0], 0x7F800000),
}


@pytest.mark.parametrize("name", sorted(NAN_CASES))
def test_l2dist_ref_nan_bits(name):
    """The plain version's NaN bits on the rule's edge cases: the first
    NaN operand, quieted, and x86's 0xFFC00000 for inf - inf; pinned, as
    the CUDA kernel is held to them and the ranking reads their sign."""
    xr, qr, want = NAN_CASES[name]
    x = np.array([xr], np.float32)
    q = np.array([qr], np.float32)
    got = tref.l2dist_ref(*_t(x, q)).numpy().view(np.uint32)
    assert got.shape == (1, 1) and int(got[0, 0]) == want, hex(got[0, 0])
    # the same pair among other rows and queries (the rewrite of the NaN
    # entries picks the right pair)
    xs = np.concatenate([np.ones((3, 3), np.float32), x])
    qs = np.concatenate([np.zeros((2, 3), np.float32), q])
    got = tref.l2dist_ref(*_t(xs, qs)).numpy().view(np.uint32)
    assert int(got[3, 2]) == want
    assert np.isfinite(got[:3, :2].view(np.float32)).all()


def test_knn_topk_ranks_nan_distances_as_reference():
    """ROADMAP C1: an inf - inf distance is x86's negative NaN, which
    lax.top_k(-d.T, k) ranks FIRST; a NaN from the data is positive and
    ranks last. Ids and distance bits equal the reference's."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (7, 2)).astype(np.float32)
    x[2] = [np.inf, 0]
    x[4] = [np.nan, 0]
    q = np.array([[np.inf, 0]], np.float32)
    wd, wi = jops.knn_topk(jnp.asarray(x), jnp.asarray(q), 7)
    gd, gi = tops.knn_topk(*_t(x, q), 7)
    np.testing.assert_array_equal(np.asarray(wi), [[2, 0, 1, 3, 5, 6, 4]])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy().view(np.uint32),
                                  np.asarray(wd).view(np.uint32))
    assert int(gd.numpy().view(np.uint32)[0, 0]) == 0xFFC00000


def test_zone_prune_boundary_zone():
    """A zone ending exactly at box lo cannot contain a match."""
    zlo = np.array([[0.0], [2.0]], np.float32)
    zhi = np.array([[1.0], [3.0]], np.float32)
    blo, bhi = np.array([[1.0]], np.float32), np.array([[2.5]], np.float32)
    want = np.asarray(jops.zone_prune(*map(jnp.asarray, (zlo, zhi, blo, bhi)),
                                      interpret=True))
    got = tref.zone_prune_ref(*_t(zlo, zhi, blo, bhi)).numpy()
    np.testing.assert_array_equal(want[:, 0], [False, True])
    np.testing.assert_array_equal(got, want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version itself: CPU tensors
    reaching it raise (ops.py does the CPU dispatch)."""
    arrs = _t(*_zone_case(37, 6, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tzone_prune.zone_hits(*arrs)
    x, lo, hi, onehot = _t(*_seg_case(300, 6, 7, 3, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbox_scan.box_scan_seg(x, lo, hi, onehot)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbox_scan.box_scan(x, lo, hi)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tl2dist.l2dist(x, lo)


# ----------------------------------------------------------------------
# CUDA kernels vs their plain versions (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_kernels.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("nz,d,b", ZONE_SHAPES)
def test_zone_prune_cuda_matches_plain(cuda, nz, d, b):
    arrs = _t(*_zone_case(nz, d, b), device=cuda)
    n0 = tzone_prune.launches
    mask = tzone_prune.zone_prune(*arrs)
    hit = tzone_prune.zone_hits(*arrs)
    torch.cuda.synchronize()
    assert tzone_prune.launches == n0 + 2
    assert torch.equal(mask, tref.zone_prune_ref(*arrs))
    assert torch.equal(hit, tref.zone_hits_ref(*arrs))


@pytest.mark.gpu
@pytest.mark.parametrize("nz,d,b", ZONE_MASK_CUDA_SHAPES)
def test_zone_prune_mask_cuda_bitwise(cuda, nz, d, b):
    """The mask kernel's bytes equal the plain version's, twice; the hit
    vector beside it."""
    arrs = _t(*_zone_mask_case(nz, d, b), device=cuda)
    n0 = tzone_prune.launches
    first = tzone_prune.zone_prune(*arrs)
    second = tzone_prune.zone_prune(*arrs)
    hit = tzone_prune.zone_hits(*arrs)
    torch.cuda.synchronize()
    assert tzone_prune.launches == n0 + 3
    want = tref.zone_prune_ref(*arrs)
    assert first.shape == (nz, b) and first.dtype == torch.bool
    assert torch.equal(first.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(second.view(torch.uint8), first.view(torch.uint8))
    assert torch.equal(hit, want.any(1))


@pytest.mark.gpu
def test_query_index_fused_cuda_equals_cpu(cuda):
    """query_index_fused / query_index_fused_multi on the card: the CPU's
    counts and stats, with one zone_candidates and one box_scan_seg
    launch a call and no zone_prune mask."""
    from repro_torch.core import index as tindex
    from repro_torch.core.boxes import BoxSet
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (20000, 6)).astype(np.float32)
    dims = np.arange(6)
    gix = tindex.build_index(x, dims, block=128, device=cuda)
    cix = tindex.build_index(x, dims, block=128, device="cpu")
    centers = x[rng.integers(0, len(x), 9)]
    lo, hi = centers - 0.4, centers + 0.4
    owner = np.repeat(np.arange(3, dtype=np.int32), 3)
    bs = BoxSet(lo.astype(np.float32), hi.astype(np.float32), dims)
    for cap in (None, 3):
        c0 = (tzone_prune.candidates_launches, tbox_scan.seg_launches,
              tzone_prune.launches)
        got, st = tindex.query_index_fused(gix, bs, capacity=cap)
        gm, stm = tindex.query_index_fused_multi(gix, bs, owner, 3,
                                                 capacity=cap)
        assert (tzone_prune.candidates_launches - c0[0],
                tbox_scan.seg_launches - c0[1],
                tzone_prune.launches - c0[2]) == (2, 2, 2)
        want, st_c = tindex.query_index_fused(cix, bs, capacity=cap)
        wm, stm_c = tindex.query_index_fused_multi(cix, bs, owner, 3,
                                                   capacity=cap)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gm, wm)
        assert st == st_c and stm == stm_c
        assert st["overflowed"] == (cap is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,q", SEG_SHAPES)
def test_box_scan_seg_cuda_matches_plain(cuda, n, d, b, q):
    x, lo, hi, onehot = _t(*_seg_case(n, d, b, q, seed=n + b), device=cuda)
    n0 = tbox_scan.seg_launches
    got = tbox_scan.box_scan_seg(x, lo, hi, onehot)
    torch.cuda.synchronize()
    assert tbox_scan.seg_launches == n0 + 1
    assert torch.equal(got, tref.box_scan_seg_ref(x, lo, hi, onehot))
    # gather mode: blocks of 64 rows (single rows when 64 does not
    # divide n) read in place
    block = 64 if n % 64 == 0 else 1
    rows3 = x.reshape(-1, block, d)
    nb = rows3.shape[0]
    cand = torch.arange(nb - 1, -1, -2, dtype=torch.int32, device=cuda)
    for nh in (0, cand.shape[0] // 2, cand.shape[0]):
        n_hit = torch.tensor(nh, dtype=torch.int32, device=cuda)
        got = tbox_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi,
                                            onehot)
        want = tref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b", SCAN_CUDA_SHAPES)
def test_box_scan_cuda_matches_plain(cuda, n, d, b):
    x, lo, hi = _t(*_scan_case(n, d, b, seed=n + d + b), device=cuda)
    n0 = tbox_scan.scan_launches
    got = tbox_scan.box_scan(x, lo, hi)
    torch.cuda.synchronize()
    assert tbox_scan.scan_launches == n0 + 1
    assert torch.equal(got, tref.box_scan_ref(x, lo, hi))
    none = tbox_scan.box_scan(x, lo[:0], hi[:0])     # B = 0: no launch
    assert tbox_scan.scan_launches == n0 + 1
    assert not none.any() and none.dtype == torch.int32


def _pruned_case(nb, block, d, b, c, m, seed):
    """rows3 [nb, block, d] with +-inf and NaN rows, b boxes around random
    rows (every fifth with a -inf lo or +inf hi dim, the last an
    impossible (+inf, -inf) pad), and cand [c]: m ascending, unique block
    ids, 0-filled as zone_candidates fills it."""
    rng = np.random.default_rng(seed)
    rows3 = rng.normal(0, 1, (nb, block, d)).astype(np.float32)
    flat = rows3.reshape(-1, d)
    n = flat.shape[0]
    centers = flat[rng.integers(0, n, max(b, 1))][:b]
    w = np.float32(0.3 + 0.25 * np.sqrt(d))       # wider with d
    lo, hi = centers - w, centers + w
    flat[rng.integers(0, n, 3), 0] = np.nan
    flat[rng.integers(0, n, 3), d - 1] = np.inf
    flat[rng.integers(0, n, 3), 0] = -np.inf
    lo[::5, 0], hi[1::5, d - 1] = -np.inf, np.inf
    if b:
        lo[-1], hi[-1] = np.inf, -np.inf
    cand = np.zeros(c, np.int32)
    cand[:m] = np.sort(rng.choice(nb, m, replace=False))
    return rows3, cand, lo, hi


# (nb, block, d, boxes, C, live): blocks of 1,024 at d' = 6 and at every
# d <= 8; block lengths not a multiple of 4 or 32, of one row, and one
# item past 1,024; C > NB; more boxes than one 64 KB chunk of records
# (1,365 at d' = 6, 455 at d = 17); no box; d = 17 (rows from the stage).
# Where live == C, n_hit also runs past C (zone_candidates fills no slot
# then).
PRUNED_CUDA_CASES = [(8, 1024, 6, 16, 8, 5), (40, 1024, 6, 16, 32, 20),
                     (8, 1024, 6, 16, 4, 4)] + [
    (6, 1024, d, 9, 4, 4) for d in (1, 2, 3, 4, 5, 7, 8)] + [
    (50, 37, 6, 7, 16, 11), (300, 1, 6, 5, 64, 40), (5, 3000, 6, 12, 3, 3),
    (6, 64, 6, 9, 10, 4), (9, 101, 6, 1500, 6, 5), (12, 50, 17, 600, 8, 6),
    (7, 1024, 17, 9, 4, 4), (10, 64, 6, 0, 4, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("nb,block,d,b,c,m", PRUNED_CUDA_CASES)
def test_box_scan_pruned_cuda_matches_plain(cuda, nb, block, d, b, c, m):
    """box_scan_pruned bitwise box_scan_pruned_ref at n_hit 0, within the
    live slots, all of them, and past C where every slot is live; one
    launch a call, two calls bitwise equal."""
    rows3, cand, lo, hi = _t(*_pruned_case(nb, block, d, b, c, m,
                                           seed=nb + block + d + b),
                             device=cuda)
    for nh in (0, m // 2, m) + ((c + 3,) if m == c else ()):
        n_hit = torch.tensor(nh, dtype=torch.int32, device=cuda)
        n0 = tbox_scan.pruned_launches
        got = tbox_scan.box_scan_pruned(rows3, cand, n_hit, lo, hi)
        again = tbox_scan.box_scan_pruned(rows3, cand, n_hit, lo, hi)
        torch.cuda.synchronize()
        assert tbox_scan.pruned_launches == n0 + 2
        want = tref.box_scan_pruned_ref(rows3, cand, n_hit, lo, hi)
        assert torch.equal(got, want), (got != want).nonzero()[:5]
        assert torch.equal(got, again)
        assert torch.equal(tops.box_scan_pruned(rows3, cand, n_hit, lo, hi),
                           want)


@pytest.mark.gpu
def test_box_scan_pruned_cuda_one_gap_spans_the_catalog(cuda):
    """One live block at each end of 4,096: the gap between them spans
    most of the output and is spread over the grid."""
    rows3, _, lo, hi = _pruned_case(4096, 64, 6, 16, 0, 0, seed=1)
    cand = np.array([0, 4095, 0, 0], np.int32)
    rows3, cand, lo, hi = _t(rows3, cand, lo, hi, device=cuda)
    n_hit = torch.tensor(2, dtype=torch.int32, device=cuda)
    got = tbox_scan.box_scan_pruned(rows3, cand, n_hit, lo, hi)
    assert torch.equal(got, tref.box_scan_pruned_ref(rows3, cand, n_hit, lo,
                                                     hi))
    assert not got[64:-64].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 5 * 1024 + 7,
                               264 * 1024 * 3 + 513])
@pytest.mark.parametrize("d", [1, 6, 8])
def test_box_scan_narrow_cuda_matches_plain(cuda, n, d):
    """box_scan at d <= 8, box_scan_pruned's one-block case, at N not a
    multiple of the 1,024-row item, more items than the grid's CTAs
    included; one launch counted on box_scan's counter only."""
    x, lo, hi = _t(*_scan_case(n, d, 40, seed=n + d), device=cuda)
    n0 = (tbox_scan.scan_launches, tbox_scan.pruned_launches)
    got = tbox_scan.box_scan(x, lo, hi)
    torch.cuda.synchronize()
    assert (tbox_scan.scan_launches,
            tbox_scan.pruned_launches) == (n0[0] + 1, n0[1])
    assert torch.equal(got, tref.box_scan_ref(x, lo, hi))


@pytest.mark.gpu
def test_box_scan_pruned_cuda_refuses_what_it_cannot_take(cuda):
    rows3, cand, lo, hi = _t(*_pruned_case(4, 16, 6, 3, 4, 2, seed=0),
                             device=cuda)
    n_hit = torch.tensor(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="cand"):
        tbox_scan.box_scan_pruned(rows3, cand.long(), n_hit, lo, hi)
    with pytest.raises(ValueError, match="lo"):
        tbox_scan.box_scan_pruned(rows3, cand, n_hit, lo[:, :5], hi)
    with pytest.raises(ValueError, match="CUDA"):
        tbox_scan.box_scan_pruned(rows3.cpu(), cand.cpu(), n_hit.cpu(),
                                  lo.cpu(), hi.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,q", L2_CUDA_SHAPES)
def test_l2dist_cuda_matches_plain(cuda, n, d, q):
    x, qq = _t(*_l2_case(n, d, q, seed=n + d + q), device=cuda)
    n0 = tl2dist.launches
    got = tl2dist.l2dist(x, qq)
    torch.cuda.synchronize()
    assert tl2dist.launches == n0 + 1
    assert torch.equal(got, tref.l2dist_ref(x, qq))
    cd, ci = tops.knn_topk(x, qq, min(50, n))
    hd, hi_ = tops.knn_topk(x.cpu(), qq.cpu(), min(50, n))
    assert torch.equal(cd.cpu(), hd) and torch.equal(ci.cpu(), hi_)


@pytest.mark.gpu
@pytest.mark.parametrize("d_pad", [3, 130])       # tiled, D-chunked
def test_l2dist_cuda_nan_bits_match_cpu(cuda, d_pad):
    """The CUDA kernel's NaN bits equal the plain version's run on CPU
    copies (torch's CUDA ops give 0x7FFFFFFF for every NaN), on the NaN
    rule's edge cases, every row against every query."""
    xs = np.zeros((len(NAN_CASES) + 2, d_pad), np.float32)
    qs = np.zeros((len(NAN_CASES) + 1, d_pad), np.float32)
    for i, name in enumerate(sorted(NAN_CASES)):
        xs[i, :3], qs[i, :3] = NAN_CASES[name][0], NAN_CASES[name][1]
    xs[-2:] = np.arange(2 * d_pad).reshape(2, d_pad)
    x, q = _t(xs, qs)
    got = tl2dist.l2dist(x.to(cuda), q.to(cuda))
    want = tref.l2dist_ref(x, q)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    for i, name in enumerate(sorted(NAN_CASES)):
        assert int(got[i, i].cpu().view(torch.int32)) & 0xFFFFFFFF \
            == NAN_CASES[name][2]
    cd, ci = tops.knn_topk(x.to(cuda), q.to(cuda), xs.shape[0])
    hd, hi_ = tops.knn_topk(x, q, xs.shape[0])
    assert torch.equal(ci.cpu(), hi_)
    assert torch.equal(cd.cpu().view(torch.int32), hd.view(torch.int32))
