"""The port's kernels against the reference's.

On the CPU: the plain PyTorch versions (repro_torch.kernels.ref, what the
wrappers use for CPU tensors) against the Pallas kernels run in interpret
mode, at the shapes of tests/test_kernels.py and tests/test_fused_query.py
plus the half-open boundary and +-inf / NaN padding cases. Outputs are
bool or int32: equality is exact.

On a CUDA card (marker ``gpu``; skipped without one): the hand-written
CUDA kernels against their plain versions at the same shapes, exactly.
Run them there with ``python -m pytest -m gpu tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.zone_prune import zone_prune_pallas
from repro_torch.kernels import box_scan as tbox_scan
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


ZONE_SHAPES = [(512, 128, 8), (1024, 128, 32), (512, 256, 2),
               (37, 6, 3), (513, 5, 9), (1, 6, 1), (1024, 6, 64)]
SEG_SHAPES = [(300, 6, 7, 3), (1024, 4, 16, 1), (513, 17, 5, 9),
              (2048, 6, 40, 8)]


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
@pytest.mark.parametrize("n,d,b,q", SEG_SHAPES)
def test_box_scan_seg_cuda_matches_plain(cuda, n, d, b, q):
    x, lo, hi, onehot = _t(*_seg_case(n, d, b, q, seed=n + b), device=cuda)
    n0 = tbox_scan.launches
    got = tbox_scan.box_scan_seg(x, lo, hi, onehot)
    torch.cuda.synchronize()
    assert tbox_scan.launches == n0 + 1
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
