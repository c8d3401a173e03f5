"""The fused probe's front end: zone maps -> (cand, n_hit).

On the CPU: the plain version ``repro_torch.kernels.ref.zone_candidates_ref``
(and ``ops.fused_query``, which takes it for CPU tensors) against the
reference's ``fused_query`` — ``jnp.nonzero(hit, size=capacity,
fill_value=0)`` and ``hit.sum()`` — on the cases the kernel has to get
right: capacity below, at and above n_hit, ragged NZ, no hits, all hits,
one box, D > 8, NaN zone maps, +-inf boxes, exact boundaries, and a hypothesis property over
random zone maps and boxes. cand and n_hit are int32: equality is exact.

On a CUDA card (marker ``gpu``; skipped without one): the one-launch
kernel ``zone_prune.zone_candidates`` against the plain version on the
same cases, at the main path's shape (1,024 zones of d' = 6: the most
that one CTA takes), one zone either side of it, at 8,192 and at 131,072
zones (several CTAs joined by a look-back scan); a CUDA ``fused_query`` makes exactly
one zone_prune launch. Run them there with
``python -m pytest -m gpu tests/test_torch_probe.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import zone_prune as tzone_prune

INF = np.float32(np.inf)
NAN = np.float32(np.nan)


def _zones(nz, d, seed):
    rng = np.random.default_rng(seed)
    zlo = rng.normal(0, 1, (nz, d)).astype(np.float32)
    zhi = zlo + np.abs(rng.normal(0, 0.5, (nz, d))).astype(np.float32)
    return zlo, zhi


def _boxes(b, d, seed, width=0.3):
    rng = np.random.default_rng(seed)
    lo = rng.normal(0, 1, (b, d)).astype(np.float32)
    return lo, (lo + width).astype(np.float32)


def _case(name):
    """(zlo, zhi, blo, bhi, capacity) for each named case."""
    if name in ("cap_below", "cap_equal", "cap_above"):
        zlo, zhi = _zones(60, 4, 0)
        blo, bhi = _boxes(5, 4, 1, width=1.0)
        n = int(tref.zone_hits_ref(*map(torch.from_numpy,
                                        (zlo, zhi, blo, bhi))).sum())
        assert 2 < n < 58
        cap = {"cap_below": n - 2, "cap_equal": n, "cap_above": n + 7}[name]
        return zlo, zhi, blo, bhi, cap
    if name == "ragged":
        zlo, zhi = _zones(37, 6, 2)
        return (zlo, zhi, *_boxes(3, 6, 3, width=1.5), 10)
    if name == "no_hits":
        zlo, zhi = _zones(40, 3, 4)
        blo = np.full((4, 3), 50, np.float32)
        return zlo, zhi, blo, blo + 1, 8
    if name == "all_hits":
        zlo, zhi = _zones(40, 3, 5)
        blo = np.full((2, 3), -INF, np.float32)
        return zlo, zhi, blo, np.full((2, 3), INF, np.float32), 64
    if name == "wide_dims":               # D > 8: the kernel's generic route
        zlo, zhi = _zones(45, 12, 10)
        return (zlo, zhi, *_boxes(6, 12, 11, width=2.5), 20)
    if name == "one_box":
        zlo, zhi = _zones(50, 6, 6)
        return (zlo, zhi, *_boxes(1, 6, 7, width=3.0), 16)
    if name == "nan_zones":
        zlo, zhi = _zones(30, 3, 8)
        zlo[[1, 4, 9]], zhi[[2, 4]] = NAN, NAN
        blo = np.full((1, 3), -INF, np.float32)
        return zlo, zhi, blo, np.full((1, 3), INF, np.float32), 30
    if name == "inf_boxes":
        zlo, zhi = _zones(30, 2, 9)
        zlo[0], zhi[0] = INF, INF                # +inf padded zone
        zhi[3, 1] = -INF
        blo = np.array([[-INF, -INF], [INF, -INF], [0.5, -INF]],
                       np.float32)
        bhi = np.array([[-1.0, INF], [-INF, INF], [INF, 0.0]], np.float32)
        return zlo, zhi, blo, bhi, 30
    if name == "boundary":
        # a zone ending exactly at a box's lo cannot hold a match; one
        # starting exactly at its hi can
        zlo = np.array([[0.0], [2.0], [2.5], [5.0]], np.float32)
        zhi = np.array([[1.0], [3.0], [4.0], [6.0]], np.float32)
        return (zlo, zhi, np.array([[1.0]], np.float32),
                np.array([[2.5]], np.float32), 4)
    raise KeyError(name)


CASES = ["cap_below", "cap_equal", "cap_above", "ragged", "no_hits",
         "all_hits", "one_box", "wide_dims", "nan_zones", "inf_boxes",
         "boundary"]


def _t(*arrs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrs]


def _reference(zlo, zhi, blo, bhi, cap, use_pallas):
    """The reference fused_query's (cand, n_hit) on these zone maps, over
    rows3 of two zero rows a block."""
    nz, d = zlo.shape
    rows3 = np.zeros((nz, 2, d), np.float32)
    onehot = np.ones((blo.shape[0], 1), np.float32)
    _, cand, n_hit = jops.fused_query(
        *map(jnp.asarray, (rows3, zlo, zhi, blo, bhi, onehot)),
        capacity=cap, use_pallas=use_pallas,
        interpret=True if use_pallas else None)
    return np.asarray(cand), np.asarray(n_hit)


def _eq(got, want):
    g = got.cpu().numpy()
    assert g.dtype == want.dtype == np.int32, (g.dtype, want.dtype)
    assert g.shape == want.shape
    np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("name", CASES)
def test_zone_candidates_ref_matches_fused_query(name):
    zlo, zhi, blo, bhi, cap = _case(name)
    cand, n_hit = tref.zone_candidates_ref(*_t(zlo, zhi, blo, bhi), cap)
    for use_pallas in (False, True):
        wc, wn = _reference(zlo, zhi, blo, bhi, cap, use_pallas)
        _eq(cand, wc)
        _eq(n_hit, wn)
    # the CPU dispatch of ops, and fused_query's own cand / n_hit
    oc, on = tops.zone_candidates(*_t(zlo, zhi, blo, bhi), cap)
    _eq(oc, wc)
    _eq(on, wn)
    rows3 = torch.zeros((zlo.shape[0], 2, zlo.shape[1]))
    onehot = torch.ones((blo.shape[0], 1))
    _, fc, fn = tops.fused_query(rows3, *_t(zlo, zhi, blo, bhi), onehot,
                                 capacity=cap)
    _eq(fc, wc)
    _eq(fn, wn)
    if name == "cap_below":
        assert int(wn) > cap
    if name == "no_hits":
        assert int(wn) == 0 and not wc.any()
    if name == "all_hits":
        assert int(wn) == zlo.shape[0]
    if name == "boundary":
        np.testing.assert_array_equal(wc, [1, 2, 0, 0])


_VALUES = st.sampled_from([-np.inf, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0,
                           np.inf, np.nan])


@settings(max_examples=40, deadline=None)
@given(st.sampled_from([5, 33]), st.sampled_from([1, 3]),
       st.sampled_from([1, 4]), st.sampled_from([1, 6, 40]), st.data())
def test_zone_candidates_ref_property(nz, d, b, cap, data):
    """Zone maps and boxes drawn from {+-inf, NaN, a few numbers}: the
    plain version equals the reference's fused_query."""
    def arr(shape):
        return np.array(data.draw(st.lists(_VALUES, min_size=int(np.prod(
            shape)), max_size=int(np.prod(shape)))), np.float32
                        ).reshape(shape)
    zlo, blo = arr((nz, d)), arr((b, d))
    with np.errstate(invalid="ignore"):            # -inf + inf is NaN
        zhi = zlo + np.abs(arr((nz, d)))
        bhi = blo + np.abs(arr((b, d)))
    cand, n_hit = tref.zone_candidates_ref(*_t(zlo, zhi, blo, bhi), cap)
    wc, wn = _reference(zlo, zhi, blo, bhi, cap, use_pallas=False)
    _eq(cand, wc)
    _eq(n_hit, wn)


def test_zone_candidates_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version itself."""
    zlo, zhi, blo, bhi, cap = _case("ragged")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tzone_prune.zone_candidates(*_t(zlo, zhi, blo, bhi), cap)


# ----------------------------------------------------------------------
# The CUDA kernel vs its plain version (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_probe.py)")
    return torch.device("cuda", 0)


def _check_cuda(arrs, cap):
    n0 = tzone_prune.launches
    cand, n_hit = tzone_prune.zone_candidates(*arrs, cap)
    torch.cuda.synchronize()
    assert tzone_prune.launches == n0 + 1
    wc, wn = tref.zone_candidates_ref(*arrs, cap)
    assert cand.dtype == n_hit.dtype == torch.int32
    assert n_hit.shape == () and cand.shape == (cap,)
    assert torch.equal(cand, wc) and torch.equal(n_hit, wn)
    return int(wn)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_zone_candidates_cuda_matches_plain(cuda, name):
    zlo, zhi, blo, bhi, cap = _case(name)
    arrs = _t(zlo, zhi, blo, bhi, device=cuda)
    for _ in range(2):
        _check_cuda(arrs, cap)


def _main_path_case(nz, seed, b=16, d=6):
    """Zones of sorted clustered rows and boxes around some of them, as
    the fused batch's probes see them (a NaN zone, a +inf padded one)."""
    rng = np.random.default_rng(seed)
    centres = np.sort(rng.normal(0, 3, nz))
    zlo = (centres[:, None] + rng.normal(0, 1, (nz, d))).astype(np.float32)
    zhi = (zlo + np.abs(rng.normal(0, 0.5, (nz, d)))).astype(np.float32)
    zlo[nz // 3, 2] = NAN
    zlo[-1], zhi[-1] = INF, INF
    lo = (zlo[rng.integers(0, nz, b)] - 0.2).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 2.0, (b, d))).astype(np.float32)
    return zlo, zhi, lo, hi


@pytest.mark.gpu
@pytest.mark.parametrize("nz,cap", [
    (1024, 1024), (1024, 256), (1023, 4096), (1025, 4096), (1025, 16),
    (8192, 8192), (131072, 32768), (131072, 131072)])
def test_zone_candidates_cuda_at_path_shapes(cuda, nz, cap):
    arrs = _t(*_main_path_case(nz, seed=nz + cap), device=cuda)
    # twice: the several-CTA launch leaves its scratch zero for the next
    hits = [_check_cuda(arrs, cap) for _ in range(2)]
    assert 0 < hits[0] == hits[1] < nz


@pytest.mark.gpu
def test_fused_query_cuda_one_zone_launch_per_probe(cuda):
    """ops.fused_query on CUDA tensors: one zone_prune launch from zone
    maps to cand / n_hit, and the same outputs as on the CPU."""
    zlo, zhi, lo, hi = _main_path_case(300, seed=3, b=9)
    rng = np.random.default_rng(0)
    rows3 = rng.normal(0, 1, (300, 8, 6)).astype(np.float32)
    onehot = (rng.integers(0, 3, 9)[:, None] == np.arange(3)).astype(
        np.float32)
    host = _t(rows3, zlo, zhi, lo, hi, onehot)
    dev = [a.to(cuda) for a in host]
    for cap in (4, 64, 300):
        n0 = tzone_prune.launches
        got = tops.fused_query(*dev, capacity=cap)
        torch.cuda.synchronize()
        assert tzone_prune.launches == n0 + 1
        want = tops.fused_query(*host, capacity=cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
