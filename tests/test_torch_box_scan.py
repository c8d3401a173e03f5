"""The box-scan kernels' rules against the reference's, and the CUDA
kernels against their plain versions.

The full-width box_scan kernel (csrc/box_scan.cu) tests each box only on
the dims it constrains (lo, hi) != (-inf, +inf), behind a per-row check
``row_ok = all_k x_k > -inf``, and takes the boxes in chunks of at most
``MAX_ENTRIES`` list entries and ``MAX_CHUNK_BOXES`` boxes, a pass over
the rows a chunk. box_scan_seg (csrc/box_scan_seg.cu) tests a candidate
slot's rows in tiles, adds each containing box's ownership row into f32
sums in box order, takes the boxes in chunks, and writes every row of a
slot >= n_hit as zero. On the CPU, torch emulations of those rules are
held against ``repro.kernels.ref`` and the Pallas kernels in interpret
mode, on the edge cases the rules must get right (NaN and -inf rows at
constrained and free dims, NaN bounds, half-infinite bounds, boxes with
no constrained dim, x == lo and x == hi) and on a hypothesis property
over {-inf, -1, 0, 1, +inf, NaN}. Outputs are int32: equality is exact.

On a CUDA card (marker ``gpu``; skipped without one) the kernels are held
bitwise against ``repro_torch.kernels.ref`` at tile edges, every row-width
route, chunk overflows and every n_hit regime. Run them there with
``python -m pytest -m gpu tests/test_torch_box_scan.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.box_scan import box_scan_pallas
from repro_torch.kernels import box_scan as tbox_scan
from repro_torch.kernels import ref as tref

INF = np.float32(np.inf)
# the kernels' chunk limits (csrc/box_scan.cu kMaxEntries, kMaxChunkBoxes;
# csrc/box_scan_seg.cu kBoxBudget) and row tiles (kStageTarget)
MAX_ENTRIES, MAX_CHUNK_BOXES = 4096, 256
SEG_BOX_BUDGET = 64 * 1024


def scan_tile_rows(d):
    """Rows a ring stage of the full-width box_scan holds."""
    return max(1, 48 * 1024 // (4 * d))


def seg_tile_rows(d, block):
    """Rows of one box_scan_seg work item."""
    return max(1, min(32 * 1024 // (4 * d), 1024, block))


# ----------------------------------------------------------------------
# the kernels' rules, emulated in torch
# ----------------------------------------------------------------------

def lists_box_scan(x, lo, hi, max_entries=MAX_ENTRIES,
                   max_boxes=MAX_CHUNK_BOXES):
    """box_scan by the full-width kernel's rule: per box, the list of
    constrained dims (ascending) tested up to the first failing one;
    rows with NaN or -inf anywhere count 0; boxes in chunks that fit
    ``max_entries`` entries (a list of even length takes one more, an
    always-passing (-inf, +inf) entry) and ``max_boxes`` boxes, the
    counts added over the passes."""
    n, d = x.shape
    nb = lo.shape[0]
    free = (lo == -INF) & (hi == INF)                      # [B, D]
    row_ok = (x > -INF).all(1)
    out = torch.zeros(n, dtype=torch.int32)
    b0 = 0
    while b0 < nb:
        run, bn = 0, 0
        while b0 + bn < nb and bn < max_boxes:
            c = int((~free[b0 + bn]).sum()) | 1        # padded to odd
            if bn > 0 and run + c > max_entries:
                break
            run += c
            bn += 1
        cnt = torch.zeros(n, dtype=torch.int32)
        for b in range(b0, b0 + bn):
            dims = torch.nonzero(~free[b]).flatten()
            inside = torch.ones(n, dtype=torch.bool)
            for k in dims.tolist():                        # first failing
                inside &= (x[:, k] > lo[b, k]) & (x[:, k] <= hi[b, k])
            cnt += (inside & row_ok).to(torch.int32)
        out += cnt
        b0 += bn
    return out


def seg_gather(rows3, cand, n_hit, lo, hi, onehot, tile_rows,
               box_chunk):
    """box_scan_seg_gather by the kernel's rule: live slots' rows in
    items of ``tile_rows``, each warp's run of 128 rows skipping the
    boxes that miss its bounding box (NaN left out), each containing box
    adding its ownership row into f32 sums in box order, boxes in chunks
    of ``box_chunk``; every row of a slot >= n_hit (clamped to [0, C])
    zero."""
    c = cand.shape[0]
    _, block, d = rows3.shape
    nq = onehot.shape[1]
    out = torch.zeros((c * block, nq), dtype=torch.int32)
    nh = max(0, min(int(n_hit), c))
    for slot in range(nh):
        rows = rows3[int(cand[slot])]
        for t0 in range(0, block, tile_rows):
            x = rows[t0:t0 + tile_rows]
            acc = torch.zeros((x.shape[0], nq), dtype=torch.float32)
            for w0 in range(0, x.shape[0], 128):
                xw = x[w0:w0 + 128]
                mn = torch.where(xw.isnan(), INF, xw).min(0).values
                mx = torch.where(xw.isnan(), -INF, xw).max(0).values
                for b0 in range(0, lo.shape[0], box_chunk):
                    for b in range(b0, min(b0 + box_chunk, lo.shape[0])):
                        if not ((lo[b] < mx) & (mn <= hi[b])).all():
                            continue
                        inside = ((xw > lo[b]) & (xw <= hi[b])).all(1)
                        acc[w0:w0 + 128][inside] += onehot[b]
            r0 = slot * block + t0
            out[r0:r0 + x.shape[0]] = acc.to(torch.int32)
    return out


# ----------------------------------------------------------------------
# cases
# ----------------------------------------------------------------------

def edge_case(n, d, b, seed, p_free=0.8):
    """Rows ~ N(0, 1); boxes around random rows with most dims free, and
    the rule's edge cases: box 0 free on every dim, box 1 one constrained
    dim, box 2 every dim constrained, box 3 a NaN bound, box 4 lo = -inf
    under a finite hi and hi = +inf over a finite lo. Row 1 NaN, row 2
    -inf and row 3 +inf at dims box 0 leaves free and box 2 constrains;
    row 4 on box 2's hi (inside), row 5 on its lo at dim 0 (outside);
    row 6 NaN at the one dim box 1 constrains."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    c = x[rng.integers(0, n, b)]
    lo = (c - rng.uniform(0.2, 1.5, (b, d))).astype(np.float32)
    hi = (c + rng.uniform(0.2, 1.5, (b, d))).astype(np.float32)
    free = rng.random((b, d)) < p_free
    if b > 0:
        free[0] = True
    if b > 1:
        free[1] = True
        free[1, d // 2] = False
    if b > 2:
        free[2] = False
    lo[free], hi[free] = -INF, INF
    if b > 3:
        lo[3, 0], hi[3, 0] = np.nan, 1.0
    if b > 4:
        lo[4, 0], hi[4, 0] = -INF, 0.5
        lo[4, d - 1], hi[4, d - 1] = -0.5, INF
    if n > 6 and b > 2:
        x[1, d - 1] = np.nan
        x[2, 0] = -INF
        x[3, 0] = INF
        x[4] = hi[2]                      # inside box 2: x == hi
        x[5] = hi[2]
        x[5, 0] = lo[2, 0]                # outside box 2: x == lo
        x[6, d // 2] = np.nan
    return x, lo, hi


def _t(*arrs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrs]


def _jax_scan(x, lo, hi):
    """repro's plain version and its interpret-mode Pallas kernel (through
    the padding wrapper), which must agree."""
    want = np.asarray(jref.box_scan_ref(*map(jnp.asarray, (x, lo, hi))))
    pallas = np.asarray(jops.box_scan(*map(jnp.asarray, (x, lo, hi)),
                                      interpret=True))
    np.testing.assert_array_equal(pallas, want)
    return want


# ----------------------------------------------------------------------
# CPU: the rules against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b,max_entries", [
    (40, 6, 7, MAX_ENTRIES), (64, 17, 9, MAX_ENTRIES),
    (50, 130, 6, MAX_ENTRIES), (33, 384, 12, MAX_ENTRIES),
    (30, 400, 5, MAX_ENTRIES), (40, 17, 9, 7), (40, 6, 7, 1)])
def test_lists_rule_matches_reference(n, d, b, max_entries):
    """The list rule (chunked down to ``max_entries`` entries a chunk)
    equals repro's box_scan_ref and the interpret-mode Pallas kernel."""
    x, lo, hi = edge_case(n, d, b, seed=n + d + b)
    want = _jax_scan(x, lo, hi)
    got = lists_box_scan(*_t(x, lo, hi), max_entries=max_entries)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.box_scan_ref(*_t(x, lo, hi)).numpy(),
                                  want)


def test_lists_rule_edge_semantics():
    """What the rule must get right, case by case."""
    x, lo, hi = edge_case(40, 6, 7, seed=0)
    inside = lambda i, bx: bool(((x[i] > lo[bx]) & (x[i] <= hi[bx])).all())
    assert not inside(1, 0) and not inside(2, 0)   # NaN / -inf, free dims
    assert inside(3, 0)                            # +inf passes free dims
    assert inside(4, 2) and not inside(5, 2)       # x == hi in, == lo out
    assert not any(inside(i, 3) for i in range(40))    # NaN bound
    got = lists_box_scan(*_t(x, lo, hi)).numpy()
    np.testing.assert_array_equal(got, _jax_scan(x, lo, hi))
    assert got[1] == 0 and got[2] == 0 and got[6] == 0
    # without the row check, the free box 0 would count the NaN row
    free = (lo == -INF) & (hi == INF)
    assert free[0].all() and free[1].sum() == 5 and not free[2].any()


def test_box_with_no_constrained_dim_counts_every_ordinary_row():
    x = np.array([[0.0, 1.0], [INF, -1.0], [np.nan, 0.0], [-INF, 0.0],
                  [1e30, -1e30]], np.float32)
    lo = np.full((1, 2), -INF, np.float32)
    hi = np.full((1, 2), INF, np.float32)
    want = _jax_scan(x, lo, hi)
    np.testing.assert_array_equal(want, [1, 1, 0, 0, 1])
    np.testing.assert_array_equal(lists_box_scan(*_t(x, lo, hi)).numpy(),
                                  want)


def test_half_infinite_bounds_and_raw_pallas():
    """lo = -inf with a finite hi admits -1e30 but not -inf; hi = +inf
    with a finite lo admits +inf. At the raw kernel's aligned shape."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (512, 128)).astype(np.float32)
    lo = np.full((3, 128), -INF, np.float32)
    hi = np.full((3, 128), INF, np.float32)
    hi[0, 5] = 0.0                                 # (-inf, 0] at dim 5
    lo[1, 7] = 0.0                                 # (0, +inf] at dim 7
    lo[2], hi[2] = -1.0, 1.0
    x[0, 5], x[1, 5], x[2, 7], x[3, 7] = -1e30, -INF, INF, 0.0
    want = np.asarray(box_scan_pallas(*map(jnp.asarray, (x, lo, hi)),
                                      tile_n=512, interpret=True))
    got = lists_box_scan(*_t(x, lo, hi)).numpy()
    np.testing.assert_array_equal(got, want)
    # box 2 holds neither row 0 (-1e30) nor row 2 (+inf)
    assert want[0] == 1 + int(x[0, 7] > 0)         # box 0 admits -1e30
    assert want[1] == 0                            # a -inf row: none
    assert want[2] == 1 + int(x[2, 5] <= 0)        # box 1 admits +inf


_VALS = st.sampled_from([-np.inf, -1.0, 0.0, 1.0, np.inf, np.nan])


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.integers(1, 9), st.integers(1, 6),
       st.data())
def test_lists_rule_property(n, d, b, data):
    """Over values from {-inf, -1, 0, 1, +inf, NaN} with random free
    dims, the list rule (in chunks of 3 entries) equals box_scan_ref."""
    draw = lambda shape: np.array(
        data.draw(st.lists(_VALS, min_size=int(np.prod(shape)),
                           max_size=int(np.prod(shape)))),
        np.float32).reshape(shape)
    x, lo, hi = draw((n, d)), draw((b, d)), draw((b, d))
    free = np.array(data.draw(st.lists(st.booleans(), min_size=b * d,
                                       max_size=b * d))).reshape(b, d)
    lo[free], hi[free] = -INF, INF
    want = np.asarray(jref.box_scan_ref(*map(jnp.asarray, (x, lo, hi))))
    for max_entries in (MAX_ENTRIES, 3):
        got = lists_box_scan(*_t(x, lo, hi), max_entries=max_entries)
        np.testing.assert_array_equal(got.numpy(), want)


def seg_case(nblocks, block, d, b, q, seed):
    """rows3 with +inf padding and a NaN row, boxes around rows with
    impossible (+inf, -inf) padding, a one-hot owner map."""
    rng = np.random.default_rng(seed)
    rows3 = rng.normal(0, 1, (nblocks, block, d)).astype(np.float32)
    rows3[-1, -1] = INF
    rows3[0, 0, 0] = np.nan
    c = rows3.reshape(-1, d)[rng.integers(0, nblocks * block, b)]
    lo = (c - 0.4).astype(np.float32)
    hi = (c + 0.4).astype(np.float32)
    lo[-1], hi[-1] = INF, -INF
    lo[0], hi[0] = c[1], c[1]                      # row c[1] on lo and hi
    owner = rng.integers(0, q, b)
    onehot = (owner[:, None] == np.arange(q)[None]).astype(np.float32)
    return rows3, lo, hi, onehot


@pytest.mark.parametrize("block,d,b,q,n_hit,chunk", [
    (64, 6, 12, 3, 2, 64), (64, 6, 12, 8, 0, 5), (37, 6, 9, 9, 4, 2),
    (100, 17, 7, 1, 9, 64), (50, 6, 20, 16, 3, 7), (64, 6, 12, 8, -1, 64)])
def test_seg_rule_matches_reference(block, d, b, q, n_hit, chunk):
    """The item / chunk / zeroing rule equals repro's box_scan_seg over
    rows3[cand] (interpret-mode Pallas) with slots >= n_hit zeroed, for
    n_hit below 0, 0, partial, C and above C."""
    rows3, lo, hi, onehot = seg_case(8, block, d, b, q, seed=block + b)
    cand = np.array([5, 1, 6, 0], np.int32)
    x = rows3[cand].reshape(-1, d)
    want = np.array(jops.box_scan_seg(*map(jnp.asarray, (x, lo, hi, onehot)),
                                      interpret=True)).reshape(4, block, q)
    np.testing.assert_array_equal(
        want.reshape(-1, q),
        np.asarray(jref.box_scan_seg_ref(*map(jnp.asarray,
                                              (x, lo, hi, onehot)))))
    want[max(0, min(n_hit, 4)):] = 0
    tile = seg_tile_rows(d, block) // 3 or 1       # several items a slot
    got = seg_gather(*_t(rows3, cand), torch.tensor(n_hit), *_t(lo, hi,
                                                               onehot),
                     tile_rows=tile, box_chunk=chunk)
    np.testing.assert_array_equal(got.numpy().reshape(4, block, q), want)
    plain = tref.box_scan_seg_gather_ref(
        *_t(rows3, cand), torch.tensor(n_hit, dtype=torch.int32),
        *_t(lo, hi, onehot))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


# ----------------------------------------------------------------------
# CUDA kernels vs their plain versions (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_box_scan.py)")
    return torch.device("cuda", 0)


def _scan_on_card(x, lo, hi):
    n0 = tbox_scan.scan_launches
    got = tbox_scan.box_scan(x, lo, hi)
    torch.cuda.synchronize()
    assert tbox_scan.scan_launches == n0 + 1
    want = tref.box_scan_ref(x, lo, hi)
    assert torch.equal(got, want), (got != want).nonzero()[:5]
    return got


def _scan_shapes():
    """(n, d, b): N = 1, one row below and above a tile, a ragged last
    tile, several tiles a CTA (132 CTAs) at every row width D."""
    out = []
    for d in (6, 17, 130, 384, 400):
        t = scan_tile_rows(d)
        out += [(1, d, 9), (t - 1, d, 9), (t + 1, d, 9),
                (132 * t * 2 + t // 2 + 3, d, 40)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b", _scan_shapes())
def test_box_scan_cuda_tiles(cuda, n, d, b):
    x, lo, hi = _t(*edge_case(n, d, b, seed=n + d), device=cuda)
    _scan_on_card(x, lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("n_constrained", [0, 1, 384])
def test_box_scan_cuda_constrained_dims(cuda, n_constrained):
    """Every box constraining 0, 1 or all 384 dims; at 384 the lists of
    24 boxes (9,216 entries) overflow one chunk."""
    x, lo, hi = edge_case(5000, 384, 24, seed=n_constrained, p_free=0.0)
    rng = np.random.default_rng(n_constrained)
    keep = rng.random((24, 384)).argsort(1) < n_constrained
    lo[~keep], hi[~keep] = -INF, INF
    got = _scan_on_card(*_t(x, lo, hi, device=cuda))
    if n_constrained == 0:
        ordinary = (x > -INF).all(1)
        assert torch.equal(got.cpu(), torch.from_numpy(24 * ordinary)
                           .to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b", [(3001, 384, 300), (4099, 17, 700),
                                   (20, 4100, 3)])
def test_box_scan_cuda_chunks_and_widest(cuda, n, d, b):
    """More boxes than one chunk takes (kMaxChunkBoxes), and D past the
    list path's widest (kMaxListD), which keeps the warp-per-row path."""
    x, lo, hi = _t(*edge_case(n, d, b, seed=d, p_free=0.97), device=cuda)
    _scan_on_card(x, lo, hi)


@pytest.mark.gpu
def test_box_scan_cuda_unaligned_rows(cuda):
    """Rows whose start is not 16-byte aligned (a view one float in)."""
    x, lo, hi = edge_case(3 * scan_tile_rows(130) + 7, 130, 11, seed=2)
    base = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.float32), x.reshape(-1)])).to(cuda)
    xv = base[1:].view(x.shape)
    assert xv.data_ptr() % 16 == 4
    _scan_on_card(xv, *_t(lo, hi, device=cuda))


def _seg_on_card(rows3, cand, n_hit, lo, hi, onehot):
    n0 = tbox_scan.seg_launches
    got = tbox_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi, onehot)
    torch.cuda.synchronize()
    assert tbox_scan.seg_launches == n0 + 1
    want = tref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi, onehot)
    assert torch.equal(got, want), (got != want).nonzero()[:5]


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 8, 9, 16])
@pytest.mark.parametrize("block,d", [(1024, 6), (37, 6), (3000, 6),
                                     (64, 17), (1, 6)])
def test_box_scan_seg_cuda_n_hit(cuda, q, block, d):
    """n_hit 0, partial, C and past C, every Q route, blocks that are one
    item, odd-sized (unaligned spans), several items, and single rows."""
    nblocks = max(8, 2048 // block)
    rows3, lo, hi, onehot = seg_case(nblocks, block, d, 40, q,
                                     seed=block + q)
    rows3, lo, hi, onehot = _t(rows3, lo, hi, onehot, device=cuda)
    cand = torch.arange(nblocks - 1, -1, -2, dtype=torch.int32, device=cuda)
    c = cand.shape[0]
    for nh in (0, c // 2, c, c + 3):
        n_hit = torch.tensor(nh, dtype=torch.int32, device=cuda)
        _seg_on_card(rows3, cand, n_hit, lo, hi, onehot)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,q", [(900, 8), (600, 16)])
def test_box_scan_seg_cuda_box_chunks(cuda, nb, q):
    """More box records than one chunk holds (64 KB: 819 boxes at d' = 6,
    Q = 8; 585 at Q = 16)."""
    rec = (12 + -(-q // 8) * 8) * 4
    assert nb * rec > SEG_BOX_BUDGET
    rows3, lo, hi, onehot = seg_case(64, 1024, 6, nb, q, seed=nb)
    rows3, lo, hi, onehot = _t(rows3, lo, hi, onehot, device=cuda)
    cand = torch.arange(0, 64, 3, dtype=torch.int32, device=cuda)
    n_hit = torch.tensor(15, dtype=torch.int32, device=cuda)
    _seg_on_card(rows3, cand, n_hit, lo, hi, onehot)


@pytest.mark.gpu
def test_box_scan_seg_cuda_flat(cuda):
    """The flat entry (rows3 = x[None], block = N) over many items."""
    rows3, lo, hi, onehot = seg_case(1, 5000, 6, 64, 8, seed=9)
    x, lo, hi, onehot = _t(rows3[0], lo, hi, onehot, device=cuda)
    got = tbox_scan.box_scan_seg(x, lo, hi, onehot)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.box_scan_seg_ref(x, lo, hi, onehot))
