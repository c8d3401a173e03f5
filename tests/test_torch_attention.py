"""The port's flash attention against the reference's.

On the CPU: ``repro_torch.kernels.ref.flash_attention_ref`` (kernel
layout) and ``repro_torch.kernels.ops.flash_attention`` (model layout,
which takes the plain version for CPU tensors) against
``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
run in interpret mode through ``repro.kernels.ops.flash_attention``, at
the shapes and dtypes of tests/test_kernels.py plus the ViT's own (S = 17,
G = 1, D = 64, non-causal). Tolerance 2e-4 for f32, 2e-2 for bf16, as
there: the Pallas kernel scales q before the product and sums online;
the plain versions scale the scores and materialise the softmax. The
plain version's lse (``return_lse``, the backward's residual) against the
reference forward's own (``repro.models.attention._flash_fwd_impl``) at S
64 in chunks of 16, causal and not, G 1/2/4, within 1e-5.

The kernel's f32 route (3xTF32) is emulated in torch on the CPU and held
against the reference, beside a one-pass TF32 emulation that errs at
least 10x more.

On a CUDA card (marker ``gpu``; skipped without one): the CUDA kernel
against its plain version over causal and non-causal inputs, G in
{1, 2, 3, 4, 8}, D in {16, 32, 64, 128}, ragged S and ragged query
tiles, the ViT's batch of 384 bh, f32 and bf16, and the wrapper's
16-byte alignment check; the kernel's lse against the plain version's
within the same tolerances. Run them there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention.py``.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (b, s, hq, hkv, d, causal): tests/test_kernels.py's four and the ViT's
SHAPES = [
    (2, 256, 8, 2, 32, True),
    (1, 128, 4, 4, 64, True),      # MHA
    (1, 128, 4, 1, 32, True),      # MQA
    (2, 128, 4, 2, 32, False),     # bidirectional
    (2, 17, 3, 3, 64, False),      # ViT-T: 16 patches + CLS, 3 heads
]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the forward's lse (f32 in both dtypes, about log S in size)
LSE_TOL = 1e-4


def _model_inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, hq, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32))


def _kernel_layout_np(q, k, v):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qk = q.reshape(b, s, hkv, g, d).transpose(0, 2, 1, 3, 4).reshape(
        b * hkv, s, g, d)
    kk = k.transpose(0, 2, 1, 3).reshape(b * hkv, s, d)
    vk = v.transpose(0, 2, 1, 3).reshape(b * hkv, s, d)
    return qk, kk, vk


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrs]


def _j(*arrs, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


@pytest.mark.parametrize("b,s,hq,hkv,d,causal", SHAPES)
def test_flash_attention_ref_matches_reference(b, s, hq, hkv, d, causal):
    q, k, v = _kernel_layout_np(*_model_inputs(b, s, hq, hkv, d,
                                               seed=b + s + hq))
    want = np.asarray(jref.flash_attention_ref(*_j(q, k, v), causal=causal))
    got = tref.flash_attention_ref(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal", SHAPES)
def test_flash_attention_op_matches_pallas(b, s, hq, hkv, d, causal):
    """Model layout through both wrappers: the Pallas kernel in interpret
    mode (chunks of 64, or S when shorter) and the port's CPU op."""
    q, k, v = _model_inputs(b, s, hq, hkv, d, seed=b + s + hq)
    want = np.asarray(jops.flash_attention(*_j(q, k, v), causal=causal,
                                           q_chunk=64, kv_chunk=64,
                                           interpret=True))
    got = tops.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes_match_pallas(dtype):
    """tests/test_kernels.py's dtype case: causal, GQA 4/2, output in the
    inputs' dtype."""
    b, s, hq, hkv, d = 1, 128, 4, 2, 32
    q, k, v = _model_inputs(b, s, hq, hkv, d, seed=0)
    want = jops.flash_attention(*_j(q, k, v, dtype=getattr(jnp, dtype)),
                                q_chunk=64, kv_chunk=32, interpret=True)
    got = tops.flash_attention(*_t(q, k, v, dtype=getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    want_ref = jref.flash_attention_ref(
        *_j(*_kernel_layout_np(q, k, v), dtype=getattr(jnp, dtype)))
    got_ref = tref.flash_attention_ref(
        *_t(*_kernel_layout_np(q, k, v), dtype=getattr(torch, dtype)))
    np.testing.assert_allclose(got_ref.float().numpy(),
                               np.asarray(want_ref, np.float32),
                               rtol=tol, atol=tol)


LSE_TOL = 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (4, 1)])
def test_flash_attention_ref_lse_matches_reference(hq, hkv, causal):
    """lse [BH, S G] in the kernel's row order against the reference
    forward's [B, Hkv, G, nq, q_chunk] at S 64 in chunks of 16 (G = 1, 2,
    4): the residual its custom VJP saves."""
    b, s, d = 2, 64, 16
    q, k, v = _model_inputs(b, s, hq, hkv, d, seed=hq * 7 + hkv + causal)
    out, lse = jattention._flash_fwd_impl(*_j(q, k, v), causal, 16, 16)
    g = hq // hkv
    want = np.asarray(lse).reshape(b, hkv, g, s).transpose(0, 1, 3, 2) \
        .reshape(b * hkv, s * g)
    got_out, got = tref.flash_attention_ref(
        *_t(*_kernel_layout_np(q, k, v)), causal=causal, return_lse=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=LSE_TOL,
                               atol=LSE_TOL)
    plain = tref.flash_attention_ref(*_t(*_kernel_layout_np(q, k, v)),
                                     causal=causal)
    assert torch.equal(got_out, plain)


def test_flash_attention_causal_first_row_is_v0():
    """Causal row 0 sees key 0 alone: its output is v[0] exactly."""
    q, k, v = _t(*_kernel_layout_np(*_model_inputs(1, 9, 2, 1, 16, 3)))
    out = tref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0, 0], v[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(out[:, 0, 1], v[:, 0], rtol=0, atol=0)


def test_kernel_layout_matches_reference_repack():
    q, k, v = _model_inputs(2, 11, 6, 2, 16, seed=4)
    want = _kernel_layout_np(q, k, v)
    got = tops.kernel_layout(*_t(q, k, v))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="do not group"):
        tops.kernel_layout(*_t(*_model_inputs(1, 4, 3, 2, 16, seed=0)))


def test_flash_wrapper_checks_inputs():
    """The CUDA wrapper refuses what the kernel does not take, CPU
    tensors included (ops.py does the CPU dispatch)."""
    q, k, v = _t(*_kernel_layout_np(*_model_inputs(1, 8, 2, 1, 32, 0)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="shape"):
        tflash.flash_attention(q, k[:, :4], v)
    with pytest.raises(TypeError, match="one dtype"):
        tflash.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError, match="dtype"):
        tflash.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), v)


# ----------------------------------------------------------------------
# the CUDA kernel's key split (bf16 route), modelled on the CPU
# ----------------------------------------------------------------------

SPLIT_S, SPLIT_TILE = 64, 16


@functools.lru_cache(maxsize=None)
def _split_references(g, causal):
    """Inputs (kernel layout, numpy) at S 64, D 16, BH 4 and the three
    references the split model is held to: the port's plain (out, lse),
    the reference's chunked forward ``_flash_fwd_impl`` by kv_chunk (out,
    lse in the kernel's row order), and the Pallas kernel in interpret
    mode (out)."""
    b, hkv, d = 2, 2, 16
    hq = hkv * g
    model = _model_inputs(b, SPLIT_S, hq, hkv, d, seed=g * 10 + causal)
    q, k, v = _kernel_layout_np(*model)
    plain = [x.numpy() for x in tref.flash_attention_ref(
        *_t(q, k, v), causal=causal, return_lse=True)]
    chunked = {}
    for chunk in (16, 32, 64):
        out, lse = jattention._flash_fwd_impl(*_j(*model), causal,
                                              SPLIT_S, chunk)
        out = np.asarray(out).reshape(b, SPLIT_S, hkv, g, d) \
            .transpose(0, 2, 1, 3, 4).reshape(q.shape)
        lse = np.asarray(lse).reshape(b, hkv, g, SPLIT_S) \
            .transpose(0, 1, 3, 2).reshape(b * hkv, SPLIT_S * g)
        chunked[chunk] = (out, lse)
    pallas = np.asarray(jops.flash_attention(
        *_j(*model), causal=causal, q_chunk=64, kv_chunk=16,
        interpret=True)).reshape(b, SPLIT_S, hkv, g, d) \
        .transpose(0, 2, 1, 3, 4).reshape(q.shape)
    return (q, k, v), plain, chunked, pallas


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_flash_split_model_matches_references(splits, g, causal):
    """The key split's plain model (``ref.flash_attention_split_ref``:
    per split (o, m, l) by torch ops, combined in the kernel's fixed
    order) at S 64 in key tiles of 16, 1-4 splits: out within 2e-4 and
    lse within LSE_TOL of the port's plain version, of the reference's
    chunked forward with kv_chunk the split's length (16 where 3 splits
    cut 4 tiles unevenly), and out of the Pallas kernel (interpret
    mode)."""
    (q, k, v), plain, chunked, pallas = _split_references(g, causal)
    out, lse = tref.flash_attention_split_ref(
        *_t(q, k, v), causal=causal, splits=splits, tile=SPLIT_TILE,
        return_lse=True)
    out, lse = out.numpy(), lse.numpy()
    chunk = SPLIT_S // splits if SPLIT_S % splits == 0 else SPLIT_TILE
    for want_out, want_lse in (plain, chunked[chunk]):
        np.testing.assert_allclose(out, want_out, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(lse, want_lse, rtol=0, atol=LSE_TOL)
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bh,s,g,dtype,want", [
    (16, 4096, 2, torch.bfloat16, 1),   # lm_train: 1,024 CTAs
    (8, 4096, 2, torch.bfloat16, 1),    # mesh training: 512
    (4, 4096, 2, torch.bfloat16, 1),    # mesh data x model: 256
    (2, 4096, 2, torch.bfloat16, 2),    # mesh head mode: 128 < 132
    (1, 4096, 2, torch.bfloat16, 3),    # 64: 132 / 64 rounded up
    (1, 1000, 2, torch.bfloat16, 8),    # 16 CTAs: capped at 8 key tiles
    (1, 100, 1, torch.bfloat16, 1),     # one key tile
    (1, 4096, 16, torch.float32, 1),    # f32 never splits
])
def test_flash_fwd_splits_only_under_filled_grids(bh, s, g, dtype, want):
    """On a card of 132 SMs the forward splits only a bf16 grid of fewer
    CTAs (BH times the 128-row query tiles) than SMs, to about one CTA
    an SM; its scratch is the splits' partials, or for f32 past one
    32-key tile the pre-pass's four split planes."""
    code = tflash.DTYPE_CODES[dtype]
    assert tflash.fwd_splits(bh, s, g, code, 132) == want
    numel = tflash.fwd_scratch_numel(bh, s, g, 128, code, want)
    if dtype == torch.float32:
        assert numel == 4 * bh * s * 128
    else:
        assert numel == (want * bh * s * g * 130 if want > 1 else 0)


@pytest.mark.parametrize("bh,s,g,d,dtype,with_lse", [
    (2, 4096, 2, 128, torch.bfloat16, False),   # 2 splits' partials
    (1, 1000, 4, 64, torch.bfloat16, True),
    (2, 300, 2, 64, torch.float32, True),       # the f32 pre-pass
    (16, 4096, 2, 128, torch.bfloat16, False),  # no scratch
    (3, 17, 1, 64, torch.float32, False),       # one key tile: none
])
def test_flash_fwd_scratch_in_dry_run_temp_bytes(bh, s, g, d, dtype,
                                                 with_lse):
    """On meta tensors (a dry run) the forward allocates the scratch the
    wrapper allocates on the card, at an H100's 132 SMs, and holds it
    across the call: an op trace's temp_bytes is exactly its bytes."""
    from repro_torch.kernels import meta
    from repro_torch.launch import hlo_analysis
    q = torch.empty((bh, s, g, d), dtype=dtype, device="meta")
    k = torch.empty((bh, s, d), dtype=dtype, device="meta")
    code = tflash.DTYPE_CODES[dtype]
    numel = tflash.fwd_scratch_numel(
        bh, s, g, d, code, tflash.fwd_splits(bh, s, g, code,
                                             meta.DRY_RUN_SMS))
    with hlo_analysis.OpTrace((q, k)) as tr:
        out = (tops._flash_forward_lse(q, k, k, True) if with_lse
               else (tops._flash_forward(q, k, k, True),))
    memory = tr.finish(out)
    assert memory["temp_bytes"] == 4 * numel
    assert memory["output_bytes"] == sum(t.untyped_storage().nbytes()
                                         for t in out)
    assert out[0].shape == q.shape and out[0].dtype == dtype


# ----------------------------------------------------------------------
# the CUDA kernel's f32 route (3xTF32), emulated on the CPU
# ----------------------------------------------------------------------

def _tf32_hi(x):
    """x with its low 13 mantissa bits cleared: a TF32 value."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_rna(x):
    """x rounded to TF32, to nearest with ties away from zero (the
    kernel's cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b in f32 from TF32 products: 3 passes (lo.hi + hi.lo + hi.hi,
    the kernel's route) or 1 (each operand rounded to TF32). Products of
    two TF32 values are exact in f32, so f32 matmuls of the parts model
    the tensor cores' f32 accumulation."""
    if passes == 1:
        return _tf32_rna(a) @ _tf32_rna(b)
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _flash_tf32(q, k, v, causal, passes, tile=32):
    """The f32 kernel's arithmetic in the kernel layout: per key tile of
    ``tile``, scores from TF32 products scaled after the product, masked
    (-1e30 causal, -inf past S), an f32 online softmax, P V from TF32
    products, l floored at 1e-30."""
    bh, s, g, d = q.shape
    qm = q.reshape(bh, s * g, d)
    qpos = torch.arange(s * g) // g
    m = torch.full((bh, s * g, 1), -1e30)
    l = torch.zeros(bh, s * g, 1)
    acc = torch.zeros(bh, s * g, d)
    for k0 in range(0, s, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        sc = _tf32_matmul(qm, kt.transpose(1, 2), passes) * d ** -0.5
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1])
            sc = torch.where(kpos[None, None] > qpos[None, :, None],
                             torch.tensor(-1e30), sc)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _tf32_matmul(p, vt, passes)
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(bh, s, g, d)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal", [
    (2, 17, 3, 3, 64, False),      # the ViT's shape
    (1, 626, 3, 3, 64, False),     # 400x400 patches at /16 + CLS
    (1, 128, 4, 1, 32, True),      # causal MQA
])
def test_flash_tf32_route_needs_three_passes(b, s, hq, hkv, d, causal):
    """3xTF32 stays within a tenth of the f32 tolerance of the JAX
    reference; one TF32 pass errs at least 10x more. This is why the f32
    kernel makes three products and never one."""
    q, k, v = _kernel_layout_np(*_model_inputs(b, s, hq, hkv, d,
                                               seed=s + d))
    want = np.asarray(jref.flash_attention_ref(*_j(q, k, v), causal=causal))
    err = {n: float(np.abs(_flash_tf32(*_t(q, k, v), causal, n).numpy()
                           - want).max()) for n in (1, 3)}
    assert err[3] <= TOL["float32"] / 10, err
    assert err[1] >= 10 * err[3], err


# ----------------------------------------------------------------------
# the CUDA kernel vs its plain version (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_attention.py)")
    return torch.device("cuda", 0)


def _cuda_case(s, g, d, dtype, seed, device, bh=3):
    """Seeded N(0, 1) q [bh, s, g, d], k and v [bh, s, d] on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bh, s, g, d, device=device, generator=gen)
    k = torch.randn(bh, s, d, device=device, generator=gen)
    v = torch.randn(bh, s, d, device=device, generator=gen)
    return [t.to(getattr(torch, dtype)) for t in (q, k, v)]


def _check_cuda(q, k, v, causal, dtype):
    n0 = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == n0 + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_cuda_matches_plain(cuda, d, g, causal, dtype):
    """S = 67: two full 32-key tiles (f32) or one 64-key tile (bf16) and
    a ragged last one; S * G (67, 134, 268, 536) never a multiple of 64,
    so the last query tile is ragged too."""
    _check_cuda(*_cuda_case(67, g, d, dtype, seed=d + g, device=cuda),
                causal, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s,g,d,causal,dtype", [
    (1, 1, 64, True, "float32"),
    (17, 1, 64, False, "float32"),        # the ViT's shape
    (300, 4, 128, True, "bfloat16"),
    (626, 1, 64, False, "float32"),       # 400x400 patches at /16 + CLS
    (1000, 8, 32, True, "float32"),
])
def test_flash_cuda_lengths(cuda, s, g, d, causal, dtype):
    _check_cuda(*_cuda_case(s, g, d, dtype, seed=s, device=cuda),
                causal, dtype)


@pytest.mark.gpu
def test_flash_cuda_model_layout_op(cuda):
    """ops.flash_attention on CUDA tensors launches the kernel and agrees
    with the same op on the CPU."""
    q, k, v = _t(*_model_inputs(2, 33, 6, 2, 64, seed=5))
    n0 = tflash.launches
    got = tops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                               causal=False)
    torch.cuda.synchronize()
    assert tflash.launches == n0 + 1
    want = tops.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [33, 95])
def test_flash_cuda_ragged_tiles(cuda, s, d, dtype):
    """G = 3: S * G (99, 285) is no multiple of 64 rows and S no
    multiple of the key tile (32 or 64); S = 33 is one ragged bf16 tile."""
    _check_cuda(*_cuda_case(s, 3, d, dtype, seed=s + d, device=cuda),
                True, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_vit_batch(cuda, dtype):
    """The ViT's batch, BH = 384 at S = 17: every bh is one 64-row tile
    of which 47 rows lie past its end, and a 2-D view would read them
    from the next bh; the 3-D tensor maps read zeros there."""
    _check_cuda(*_cuda_case(17, 1, 64, dtype, seed=17, device=cuda,
                            bh=384), False, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 200])
def test_flash_cuda_causal_gqa8(cuda, s, dtype):
    """Causal, G = 8: a 64-row block holds 8 query positions, so the
    diagonal runs through the block, and a 128-row CTA's last key tile
    is cut at its last position."""
    _check_cuda(*_cuda_case(s, 8, 64, dtype, seed=s, device=cuda),
                True, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [32, 77, 300])
def test_flash_cuda_d128_f32(cuda, s, causal):
    """D = 128 f32: one consumer warpgroup and 32-key tiles (shared memory
    holds no more beside Q's hi and lo); S = 32 is one full tile."""
    _check_cuda(*_cuda_case(s, 2, 128, "float32", seed=s, device=cuda),
                causal, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,g,d,causal", [
    (67, 2, 64, True), (17, 1, 64, False), (300, 4, 128, True),
    (95, 3, 16, False)])
def test_flash_cuda_lse_matches_plain(cuda, s, g, d, causal, dtype):
    """The forward with ``return_lse``: the same output as without, and
    its lse within LSE_TOL of the plain version's (f32 in both dtypes)."""
    q, k, v = _cuda_case(s, g, d, dtype, seed=s + g, device=cuda)
    out, lse = tflash.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    plain_out = tflash.flash_attention(q, k, v, causal=causal)
    _, want = tref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    torch.testing.assert_close(lse, want, rtol=0, atol=LSE_TOL)


@pytest.mark.gpu
def test_flash_cuda_refuses_unaligned(cuda):
    """TMA needs 16-byte aligned tensors: a view 4 bytes into its
    storage raises, and so does an unaligned k or v."""
    q, k, v = _cuda_case(8, 1, 32, "float32", seed=0, device=cuda)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    bad = flat[1:].view(q.shape)
    bad.copy_(q)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(bad, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, flat[1:1 + k.numel()].view(k.shape), v)
