"""The port's flash attention against the reference's.

On the CPU: ``repro_torch.kernels.ref.flash_attention_ref`` (kernel
layout) and ``repro_torch.kernels.ops.flash_attention`` (model layout,
which takes the plain version for CPU tensors) against
``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
run in interpret mode through ``repro.kernels.ops.flash_attention``, at
the shapes and dtypes of tests/test_kernels.py plus the ViT's own (S = 17,
G = 1, D = 64, non-causal). Tolerance 2e-4 for f32, 2e-2 for bf16, as
there: the Pallas kernel scales q before the product and sums online;
the plain versions scale the scores and materialise the softmax.

On a CUDA card (marker ``gpu``; skipped without one): the CUDA kernel
against its plain version over causal and non-causal inputs, G in
{1, 2, 4, 8}, D in {16, 32, 64, 128}, ragged S, f32 and bf16. Run them
there with ``python -m pytest -m gpu tests/test_torch_attention.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
# the CUDA kernel vs its plain version (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_attention.py)")
    return torch.device("cuda", 0)


def _cuda_case(s, g, d, dtype, seed, device, bh=3):
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
    """S = 67: two full key tiles and a ragged third; the last query
    tile ragged too."""
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
