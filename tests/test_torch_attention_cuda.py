"""The flash attention forward kernel's routes on a CUDA card.

The kernel (csrc/flash_attention.cu) takes three routes: bf16 on a
warp-specialised kernel, with its key split (partials and a combine)
where BH times the 128-row query tiles gives fewer CTAs than SMs; f32
past one 32-key tile with K and V split into TF32 hi and lo by a
pre-pass; f32 within one tile (the ViT's S = 17) splitting in the CTA.
Each is held here to the plain version (``kernels/ref.flash_attention_
ref``) within 2e-4 (f32) or 2e-2 (bf16), its lse within 1e-4, and two
calls with the same inputs to equal bits: at BH 1, 2 and 4 on the split
route (and to the split's own plain model, ``flash_attention_split_ref``),
and across the causal diagonal at G 1 / 2 / 4 / 8 with S no multiple
of the key tile.

No JAX here: the tests against the reference are
tests/test_torch_attention.py's. Marker ``gpu``; skipped without a card.
Run them there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention_cuda.py``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (python "
                    "-m pytest -m gpu tests/test_torch_attention_cuda.py)")
    return torch.device("cuda", 0)


def _case(bh, s, g, d, dtype, seed, device):
    """Seeded N(0, 1) q [bh, s, g, d], k and v [bh, s, d] on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bh, s, g, d, device=device, generator=gen)
    k = torch.randn(bh, s, d, device=device, generator=gen)
    v = torch.randn(bh, s, d, device=device, generator=gen)
    return [t.to(getattr(torch, dtype)) for t in (q, k, v)]


def _splits(q):
    bh, s, g, _ = q.shape
    return tflash._fwd_split_count(q.device, bh, s, g,
                                   tflash.DTYPE_CODES[q.dtype])


def _check(q, k, v, causal, dtype):
    """One launch with lse, held to the plain version; returns (out,
    lse)."""
    n0 = tflash.launches
    out, lse = tflash.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    want, want_lse = tref.flash_attention_ref(q, k, v, causal=causal,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert tflash.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_TOL)
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,g,d,dtype,split", [
    (1, 1000, 2, 64, "bfloat16", True),     # 16 CTAs: split
    (140, 128, 1, 64, "bfloat16", False),   # 140 CTAs: one pass
    (384, 17, 1, 64, "float32", False),     # one key tile, split in the CTA
    (2, 300, 2, 64, "float32", False),      # the pre-pass's split planes
])
def test_fwd_cuda_routes_are_bitwise(cuda, bh, s, g, d, dtype, split):
    """Every route sums each output in a fixed order: two calls give
    equal out and lse bits; the split is taken where BH times the query
    tiles is under the card's SMs."""
    q, k, v = _case(bh, s, g, d, dtype, seed=bh + s, device=cuda)
    a = _check(q, k, v, True, dtype)
    b = tflash.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert (_splits(q) > 1) == split
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh", [1, 2, 4])
def test_fwd_cuda_split_route(cuda, bh, causal):
    """BH 1 / 2 / 4 at S 1,024, G 2, D 128 (the mesh's heads at a
    shorter S): 16 query tiles a bh, so every grid splits; out and lse
    against the plain version and against the split's plain model."""
    q, k, v = _case(bh, 1024, 2, 128, "bfloat16", seed=bh, device=cuda)
    out, lse = _check(q, k, v, causal, "bfloat16")
    splits = _splits(q)
    assert splits > 1
    want, want_lse = tref.flash_attention_split_ref(
        q, k, v, causal=causal, splits=splits, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_fwd_cuda_causal_diagonal_ragged(cuda, d, g, dtype):
    """Causal at S 300 (no multiple of 128 or 32): a 128-row query tile
    spans 128 / G positions, so the diagonal crosses its key tiles at
    every G, and the last key tile is ragged; at BH 16 the bf16 grid is
    whole at G 4 and 8 and split at G 1 and 2."""
    _check(*_case(16, 300, g, d, dtype, seed=g + d, device=cuda), True,
           dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fwd_cuda_narrow_heads(cuda, dtype, d):
    """D 16 and 32 (32- and 64-byte swizzles) on both routes, causal,
    with a split bf16 grid (BH 1) and the f32 pre-pass (S 200)."""
    _check(*_case(1, 200, 3, d, dtype, seed=d, device=cuda), True, dtype)
