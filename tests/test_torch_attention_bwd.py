"""The flash attention backward of the port: the plain version
``kernels/ref.flash_attention_bwd_ref``, the CUDA kernel's wrapper
``kernels/flash_attention.flash_attention_bwd`` and the meta op that a
dry run prices, and how ``ops.flash_attention``'s autograd Function
routes between them.

On the CPU:

- ``flash_attention_bwd_ref`` against ``jax.vjp`` of
  ``repro.models.attention.flash_attention`` (the custom VJP with the
  hand-written ``_flash_core_bwd``) at S 64 in chunks of 16, so that
  several (query chunk, key chunk) pairs are visible and, causal, some
  are skipped; G 1/2/4, D 16/32/64/128; each gradient within 1e-4 of its
  largest entry;
- the meta op's shapes and dtypes, what it refuses, and the price
  ``hlo_analysis.analyze`` puts on it, causal and not: five products of
  2·BH·G·S²·D, the causal kernel's own S(S+1)/2 apart;
- what the CUDA wrapper refuses: a CPU tensor, a bad shape, dtype or
  head dim, a dout unlike q, a misaligned dout;
- the autograd Function's routing: CPU tensors to the plain version,
  meta tensors to the meta op, others to the kernel's wrapper, each
  moving ``backward_calls`` and only the kernel ``backward_launches``.

On a CUDA card (marker ``gpu``; skipped without one): the kernel
against the plain version within the forward's tolerances (2e-4 f32,
2e-2 bf16), two calls bitwise equal, and a misaligned q refused. Run
them there with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_attention_bwd.py`` (this file imports JAX only inside
the reference's tests).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import meta as tmeta
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import hlo_analysis

REF_TOL = 1e-4          # each gradient against the reference's, of its max
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _model_inputs(b, s, hq, hkv, d, seed):
    """q, k, v, dout in model layout ([B, S, H, D]) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv, hq)]


def _kernel_inputs(bh, s, g, d, seed, dtype=torch.float32, device="cpu"):
    """q, k, v, dout in the kernel layout from a torch seed."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((bh, s, g, d), (bh, s, d), (bh, s, d), (bh, s, g, d))
    return [torch.randn(sh, generator=gen).to(dtype).to(device)
            for sh in shapes]


# ----------------------------------------------------------------------
# the plain version against the reference's custom VJP
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,hq,hkv,d", [
    (True, 2, 2, 16), (True, 4, 2, 32), (True, 4, 1, 64),
    (True, 8, 2, 128), (False, 2, 2, 32), (False, 4, 2, 64),
    (False, 4, 1, 16), (False, 4, 2, 128),
])
def test_bwd_ref_matches_reference_vjp(causal, hq, hkv, d):
    """S 64 in chunks of 16: 16 chunk pairs, 10 of them visible when
    causal; G = hq / hkv of 1, 2 or 4."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_attention as jflash
    b, s = 1, 64
    q, k, v, dout = _model_inputs(b, s, hq, hkv, d, seed=hq * d + causal)
    _, vjp = jax.vjp(lambda *a: jflash(*a, causal=causal, q_chunk=16,
                                       kv_chunk=16),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout))]
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    qk, kk, vk = tops.kernel_layout(torch.from_numpy(q), kt, vt)
    dok = tops.kernel_layout(torch.from_numpy(dout), kt, vt)[0]
    dq, dk, dv = tref.flash_attention_bwd_ref(qk, kk, vk, dok, causal=causal)
    g = hq // hkv
    got = [dq.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4)
           .reshape(b, s, hq, d),
           dk.reshape(b, hkv, s, d).permute(0, 2, 1, 3),
           dv.reshape(b, hkv, s, d).permute(0, 2, 1, 3)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(a.numpy() - w).max() / np.abs(w).max()
        assert err <= REF_TOL, (name, err)


# ----------------------------------------------------------------------
# the meta op and its price
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_bwd_shapes_and_dtypes(dtype):
    q, k, v, dout = (t.to("meta") for t in _kernel_inputs(
        3, 20, 2, 32, seed=0, dtype=dtype))
    dq, dk, dv = tops._flash_backward(q, k, v, dout, True)
    for got, like in zip((dq, dk, dv), (q, k, v)):
        assert got.device.type == "meta"
        assert got.shape == like.shape and got.dtype == like.dtype


def test_meta_bwd_refuses_what_the_kernel_refuses():
    q, k, v, dout = (t.to("meta") for t in _kernel_inputs(
        1, 8, 1, 32, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        tops._flash_backward(q[..., :24], k[..., :24], v[..., :24],
                             dout[..., :24], True)
    with pytest.raises(TypeError, match="dtypes"):
        tops._flash_backward(q.half(), k.half(), v.half(), dout.half(), True)
    with pytest.raises(ValueError, match="dout"):
        tops._flash_backward(q, k, v, dout[:, :4], True)


@pytest.mark.parametrize("causal", [True, False])
def test_analyze_prices_the_backward(causal):
    """One backward call: 10·BH·G·S²·D dot FLOPs (the reference's five
    products), the causal kernel's own S(S+1)/2 pairs apart, q, k, v,
    dout read and dq, dk, dv written once; traced on meta tensors and as
    a hand-built trace."""
    bh, s, g, d = 2, 48, 2, 16
    q, k, v, dout = (t.to("meta") for t in _kernel_inputs(
        bh, s, g, d, seed=0, dtype=torch.bfloat16))
    with hlo_analysis.OpTrace() as tr:
        tops._flash_backward(q, k, v, dout, causal)
    traced = hlo_analysis.analyze(tr.trace())
    bf = lambda *sh: ["bfloat16", list(sh)]
    hand = hlo_analysis.analyze({"ops": [[
        "repro_torch.flash_attention_bwd.default",
        [bf(bh, s, g, d), bf(bh, s, d), bf(bh, s, d), bf(bh, s, g, d)],
        [bf(bh, s, g, d), bf(bh, s, d), bf(bh, s, d)], True,
        {"args": [causal]}]]})
    pairs = s * (s + 1) // 2 if causal else s * s
    byts = 2 * (3 * bh * s * g * d + 4 * bh * s * d)      # bf16
    for d_ in (traced, hand):
        assert d_["kernels"]["flash_attention_bwd"]["calls"] == 1
        assert d_["dot_flops"] == 10 * bh * g * s * s * d
        assert d_["flash_causal_flops"] == 10 * bh * g * pairs * d
        assert d_["kernels"]["flash_attention_bwd"]["bytes"] == byts
        assert d_["hbm_bytes"] == byts
    assert hand["dot_flops_backward"] == hand["dot_flops"]
    assert tmeta.flash_bwd_flops((bh, s, g, d), causal) \
        == 10 * bh * g * pairs * d


# ----------------------------------------------------------------------
# the CUDA wrapper's refusals
# ----------------------------------------------------------------------

def test_bwd_wrapper_checks_inputs():
    """The wrapper refuses what the kernel does not take, CPU tensors
    included (ops.py does the CPU dispatch), and a dout unlike q or not
    16-byte aligned."""
    q, k, v, dout = _kernel_inputs(1, 8, 2, 32, seed=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tflash.flash_attention_bwd(q, k, v, dout)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_bwd(*(t[..., :24].contiguous()
                                     for t in (q, k, v, dout)))
    with pytest.raises(ValueError, match="shape"):
        tflash.flash_attention_bwd(q, k[:, :4], v, dout)
    with pytest.raises(TypeError, match="one dtype"):
        tflash.flash_attention_bwd(q, k.to(torch.bfloat16), v, dout)
    with pytest.raises(TypeError, match="dtype"):
        tflash.flash_attention_bwd(q.half(), k.half(), v.half(),
                                   dout.half())
    with pytest.raises(ValueError, match="dout must be q's shape"):
        tflash.flash_attention_bwd(q, k, v, dout[:, :4])
    with pytest.raises(ValueError, match="dout must be q's shape"):
        tflash.flash_attention_bwd(q, k, v, dout.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_bwd(q, k, v, dout.transpose(1, 2)
                                   .contiguous().transpose(1, 2))
    flat = torch.zeros(dout.numel() + 1)
    bad = flat[1:].view(dout.shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_bwd(q, k, v, bad)


# ----------------------------------------------------------------------
# the autograd Function's routing
# ----------------------------------------------------------------------

def _grads(q, k, v, dout, causal=True):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = tops._FlashAttention.apply(*leaves, causal)
    return torch.autograd.grad(out, leaves, dout)


def test_function_routes_cpu_to_the_plain_version(monkeypatch):
    monkeypatch.setattr(tflash, "backward_calls", 0)
    monkeypatch.setattr(tflash, "backward_launches", 0)
    q, k, v, dout = _kernel_inputs(2, 11, 2, 16, seed=1)
    got = _grads(q, k, v, dout)
    want = tref.flash_attention_bwd_ref(q, k, v, dout, causal=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (tflash.backward_calls, tflash.backward_launches) == (1, 0)


def test_function_routes_meta_to_the_meta_op(monkeypatch):
    monkeypatch.setattr(tflash, "backward_calls", 0)
    monkeypatch.setattr(tflash, "backward_launches", 0)
    q, k, v, dout = (t.to("meta") for t in _kernel_inputs(
        2, 11, 2, 16, seed=1))
    with hlo_analysis.OpTrace() as tr:
        got = _grads(q, k, v, dout, causal=False)
    names = [op[0] for op in tr.trace()["ops"]]
    assert names.count("repro_torch.flash_attention_bwd.default") == 1
    assert [g.device.type for g in got] == ["meta"] * 3
    assert (tflash.backward_calls, tflash.backward_launches) == (1, 0)


@pytest.mark.parametrize("causal", [True, False])
def test_function_routes_a_card_to_the_kernel(monkeypatch, causal):
    """With the tensors taken for a card's (``ops._on_cpu`` false) the
    forward and the backward go to the kernels' wrappers (stubbed by the
    plain versions plus their counters), the backward with the causal
    flag and a contiguous dout, never to the plain backward itself."""
    plain_fwd = tref.flash_attention_ref
    plain_bwd = tref.flash_attention_bwd_ref
    seen = []

    def kernel(q, k, v, *, causal=True):
        tflash.launches += 1
        return plain_fwd(q, k, v, causal=causal)

    def backward_kernel(q, k, v, dout, *, causal=True):
        assert dout.is_contiguous()
        seen.append(causal)
        tflash.backward_launches += 1
        return plain_bwd(q, k, v, dout, causal=causal)

    def refused(*args, **kwargs):
        raise AssertionError("flash_attention_bwd_ref called on a card")
    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tflash, "flash_attention", kernel)
    monkeypatch.setattr(tflash, "flash_attention_bwd", backward_kernel)
    monkeypatch.setattr(tref, "flash_attention_bwd_ref", refused)
    for name in ("launches", "backward_calls", "backward_launches"):
        monkeypatch.setattr(tflash, name, 0)
    q, k, v, dout = _kernel_inputs(1, 9, 2, 32, seed=2)
    got = _grads(q, k, v, dout.transpose(1, 2).contiguous().transpose(1, 2),
                 causal=causal)
    want = plain_bwd(q, k, v, dout, causal=causal)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert seen == [causal]
    assert (tflash.launches, tflash.backward_calls,
            tflash.backward_launches) == (1, 1, 1)


# ----------------------------------------------------------------------
# the CUDA kernel vs its plain version (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python -m pytest -m gpu "
                    "tests/test_torch_attention_bwd.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,g,d,causal,dtype", [
    (2, 64, 1, 16, True, "float32"), (2, 17, 1, 64, False, "float32"),
    (1, 130, 2, 32, True, "bfloat16"), (1, 97, 4, 128, True, "float32"),
    (3, 200, 2, 128, False, "bfloat16"), (1, 70, 16, 128, True, "float32"),
    (2, 626, 1, 64, False, "float32"), (1, 1, 1, 16, True, "bfloat16"),
])
def test_bwd_cuda_matches_plain(cuda, bh, s, g, d, causal, dtype):
    q, k, v, dout = _kernel_inputs(bh, s, g, d, seed=s + d,
                                   dtype=getattr(torch, dtype), device=cuda)
    n0 = tflash.backward_launches
    got = tflash.flash_attention_bwd(q, k, v, dout, causal=causal)
    torch.cuda.synchronize()
    assert tflash.backward_launches == n0 + 1
    want = tref.flash_attention_bwd_ref(q, k, v, dout, causal=causal)
    tol = TOL[dtype]
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_cuda_is_deterministic(cuda, dtype):
    """Every output element is summed in a fixed order: two calls give
    bitwise equal gradients."""
    q, k, v, dout = _kernel_inputs(2, 300, 2, 64, seed=5,
                                   dtype=getattr(torch, dtype), device=cuda)
    a = tflash.flash_attention_bwd(q, k, v, dout, causal=True)
    b = tflash.flash_attention_bwd(q, k, v, dout, causal=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_bwd_cuda_refuses_unaligned(cuda):
    q, k, v, dout = _kernel_inputs(1, 8, 1, 32, seed=0, device=cuda)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    bad = flat[1:].view(q.shape)
    bad.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_bwd(bad, k, v, dout)
