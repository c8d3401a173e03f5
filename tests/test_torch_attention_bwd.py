"""The flash attention backward of the port: the plain version
``kernels/ref.flash_attention_bwd_ref``, the CUDA kernel's wrapper
``kernels/flash_attention.flash_attention_bwd`` and the meta op that a
dry run prices, and how ``ops.flash_attention``'s autograd Function
routes between them.

On the CPU:

- ``flash_attention_bwd_ref(q, k, v, out, lse, dout)``, from the plain
  forward's out and lse, against ``jax.vjp`` of
  ``repro.models.attention.flash_attention`` (the custom VJP with the
  hand-written ``_flash_core_bwd``) at S 64 in chunks of 16, so that
  several (query chunk, key chunk) pairs are visible and, causal, some
  are skipped; G 1/2/4, D 16/32/64/128; float32 (the route that
  normalises p over its own scores and takes delta = sum_k p dp) with
  each gradient within 2e-6 of its largest entry (measured at most
  7e-7), and bfloat16 inputs on both sides
  (the route of the reference's formulas: p from the forward's lse,
  delta = sum_d dout out) within 2e-2;
- the two routes' residuals: float32 reads neither out nor lse, bfloat16
  reads both;
- the meta ops' shapes and dtypes (the forward's lse overload and the
  backward), what they refuse, and the price ``hlo_analysis.analyze``
  puts on the backward, causal and not: five products of 2·BH·G·S²·D,
  the causal kernel's own S(S+1)/2 apart, whatever the kernel does;
- what the CUDA wrapper refuses: a CPU tensor, a bad shape, dtype or
  head dim, an out or dout unlike q, an lse of the wrong shape or dtype,
  a misaligned out, lse or dout;
- the autograd Function's routing: CPU tensors to the plain version,
  meta tensors to the meta op, others to the kernel's wrapper, each
  moving ``backward_calls`` and only the kernel ``backward_launches``;
  the forward asks for lse only where autograd records, and the
  backward gets the forward's out and lse.

On a CUDA card (marker ``gpu``; skipped without one): the kernel, from
the forward kernel's out and lse, against the plain version within the
forward's tolerances (2e-4 f32, 2e-2 bf16) at every bf16 head dim,
ragged S, G 1/2/16, and the split dk / dv route at BH 1; two calls
bitwise equal, and a misaligned q refused. Run them there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention_bwd.py``
(this file imports JAX only inside the reference's tests).
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

# each gradient against the reference's, of its max
REF_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
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


def _bwd_inputs(bh, s, g, d, seed, dtype=torch.float32, causal=True):
    """q, k, v, out, lse, dout in the kernel layout: out and lse the plain
    forward's."""
    q, k, v, dout = _kernel_inputs(bh, s, g, d, seed, dtype)
    out, lse = tref.flash_attention_ref(q, k, v, causal=causal,
                                        return_lse=True)
    return q, k, v, out, lse, dout


# ----------------------------------------------------------------------
# the plain version against the reference's custom VJP
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,hq,hkv,d", [
    (True, 2, 2, 16), (True, 4, 2, 32), (True, 4, 1, 64),
    (True, 8, 2, 128), (False, 2, 2, 32), (False, 4, 2, 64),
    (False, 4, 1, 16), (False, 4, 2, 128),
])
def test_bwd_ref_matches_reference_vjp(causal, hq, hkv, d, dtype):
    """S 64 in chunks of 16: 16 chunk pairs, 10 of them visible when
    causal; G = hq / hkv of 1, 2 or 4. bfloat16: the inputs rounded to
    it on both sides, the gradients compared in float32."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_attention as jflash
    b, s = 1, 64
    q, k, v, dout = _model_inputs(b, s, hq, hkv, d, seed=hq * d + causal)
    _, vjp = jax.vjp(lambda *a: jflash(*a, causal=causal, q_chunk=16,
                                       kv_chunk=16),
                     *(jnp.asarray(a, dtype) for a in (q, k, v)))
    want = [np.asarray(w, np.float32)
            for w in vjp(jnp.asarray(dout, dtype))]
    tdt = getattr(torch, dtype)
    kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    qk, kk, vk = tops.kernel_layout(torch.from_numpy(q).to(tdt), kt, vt)
    dok = tops.kernel_layout(torch.from_numpy(dout).to(tdt), kt, vt)[0]
    out, lse = tref.flash_attention_ref(qk, kk, vk, causal=causal,
                                        return_lse=True)
    dq, dk, dv = tref.flash_attention_bwd_ref(qk, kk, vk, out, lse, dok,
                                              causal=causal)
    g = hq // hkv
    got = [dq.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4)
           .reshape(b, s, hq, d),
           dk.reshape(b, hkv, s, d).permute(0, 2, 1, 3),
           dv.reshape(b, hkv, s, d).permute(0, 2, 1, 3)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        err = np.abs(a.float().numpy() - w).max() / np.abs(w).max()
        assert err <= REF_TOL[dtype], (name, err)


def test_bwd_ref_routes_read_their_residuals():
    """float32 normalises p over the scores it recomputes and takes delta
    = sum_k p dp, so an lse shifted by a constant and an out of noise
    change nothing; bfloat16 takes p = exp(scores - lse) and delta from
    out, so each changes its gradients."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, out, lse, dout = _bwd_inputs(2, 24, 2, 32, seed=4,
                                              dtype=dtype)
        want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
        shifted = tref.flash_attention_bwd_ref(q, k, v, out, lse + 0.5,
                                               dout)
        noisy = tref.flash_attention_bwd_ref(q, k, v, torch.randn_like(out)
                                             .to(dtype), lse, dout)
        same = [all(torch.equal(a, w) for a, w in zip(x, want))
                for x in (shifted, noisy)]
        assert same == ([True, True] if dtype == torch.float32
                        else [False, False]), dtype


# ----------------------------------------------------------------------
# the meta ops and their price
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_bwd_shapes_and_dtypes(dtype):
    q, k, v, out, lse, dout = (t.to("meta") for t in _bwd_inputs(
        3, 20, 2, 32, seed=0, dtype=dtype))
    o2, l2 = tops._flash_forward_lse(q, k, v, True)
    assert (o2.device.type, o2.shape, o2.dtype) == ("meta", q.shape,
                                                    q.dtype)
    assert (l2.device.type, l2.shape, l2.dtype) == ("meta", lse.shape,
                                                    torch.float32)
    dq, dk, dv = tops._flash_backward(q, k, v, out, lse, dout, True)
    for got, like in zip((dq, dk, dv), (q, k, v)):
        assert got.device.type == "meta"
        assert got.shape == like.shape and got.dtype == like.dtype


def test_meta_bwd_refuses_what_the_kernel_refuses():
    q, k, v, out, lse, dout = (t.to("meta") for t in _bwd_inputs(
        1, 8, 1, 32, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        tops._flash_backward(q[..., :24], k[..., :24], v[..., :24],
                             out[..., :24], lse, dout[..., :24], True)
    with pytest.raises(ValueError, match="head dim"):
        tops._flash_forward_lse(q[..., :24], k[..., :24], v[..., :24],
                                True)
    with pytest.raises(TypeError, match="dtypes"):
        tops._flash_backward(q.half(), k.half(), v.half(), out.half(), lse,
                             dout.half(), True)
    with pytest.raises(ValueError, match="dout"):
        tops._flash_backward(q, k, v, out, lse, dout[:, :4], True)
    with pytest.raises(ValueError, match="out"):
        tops._flash_backward(q, k, v, out.to(torch.bfloat16), lse, dout,
                             True)
    with pytest.raises(ValueError, match="lse"):
        tops._flash_backward(q, k, v, out, lse[:, :4], dout, True)
    with pytest.raises(ValueError, match="lse"):
        tops._flash_backward(q, k, v, out, lse.to(torch.bfloat16), dout,
                             True)


@pytest.mark.parametrize("causal", [True, False])
def test_analyze_prices_the_backward(causal):
    """One backward call: 10·BH·G·S²·D dot FLOPs (the reference's five
    products), the causal kernel's own S(S+1)/2 pairs apart, q, k, v,
    out, lse, dout read and dq, dk, dv written once; traced on meta
    tensors and as a hand-built trace."""
    bh, s, g, d = 2, 48, 2, 16
    q, k, v, out, lse, dout = (t.to("meta") for t in _bwd_inputs(
        bh, s, g, d, seed=0, dtype=torch.bfloat16))
    with hlo_analysis.OpTrace() as tr:
        tops._flash_backward(q, k, v, out, lse, dout, causal)
    traced = hlo_analysis.analyze(tr.trace())
    bf = lambda *sh: ["bfloat16", list(sh)]
    hand = hlo_analysis.analyze({"ops": [[
        "repro_torch.flash_attention_bwd.default",
        [bf(bh, s, g, d), bf(bh, s, d), bf(bh, s, d), bf(bh, s, g, d),
         ["float32", [bh, s * g]], bf(bh, s, g, d)],
        [bf(bh, s, g, d), bf(bh, s, d), bf(bh, s, d)], True,
        {"args": [causal]}]]})
    pairs = s * (s + 1) // 2 if causal else s * s
    # bf16 q, out, dout, dq and k, v, dk, dv; f32 lse
    byts = 2 * (4 * bh * s * g * d + 4 * bh * s * d) + 4 * bh * s * g
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

def _misaligned(t):
    """t's values in a contiguous view 4 bytes into its storage."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    bad = flat[1:].view(t.shape)
    bad.copy_(t)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    return bad


def test_bwd_wrapper_checks_inputs():
    """The wrapper refuses what the kernel does not take, CPU tensors
    included (ops.py does the CPU dispatch), an out or dout unlike q, an
    lse unlike the forward's, and an out, lse or dout not contiguous or
    not 16-byte aligned."""
    q, k, v, out, lse, dout = _bwd_inputs(1, 8, 2, 32, seed=0)
    bwd = tflash.flash_attention_bwd
    with pytest.raises(ValueError, match="CUDA tensor"):
        bwd(q, k, v, out, lse, dout)
    with pytest.raises(ValueError, match="head dim"):
        bwd(*(t[..., :24].contiguous() for t in (q, k, v, out)), lse,
            dout[..., :24].contiguous())
    with pytest.raises(ValueError, match="shape"):
        bwd(q, k[:, :4], v, out, lse, dout)
    with pytest.raises(TypeError, match="one dtype"):
        bwd(q, k.to(torch.bfloat16), v, out, lse, dout)
    with pytest.raises(TypeError, match="dtype"):
        bwd(q.half(), k.half(), v.half(), out.half(), lse, dout.half())
    with pytest.raises(ValueError, match="dout must be q's shape"):
        bwd(q, k, v, out, lse, dout[:, :4])
    with pytest.raises(ValueError, match="dout must be q's shape"):
        bwd(q, k, v, out, lse, dout.to(torch.bfloat16))
    with pytest.raises(ValueError, match="out must be q's shape"):
        bwd(q, k, v, out[:, :4], lse, dout)
    with pytest.raises(ValueError, match="out must be q's shape"):
        bwd(q, k, v, out.to(torch.bfloat16), lse, dout)
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, k, v, out, lse[:, :4], dout)
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, k, v, out, lse.to(torch.bfloat16), dout)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, out, lse, dout.transpose(1, 2).contiguous()
            .transpose(1, 2))
    with pytest.raises(ValueError, match="out must be contiguous"):
        bwd(q, k, v, out.transpose(1, 2).contiguous().transpose(1, 2), lse,
            dout)
    with pytest.raises(ValueError, match="lse must be contiguous"):
        bwd(q, k, v, out, torch.stack([lse, lse], -1)[..., 0], dout)
    for name, i in (("out", 3), ("lse", 4), ("dout", 5)):
        args = [q, k, v, out, lse, dout]
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            bwd(*args)


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
    q, k, v, out, lse, dout = _bwd_inputs(2, 11, 2, 16, seed=1)
    got = _grads(q, k, v, dout)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                        causal=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert (tflash.backward_calls, tflash.backward_launches) == (1, 0)


def test_function_saves_out_and_lse(monkeypatch):
    """Where autograd records, the forward asks for lse and saves q, k, v,
    out and lse (the reference's residuals); the backward gets them.
    Without a record the op is the forward alone, and lse is never
    computed."""
    asked = []
    plain_fwd = tref.flash_attention_ref

    def fwd(q, k, v, *, causal=True, return_lse=False):
        asked.append(return_lse)
        return plain_fwd(q, k, v, causal=causal, return_lse=return_lse)
    monkeypatch.setattr(tref, "flash_attention_ref", fwd)
    q, k, v, dout = _kernel_inputs(1, 9, 2, 16, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tops._FlashAttention.apply(*leaves, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and asked == [True]
    want_out, want_lse = plain_fwd(q, k, v, causal=True, return_lse=True)
    for a, w in zip(saved, (q, k, v, want_out, want_lse)):
        assert torch.equal(a, w)
    assert saved[3].data_ptr() == out.data_ptr()
    # model layout (B 1, Hkv 1): under no_grad, and with no input that
    # requires grad
    model = lambda q, k, v: (q, k[:, :, None], v[:, :, None])
    with torch.no_grad():
        tops.flash_attention(*model(*leaves))
    tops.flash_attention(*model(q, k, v))
    assert asked == [True, False, False]


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

    def kernel(q, k, v, *, causal=True, return_lse=False):
        assert return_lse
        tflash.launches += 1
        return plain_fwd(q, k, v, causal=causal, return_lse=True)

    def backward_kernel(q, k, v, out, lse, dout, *, causal=True):
        assert dout.is_contiguous()
        seen.append(causal)
        tflash.backward_launches += 1
        return plain_bwd(q, k, v, out, lse, dout, causal=causal)

    def refused(*args, **kwargs):
        raise AssertionError("flash_attention_bwd_ref called on a card")
    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tflash, "flash_attention", kernel)
    monkeypatch.setattr(tflash, "flash_attention_bwd", backward_kernel)
    monkeypatch.setattr(tref, "flash_attention_bwd_ref", refused)
    for name in ("launches", "backward_calls", "backward_launches"):
        monkeypatch.setattr(tflash, name, 0)
    q, k, v, out, lse, dout = _bwd_inputs(1, 9, 2, 32, seed=2,
                                          causal=causal)
    got = _grads(q, k, v, dout.transpose(1, 2).contiguous().transpose(1, 2),
                 causal=causal)
    want = plain_bwd(q, k, v, out, lse, dout, causal=causal)
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


def _cuda_bwd_inputs(bh, s, g, d, causal, dtype, seed, device):
    """q, k, v, dout on the card and the forward kernel's out and lse."""
    q, k, v, dout = _kernel_inputs(bh, s, g, d, seed=seed,
                                   dtype=getattr(torch, dtype),
                                   device=device)
    out, lse = tflash.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,g,d,causal,dtype", [
    (2, 64, 1, 16, True, "float32"), (2, 17, 1, 64, False, "float32"),
    (1, 130, 2, 32, True, "bfloat16"), (1, 97, 4, 128, True, "float32"),
    (3, 200, 2, 128, False, "bfloat16"), (1, 70, 16, 128, True, "float32"),
    (2, 626, 1, 64, False, "float32"), (1, 1, 1, 16, True, "bfloat16"),
    # every bf16 head dim, ragged S, G 1 / 2 / 16
    (2, 77, 1, 16, True, "bfloat16"), (2, 300, 2, 16, False, "bfloat16"),
    (2, 150, 2, 32, False, "bfloat16"), (2, 129, 1, 64, True, "bfloat16"),
    (1, 90, 16, 64, True, "bfloat16"), (2, 33, 16, 128, False, "bfloat16"),
    (1, 260, 1, 128, True, "bfloat16"),
])
def test_bwd_cuda_matches_plain(cuda, bh, s, g, d, causal, dtype):
    q, k, v, out, lse, dout = _cuda_bwd_inputs(bh, s, g, d, causal, dtype,
                                               s + d, cuda)
    n0 = tflash.backward_launches
    got = tflash.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert tflash.backward_launches == n0 + 1
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                        causal=causal)
    tol = TOL[dtype]
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_cuda_split_route(cuda, dtype, causal):
    """BH 1: fewer key tiles than SMs, so each key tile's query
    rows split over several CTAs whose f32 partials a third kernel adds
    in order; held to the plain version and bitwise equal twice."""
    bh, s, g, d = 1, 1024, 4, 64
    splits = tflash.launch_fn("flash_attention_bwd",
                              "flash_attention_bwd_splits")(
        bh, s, g, tflash.DTYPE_CODES[getattr(torch, dtype)],
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert splits > 1
    args = _cuda_bwd_inputs(bh, s, g, d, causal, dtype, 7, cuda)
    got = tflash.flash_attention_bwd(*args, causal=causal)
    again = tflash.flash_attention_bwd(*args, causal=causal)
    want = tref.flash_attention_bwd_ref(*args, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,g,dtype,want", [
    (8, 4096, 2, "bfloat16", 1),     # mesh training: 256 CTAs, no split
    (16, 4096, 2, "bfloat16", 1),    # LM training
    (48, 626, 1, "float32", 1),      # DINO 400x400
    (1, 4096, 16, "float32", 5),     # the mesh MoE: 64 CTAs, to 2 waves
    (1, 100, 1, "float32", 2),       # at most a query tile of 64 a split
])
def test_bwd_cuda_splits_only_under_filled_grids(cuda, bh, s, g, dtype,
                                                 want):
    """On a card of 132 SMs the dk / dv kernel splits only a grid of
    fewer CTAs than SMs (key tiles of 64 f32, 128 bf16)."""
    splits = tflash.launch_fn("flash_attention_bwd",
                              "flash_attention_bwd_splits")(
        bh, s, g, tflash.DTYPE_CODES[getattr(torch, dtype)], 132)
    assert splits == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_cuda_is_deterministic(cuda, dtype):
    """Every output element is summed in a fixed order: two calls give
    bitwise equal gradients."""
    args = _cuda_bwd_inputs(2, 300, 2, 64, True, dtype, 5, cuda)
    a = tflash.flash_attention_bwd(*args, causal=True)
    b = tflash.flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_bwd_cuda_refuses_unaligned(cuda):
    q, k, v, out, lse, dout = _cuda_bwd_inputs(1, 8, 1, 32, True, "float32",
                                               0, cuda)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    bad = flat[1:].view(q.shape)
    bad.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_bwd(bad, k, v, out, lse, dout)
