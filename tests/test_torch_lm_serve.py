"""The port's LM serving path against the reference's: the flash branch,
the decode cache writes, the step factories and the cache converters.

The flash branch: ``FLASH_THRESHOLD`` monkeypatched to 16 in both
``repro.models.lm`` and the port's ``models.lm`` (nothing in the JAX
package is edited), so that prefill, ``lm_feature_fn`` and a decode
after the prefill at S = 32 and 64 take each package's flash attention
(the port's is the CUDA kernel's plain version on the CPU), counted in
both. The clamped decode write (position S without ``pad_caches``
overwrites slot S - 1 in both packages), ``make_prefill_step`` /
``make_decode_step`` (a model not placed on a step's mesh is refused),
caches handed both ways
between the packages, bf16 parameters carried across bitwise, the
reference's prefill-then-decode consistency (tests/test_arch_smoke.py)
run on the port, and the entry points refusing the CPU unless asked.
Tolerance 1e-4 * max(1, max |reference|) (float32). On the CPU; the
``gpu``-marked cases hold the card's flash branch against the plain
route on the card (``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_lm_serve.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ServeConfig as JServeConfig
from repro.features import extract as jextract
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.models.common import ParallelCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ServeConfig
from repro_torch.core.convert import (caches_from_numpy, caches_to_numpy,
                                      lm_from_numpy)
from repro_torch.features.extract import lm_feature_fn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps
from repro_torch.models import lm as tlm

CTX = ParallelCtx()
JSV = JServeConfig(cache_dtype="float32")
SV = ServeConfig(cache_dtype="float32")


def _close(got, want, rel=1e-4):
    """max |got - want| <= rel * max(1, max |want|)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_caches(got, want_tree, cfg):
    want = caches_from_numpy(_np(want_tree), cfg, device="cpu")
    for g, w in zip(got, want):
        for a, b in zip(g.values() if isinstance(g, dict) else g,
                        w.values() if isinstance(w, dict) else w):
            _close(a, b)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _pair(arch, seed=0, **overrides):
    jc = jconfigs.get_reduced_config(arch, **overrides)
    tc = tconfigs.get_reduced_config(arch, **overrides)
    params = jlm.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, params, lm_from_numpy(_np(params), tc, device="cpu")


# ----------------------------------------------------------------------
# the flash branch
# ----------------------------------------------------------------------

@pytest.fixture
def flash_at_16(monkeypatch):
    """FLASH_THRESHOLD 16 in both packages; counts each package's flash
    calls."""
    calls = {"ref": 0, "port": 0}
    ref_flash, port_flash = jattention.flash_attention, tops.flash_attention

    def counted_ref(*a, **kw):
        calls["ref"] += 1
        return ref_flash(*a, **kw)

    def counted_port(*a, **kw):
        calls["port"] += 1
        return port_flash(*a, **kw)
    monkeypatch.setattr(jlm, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tlm, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(jattention, "flash_attention", counted_ref)
    monkeypatch.setattr(tops, "flash_attention", counted_port)
    return calls


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-20b",
                                  "musicgen-medium", "qwen3-moe-235b-a22b",
                                  "llava-next-mistral-7b"])
def test_flash_branch_matches_reference(flash_at_16, arch, s):
    jc, tc, params, model = _pair(arch)
    x = _inputs(jc, 2, s + 2, seed=s)
    want, jcaches = jlm.prefill(params, jnp.asarray(x[:, :s]), jc, CTX, JSV)
    got, caches = tlm.prefill(model, x[:, :s], SV)
    layers = tc.num_layers
    # the reference traces its scanned blocks once: one call a slot of
    # the pattern and one a tail layer
    pattern, _, tail = jc.scan_pattern()
    traced = len(pattern) + len(tail)
    assert flash_at_16 == {"ref": traced, "port": layers}
    _close(got, want)
    _same_caches(caches, jcaches, tc)
    jcaches = jlm.pad_caches(jcaches, jc, s + 2)
    caches = tlm.pad_caches(caches, tc, s + 2)
    for t in (s, s + 1):
        want, jcaches = jlm.decode_step(params, jcaches,
                                        jnp.asarray(x[:, t:t + 1]),
                                        jnp.asarray(t), jc, CTX, JSV)
        got, caches = tlm.decode_step(model, caches, x[:, t:t + 1], t, SV)
        _close(got, want)
    assert flash_at_16 == {"ref": traced, "port": layers}   # decode: none
    _close(lm_feature_fn(model)(torch.from_numpy(x[:, :s])),
           jextract.lm_feature_fn(jc, CTX)(params, jnp.asarray(x[:, :s])))
    assert flash_at_16 == {"ref": 2 * traced, "port": 2 * layers}


def test_local_attention_never_takes_the_flash_branch(flash_at_16):
    """recurrentgemma's only attention is local: past the threshold its
    prefill matches the reference's and neither package calls flash."""
    jc, tc, params, model = _pair("recurrentgemma-2b")
    x = _inputs(jc, 1, 40)
    _close(tlm.prefill(model, x, SV)[0],
           jlm.prefill(params, jnp.asarray(x), jc, CTX, JSV)[0])
    assert flash_at_16 == {"ref": 0, "port": 0}


# ----------------------------------------------------------------------
# decode writes, steps, converters
# ----------------------------------------------------------------------

def test_decode_past_the_cache_clamps_as_the_reference():
    """Without pad_caches the cache holds S slots; the reference's
    dynamic_update_slice clamps position S to slot S - 1, and so does
    the port: the last prompt token's k/v are overwritten, the cache
    keeps S slots, logits and caches equal."""
    jc, tc, params, model = _pair("llama3-8b")
    x = _inputs(jc, 2, 13)
    s = 12
    _, jcaches = jlm.prefill(params, jnp.asarray(x[:, :s]), jc, CTX, JSV)
    caches = caches_from_numpy(_np(jcaches), tc, device="cpu")
    before = caches[0]["k"][:, s - 1].clone()
    want, jcaches = jlm.decode_step(params, jcaches, jnp.asarray(x[:, s:]),
                                    jnp.asarray(s), jc, CTX, JSV)
    got, caches = tlm.decode_step(model, caches, x[:, s:], s, SV)
    _close(got, want)
    _same_caches(caches, jcaches, tc)
    assert caches[0]["k"].shape[1] == s
    assert not torch.equal(caches[0]["k"][:, s - 1], before)


@pytest.mark.parametrize("s", [20, 40, 64])
def test_local_ring_cache_matches_reference(s):
    """recurrentgemma's local layer keeps the trailing window (32 in the
    reduced config) in ring layout: a short prompt right-padded, a long
    one rolled by s % window; decode writes at pos % window."""
    jc, tc, params, model = _pair("recurrentgemma-2b")
    x = _inputs(jc, 1, s + 3, seed=s)
    _, jcaches = jlm.prefill(params, jnp.asarray(x[:, :s]), jc, CTX, JSV)
    logits, caches = tlm.prefill(model, x[:, :s], SV)
    _same_caches(caches, jcaches, tc)
    for t in range(s, s + 3):
        want, jcaches = jlm.decode_step(params, jcaches,
                                        jnp.asarray(x[:, t:t + 1]),
                                        jnp.asarray(t), jc, CTX, JSV)
        got, caches = tlm.decode_step(model, caches, x[:, t:t + 1], t, SV)
        _close(got, want)
    _same_caches(caches, jcaches, tc)


def test_step_factories():
    jc, tc, params, model = _pair("internlm2-1.8b")
    x = _inputs(jc, 1, 10)
    prefill_step = steps.make_prefill_step(tc, SV, None)
    decode_step = steps.make_decode_step(tc, SV, None)
    logits, caches = prefill_step(model, x[:, :9])
    want, _ = tlm.prefill(model, x[:, :9], SV)
    assert torch.equal(logits, want)
    caches = tlm.pad_caches(caches, tc, 10)
    got, _ = decode_step(model, caches, x[:, 9:], 9)
    jl, jcaches = jlm.prefill(params, jnp.asarray(x[:, :9]), jc, CTX, JSV)
    jcaches = jlm.pad_caches(jcaches, jc, 10)
    want, _ = jlm.decode_step(params, jcaches, jnp.asarray(x[:, 9:]),
                              jnp.asarray(9), jc, CTX, JSV)
    _close(got, want)
    # a step made for a mesh refuses a model not placed on it (the mesh
    # itself runs in tests/test_torch_mesh_serve.py)
    stand_in = SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="not placed"):
        steps.make_prefill_step(tc, SV, mesh=stand_in)(model, x[:, :9])
    with pytest.raises(ValueError, match="not placed"):
        steps.make_decode_step(tc, SV, mesh=stand_in)(model, caches,
                                                      x[:, 9:], 9)
    other = tconfigs.get_reduced_config("llama3-8b")
    with pytest.raises(ValueError, match="another config"):
        steps.make_prefill_step(other, SV)(model, x)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b"])
def test_caches_cross_both_ways(arch):
    """The port's prefill caches, by caches_to_numpy, drive the
    reference's decode; and round trip through caches_from_numpy."""
    jc, tc, params, model = _pair(arch)
    x = _inputs(jc, 2, 17)
    _, caches = tlm.prefill(model, x[:, :16], SV)
    tree = caches_to_numpy(caches, tc)
    back = caches_from_numpy(tree, tc, device="cpu")
    for a, b in zip(caches, back):
        for u, w in zip(a.values() if isinstance(a, dict) else a,
                        b.values() if isinstance(b, dict) else b):
            assert torch.equal(u, w)
    tree = jlm.pad_caches(jax.tree_util.tree_map(jnp.asarray, tree), jc, 17)
    want, _ = jlm.decode_step(params, tree, jnp.asarray(x[:, 16:]),
                              jnp.asarray(16), jc, CTX, JSV)
    got, _ = tlm.decode_step(model, tlm.pad_caches(caches, tc, 17),
                             x[:, 16:], 16, SV)
    _close(got, want)


def test_bf16_parameters_cross_bitwise():
    """A bf16-parameter config carries the reference's bf16 leaves across
    bit for bit, and prefill (computing in float32) matches."""
    jc, tc, params, model = _pair("llama3-8b", param_dtype="bfloat16")
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("router")
                           else torch.bfloat16), name
    embed = np.asarray(params["embed"]).view(np.uint16)
    assert np.array_equal(model.embed.view(torch.int16).numpy().view(
        np.uint16), embed)
    x = _inputs(jc, 1, 12)
    _close(tlm.prefill(model, x, SV)[0],
           jlm.prefill(params, jnp.asarray(x), jc, CTX, JSV)[0])


@pytest.mark.parametrize(
    "arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-1.3b",
             "recurrentgemma-2b", "musicgen-medium"])
def test_prefill_then_decode_matches_full_forward(arch):
    """tests/test_arch_smoke.py's consistency check on the port:
    prefill(S) + T decode steps == prefill(S + T) at the last position
    (MoE dropless at capacity factor 64)."""
    _, tc, _, model = _pair(arch, moe_capacity_factor=64.0)
    S, T = 24, 4
    full = _inputs(tc, 1, S + T)
    want, _ = tlm.prefill(model, full, SV)
    logits, caches = tlm.prefill(model, full[:, :S], SV)
    caches = tlm.pad_caches(caches, tc, S + T)
    for t in range(S, S + T):
        logits, caches = tlm.decode_step(model, caches, full[:, t:t + 1], t,
                                         SV)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_lm_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = tconfigs.get_reduced_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_caches(cfg, 1, 8)
    jc = jconfigs.get_reduced_config("llama3-8b")
    params = _np(jlm.init_params(jax.random.PRNGKey(0), jc))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_from_numpy(params, cfg)
    caches = _np(jlm.init_caches(jc, 1, 8, JSV))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        caches_from_numpy(caches, cfg)


def test_init_caches_match_reference():
    for arch in ("llama4-maverick-400b-a17b", "mamba2-1.3b",
                 "recurrentgemma-2b"):
        jc = jconfigs.get_reduced_config(arch)
        tc = tconfigs.get_reduced_config(arch)
        want = caches_from_numpy(_np(jlm.init_caches(jc, 2, 16, JSV)), tc,
                                 device="cpu")
        got = tlm.init_caches(tc, 2, 16, SV, device="cpu")
        for a, b in zip(got, want):
            for u, w in zip(a.values() if isinstance(a, dict) else a,
                            b.values() if isinstance(b, dict) else b):
                assert u.shape == w.shape and u.dtype == w.dtype
                assert not u.any()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_lm_serve.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv", [(32, 8), (48, 1)])
def test_lm_flash_branch_on_the_card(cuda, hq, hkv):
    """The LM's flash branch at a 4,096-token prefill, bf16 (llama3-8b's
    32/8 heads, granite-20b's MQA 48/1, head dim 128): one kernel launch,
    within 2e-2 of the plain route (full_attention) on the same card."""
    from repro_torch.models import attention as tattention
    gen = torch.Generator(device=cuda).manual_seed(hq)
    q, k, v = (torch.randn(1, 4096, h, 128, device=cuda, generator=gen)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    n0 = tflash.launches
    got = tattention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tflash.launches == n0 + 1
    want = tattention.full_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
